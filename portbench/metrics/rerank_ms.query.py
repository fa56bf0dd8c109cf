"""rerank_ms.query: Mean host-clock time of ``TorchReranker.rerank`` a question in the
window, ms."""

def read(m):
    v = m.rerank_s
    return 1e3 * sum(v) / len(v) if v else None
