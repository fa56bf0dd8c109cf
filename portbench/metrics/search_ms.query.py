"""search_ms.query: Mean ``retrieval/vector_search`` span of the window, ms; with the
store's coalescer on, it holds the coalescer's wait."""

def read(m):
    v = m.spans.get("retrieval/vector_search")
    return sum(v) / len(v) if v else None
