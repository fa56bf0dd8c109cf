"""step_mfu.query: The least time the card needs for the window's work, over the window, %:
every encoder forward's model operations at the tokens its inputs hold
(unpadded; ``counts.bert_flops``, the query embedder's and the
cross-encoder's widths alike) at the bf16 peak, plus every index scan's
rows read once (``counts.scan_bytes``) at the HBM rate. In a traced run the
window is the stretch after the profiler's stop (``bench/drive.py``)."""

from portbench.bench import counts


def read(m):
    cfg = m.config["embedder"]
    ops = sum(counts.bert_flops(cfg, n, sq) for _, _, n, sq in m.forwards)
    nbytes = sum(counts.scan_bytes(rows, rb) for _, rows, rb in m.scans)
    if not ops and not nbytes:
        return None
    return 100.0 * (ops / counts.BF16_FLOPS + nbytes / counts.HBM_BYTES) / m.window_s
