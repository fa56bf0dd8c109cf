"""step_mfu.ingest: The embedder forwards' model operations at the tokens their inputs hold
(unpadded; ``counts.bert_flops``) at the bf16 peak, over the window (in a
traced run the stretch after the profiler's stop), %."""

from portbench.bench import counts


def read(m):
    cfg = m.config["embedder"]
    ops = sum(counts.bert_flops(cfg, n, sq) for _, _, n, sq in m.forwards)
    return 100.0 * ops / counts.BF16_FLOPS / m.window_s if ops else None
