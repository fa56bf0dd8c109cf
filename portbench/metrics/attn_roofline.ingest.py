"""attn_roofline.ingest: Blockwise attention's bound (``counts.attention_bound_s`` of every call
in the profiled stretch: the embedder's forwards at T >= 256) over the
attention kernel's device time there, %."""

from portbench.bench import counts


def read(m):
    t = sum(s for n, s in m.trace["by_name"].items() if "attention_kernel" in n)
    bound = sum(counts.attention_bound_s(*c) for c in m.attn)
    return 100.0 * bound / t if t > 0 and bound > 0 else None
