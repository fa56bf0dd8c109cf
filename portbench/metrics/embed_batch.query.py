"""embed_batch.query: Questions a dispatch of the embedder's coalescer in the window."""

def read(m):
    c = m.coalescers
    return c["embed_items"] / c["embed_dispatches"] if c["embed_dispatches"] else None
