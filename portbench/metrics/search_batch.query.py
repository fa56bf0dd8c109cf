"""search_batch.query: Questions a dispatch of the store's coalescer in the window."""

def read(m):
    c = m.coalescers
    return c["search_queries"] / c["search_dispatches"] if c["search_dispatches"] else None
