"""embed_share.ingest: Share of the window spent inside the builder's embedder calls, %."""

def read(m):
    return 100.0 * m.embed_s / m.window_s if m.embed_s else None
