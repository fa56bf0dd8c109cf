"""embed_ms.query: Mean ``embedding/embed_queries`` span of the window (the program's
tracer, through the harness's processor), ms."""

def read(m):
    v = m.spans.get("embedding/embed_queries")
    return sum(v) / len(v) if v else None
