"""idle_share.query: Share of the profiled stretch with no kernel running on the card, %."""

def read(m):
    t = m.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["busy_s"] > 0 else None
