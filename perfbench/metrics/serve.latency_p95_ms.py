"""The 95th percentile of the client-side latency (send to last byte)
of every request of the window answered before the profiled stretch,
a third into the window (several hundred requests)."""


def read(m):
    return m.get("latency_p95_ms")
