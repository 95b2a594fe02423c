"""Share of the traced stretch in which no kernel ran on the card:
1 − the union of kernel intervals over the stretch's wall time."""


def read(m):
    t = m.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
