"""Share of the narration window's untraced calls spent on the host after
the device program and its copy: 1 − Σ ``batch_secs`` / Σ call wall
(``batch_secs`` is the synthesizer's own figure for program plus copy)."""


def read(m):
    v = m.get("host_tail_share")
    return None if v is None else 100.0 * v
