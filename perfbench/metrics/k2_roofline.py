"""K2 (the MRF kernel, ``mrf_kernel``): the sum of its least times for
the traced rows' valid frames, from the MRF's convolution work and the
activations each stage must read and write, over its kernel time."""

from perfbench.yardstick.trace import kernel_s
from perfbench.yardstick.work import mrf_bound_s


def read(m):
    t = m.get("trace")
    if not t:
        return None
    spent = kernel_s(t, "mrf_kernel")
    if spent <= 0:
        return None
    bound = sum(mrf_bound_s(m["hifigan"], f) for f in m["traced_frames"])
    return 100.0 * bound / spent
