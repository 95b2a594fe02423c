"""K2's wide kernel (``mrf_kernel_wide``: the stages 256 channels wide,
HiFi-GAN V1's first): those stages' least times for the traced rows'
valid frames, by the rule of ``work.mrf_bound_s`` (the MRF's bf16
products over the tensor-core peak, or its float32 activations in and
out and its weights over the memory rate, whichever is larger), over the
wide kernel's time."""

from perfbench.yardstick import work
from perfbench.yardstick.trace import kernel_s

WIDE = 256


def wide_bound_s(hcfg: dict, frames: int) -> float:
    convs = 2 * sum(len(d) for d in hcfg["resblock_dilation_sizes"])
    total = 0.0
    for st in work.mrf_stages(hcfg):
        c, s = st["channels"], st["samples_per_frame"] * frames
        if c != WIDE:
            continue
        # taps · C² bf16 weights: flops_per_sample is 2 · C² · taps
        w_bytes = st["flops_per_sample"] + convs * c * 4
        total += work.bound_s(st["flops_per_sample"] * s, 0.0,
                              2 * c * s * 4 + w_bytes)
    return total


def read(m):
    t = m.get("trace")
    if not t:
        return None
    spent = kernel_s(t, "mrf_kernel_wide")
    if spent <= 0:
        return None
    bound = sum(wide_bound_s(m["hifigan"], f) for f in m["traced_frames"])
    return 100.0 * bound / spent
