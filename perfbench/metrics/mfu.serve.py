"""Model FLOPs of the traced batches of the server' valid phonemes and frames (acoustic
model and the convolutional generator, counted from their definitions)
over the traced stretch and the bf16 peak."""

from perfbench.yardstick.work import PEAK_BF16_FLOPS


def read(m):
    t = m.get("trace")
    if not t or not m.get("traced_flops"):
        return None
    return 100.0 * m["traced_flops"] / t["window_s"] / PEAK_BF16_FLOPS
