"""Operand precision of the reference's products.

``float32`` leaves operands as they are (the reference proper, run with
TF32 off).  ``bf16`` rounds each operand to bfloat16.  ``fp8`` rounds each
operand to float8 e4m3 after scaling the tensor so that its largest
magnitude sits at the format's largest finite value (448), then scales
back: the per-tensor scaled fp8 product a lower-precision route would
use.  The arithmetic after the rounding stays float32, and a gradient
passes the rounding unchanged (the backward's products take the rounded
operands the forward saved, and float32 output gradients)."""

import torch

FP8_MAX = 448.0


class Precision:
    """``acts=True`` also rounds every activation a layer writes to
    bfloat16 (``a``): a model that computes in bf16 throughout, as the
    measured acoustic model does when it serves.  ``biases=True`` (the
    default with ``acts``) rounds the biases as the products' operands
    (``b``), as a model whose parameters are stored in that precision."""

    def __init__(self, name: str = "float32", acts: bool = False,
                 biases=None):
        if name not in ("float32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.acts = acts
        self.biases = acts if biases is None else biases

    def a(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).float() if self.acts else x

    def b(self, bias):
        return self.q(bias) if self.biases and bias is not None else bias

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32" or not x.is_floating_point():
            return x
        with torch.no_grad():
            if self.name == "bf16":
                r = x.to(torch.bfloat16).float()
            else:
                scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
                r = (x * scale).to(torch.float8_e4m3fn).float() / scale
            step = r - x
        return x + step if x.requires_grad else r


def reference_mode():
    """Float32 products everywhere: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
