"""Where the port runs: CUDA unless the caller asks for the CPU."""

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Without one this raises instead of
    carrying on quietly on the CPU; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_full_f32():
    """Keep float32 work in float32 on the card: cuDNN's convolutions take
    TF32 by default (about three decimal digits), and so would cuBLAS's
    products if the switch were flipped.  ``--precision f32`` calls this so
    that the model's other ops agree with its float32 kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
