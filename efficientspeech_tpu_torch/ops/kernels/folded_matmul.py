"""Windowed matmul of the folded vocoder: the CUDA kernel K1
(``csrc/folded_matmul.cu``) and its plain PyTorch version.

    y[t] = Σ_{j<2w+1} act(x[t−w+j]) @ W[j·D_in:(j+1)·D_in] + b
           (+ residual) (+ accum), then × out_scale; rows ≥ valid → 0

``act`` is an optional leaky-relu; rows outside [0, T) read as zero.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The kernel has two variants, chosen by W's dtype: bf16 W
multiplies in bf16 with float32 accumulation, float32 W in float32 (see
the source's notes on numerics); the plain version multiplies in float32.
"""

import ctypes
from typing import Optional, Union

import torch
import torch.nn.functional as F

from efficientspeech_tpu_torch.ops.kernels import build

LRELU_SLOPE = 0.1

# the weight dtypes the kernel is built for
DTYPES = (torch.bfloat16, torch.float32)

# kernel launches by W's dtype since the counts were last set to 0
launches = dict.fromkeys(DTYPES, 0)


def leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def window(x: torch.Tensor, w: int) -> torch.Tensor:
    """(T, D) → (T, (2w+1)·D): rows t−w..t+w side by side, zero outside."""
    if w == 0:
        return x
    t = x.shape[0]
    xp = F.pad(x, (0, 0, w, w))
    return torch.cat([xp[j: j + t] for j in range(2 * w + 1)], dim=-1)


def mask_rows(y: torch.Tensor, valid: Union[int, torch.Tensor]
              ) -> torch.Tensor:
    """Zero the rows at or beyond ``valid`` (an int or a one-element
    tensor on y's device)."""
    if isinstance(valid, torch.Tensor):
        valid = valid.reshape(())
    rows = torch.arange(y.shape[0], device=y.device)
    return torch.where((rows < valid)[:, None], y, torch.zeros_like(y))


def folded_matmul_plain(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                        w: int, valid: Union[int, torch.Tensor],
                        residual: Optional[torch.Tensor] = None,
                        accum: Optional[torch.Tensor] = None,
                        out_scale: Optional[float] = None,
                        pre_lrelu: bool = False,
                        lrelu_slope: float = LRELU_SLOPE) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32 products."""
    src = leaky(x, lrelu_slope) if pre_lrelu else x
    y = window(src, w).float() @ W.to(x.dtype).float()
    y = y + b.to(x.dtype).float()
    if residual is not None:
        y = y + residual.float()
    if accum is not None:
        y = y + accum.float()
    if out_scale is not None:
        y = y * out_scale
    return mask_rows(y, valid).to(x.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "folded_matmul_launch": ([_P] * 7 + [_I] * 5 + [_F, _I, _F, _I, _P],
                             _I),
    "folded_matmul_smem_bytes": ([_I, _I, _I], _I),
}


def _lib():
    return build.load("folded_matmul", _SIGNATURES)


def folded_matmul(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor, w: int,
                  valid: Union[int, torch.Tensor],
                  residual: Optional[torch.Tensor] = None,
                  accum: Optional[torch.Tensor] = None,
                  out_scale: Optional[float] = None,
                  pre_lrelu: bool = False,
                  lrelu_slope: float = LRELU_SLOPE) -> torch.Tensor:
    """x (T, D_in) → (T, D_out).  W ((2w+1)·D_in, D_out), b (D_out,),
    ``valid`` a row count (on CUDA a one-element int32 tensor on the card,
    so the host never waits for it).

    On CUDA: x, residual, accum float32; W bf16 or float32 (the kernel's
    variant); b float32; D_in and D_out multiples of 16."""
    if x.device.type == "cpu":
        return folded_matmul_plain(x, W, b, w, valid, residual, accum,
                                   out_scale, pre_lrelu, lrelu_slope)
    if x.device.type != "cuda":
        raise ValueError(f"folded_matmul: unsupported device {x.device}")
    t, d_in = x.shape
    n_win = 2 * w + 1
    d_out = W.shape[1]
    dev = x.device
    if d_in % 16 or d_out % 16:
        raise ValueError(f"folded_matmul: D_in {d_in} and D_out {d_out} "
                         "must be multiples of 16")
    if W.dtype not in DTYPES:
        raise ValueError(f"folded_matmul: W is {W.dtype}, not one of "
                         f"{DTYPES}")
    f32 = int(W.dtype == torch.float32)
    build.check_tensor("x", x, torch.float32, (t, d_in), dev)
    build.check_tensor("W", W, W.dtype, (n_win * d_in, d_out), dev)
    build.check_tensor("b", b, torch.float32, (d_out,), dev)
    build.check_valid("folded_matmul", valid, dev)
    for name, r in (("residual", residual), ("accum", accum)):
        if r is not None:
            build.check_tensor(name, r, torch.float32, (t, d_out), dev)
    lib = _lib()
    if lib.folded_matmul_smem_bytes(d_in, w, f32) > 227 * 1024:
        raise ValueError(f"folded_matmul: D_in {d_in} with w {w} needs more "
                         "shared memory than a block has")
    out = torch.empty((t, d_out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.folded_matmul_launch(
            x.data_ptr(), W.data_ptr(), b.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if accum is None else accum.data_ptr(),
            out.data_ptr(), valid.data_ptr(), t, d_in, d_out, w,
            int(pre_lrelu), float(lrelu_slope), int(out_scale is not None),
            float(out_scale if out_scale is not None else 1.0), f32, stream)
    build.check(lib, err, "folded_matmul")
    launches[W.dtype] += 1
    return out
