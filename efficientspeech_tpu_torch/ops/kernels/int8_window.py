"""int8 windowed deep-K matmul: the CUDA kernel K5
(``csrc/int8_window.cu``) and its plain PyTorch version.

Over x (t_pad + slice_rows, d_in) and int8 W (n_win·d_in, d_out), with
slice_rows = round_up(tm + n_win − 1, 8) and t_pad a multiple of tm, tile
i of tm output rows is

    slice  = x[i·tm : i·tm + slice_rows]
    bf16 x: scale = max(max |slice|, 1e−6) · float32(1/127)
            xq    = trunc_toward_zero(clip(slice / scale, −127, 127))
    int8 x: scale = 1, xq = slice
    out[i·tm + r] = float(Σ_j xq[r + j] · W[j·d_in:(j+1)·d_in]) · scale

with int8 × int8 products summed in int32: the function of the int8 probe
kernel of the JAX package's benchmarks, a probe of the card's int8 tensor
cores for the folded vocoder.  tm sets each scale's extent, so it is an
argument.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""

import ctypes

import numpy as np
import torch

from efficientspeech_tpu_torch.ops.kernels import build

# kernel launches since the counts were last set to 0: bf16 input with
# tile quantisation, and int8 input
launches_quant = 0
launches_int8 = 0

# float32(1/127), the reciprocal XLA folds the probe's "/ 127.0" into
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def slice_rows(tm: int, n_win: int) -> int:
    """Rows of x a tile reads: the window's tm + n_win − 1, rounded up to
    a multiple of 8."""
    return -(-(tm + n_win - 1) // 8) * 8


def layout(t: int, tm: int, n_win: int):
    """(t_pad, rows of x) for t output rows: t rounded up to tiles of tm,
    and the last tile's whole slice."""
    t_pad = -(-t // tm) * tm
    return t_pad, t_pad + slice_rows(tm, n_win)


def quantized_slices(x: torch.Tensor, n_win: int, tm: int):
    """The tiles' slices as the kernel quantises them → (xq (n_tiles,
    slice_rows, d_in) float32 holding integers, scale (n_tiles,)
    float32)."""
    sr = slice_rows(tm, n_win)
    n_tiles = (x.shape[0] - sr) // tm
    rows = (torch.arange(n_tiles, device=x.device)[:, None] * tm
            + torch.arange(sr, device=x.device)[None, :])
    slices = x[rows].float()
    if x.dtype == torch.int8:
        return slices, torch.ones(n_tiles, device=x.device)
    amax = slices.abs().amax(dim=(1, 2))
    scale = torch.clamp_min(amax, 1e-6) * INV_127
    return torch.clamp(slices / scale[:, None, None], -127, 127).trunc(), scale


def window(xq: torch.Tensor, n_win: int, tm: int) -> torch.Tensor:
    """(n_tiles, slice_rows, d_in) → the tiles' windows (n_tiles, tm,
    n_win·d_in): rows r .. r + n_win − 1 side by side."""
    return torch.cat([xq[:, j:j + tm] for j in range(n_win)], dim=2)


def int8_window_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_win: int,
                             tm: int) -> torch.Tensor:
    """The kernel's function: exact integer sums (float64 products of
    integers below 2⁵³), then one float32 multiply by the tile's scale."""
    xq, scale = quantized_slices(x, n_win, tm)
    acc = torch.matmul(window(xq, n_win, tm).double(), w.double())
    return (acc.float() * scale[:, None, None]).reshape(-1, w.shape[1])


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "int8_window_launch": ([_P] * 3 + [_I] * 7 + [_P], _I),
    "int8_window_smem_bytes": ([_I] * 4, _I),
}


def _lib():
    return build.load("int8_window", _SIGNATURES)


def int8_window_matmul(x: torch.Tensor, w: torch.Tensor, n_win: int,
                       tm: int) -> torch.Tensor:
    """x (t_pad + slice_rows, d_in) bf16 (quantised per tile) or int8, w
    (n_win·d_in, d_out) int8 → (t_pad, d_out) float32.  On CUDA: d_in a
    multiple of 32, d_out of 64, tm of 32."""
    global launches_quant, launches_int8
    if x.device.type == "cpu":
        return int8_window_matmul_plain(x, w, n_win, tm)
    if x.device.type != "cuda":
        raise ValueError(f"int8_window: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"int8_window: x must be bf16 or int8, not "
                         f"{x.dtype}")
    rows, d_in = x.shape
    d_out = w.shape[1]
    sr = slice_rows(tm, n_win)
    t_pad = rows - sr
    if d_in % 32 or d_out % 64 or tm % 32 or t_pad < tm or t_pad % tm:
        raise ValueError(f"int8_window: needs d_in % 32, d_out % 64, tm % 32 "
                         f"and rows − {sr} a positive multiple of tm; got "
                         f"x {tuple(x.shape)}, d_out {d_out}, tm {tm}")
    dev = x.device
    build.check_tensor("x", x, x.dtype, (rows, d_in), dev)
    build.check_tensor("w", w, torch.int8, (n_win * d_in, d_out), dev)
    lib = _lib()
    if lib.int8_window_smem_bytes(d_in, d_out, n_win, sr) > 227 * 1024:
        raise ValueError(f"int8_window: a tile of {sr} x {d_in} and W "
                         f"{tuple(w.shape)} need more shared memory than a "
                         "block has")
    out = torch.empty((t_pad, d_out), dtype=torch.float32, device=dev)
    quant = x.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.int8_window_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), int(quant), d_in,
            d_out, n_win, tm, sr, t_pad // tm, stream)
    build.check(lib, err, "int8_window")
    if quant:
        launches_quant += 1
    else:
        launches_int8 += 1
    return out
