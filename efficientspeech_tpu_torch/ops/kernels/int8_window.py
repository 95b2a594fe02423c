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
the kernel or raises.  How the kernel spreads a tile over a cluster of
blocks is decided here, by ``plan``, and handed to the launch.
"""

import ctypes
import functools
from typing import NamedTuple

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


# shared memory a block may use on an H100 (232,448 bytes); the kernel
# aims at two blocks an SM
SMEM_LIMIT = 227 * 1024
MAX_CLUSTER = 8     # the portable cluster size
NT = 256            # csrc: threads a block (two warpgroups)
PADB = 16           # bytes of padding an int8-tile row
SHARE_CHUNKS = 16 * NT   # 16-byte chunks of a bf16 share in registers
HALO_CHUNKS = 2 * NT     # and of the halo rows past it
ALIGN_SLACK = 1024  # the kernel aligns its shared memory to 1,024 bytes


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def wt_bytes(n_win: int, d_in: int, d_out: int) -> int:
    """W^T in wgmma's 128-byte-swizzled K-major layout: 1,024-byte atoms
    of 8 columns x 128 k, every k block padded to 128."""
    return -(-n_win * d_in // 128) * (d_out // 8) * 1024


class Plan(NamedTuple):
    """How the kernel spreads a tile of ``tm`` rows: a cluster of ``cs``
    blocks, block r computing output rows [r·rb, min((r+1)·rb, tm)) and
    reading slice rows [r·rb, (r+1)·rb) for the maximum (the last block to
    slice_rows).  Shared memory, from a 1,024-byte aligned base: W^T at 0
    (``wt_bytes``), the int8 tile at ``xq_off``, the partial maxima at
    ``pmax_off``, W^T's mbarrier at ``bar_off``; ``smem`` bytes in all,
    the alignment slack included."""
    cs: int
    rb: int
    xq_off: int
    pmax_off: int
    bar_off: int
    wt_bytes: int
    smem: int

    def out_rows(self, tm: int):
        """Each block's [start, end) of the tile's output rows."""
        return [(r * self.rb, min((r + 1) * self.rb, tm))
                for r in range(self.cs)]

    def shares(self, tm: int, n_win: int):
        """Each block's [start, end) of the slice rows it reads for the
        maximum."""
        sr = slice_rows(tm, n_win)
        return [(r * self.rb, sr if r == self.cs - 1 else (r + 1) * self.rb)
                for r in range(self.cs)]


@functools.lru_cache(maxsize=64)
def plan(tm: int, n_win: int, d_in: int, d_out: int, itemsize: int = 2
         ) -> Plan:
    """The kernel's cluster plan for tiles of ``tm`` rows (x of
    ``itemsize`` bytes a value); raises ValueError for what the kernel
    does not take.  Rows a block: about 128 (then 96, 64, 32, or tm / 8
    for tiles past 1,024 rows), the first whose cluster has at most 8
    blocks, whose largest bf16 share fits the registers of a block and
    whose shared memory fits."""
    if d_in <= 0 or d_in % 32 or d_out <= 0 or d_out % 64 or tm <= 0 \
            or tm % 32 or n_win < 1:
        raise ValueError(f"int8_window: needs d_in % 32, d_out % 64 and "
                         f"tm % 32; got d_in {d_in}, d_out {d_out}, tm {tm}")
    if itemsize == 2 and (n_win - 1) * d_in // 8 > HALO_CHUNKS:
        raise ValueError(f"int8_window: {n_win} taps at d_in {d_in} give a "
                         "halo wider than a block's registers hold")
    sr = slice_rows(tm, n_win)
    wt = wt_bytes(n_win, d_in, d_out)
    for cap in (128, 96, 64, 32, None):
        cs = MAX_CLUSTER if cap is None else -(-tm // cap)
        if cs > MAX_CLUSTER:
            continue
        rb = _align(-(-tm // cs), 32)
        cs = -(-tm // rb)
        share = max(rb, sr - (cs - 1) * rb)
        if itemsize == 2 and share * d_in // 8 > SHARE_CHUNKS:
            continue
        # rows the products read: whole 64-row passes and the window
        xq_bytes = _align((_align(rb, 64) + n_win - 1) * (d_in + PADB), 16)
        pmax_off = wt + xq_bytes
        bar_off = _align(pmax_off + 4 * (1 + NT // 32), 8)
        smem = bar_off + 8 + ALIGN_SLACK
        if smem <= SMEM_LIMIT:
            return Plan(cs, rb, wt, pmax_off, bar_off, wt, smem)
    raise ValueError(f"int8_window: no cluster of at most {MAX_CLUSTER} "
                     f"blocks takes tm {tm} at d_in {d_in}, d_out {d_out}, "
                     f"{n_win} taps in a block's shared memory and "
                     "registers")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "int8_window_launch": ([_P] * 4 + [_I] * 14 + [_P], _I),
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
    if t_pad < tm or t_pad % tm:
        raise ValueError(f"int8_window: needs rows − {sr} a positive "
                         f"multiple of tm; got x {tuple(x.shape)}, tm {tm}")
    pl = plan(tm, n_win, d_in, d_out, x.element_size())
    dev = x.device
    build.check_tensor("x", x, x.dtype, (rows, d_in), dev)
    build.check_tensor("w", w, torch.int8, (n_win * d_in, d_out), dev)
    lib = _lib()
    out = torch.empty((t_pad, d_out), dtype=torch.float32, device=dev)
    # W^T in the products' layout, written by the kernel's pre-pass
    wt = torch.empty(pl.wt_bytes, dtype=torch.uint8, device=dev)
    quant = x.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.int8_window_launch(
            x.data_ptr(), w.data_ptr(), wt.data_ptr(), out.data_ptr(),
            int(quant), d_in, d_out, n_win, tm, sr, t_pad // tm, pl.cs,
            pl.rb, pl.xq_off, pl.pmax_off, pl.bar_off, pl.wt_bytes, pl.smem,
            stream)
    build.check(lib, err, "int8_window")
    if quant:
        launches_quant += 1
    else:
        launches_int8 += 1
    return out
