"""Windowed matmul of the folded vocoder: the CUDA kernel K1
(``csrc/folded_matmul.cu``) and its plain PyTorch version.

    y[t] = Σ_{j<2w+1} act(x[t−w+j]) @ W[j·D_in:(j+1)·D_in] + b
           (+ residual) (+ accum), then × out_scale; rows ≥ valid → 0

``act`` is an optional leaky-relu; rows outside [0, T) read as zero.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The kernel has two variants, chosen by W's dtype: bf16 W
multiplies in bf16 with float32 accumulation, float32 W by 3xTF32 split
products on the tensor cores, held to float32 (see the sources' notes on
numerics); the plain version multiplies in float32.  Each variant's
tiling is decided here (``plan``, ``f32_plan``) and handed to the launch.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Union

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


# shared memory a block may use on an H100 (232,448 bytes)
SMEM_LIMIT = 227 * 1024
SMS_H100 = 132
APAD = 8            # bf16 padding of an A-tile row (csrc: bf16v::APAD)
ALIGN_SLACK = 1024  # the kernel aligns its shared memory to 1,024 bytes


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


class Plan(NamedTuple):
    """How the bf16 kernel tiles one call: ``tm`` rows × ``tn`` columns a
    tile; a block per SM walks the row tiles of one ``tn``-column panel
    (``bpp`` blocks a panel, ``grid`` = bpp · n_panels), its ``n_wg``
    warpgroups taking alternate tiles, each with its own x stage and A
    tile.  W's panel is ``resident`` (all 2w+1 taps, loaded once per
    block) or streamed a tap at a time through one ``w_slot``-byte slot a
    warpgroup.  Shared memory, from a 1024-byte aligned base: W at 0, the
    x stages at ``x_off`` (``x_bytes`` each; 0 where even one stage does
    not fit beside W and the A tile, and the converter then reads x from
    device memory), the bf16 A tiles at ``a_off`` (``a_bytes`` each), the
    mbarriers at ``bar_off``; ``smem`` bytes in all, the alignment slack
    included."""
    tm: int
    tn: int
    n_wg: int
    resident: bool
    bpp: int
    n_panels: int
    grid: int
    w_slot: int
    x_off: int
    x_bytes: int
    a_off: int
    a_bytes: int
    bar_off: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(t: int, d_in: int, d_out: int, w: int, sms: int = SMS_H100) -> Plan:
    """The bf16 kernel's tile plan for x (t, d_in) → (t, d_out) with a
    2w+1-tap window on ``sms`` SMs; raises ValueError for a shape the
    kernel does not take.  Panels of 128 columns where there are tiles
    enough for two warpgroups a block, else 64; W resident before
    streamed, two warpgroups before one: the first that fits a block's
    shared memory, with x staged in it before x read from device memory
    (the only way HiFi-GAN V1's first upsampler, D_in 512, fits)."""
    if d_in <= 0 or d_in % 64:
        raise ValueError(f"folded_matmul: D_in {d_in} must be a positive "
                         "multiple of 64")
    if d_out <= 0 or d_out % 16:
        raise ValueError(f"folded_matmul: D_out {d_out} must be a positive "
                         "multiple of 16")
    if w < 0:
        raise ValueError(f"folded_matmul: w {w} < 0")
    tn = next(n for n in (128, 64, 32, 16) if d_out % n == 0)
    if tn == 128 and -(-t // 64) * (d_out // 128) < 2 * sms:
        # too few tiles for two warpgroups a block: halve the panel (and
        # the W each block loads) to double them
        tn = 64
    tm = 64 if tn >= 64 else 128   # taller tiles for narrow panels
    rows = tm + 2 * w
    x_bytes = _align(rows * d_in * 4, 128)
    a_bytes = _align(rows * (d_in + APAD) * 2, 128)
    w_slot = _align(d_in * tn * 2, 1024)
    for x_bytes, resident, n_wg in ((x_bytes, True, 2), (x_bytes, True, 1),
                                    (x_bytes, False, 2), (x_bytes, False, 1),
                                    (0, False, 1)):
        w_bytes = (_align((2 * w + 1) * d_in * tn * 2, 1024) if resident
                   else n_wg * w_slot)
        bar_off = w_bytes + n_wg * (x_bytes + a_bytes)
        smem = bar_off + 8 * (n_wg + 1) + ALIGN_SLACK
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"folded_matmul: D_in {d_in} with w {w} needs more "
                         "shared memory than a block has")
    n_panels = d_out // tn
    n_tiles = -(-t // tm)
    bpp = max(1, min(n_tiles, sms // n_panels))
    return Plan(tm, tn, n_wg, resident, bpp, n_panels, bpp * n_panels,
                w_slot, w_bytes, x_bytes, w_bytes + n_wg * x_bytes, a_bytes,
                bar_off, smem)


class F32Plan(NamedTuple):
    """How the float32 kernel tiles one call: a block of two warpgroups
    covers ``tile_rows`` rows × ``tn`` columns of one of ``n_panels``
    panels (``grid`` blocks).  For ``tn`` = 128 each warpgroup takes 64
    columns over all the rows; a narrower panel (padded to wgmma's 64) is
    taken by both warpgroups over the two halves of the rows.  ``nc``
    64-row chunks a warpgroup.  Shared memory holds the split x tile with
    its halo, a hi copy at 0 and a lo copy at ``lo_off``, each in chunks
    of 4 channels of ``r_alloc`` rows (16 bytes a row; ``r_alloc`` odd, so
    the staging stores meet distinct banks); the output tile, rows tn + 4
    floats apart, passes through the same memory after the products;
    ``smem`` bytes in all."""
    tn: int
    nc: int
    tile_rows: int
    n_panels: int
    grid: int
    r_alloc: int
    lo_off: int
    smem: int


@functools.lru_cache(maxsize=256)
def f32_plan(t: int, d_in: int, d_out: int, w: int,
             sms: int = SMS_H100) -> F32Plan:
    """The float32 kernel's tile plan for x (t, d_in) → (t, d_out) with a
    2w+1-tap window on ``sms`` SMs; raises ValueError for a shape the
    kernel does not take.  Two 64-row chunks a warpgroup where that still
    gives a block to every SM, else one; the first that fits a block's
    shared memory."""
    if d_in <= 0 or d_in % 32:
        raise ValueError(f"folded_matmul: D_in {d_in} must be a positive "
                         "multiple of 32")
    if d_out <= 0 or d_out % 16:
        raise ValueError(f"folded_matmul: D_out {d_out} must be a positive "
                         "multiple of 16")
    if w < 0:
        raise ValueError(f"folded_matmul: w {w} < 0")
    tn = next(n for n in (128, 64, 32, 16) if d_out % n == 0)
    n_panels = d_out // tn
    fits = []
    for nc in (2, 1):
        tile_rows = 64 * nc * (1 if tn == 128 else 2)
        r_alloc = (tile_rows + 2 * w) | 1
        lo_off = _align(d_in // 4 * r_alloc * 16, 128)
        smem = max(2 * lo_off, tile_rows * (tn + 4) * 4)
        if smem <= SMEM_LIMIT:
            grid = -(-t // tile_rows) * n_panels
            fits.append(F32Plan(tn, nc, tile_rows, n_panels, grid, r_alloc,
                                lo_off, smem))
    if not fits:
        raise ValueError(f"folded_matmul: D_in {d_in} with w {w} needs more "
                         "shared memory than a block has")
    return next((pl for pl in fits if pl.grid >= sms), fits[-1])


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "folded_matmul_bf16_launch": (
        [_P] * 7 + [_I] * 5 + [_F, _I, _F] + [_I] * 13 + [_P], _I),
    "folded_matmul_f32_launch": (
        [_P] * 7 + [_I] * 5 + [_F, _I, _F] + [_I] * 6 + [_P], _I),
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
    variant); b float32; D_out a multiple of 16, D_in of 64 (bf16) or 32
    (float32)."""
    if x.device.type == "cpu":
        return folded_matmul_plain(x, W, b, w, valid, residual, accum,
                                   out_scale, pre_lrelu, lrelu_slope)
    if x.device.type != "cuda":
        raise ValueError(f"folded_matmul: unsupported device {x.device}")
    t, d_in = x.shape
    n_win = 2 * w + 1
    d_out = W.shape[1]
    dev = x.device
    if W.dtype not in DTYPES:
        raise ValueError(f"folded_matmul: W is {W.dtype}, not one of "
                         f"{DTYPES}")
    f32 = W.dtype == torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = (f32_plan if f32 else plan)(t, d_in, d_out, w, sms)
    build.check_tensor("x", x, torch.float32, (t, d_in), dev)
    build.check_tensor("W", W, W.dtype, (n_win * d_in, d_out), dev)
    build.check_tensor("b", b, torch.float32, (d_out,), dev)
    build.check_valid("folded_matmul", valid, dev)
    for name, r in (("residual", residual), ("accum", accum)):
        if r is not None:
            build.check_tensor(name, r, torch.float32, (t, d_out), dev)
    lib = _lib()
    out = torch.empty((t, d_out), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), W.data_ptr(), b.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if accum is None else accum.data_ptr(),
            out.data_ptr(), valid.data_ptr(), t, d_in, d_out, w,
            int(pre_lrelu), float(lrelu_slope), int(out_scale is not None),
            float(out_scale if out_scale is not None else 1.0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if f32:
            err = lib.folded_matmul_f32_launch(
                *args, pl.tn, pl.nc, pl.tile_rows, pl.r_alloc, pl.lo_off,
                pl.smem, stream)
        else:
            err = lib.folded_matmul_bf16_launch(
                *args, pl.tm, pl.tn, pl.n_wg, int(pl.resident), pl.bpp,
                pl.n_panels, pl.w_slot, pl.x_off, pl.x_bytes, pl.a_off,
                pl.a_bytes, pl.bar_off, pl.smem, stream)
    build.check(lib, err, "folded_matmul")
    launches[W.dtype] += 1
    return out
