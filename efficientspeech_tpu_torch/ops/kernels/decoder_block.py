"""One mel-decoder block body with a recomputing backward: the CUDA kernel
K4 (``csrc/decoder_block.cu``, forward and backward) and its plain
PyTorch version.

    xm = x · keep                               (in x's dtype)
    u  = Σ_tap xm[m + tap − 2] · dw[tap] + dw_b  (k = 5, summed in x's dtype)
    v  = (u @ W, float32 accumulation) → x's dtype, + pw_b
    y  = LayerNorm(tanh(v); float32 statistics) · ln_s + ln_b

The backward recomputes u and t = tanh(v) from x and returns dx (masked
by keep) and the gradients of the six weights, summed from float32
partials; the gradient with respect to keep is zero.  The weights are the
float32 parameters of the decoder's modules, in their PyTorch layouts:
dw_w (C, 1, k) of the depthwise Conv1d, pw_w (C, C, 1) of the pointwise
one, and the LayerNorm's (C,) scale and bias; each is cast inside, so
their gradients come back float32.  A CPU tensor takes the plain version
(any width, any dtype); a CUDA tensor launches the kernel, built for
C = 128 and 256 in bf16 and in float32, or raises.
"""

import ctypes
from typing import Dict, FrozenSet, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from efficientspeech_tpu_torch.ops.kernels import build

# the decoder widths and dtypes the CUDA kernel is built for: the list in
# csrc/decoder_block.cu's with_variant
WIDTHS = (128, 256)
DTYPES = (torch.bfloat16, torch.float32)
VARIANTS = tuple((c, dt) for c in WIDTHS for dt in DTYPES)

# kernel launches by (width, dtype) since the counts were last set to 0
launches_fwd = dict.fromkeys(VARIANTS, 0)
launches_bwd = dict.fromkeys(VARIANTS, 0)

TAPS = 5                # the depthwise conv's k (csrc: K)
SMEM_LIMIT = 232448     # dynamic shared memory of a block (csrc: SMEM_LIMIT)
SM_SMEM = 233472        # shared memory of an SM (csrc: SM_SMEM)
BF16_TILE = 64 * 64 * 2  # a bf16 operand tile's bytes (csrc: GeoH::TILE)
F32_FWD_THREADS = 256   # two warpgroups (csrc: GeoF::NT)
F32_BWD_THREADS = 256   # two warpgroups (csrc: GeoB::NT)
BF16_BWD_THREADS = 256  # two warpgroups (csrc: GeoH::NT)


class BF16FwdPlan(NamedTuple):
    """How the bf16 forward tiles a decoder of width C (csrc: GeoHF, in
    this field order): ``tile_rows`` rows a tile (wgmma's M), every one
    its own; ``blocks_per_sm`` blocks of ``warpgroups`` warpgroups (one
    per 64 columns) an SM.  Byte offsets from the 1024-byte aligned base:
    W's (C/64)² 64 × 64 bf16 tiles (8 KB, the 128-byte swizzle) at 0, u's
    C/64 tiles at ``u_off`` (over which y is staged for its TMA stores,
    a tile a warpgroup), the x rows' C/64 TMA boxes of 64 channels
    (``x_box`` bytes each) at ``x_off``, which take the block's next
    tile's rows while this tile's product and row pass run; the rows'
    mean and sum of squared deviations over each 64-column slot at
    ``st_off``, two tiles' keep values of the x rows at ``kp_off``, the
    weight vectors at ``par_off``, the x rows' mbarrier at ``bar_off``;
    ``smem`` bytes from the base."""
    tile_rows: int
    blocks_per_sm: int
    warpgroups: int
    u_off: int
    x_off: int
    x_box: int
    st_off: int
    kp_off: int
    par_off: int
    bar_off: int
    smem: int


def bf16_fwd_plan(c: int) -> BF16FwdPlan:
    """The bf16 forward's plan at width ``c`` (one of ``WIDTHS``).  A
    block holds all of W: 70 KB at C = 128, so three blocks share an SM,
    and 203 KB at C = 256, one; each reserves 1 KB more to align its base
    and the SM 1 KB a block."""
    if c not in WIDTHS:
        raise ValueError(f"decoder_block: no bf16 forward plan for "
                         f"C = {c}; built for {WIDTHS}")
    r, nch = 64, c // 64
    xrows = r + TAPS - 1
    u_off = nch * nch * BF16_TILE
    x_off = u_off + nch * BF16_TILE
    x_box = xrows * 128
    st_off = x_off + nch * x_box
    kp_off = st_off + nch * r * 8
    par_off = kp_off + 2 * -(-xrows // 4) * 16
    bar_off = par_off + (TAPS + 1) * c * 2 + 3 * c * 4
    smem = bar_off + 8
    return BF16FwdPlan(r, SM_SMEM // (smem + 2048), nch, u_off, x_off,
                       x_box, st_off, kp_off, par_off, bar_off, smem)


# the bf16 forward's phases in a tile's order
BF16_FWD_PHASES = ("wait_x", "u", "v", "row_sums", "y")


def bf16_fwd_buffers(c: int) -> Dict[str, Tuple[int, int, FrozenSet[str]]]:
    """The bf16 forward's shared-memory buffers at width ``c``: name →
    (byte offset, bytes, the phases in which it is live)."""
    pl = bf16_fwd_plan(c)
    nch = c // 64
    live = lambda *names: frozenset(names)
    every = live(*BF16_FWD_PHASES)
    return {
        "W tiles": (0, pl.u_off, every),
        "u": (pl.u_off, nch * BF16_TILE, live("u", "v")),
        # y staged for its TMA stores, read out before the next tile's u
        "y": (pl.u_off, nch * BF16_TILE, live("y", "wait_x")),
        "x rows": (pl.x_off, nch * pl.x_box, live("wait_x", "u")),
        "next tile's x rows": (pl.x_off, nch * pl.x_box,
                               live("v", "row_sums", "y")),
        "row sums": (pl.st_off, pl.kp_off - pl.st_off, live("row_sums", "y")),
        "keep of x rows": (pl.kp_off, pl.par_off - pl.kp_off, every),
        "weight vectors": (pl.par_off, pl.bar_off - pl.par_off, every),
        "mbarrier": (pl.bar_off, pl.smem - pl.bar_off, every),
    }


class F32FwdPlan(NamedTuple):
    """How the float32 forward tiles a decoder of width C (csrc: GeoF, in
    this field order): ``tile_rows`` rows of u a tile (wgmma's N), every
    one its own; ``blocks_per_sm`` blocks of ``warpgroups`` warpgroups an
    SM; the split buffer of u in chunks of 4 channels × ``r_alloc`` rows
    of 16 bytes, hi at 0 and lo at ``lo_off``, over which v's float32 rows
    go, ``ld_v`` floats apart, once the products are done; the x rows
    (``ld_x`` floats apart) at ``x_off``, which take the block's next
    tile's rows while this tile's products and row pass run; the keep
    values of two tiles' x rows at ``kp_off``; the depthwise taps and bias
    at ``par_off``; ``smem`` bytes in all."""
    tile_rows: int
    blocks_per_sm: int
    warpgroups: int
    r_alloc: int
    lo_off: int
    ld_v: int
    x_off: int
    ld_x: int
    kp_off: int
    par_off: int
    smem: int


def f32_fwd_plan(c: int) -> F32FwdPlan:
    """The float32 forward's plan at width ``c`` (one of ``WIDTHS``).
    Tiles of 64 rows: 104 KB at C = 128, so two blocks share an SM, and
    206 KB at C = 256, one.  A chunk is R + 1 rows, 16 bytes past a
    multiple of 128, so the depthwise's stores, a lane a chunk, meet 32
    banks; v's rows are 4 banks apart, so its stores, rows 2 apart, do
    too."""
    if c not in WIDTHS:
        raise ValueError(f"decoder_block: no float32 forward plan for "
                         f"C = {c}; built for {WIDTHS}")
    r = 64
    xrows = r + TAPS - 1
    r_alloc = r + 1
    lo_off = c // 4 * r_alloc * 16
    x_off = 2 * lo_off
    ld_v = ld_x = c + 4
    kp_off = x_off + xrows * ld_x * 4
    par_off = kp_off + 2 * -(-xrows // 4) * 16
    smem = par_off + (TAPS + 1) * c * 4
    return F32FwdPlan(r, SM_SMEM // (smem + 1024), F32_FWD_THREADS // 128,
                      r_alloc, lo_off, ld_v, x_off, ld_x, kp_off, par_off,
                      smem)


# the float32 forward's phases in a tile's order
F32_FWD_PHASES = ("load_x", "u", "v", "store_v", "rows")


def f32_fwd_buffers(c: int) -> Dict[str, Tuple[int, int, FrozenSet[str]]]:
    """The float32 forward's shared-memory buffers at width ``c``: name →
    (byte offset, bytes, the phases in which it is live)."""
    pl = f32_fwd_plan(c)
    rows_x = (pl.tile_rows + TAPS - 1) * pl.ld_x * 4
    live = lambda *names: frozenset(names)
    every = live(*F32_FWD_PHASES)
    return {
        "u hi": (0, pl.lo_off, live("u", "v")),
        "u lo": (pl.lo_off, pl.lo_off, live("u", "v")),
        "v": (0, pl.tile_rows * pl.ld_v * 4, live("store_v", "rows")),
        "x rows": (pl.x_off, rows_x, live("load_x", "u")),
        "next tile's x rows": (pl.x_off, rows_x, live("v", "store_v",
                                                      "rows")),
        "keep of x's rows": (pl.kp_off, pl.par_off - pl.kp_off, every),
        "depthwise taps and bias": (pl.par_off, (TAPS + 1) * c * 4, every),
    }


class F32BwdPlan(NamedTuple):
    """How the float32 backward tiles a decoder of width C (csrc: GeoB, in
    this field order): ``tile_rows`` rows of u a tile (wgmma's N), of which
    the inner ``owned_rows`` are its own; ``warpgroups`` a block; the split
    buffer of u, later dv, in chunks of 4 channels × ``r_alloc`` rows of 16
    bytes, hi at 0 and lo at ``lo_off``; the float32 rows (v, dv, du) at
    ``v_off``, ``ld_v`` floats apart, over which x's rows (``ld_x`` floats
    apart) are loaded for u; the keep values of those rows of this tile
    and of the block's next one at ``kp_off``; the
    weight vectors the passes read (the depthwise taps and bias, the
    pointwise bias, the LayerNorm scale) at ``par_off``; ``smem`` bytes in
    all."""
    tile_rows: int
    owned_rows: int
    warpgroups: int
    r_alloc: int
    lo_off: int
    v_off: int
    ld_v: int
    ld_x: int
    kp_off: int
    par_off: int
    smem: int


def f32_bwd_plan(c: int) -> F32BwdPlan:
    """The float32 backward's plan at width ``c`` (one of ``WIDTHS``).
    Tiles of 16,384 / C rows fill shared memory: 128 at C = 128, 64 at
    C = 256.  A chunk is R + 4 rows, 64 bytes past a multiple of 128, so
    the weight gradient's fragment loads meet 32 banks."""
    if c not in WIDTHS:
        raise ValueError(f"decoder_block: no float32 backward plan for "
                         f"C = {c}; built for {WIDTHS}")
    r = 16384 // c
    r_alloc = r + 4
    lo_off = c // 4 * r_alloc * 16
    v_off = 2 * lo_off
    ld_v, ld_x = c + 8, c + 4
    kp_off = v_off + max(r * ld_v * 4, (r + TAPS - 1) * ld_x * 4)
    par_off = kp_off + 2 * -(-(r + TAPS - 1) // 4) * 16
    smem = par_off + (TAPS + 3) * c * 4
    return F32BwdPlan(r, r - (TAPS - 1), F32_BWD_THREADS // 128, r_alloc,
                      lo_off, v_off, ld_v, ld_x, kp_off, par_off, smem)


# the float32 backward's phases in a tile's order, then the final sums
F32_BWD_PHASES = ("load_x", "u", "v", "dv", "weight_grad", "split_dv", "du",
                  "reload_x", "dx", "reduce")


def f32_bwd_buffers(c: int) -> Dict[str, Tuple[int, int, FrozenSet[str]]]:
    """The float32 backward's shared-memory buffers at width ``c``: name →
    (byte offset, bytes, the phases in which it is live)."""
    pl = f32_bwd_plan(c)
    half = pl.lo_off
    rows_v = pl.tile_rows * pl.ld_v * 4
    rows_x = (pl.tile_rows + TAPS - 1) * pl.ld_x * 4
    groups = F32_BWD_THREADS // c
    red = ((TAPS + 1) * groups + 3 * F32_BWD_THREADS // 32) * c * 4
    live = lambda *names: frozenset(names)
    u = live("u", "v", "dv", "weight_grad")
    tile = live(*F32_BWD_PHASES[:-1])
    return {
        "x rows for u": (pl.v_off, rows_x, live("load_x", "u")),
        "u hi": (0, half, u),
        "u lo": (pl.lo_off, half, u),
        "v, then dv": (pl.v_off, rows_v,
                       live("v", "dv", "weight_grad", "split_dv")),
        "dv hi": (0, half, live("split_dv", "du")),
        "dv lo": (pl.lo_off, half, live("split_dv", "du")),
        "du": (pl.v_off, rows_v, live("du", "reload_x", "dx")),
        "x rows for dx": (0, rows_x, live("reload_x", "dx")),
        "keep of x's rows": (pl.kp_off, pl.par_off - pl.kp_off, tile),
        "weight vectors": (pl.par_off, (TAPS + 3) * c * 4, tile),
        "sums": (0, red, live("reduce")),
    }


def f32_bwd_partial_index(c: int, device=None) -> torch.Tensor:
    """Where the float32 backward's weight-gradient partial keeps each
    value (csrc: weight_grad): the flat position i·C + o of W's (C_in,
    C_out) layout of every element, in the partial's order.  A warp's
    64 × 32 block q (i from 64·(q // (C/32)), o from 32·(q % (C/32)))
    holds 4 × 4 mma tiles (mt, nt), each 32 lanes (g, t) = (l // 4, l % 4)
    of 4 values e: i + 16 mt + g + 8 (e // 2), o + 8 nt + 2 t + e % 2."""
    q = torch.arange(c * c // 2048, device=device).view(-1, 1, 1, 1, 1)
    mt = torch.arange(4, device=device).view(1, 4, 1, 1, 1)
    nt = torch.arange(4, device=device).view(1, 1, 4, 1, 1)
    lane = torch.arange(32, device=device).view(1, 1, 1, 32, 1)
    e = torch.arange(4, device=device).view(1, 1, 1, 1, 4)
    i = 64 * (q // (c // 32)) + 16 * mt + lane // 4 + 8 * (e // 2)
    o = 32 * (q % (c // 32)) + 8 * nt + 2 * (lane % 4) + e % 2
    return (i * c + o).reshape(-1)


_partial_index: Dict[Tuple[int, str], torch.Tensor] = {}


class BF16BwdPlan(NamedTuple):
    """How the bf16 backward tiles a decoder of width C (csrc: GeoH, in
    this field order): ``tile_rows`` rows of u a tile (wgmma's M), of
    which the inner ``owned_rows`` are its own; ``warpgroups`` a block;
    ``cluster`` blocks a tile, one per 128 columns.  Byte offsets from the
    1024-byte aligned base: W's ``w_tiles`` 64 × 64 bf16 tiles (8 KB, the
    128-byte swizzle) at 0, u's C/64 tiles at ``u_off`` and dv's at
    ``dv_off``, over which du's float32 rows (``ld_du`` apart) go once
    the products are done; three slots of ``slot`` bytes from
    ``slot_off`` that take, in turn, a tile's x rows of the block's 128
    channels (two TMA boxes of 64 channels, ``x_box`` bytes each), its
    dy rows (two 64 × 64 tiles like u's) and t (rows ``ld_t`` bf16
    apart), so the next tile's x and dy land while this tile's x is
    read; the rows' LayerNorm sums and statistics at ``st_off``, the
    column sums of the vector gradients at ``cs_off``, two tiles' keep
    values of the x rows at ``kp_off``, the weight vectors at
    ``par_off``, four mbarriers (the tile's rows landed; the other
    block's u, row sums and dv arrived) at ``bar_off``; ``smem`` bytes
    from the base."""
    tile_rows: int
    owned_rows: int
    warpgroups: int
    cluster: int
    w_tiles: int
    u_off: int
    dv_off: int
    ld_du: int
    slot_off: int
    slot: int
    x_box: int
    ld_t: int
    st_off: int
    cs_off: int
    kp_off: int
    par_off: int
    bar_off: int
    smem: int




def bf16_bwd_plan(c: int) -> BF16BwdPlan:
    """The bf16 backward's plan at width ``c`` (one of ``WIDTHS``).  A
    block owns 128 columns, so a tile is spread over a cluster of C / 128
    blocks; it holds W's tiles of its output columns (v = u W) and of its
    input channels (du = dv W^T): 4·C/64 − 4 of the C²/4096.  The t rows
    are 272 bytes apart, so the row pass's stores meet 32 banks."""
    if c not in WIDTHS:
        raise ValueError(f"decoder_block: no bf16 backward plan for "
                         f"C = {c}; built for {WIDTHS}")
    r, nch, split = 64, c // 64, c // 128
    xrows = r + TAPS - 1
    w_tiles = 4 * nch - 4
    u_off = w_tiles * BF16_TILE
    dv_off = u_off + nch * BF16_TILE
    x_box = xrows * 64 * 2
    slot = 2 * x_box
    slot_off = dv_off + nch * BF16_TILE
    st_off = slot_off + 3 * slot
    cs_off = st_off + 20 * r * 4
    kp_off = cs_off + 4 * 3 * 128 * 4
    par_off = kp_off + 2 * -(-xrows // 4) * 16
    bar_off = par_off + (TAPS + 1) * 128 * 2 + 2 * 128 * 4
    return BF16BwdPlan(r, r - (TAPS - 1), BF16_BWD_THREADS // 128, split,
                       w_tiles, u_off, dv_off, 128, slot_off, slot, x_box,
                       136, st_off, cs_off, kp_off, par_off, bar_off,
                       bar_off + 4 * 8)


# the bf16 backward's phases in a tile's order, then the final sums
BF16_BWD_PHASES = ("load", "u", "send_u", "v", "row_sums", "dv", "products",
                   "dx", "reduce")


def bf16_bwd_buffers(c: int) -> Dict[str, Tuple[int, int, FrozenSet[str]]]:
    """The bf16 backward's shared-memory buffers at width ``c``: name →
    (byte offset, bytes, the phases in which it is live).  Each slot is
    live in every phase of a tile: it holds this tile's x, dy or t, or the
    next tile's x or dy landing."""
    pl = bf16_bwd_plan(c)
    r, tiles = pl.tile_rows, c // 64 * BF16_TILE
    live = lambda *names: frozenset(names)
    tile = live(*BF16_BWD_PHASES[:-1])
    bufs = {
        "W tiles": (0, pl.w_tiles * BF16_TILE, tile),
        "u": (pl.u_off, tiles, live("u", "send_u", "v", "row_sums", "dv",
                                    "products")),
        "dv": (pl.dv_off, tiles, live("dv", "products")),
        "du": (pl.u_off, r * pl.ld_du * 4, live("dx")),
        "row sums and statistics": (pl.st_off, pl.cs_off - pl.st_off,
                                    live("row_sums", "dv")),
        "column sums": (pl.cs_off, pl.kp_off - pl.cs_off,
                        live(*BF16_BWD_PHASES)),
        "keep of x rows": (pl.kp_off, pl.par_off - pl.kp_off, tile),
        "weight vectors": (pl.par_off, pl.bar_off - pl.par_off, tile),
        "mbarriers": (pl.bar_off, pl.smem - pl.bar_off,
                      live(*BF16_BWD_PHASES)),
        "sums": (pl.slot_off, 4 * (TAPS + 1) * 128 * 4, live("reduce")),
    }
    for i in range(3):
        bufs[f"slot {i}"] = (pl.slot_off + i * pl.slot, pl.slot, tile)
    return bufs


def a_fragments(w: torch.Tensor) -> torch.Tensor:
    """A (C x C, row-major: k rows, c columns) in the order the float32
    kernels' products load it as wgmma's A (csrc: product_block): for
    each 64-column m-block m, warp q (16 columns), k-step s (8 rows) and
    lane 4 g + t, the four values (8 s + t, c), (8 s + t, c + 1),
    (8 s + t + 4, c), (8 s + t + 4, c + 1), c = 64 m + 16 q + 2 g."""
    c = w.shape[0]
    return (w.reshape(c // 8, 2, 4, c // 64, 4, 8, 2)
            .permute(3, 4, 0, 5, 2, 1, 6).contiguous())


def owned_tiles(m: int, owned: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each tile of a sequence of ``m`` frames, as a
    backward kernel walks them: tile j owns rows [j·owned, (j+1)·owned)
    cut to [0, m)."""
    return [(m0, min(owned, m - m0)) for m0 in range(0, m, owned)]


def _recompute_to_t(x, keep, dww, dwb, w_io, pwb):
    """The JAX ``_recompute_to_t``, op for op, in x's dtype: returns the
    padded masked input, u and t.  dww (k, C) and w_io (C_in, C_out) are
    float32."""
    dt = x.dtype
    k, m = dww.shape[0], x.shape[1]
    xm = (x.float() * keep[..., None]).to(dt)
    xp = F.pad(xm, (0, 0, k // 2, k // 2))
    acc = None
    for tap in range(k):
        term = xp[:, tap:tap + m] * dww[tap].to(dt)
        acc = term if acc is None else acc + term
    u = acc + dwb.to(dt)
    v = torch.matmul(u.float(), w_io.to(dt).float()).to(dt) + pwb.to(dt)
    return xp, u, torch.tanh(v)


def _pack(dw_w, pw_w):
    """PyTorch conv layouts → dww (k, C) and W (C_in, C_out)."""
    return dw_w[:, 0, :].t(), pw_w[:, :, 0].t()


def decoder_block_fwd_plain(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                            eps: float = 1e-5) -> torch.Tensor:
    """The forward kernel's function (the JAX ``_fwd_kernel``)."""
    dww, w_io = _pack(dw_w, pw_w)
    _, _, t = _recompute_to_t(x, keep, dww, dw_b, w_io, pw_b)
    tf = t.float()
    mean = tf.mean(dim=-1, keepdim=True)
    cen = tf - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    y = cen * torch.rsqrt(var + eps)
    return (y * ln_s.float() + ln_b.float()).to(x.dtype)


def decoder_block_bwd_plain(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, dy,
                            eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's function (the JAX ``_bwd_kernel``): →
    (dx, d_dw_w, d_dw_b, d_pw_w, d_pw_b, d_ln_s, d_ln_b), the weight
    gradients float32 in the parameters' layouts."""
    dt = x.dtype
    k, c = dw_w.shape[2], x.shape[2]
    m = x.shape[1]
    dww, w_io = _pack(dw_w, pw_w)
    xp, u, t = _recompute_to_t(x, keep, dww, dw_b, w_io, pw_b)
    tf = t.float()
    mean = tf.mean(dim=-1, keepdim=True)
    cen = tf - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    that = cen * rstd
    dyf = dy.float()
    g = dyf * ln_s.float()
    gm = g.mean(dim=-1, keepdim=True)
    gxm = (g * that).mean(dim=-1, keepdim=True)
    dv = rstd * (g - gm - that * gxm) * (1.0 - tf * tf)
    dvc = dv.to(dt).float()
    du = torch.matmul(dvc, w_io.to(dt).float().t())
    d_w_io = torch.matmul(u.reshape(-1, c).float().t(), dvc.reshape(-1, c))
    d_dww = torch.stack([(xp[:, tap:tap + m].float() * du).sum((0, 1))
                         for tap in range(k)])
    dup = F.pad(du, (0, 0, k // 2, k // 2))
    acc = None
    for sh in range(k):
        term = dup[:, sh:sh + m] * dww[k - 1 - sh].float()
        acc = term if acc is None else acc + term
    dx = (acc * keep[..., None]).to(dt)
    return (dx, d_dww.t()[:, None, :], du.sum((0, 1)), d_w_io.t()[:, :, None],
            dv.sum((0, 1)), (dyf * that).sum((0, 1)), dyf.sum((0, 1)))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "decoder_block_fwd_launch": ([_P] * 9 + [_I] * 4 + [_F, _I, _P], _I),
    "decoder_block_bwd_launch": ([_P] * 12 + [_I] * 4 + [_F, _I, _P], _I),
    "decoder_block_taps": ([], _I),
    "decoder_block_f32_fwd_plan": ([_I, _I], _I),
    "decoder_block_f32_bwd_plan": ([_I, _I], _I),
    "decoder_block_bf16_bwd_plan": ([_I, _I], _I),
    "decoder_block_bf16_fwd_plan": ([_I, _I], _I),
    "decoder_block_bwd_clusters": ([_I], _I),
}


_plans_checked = set()
_bwd_clusters: Dict[int, int] = {}


def _lib():
    return build.load("decoder_block", _SIGNATURES)


def check_f32_fwd_plan(lib, c: int):
    """Raise unless the library's float32 forward (csrc: GeoF) has the
    plan ``f32_fwd_plan`` gives: the two are kept in step by hand."""
    if (c, "f32 fwd") in _plans_checked:
        return
    want = f32_fwd_plan(c)
    got = tuple(lib.decoder_block_f32_fwd_plan(c, i)
                for i in range(len(want)))
    if got != tuple(want):
        raise RuntimeError(f"decoder_block: the kernel's float32 forward "
                           f"plan at C = {c} is {got}, f32_fwd_plan says "
                           f"{tuple(want)}")
    _plans_checked.add((c, "f32 fwd"))


def check_bf16_fwd_plan(lib, c: int):
    """Raise unless the library's bf16 forward (csrc: GeoHF) has the plan
    ``bf16_fwd_plan`` gives: the two are kept in step by hand."""
    if (c, "bf16 fwd") in _plans_checked:
        return
    want = bf16_fwd_plan(c)
    got = tuple(lib.decoder_block_bf16_fwd_plan(c, i)
                for i in range(len(want)))
    if got != tuple(want):
        raise RuntimeError(f"decoder_block: the kernel's bf16 forward "
                           f"plan at C = {c} is {got}, bf16_fwd_plan says "
                           f"{tuple(want)}")
    _plans_checked.add((c, "bf16 fwd"))


def check_f32_bwd_plan(lib, c: int):
    """Raise unless the library's float32 backward (csrc: GeoB) has the
    plan ``f32_bwd_plan`` gives: the two are kept in step by hand."""
    if c in _plans_checked:
        return
    want = f32_bwd_plan(c)
    got = tuple(lib.decoder_block_f32_bwd_plan(c, i)
                for i in range(len(want)))
    if got != tuple(want):
        raise RuntimeError(f"decoder_block: the kernel's float32 backward "
                           f"plan at C = {c} is {got}, f32_bwd_plan says "
                           f"{tuple(want)}")
    _plans_checked.add(c)


def check_bf16_bwd_plan(lib, c: int):
    """Raise unless the library's bf16 backward (csrc: GeoH) has the plan
    ``bf16_bwd_plan`` gives: the two are kept in step by hand."""
    if (c, "bf16") in _plans_checked:
        return
    want = bf16_bwd_plan(c)
    got = tuple(lib.decoder_block_bf16_bwd_plan(c, i)
                for i in range(len(want)))
    if got != tuple(want):
        raise RuntimeError(f"decoder_block: the kernel's bf16 backward "
                           f"plan at C = {c} is {got}, bf16_bwd_plan says "
                           f"{tuple(want)}")
    _plans_checked.add((c, "bf16"))


def check_supported(channels: int, dtype: torch.dtype):
    """Raise unless the CUDA kernel covers a decoder of width ``channels``
    in ``dtype``: it is built for the widths in ``WIDTHS``, each in bf16
    and float32."""
    if (channels, dtype) not in VARIANTS:
        raise NotImplementedError(
            f"decoder_block kernel: built for C in {WIDTHS} in bf16 and "
            f"float32, not C = {channels} in {dtype}; this decoder cannot "
            "run on the card")


def _kernel_args(lib, x, keep, dw_w, dw_b, pw_w, pw_b, ln_s):
    """Check the operands and pack the weights as the kernels take them:
    W (C_in, C_out) in x's dtype, dww (k, C) float32."""
    b, m, c = x.shape
    k = lib.decoder_block_taps()
    dev = x.device
    check_supported(c, x.dtype)
    build.check_tensor("x", x, x.dtype, (b, m, c), dev)
    build.check_tensor("keep", keep, torch.float32, (b, m), dev)
    for name, t, shape in (("dw_w", dw_w, (c, 1, k)), ("dw_b", dw_b, (c,)),
                           ("pw_w", pw_w, (c, c, 1)), ("pw_b", pw_b, (c,)),
                           ("ln_s", ln_s, (c,))):
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape) != shape:
            raise ValueError(f"decoder_block kernel: {name} must be float32 "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dww, w_io = _pack(dw_w, pw_w)
    return (w_io.to(x.dtype).contiguous(), dww.contiguous(),
            dw_b.contiguous(), pw_b.contiguous(), ln_s.contiguous())


def _grid(lib, b: int, m: int, c: int, f32: int, backward: bool,
          dev) -> int:
    """Persistent grids: the forward fills every SM with as many blocks as
    fit on one; the backward puts one block on each SM, at most one a
    tile: float32 one block a tile, bf16 a cluster of ``_split`` blocks
    (one per 128 columns), as many clusters as the card runs at once.
    Tile rows and blocks an SM are the plans'."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if not backward:
        plan = f32_fwd_plan(c) if f32 else bf16_fwd_plan(c)
        tiles = b * len(owned_tiles(m, plan.tile_rows))
        return max(1, min(tiles, plan.blocks_per_sm * sms))
    plan = f32_bwd_plan(c) if f32 else bf16_bwd_plan(c)
    tiles = b * len(owned_tiles(m, plan.owned_rows))
    if f32:
        return max(1, min(tiles, sms))
    if c not in _bwd_clusters:
        with torch.cuda.device(dev):
            _bwd_clusters[c] = lib.decoder_block_bwd_clusters(c)
        if _bwd_clusters[c] < 1:
            raise RuntimeError(f"decoder_block: no cluster of the bf16 "
                               f"backward fits the card at C = {c}")
    return _split(c, f32) * min(tiles, _bwd_clusters[c])


def _split(c: int, f32: int) -> int:
    """Backward blocks that share a tile: bf16 a cluster, one block per
    128 columns; float32 one."""
    return 1 if f32 else bf16_bwd_plan(c).cluster


def decoder_block_fwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                      eps: float = 1e-5, *, grid: Optional[int] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, M, C), keep (B, M) float32 → y (B, M, C).  On CUDA: x bf16 or
    float32 and C in ``WIDTHS``.  ``grid``: the persistent grid's blocks
    (by default as many as fit on the card, at most one a tile); ``out``:
    where y is written (by default a new tensor), on the card a contiguous
    tensor that does not overlap x."""
    if x.device.type == "cpu":
        y = decoder_block_fwd_plain(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s,
                                    ln_b, eps)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_block: unsupported device {x.device}")
    lib = _lib()
    w_io, dww, dwb, pwb, lns = _kernel_args(lib, x, keep, dw_w, dw_b, pw_w,
                                            pw_b, ln_s)
    build.check_tensor("ln_b", ln_b, torch.float32, (x.shape[2],), x.device)
    b, m, c = x.shape
    f32 = int(x.dtype == torch.float32)
    if f32:  # the float32 product reads W in wgmma's A-fragment order
        check_f32_fwd_plan(lib, c)
        w_io = a_fragments(w_io)
    else:
        check_bf16_fwd_plan(lib, c)
    if grid is None:
        grid = _grid(lib, b, m, c, f32, False, x.device)
    y = torch.empty_like(x) if out is None else out
    build.check_tensor("out", y, x.dtype, (b, m, c), x.device)
    # the kernel reads x's rows by TMA (a tile's halo rows too) while it
    # stores y's tiles: y over x would race
    nbytes = x.numel() * x.element_size()
    if abs(y.data_ptr() - x.data_ptr()) < nbytes:
        raise ValueError("decoder_block: out must not overlap x")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.decoder_block_fwd_launch(
            x.data_ptr(), keep.data_ptr(), w_io.data_ptr(), dww.data_ptr(),
            dwb.data_ptr(), pwb.data_ptr(), lns.data_ptr(), ln_b.data_ptr(),
            y.data_ptr(), b, m, c, f32, float(eps), grid, stream)
    build.check(lib, err, "decoder_block forward")
    launches_fwd[c, x.dtype] += 1
    return y


def decoder_block_bwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, dy,
                      eps: float = 1e-5, *, grid: Optional[int] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """→ (dx, d_dw_w, d_dw_b, d_pw_w, d_pw_b, d_ln_s, d_ln_b); the kernel
    writes one float32 partial of each weight gradient per block (bf16:
    per cluster), summed here.  ``grid``: the persistent grid's blocks (a
    multiple of the split; by default one block an SM, at most one
    block or cluster a tile)."""
    if x.device.type == "cpu":
        return decoder_block_bwd_plain(x, keep, dw_w, dw_b, pw_w, pw_b,
                                       ln_s, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_block: unsupported device {x.device}")
    lib = _lib()
    w_io, dww, dwb, pwb, lns = _kernel_args(lib, x, keep, dw_w, dw_b, pw_w,
                                            pw_b, ln_s)
    b, m, c = x.shape
    dev = x.device
    f32 = int(x.dtype == torch.float32)
    build.check_tensor("dy", dy, x.dtype, (b, m, c), dev)
    # the float32 products read W (v = u W) and W^T (C_out, C_in: pw_w's
    # own layout; du = dv W^T) in wgmma's A-fragment order
    w_t = None
    if f32:
        check_f32_bwd_plan(lib, c)
        w_io, w_t = a_fragments(w_io), a_fragments(pw_w[:, :, 0])
    else:
        check_bf16_bwd_plan(lib, c)
    k = dw_w.shape[2]
    if grid is None:
        grid = _grid(lib, b, m, c, f32, True, dev)
    groups = grid // _split(c, f32)
    dx = torch.empty_like(x)
    part_pw = torch.empty((groups, c, c), dtype=torch.float32, device=dev)
    part_vec = torch.empty((groups, k + 4, c), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decoder_block_bwd_launch(
            x.data_ptr(), keep.data_ptr(), w_io.data_ptr(),
            None if w_t is None else w_t.data_ptr(), dww.data_ptr(),
            dwb.data_ptr(), pwb.data_ptr(), lns.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), part_pw.data_ptr(), part_vec.data_ptr(), b, m, c,
            f32, float(eps), grid, stream)
    build.check(lib, err, "decoder_block backward")
    launches_bwd[c, x.dtype] += 1
    d_w_io = part_pw.sum(0)
    if f32:  # the float32 kernel's partials are in its accumulators' order
        key = (c, str(dev))
        if key not in _partial_index:
            _partial_index[key] = f32_bwd_partial_index(c, dev)
        d_w_io = torch.empty_like(d_w_io).view(-1).index_put_(
            (_partial_index[key],), d_w_io.view(-1)).view(c, c)
    vec = part_vec.sum(0)
    return (dx, vec[:k].t()[:, None, :].contiguous(), vec[k],
            d_w_io.t()[:, :, None].contiguous(), vec[k + 1], vec[k + 2],
            vec[k + 3])


class _DecoderBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b, eps):
        x = x.contiguous()
        keep = keep.float().contiguous()
        ctx.save_for_backward(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s)
        ctx.eps = eps
        return decoder_block_fwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                                 eps)

    @staticmethod
    def backward(ctx, dy):
        x, keep, dw_w, dw_b, pw_w, pw_b, ln_s = ctx.saved_tensors
        dx, *grads = decoder_block_bwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s,
                                       dy.contiguous(), ctx.eps)
        return (dx, None, *grads, None)


def decoder_block_fused(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                        eps: float = 1e-5) -> torch.Tensor:
    """masked_fill → depthwise conv (k) → pointwise conv → tanh →
    LayerNorm over x (B, M, C), with the kernels forward and backward.
    ``keep`` (B, M) is 1.0 on valid frames and 0.0 on padding."""
    return _DecoderBlock.apply(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                               eps)
