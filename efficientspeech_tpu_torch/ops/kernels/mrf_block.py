"""One vocoder stage's whole MRF block: the CUDA kernel K2
(``csrc/mrf_block.cu``), its plain PyTorch version, and the spec that
stacks the stage's folded convs.

For each resblock j (a chain of (conv1, conv2) pairs):

    v = x;  v = mask(conv2(lrelu(mask(conv1(lrelu(v))))) + v)  per pair
    out = mask(Σ_j v / num_kernels)

with every conv output masked to rows [0, valid).  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.  The kernel
has two variants, chosen by W_all's dtype: bf16 (bf16 products, float32
sums; its tiling is decided here, by ``bf16_plan``) and float32 (3xTF32
split products on the tensor cores, held to float32; tiled by
``f32_plan``).  Stages are 128 wide, and the bf16 variant also takes 256
(``mrf_kernel_wide``, HiFi-GAN V1's first stage); ``WIDTHS`` lists the
widths each variant is built for.
"""

import ctypes
import functools
from typing import (Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from efficientspeech_tpu_torch.ops.kernels import build
from efficientspeech_tpu_torch.ops.kernels.folded_matmul import (
    ALIGN_SLACK, leaky, mask_rows, window)
from efficientspeech_tpu_torch.utils import spans

LRELU_SLOPE = 0.1
D = 128
WIDE_D = 256

# the weight dtypes the kernel is built for, and the stage widths of each
DTYPES = (torch.bfloat16, torch.float32)
WIDTHS = {torch.bfloat16: (D, WIDE_D), torch.float32: (D,)}


def supports(d: int, dtype: torch.dtype) -> bool:
    """Whether a kernel variant takes a stage ``d`` wide with W_all in
    ``dtype``."""
    return d in WIDTHS.get(dtype, ())

# kernel launches by W_all's dtype since the counts were last set to 0
launches = dict.fromkeys(DTYPES, 0)

# chains[j] = [(w, n_win, w_row_offset, b_index), ...] in execution order
Chains = List[List[Tuple[int, int, int, int]]]


def build_mrf_spec(arrays: Dict, widths: Dict, stage: int,
                   dilation_sizes: Sequence[Sequence[int]]
                   ) -> Tuple[Chains, torch.Tensor, torch.Tensor, int]:
    """Stack one stage's folded convs (c1_0, c2_0, c1_1, ... per resblock)
    into (chains, W_all rows-concatenated, b_all (n_ops, D), H = the
    largest per-chain sum of window half-widths)."""
    chains, w_parts, b_parts = [], [], []
    row_off = 0
    for j, rd in enumerate(dilation_sizes):
        chain = []
        for m in range(len(rd)):
            for cname in ("c1", "c2"):
                key = f"rb{stage}_{j}_{cname}_{m}"
                W, b = arrays[key]
                w = widths[key]
                chain.append((w, 2 * w + 1, row_off, len(b_parts)))
                w_parts.append(W)
                b_parts.append(b.reshape(1, -1))
                row_off += W.shape[0]
        chains.append(chain)
    H = max(sum(op[0] for op in chain) for chain in chains)
    return chains, torch.cat(w_parts), torch.cat(b_parts), H


def mrf_fused_plain(x: torch.Tensor, chains: Chains, W_all: torch.Tensor,
                    b_all: torch.Tensor, H: int,
                    valid: Union[int, torch.Tensor], num_kernels: int,
                    tm: Optional[int] = None,
                    lrelu_slope: float = LRELU_SLOPE) -> torch.Tensor:
    """The kernel's function in plain PyTorch, float32 products, op by op
    over the whole sequence (``H`` and ``tm`` only shape the kernel's
    tiling)."""
    W_all = W_all.to(x.dtype).float()
    b_all = b_all.to(x.dtype).float()

    def conv(src, op):
        w, n_win, off, bi = op
        y = window(leaky(src, lrelu_slope), w).float()
        return y @ W_all[off: off + n_win * src.shape[1]] + b_all[bi]

    x = mask_rows(x, valid)
    xs = None
    for chain in chains:
        v = x
        for m in range(0, len(chain), 2):
            t = mask_rows(conv(v, chain[m]), valid).to(x.dtype)
            v = mask_rows(conv(t, chain[m + 1]) + v.float(),
                          valid).to(x.dtype)
        xs = v.float() if xs is None else xs + v.float()
    return mask_rows(xs * (1.0 / num_kernels), valid).to(x.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mrf_launch": ([_P] * 5 + [_I] * 9 + [ctypes.POINTER(_I), _I, _F, _P],
                   _I),
    "mrf_f32_launch": ([_P] * 5 + [_I] * 7 + [ctypes.POINTER(_I), _I, _F,
                                              _P], _I),
    "mrf_wide_launch": ([_P] * 6 + [_I] * 9 + [ctypes.POINTER(_I), _I, _F,
                                               _P], _I),
}


def _lib():
    return build.load("mrf_block", _SIGNATURES)


SMEM_LIMIT = 227 * 1024
SMS_H100 = 132
F32_LDV = D + 4        # v's float32 stride (csrc: f32v::LDV)
F32_MAX_N = 176        # rows of one conv's output (csrc: f32v::MAX_N)


# a conv's k-step costs at least as much as F32_MIN_ROWS output rows: each
# step loads the op's 8 x 128 weights from L2, which the tensor cores' work
# on fewer rows does not cover (measured on the H100)
F32_MIN_ROWS = 64


class F32Plan(NamedTuple):
    """How the float32 kernel tiles one stage: ``tm`` rows a block (one
    block per tile); the activation buffer, split into a hi copy at 0 and
    a lo copy at ``lo_off``, in chunks of 4 channels of ``r_alloc`` rows
    (16 bytes a row; r_alloc = 1 mod 8); v, float32, (tm + 2H) rows of
    ``F32_LDV`` floats at ``v_off``; ``smem`` bytes in all.  ``cost``: a
    tile's k-steps weighted by their rows (each conv's rows rounded up to
    16, at least F32_MIN_ROWS), times the tiles a SM takes (at least
    one)."""
    tm: int
    r_alloc: int
    lo_off: int
    v_off: int
    smem: int
    cost: float


def _f32_layout(tm: int, H: int) -> Tuple[int, int, int, int]:
    r_alloc = tm + 2 * H + 15
    r_alloc += (1 - r_alloc) % 8
    lo_off = D // 4 * r_alloc * 16
    v_off = 2 * lo_off
    return r_alloc, lo_off, v_off, v_off + (tm + 2 * H) * F32_LDV * 4


@functools.lru_cache(maxsize=64)
def f32_plan(widths: Tuple[Tuple[int, ...], ...], t: int,
             tm: Optional[int] = None, sms: int = SMS_H100) -> F32Plan:
    """The float32 kernel's plan for a stage of T = ``t`` rows whose
    chains have the window half-widths ``widths`` (one tuple per chain, in
    execution order).  Without ``tm``, the tile height (a multiple of 16)
    that fits a block's shared memory and the kernel's conv rows at the
    least ``cost``: a tall tile reads each weight for more rows and
    recomputes less halo, a short one spreads a short stage over more
    SMs.  Raises ValueError where none fits."""
    H = max(sum(c) for c in widths)
    best = None
    for cand in ((tm,) if tm is not None else range(16, 257, 16)):
        r_alloc, lo_off, v_off, smem = _f32_layout(cand, H)
        if (cand % 16 or cand <= 0 or smem > SMEM_LIMIT
                or cand + 2 * H - 2 > F32_MAX_N):
            continue
        rows = 0
        for chain in widths:
            extent = cand + 2 * sum(chain)
            for w in chain:
                extent -= 2 * w
                rows += max(-(-extent // 16) * 16, F32_MIN_ROWS) * (2 * w + 1)
        cost = rows * max(-(-t // cand) / sms, 1.0)
        if best is None or cost < best.cost:
            best = F32Plan(cand, r_alloc, lo_off, v_off, smem, cost)
    if best is None:
        raise ValueError(f"mrf_fused: no float32 tile fits halo {H}"
                         + ("" if tm is None else f" at tm {tm}"))
    return best


def chain_widths(chains: Chains) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(op[0] for op in chain) for chain in chains)


BF16_MAX_N = 192          # rows of one conv's output (csrc: bf16v::MAX_N)
BF16_MAX_TM = 128         # rows of a tile (csrc: bf16v::MAX_TM): taller
                          # ones measured slower at every stage
SLICE_BYTES = D * D * 2   # one tap's W slice, a ring slot (csrc: bf16v::SLICE)
MAX_SLOTS = 4             # csrc: bf16v::MAX_SLOTS

# a tap costs its N output rows of products and, counted in rows of
# products, BF16_TAP_ROWS for its own work: waiting for its W slice,
# issuing, releasing the slot
BF16_TAP_ROWS = 64


# the wide kernel (d = WIDE_D; csrc: widev): a ring slice is a quarter of
# a tap, the same SLICE_BYTES; v lies in device memory
WIDE_MAX_N = 176          # csrc: widev::MAX_N
WIDE_MAX_TM = 80          # csrc: widev::MAX_TM


class BF16Plan(NamedTuple):
    """How the bf16 kernel tiles one stage: ``tm`` rows a tile (one block
    per tile; at d = 256 one block a SM walks every SMs-th tile).  Shared
    memory, from a 1024-byte aligned base: the weight ring's ``slots``
    slots of SLICE_BYTES at 0; the bf16 activation buffer at ``buf_off``,
    in chunks of 8 channels of ``r_alloc`` rows (16 bytes a row; r_alloc
    = 1 mod 8); v, float32, (tm + 2H) rows of 128 floats at ``v_off`` (at
    d = 256 v lies in device memory, and ``v_off`` = ``bar_off``); the
    slots' full and empty mbarriers at ``bar_off``; ``smem`` bytes in
    all, the alignment slack included.  ``chunks``: each conv's wgmma N
    (its output rows rounded up to 16), per chain in execution order.
    ``cost``: a tile's taps weighted by their N plus BF16_TAP_ROWS, times
    the waves of tiles over the SMs (one block a SM: a wave that is partly
    filled costs a whole one)."""
    tm: int
    slots: int
    r_alloc: int
    buf_off: int
    v_off: int
    bar_off: int
    smem: int
    chunks: Tuple[Tuple[int, ...], ...]
    cost: int


def bf16_chunks(widths: Tuple[Tuple[int, ...], ...],
                tm: int) -> Tuple[Tuple[int, ...], ...]:
    """Each conv's output rows at tile height ``tm``, rounded up to 16:
    the N of its one wgmma a k-step."""
    out = []
    for chain in widths:
        extent, ns = tm + 2 * sum(chain), []
        for w in chain:
            extent -= 2 * w
            ns.append(-(-extent // 16) * 16)
        out.append(tuple(ns))
    return tuple(out)


def _bf16_layout(tm: int, H: int, slots: int,
                 d: int = D) -> Tuple[int, ...]:
    r_alloc = tm + 2 * H + 15
    r_alloc += (1 - r_alloc) % 8
    buf_off = slots * SLICE_BYTES
    v_off = buf_off + d // 8 * r_alloc * 16
    bar_off = v_off + (tm + 2 * H) * D * 4 if d == D else v_off
    return (r_alloc, buf_off, v_off, bar_off,
            bar_off + 16 * slots + ALIGN_SLACK)


@functools.lru_cache(maxsize=64)
def bf16_plan(widths: Tuple[Tuple[int, ...], ...], t: int,
              tm: Optional[int] = None, sms: int = SMS_H100,
              d: int = D) -> BF16Plan:
    """The bf16 kernel's plan for a stage ``d`` wide (128, or 256 for the
    wide kernel) of T = ``t`` rows whose chains have the window
    half-widths ``widths`` (one tuple per chain, in execution order).
    Without ``tm``, the tile height (a multiple of 16, at most
    BF16_MAX_TM, or WIDE_MAX_TM at d = 256) whose convs fit one wgmma and
    whose buffers leave a block's shared memory room for two ring slots or
    more, at the least ``cost``: a tall tile reads each weight slice for
    more rows and recomputes less halo, a short one spreads a stage over
    the SMs in fewer or fuller waves; of equal costs, the one with more
    slots.  The ring takes as many slots as fit, up to MAX_SLOTS.  Raises
    ValueError where none fits."""
    if not supports(d, torch.bfloat16):
        raise ValueError(f"mrf_fused: no bf16 kernel at width {d}")
    max_tm, max_n = ((BF16_MAX_TM, BF16_MAX_N) if d == D
                     else (WIDE_MAX_TM, WIDE_MAX_N))
    H = max(sum(c) for c in widths)
    best = None
    for cand in (tm,) if tm is not None else range(16, max_tm + 1, 16):
        if cand % 16 or not 0 < cand <= max_tm:
            continue
        chunks = bf16_chunks(widths, cand)
        if max(max(c) for c in chunks) > max_n:
            continue
        fits = [s for s in range(MAX_SLOTS, 1, -1)
                if _bf16_layout(cand, H, s, d)[-1] <= SMEM_LIMIT]
        if not fits:
            continue
        rows = sum((2 * w + 1) * (n + BF16_TAP_ROWS)
                   for chain, ns in zip(widths, chunks)
                   for w, n in zip(chain, ns))
        cost = rows * -(-t // (cand * sms))
        if best is None or (cost, -fits[0]) < (best.cost, -best.slots):
            best = BF16Plan(cand, fits[0],
                            *_bf16_layout(cand, H, fits[0], d), chunks, cost)
    if best is None:
        raise ValueError(f"mrf_fused: no bf16 tile fits halo {H}"
                         + ("" if tm is None else f" at tm {tm}")
                         + ("" if d == D else f" at width {d}"))
    return best


def mrf_fused(x: torch.Tensor, chains: Chains, W_all: torch.Tensor,
              b_all: torch.Tensor, H: int, valid: Union[int, torch.Tensor],
              num_kernels: int, tm: Optional[int] = None,
              lrelu_slope: float = LRELU_SLOPE) -> torch.Tensor:
    """x (T, d) stage activations → (T, d) MRF output, d = 128 or 256
    (``WIDTHS``).  ``chains``, ``W_all``, ``b_all`` and ``H`` from
    ``build_mrf_spec``; ``valid`` in rows of this stage's grid, at most T
    (on CUDA a one-element int32 tensor on the card).

    On CUDA: x float32, W_all bf16 or float32 (the kernel's variant),
    b_all float32; ``tm`` defaults to the choice of the variant's plan
    (``bf16_plan`` or ``f32_plan``).  A width or dtype no variant is built
    for raises ValueError before any launch."""
    if x.device.type == "cpu":
        return mrf_fused_plain(x, chains, W_all, b_all, H, valid,
                               num_kernels, tm, lrelu_slope)
    t, d = x.shape
    if not supports(d, W_all.dtype):
        raise ValueError(
            f"mrf_fused: no kernel for a stage {d} wide with {W_all.dtype} "
            f"weights (built for: " + "; ".join(
                f"{dt} at {', '.join(map(str, ws))}"
                for dt, ws in WIDTHS.items()) + ")")
    if x.device.type != "cuda":
        raise ValueError(f"mrf_fused: unsupported device {x.device}")
    dev = x.device
    n_ops = sum(len(c) for c in chains)
    rows = chains[-1][-1][2] + chains[-1][-1][1] * d
    f32 = W_all.dtype == torch.float32
    build.check_tensor("x", x, torch.float32, (t, d), dev)
    build.check_tensor("W_all", W_all, W_all.dtype, (rows, d), dev)
    build.check_tensor("b_all", b_all, torch.float32, (n_ops, d), dev)
    build.check_valid("mrf_fused", valid, dev)
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = (f32_plan(chain_widths(chains), t, tm, sms) if f32 else
          bf16_plan(chain_widths(chains), t, tm, sms, d))
    spec = [len(chains)]
    for chain in chains:
        spec.append(len(chain))
        for w, _, off, bi in chain:
            spec += [w, off, bi]
    spec_arr = (_I * len(spec))(*spec)
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), W_all.data_ptr(), b_all.data_ptr(),
            out.data_ptr(), valid.data_ptr(), t, H)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if d == WIDE_D:
            # one block an SM, each with its v region in device memory
            grid = min(-(-t // pl.tm), sms)
            v_all = torch.empty((grid, pl.tm + 2 * H, d),
                                dtype=torch.float32, device=dev)
            err = lib.mrf_wide_launch(
                *args[:4], v_all.data_ptr(), *args[4:], pl.tm, pl.slots,
                pl.r_alloc, pl.buf_off, pl.bar_off, pl.smem, grid, spec_arr,
                num_kernels, float(lrelu_slope), stream)
        elif f32:
            err = lib.mrf_f32_launch(*args, pl.tm, pl.r_alloc, pl.lo_off,
                                     pl.v_off, pl.smem, spec_arr,
                                     num_kernels, float(lrelu_slope), stream)
        else:
            err = lib.mrf_launch(*args, pl.tm, pl.slots, pl.r_alloc,
                                 pl.buf_off, pl.v_off, pl.bar_off, pl.smem,
                                 spec_arr, num_kernels, float(lrelu_slope),
                                 stream)
    build.check(lib, err, "mrf_fused")
    launches[W_all.dtype] += 1
    if d == WIDE_D:
        spans.count("k2.wide_launches")
    return out
