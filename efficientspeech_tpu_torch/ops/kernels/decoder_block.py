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
from typing import Tuple

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
    "decoder_block_tile_rows": ([_I, _I, _I], _I),
    "decoder_block_fwd_blocks_per_sm": ([_I, _I], _I),
    "decoder_block_split": ([_I, _I], _I),
    "decoder_block_taps": ([], _I),
}


def _lib():
    return build.load("decoder_block", _SIGNATURES)


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
    fit on one; the backward puts one block on each SM, in groups of
    ``split`` blocks that share a tile (bf16: one per 128 columns; float32:
    one)."""
    tiles = b * -(-m // lib.decoder_block_tile_rows(c, int(backward), f32))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if not backward:
        return max(1, min(tiles,
                          lib.decoder_block_fwd_blocks_per_sm(c, f32) * sms))
    split = lib.decoder_block_split(c, f32)
    return split * max(1, min(tiles, sms // split))


def decoder_block_fwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                      eps: float = 1e-5) -> torch.Tensor:
    """x (B, M, C), keep (B, M) float32 → y (B, M, C).  On CUDA: x bf16 or
    float32 and C in ``WIDTHS``."""
    if x.device.type == "cpu":
        return decoder_block_fwd_plain(x, keep, dw_w, dw_b, pw_w, pw_b,
                                       ln_s, ln_b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_block: unsupported device {x.device}")
    lib = _lib()
    w_io, dww, dwb, pwb, lns = _kernel_args(lib, x, keep, dw_w, dw_b, pw_w,
                                            pw_b, ln_s)
    build.check_tensor("ln_b", ln_b, torch.float32, (x.shape[2],), x.device)
    b, m, c = x.shape
    f32 = int(x.dtype == torch.float32)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.decoder_block_fwd_launch(
            x.data_ptr(), keep.data_ptr(), w_io.data_ptr(), dww.data_ptr(),
            dwb.data_ptr(), pwb.data_ptr(), lns.data_ptr(), ln_b.data_ptr(),
            y.data_ptr(), b, m, c, f32, float(eps),
            _grid(lib, b, m, c, f32, False, x.device), stream)
    build.check(lib, err, "decoder_block forward")
    launches_fwd[c, x.dtype] += 1
    return y


def decoder_block_bwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, dy,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """→ (dx, d_dw_w, d_dw_b, d_pw_w, d_pw_b, d_ln_s, d_ln_b); the kernel
    writes one float32 partial of each weight gradient per block group,
    summed here."""
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
    # the float32 du = dv W^T streams W^T (C_out, C_in): pw_w's own layout
    w_t = pw_w[:, :, 0].contiguous() if f32 else None
    k = dw_w.shape[2]
    grid = _grid(lib, b, m, c, f32, True, dev)
    groups = grid // lib.decoder_block_split(c, f32)
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
