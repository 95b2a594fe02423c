"""LayerNorm over the last dim with a recomputing backward: the CUDA kernel
K3 (``csrc/layer_norm.cu``, forward and backward) and its plain PyTorch
version.

    y  = (x − mean) · rstd · scale + bias,  rstd = 1/√(var + eps)
    dx = rstd · (g − mean(g) − x̂ · mean(g · x̂)),  g = dy · scale
    dscale = Σ dy · x̂,  dbias = Σ dy

Statistics are float32 and ``y``/``dx`` keep x's dtype; scale and bias are
the float32 parameters, and their gradients come back float32, summed
from per-block float32 partials.  The backward keeps nothing but x and
scale: it recomputes mean and rstd.  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""

import ctypes
from typing import Tuple

import torch

from efficientspeech_tpu_torch.ops.kernels import build

# the widths and dtypes the CUDA kernel is built for
WIDTHS = (128, 256)
DTYPES = (torch.bfloat16, torch.float32)
VARIANTS = tuple((c, dt) for c in WIDTHS for dt in DTYPES)

# kernel launches by (width, dtype) since the counts were last set to 0
launches_fwd = dict.fromkeys(VARIANTS, 0)
launches_bwd = dict.fromkeys(VARIANTS, 0)


def _stats(xf: torch.Tensor, eps: float):
    mean = xf.mean(dim=-1, keepdim=True)
    cen = xf - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    return cen, torch.rsqrt(var + eps)


def layer_norm_fwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """The forward kernel's function (the JAX ``_fwd_kernel``, op for
    op)."""
    cen, rstd = _stats(x.float(), eps)
    y = cen * rstd
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                         dy: torch.Tensor, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function (the JAX ``_bwd_kernel``): x, dy
    (rows, C) → (dx in x's dtype, dscale, dbias float32)."""
    cen, rstd = _stats(x.float(), eps)
    xhat = cen * rstd
    dyf = dy.float()
    g = dyf * scale.float()
    gm = g.mean(dim=-1, keepdim=True)
    gxm = (g * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (g - gm - xhat * gxm)
    return dx.to(x.dtype), (dyf * xhat).sum(0), dyf.sum(0)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "layer_norm_fwd_launch": ([_P] * 4 + [_I] * 3 + [_F, _I, _P], _I),
    "layer_norm_bwd_launch": ([_P] * 6 + [_I] * 3 + [_F, _I, _P], _I),
    "layer_norm_rows_per_block": ([], _I),
}


def _lib():
    return build.load("layer_norm", _SIGNATURES)


def _check(x2d: torch.Tensor, scale: torch.Tensor, bias=None, dy=None):
    rows, c = x2d.shape
    dev = x2d.device
    if c not in WIDTHS:
        raise ValueError(f"layer_norm kernel: C {c} not in {WIDTHS}")
    if x2d.dtype not in DTYPES:
        raise ValueError(f"layer_norm kernel: dtype {x2d.dtype} is neither "
                         "bf16 nor float32")
    build.check_tensor("x", x2d, x2d.dtype, (rows, c), dev)
    build.check_tensor("scale", scale, torch.float32, (c,), dev)
    if bias is not None:
        build.check_tensor("bias", bias, torch.float32, (c,), dev)
    if dy is not None:
        build.check_tensor("dy", dy, x2d.dtype, (rows, c), dev)


def layer_norm_fwd(x2d: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (rows, C) → y (rows, C).  On CUDA: x bf16 or float32, C 128 or
    256, scale and bias float32."""
    if x2d.device.type == "cpu":
        return layer_norm_fwd_plain(x2d, scale, bias, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x2d.device}")
    _check(x2d, scale, bias=bias)
    rows, c = x2d.shape
    lib = _lib()
    y = torch.empty_like(x2d)
    per_block = lib.layer_norm_rows_per_block()
    grid = max(1, -(-rows // per_block))
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.layer_norm_fwd_launch(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, c, int(x2d.dtype == torch.bfloat16), float(eps), grid,
            stream)
    build.check(lib, err, "layer_norm forward")
    launches_fwd[c, x2d.dtype] += 1
    return y


def layer_norm_bwd(x2d: torch.Tensor, scale: torch.Tensor,
                   dy2d: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, scale, dy) → (dx, dscale, dbias); the kernel writes one float32
    partial row per block, summed here."""
    if x2d.device.type == "cpu":
        return layer_norm_bwd_plain(x2d, scale, dy2d, eps)
    if x2d.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x2d.device}")
    _check(x2d, scale, dy=dy2d)
    rows, c = x2d.shape
    lib = _lib()
    dev = x2d.device
    # four blocks of 8 warps per SM stride over the rows
    grid = max(1, min(-(-rows // lib.layer_norm_rows_per_block()),
                      4 * torch.cuda.get_device_properties(
                          dev).multi_processor_count))
    dx = torch.empty_like(x2d)
    parts = torch.empty((2, grid, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.layer_norm_bwd_launch(
            x2d.data_ptr(), scale.data_ptr(), dy2d.data_ptr(), dx.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), rows, c,
            int(x2d.dtype == torch.bfloat16), float(eps), grid, stream)
    build.check(lib, err, "layer_norm backward")
    launches_bwd[c, x2d.dtype] += 1
    ds, db = parts.sum(dim=1)
    return dx, ds, db


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1]).contiguous()
        ctx.save_for_backward(x2d, scale)
        ctx.eps = eps
        return layer_norm_fwd(x2d, scale, bias, eps).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, scale = ctx.saved_tensors
        dx, ds, db = layer_norm_bwd(
            x2d, scale, dy.reshape(x2d.shape).contiguous(), ctx.eps)
        return dx.reshape(dy.shape), ds, db, None


def layer_norm_fused(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of ``x`` (any leading shape), with the
    kernels forward and backward.  ``scale`` and ``bias`` are the float32
    parameters: their gradients come back float32."""
    return _LayerNorm.apply(x, scale, bias, eps)
