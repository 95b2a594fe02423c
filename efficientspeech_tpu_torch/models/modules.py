"""Primitive modules with the JAX package's layer semantics, in PyTorch.

- Linear/Conv hold torch-layout weights (the weight bridge in
  ``weights.py`` transposes the flax (in, out) / (k, in/groups, out)
  kernels); native init uses torch's default uniform ±1/√fan_in bounds,
- LayerNorm takes its statistics in float32 with eps 1e-5,
- GELU is the exact (erf) form,
- Embedding zeroes the padding row 0 whatever is stored there.

Activations are (B, T, C) channels-last at every public function, as in
the JAX package; convs transpose to torch's (B, C, T) only around
``F.conv1d`` / ``F.conv_transpose1d``.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class Linear(nn.Module):
    """torch.nn.Linear over the last dim; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)

    def reset_parameters(self, gen: torch.Generator):
        fan_in = self.weight.shape[1]
        _uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            _uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv1d(nn.Module):
    """torch.nn.Conv1d on (B, T, C); weight (out, in/groups, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        _uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            _uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        y = F.conv1d(x.to(self.weight.dtype).transpose(1, 2), self.weight,
                     self.bias, stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class Conv2d(nn.Module):
    """torch.nn.Conv2d on NCHW (B, C, H, W); weight (out, in, kh, kw).  The
    one module here that is not channels-last: the period discriminators
    (``hifigan_disc.py``) run on torch's layout, and the weight bridge
    maps the JAX package's (kh, kw, in, out) kernels to it."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), bias: bool = True):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, *tuple(kernel_size)))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        fan_in = self.weight[0].numel()
        _uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            _uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        return F.conv2d(x.to(self.weight.dtype), self.weight, self.bias,
                        stride=self.stride, padding=self.padding)


class ConvTranspose1d(nn.Module):
    """torch.nn.ConvTranspose1d on (B, T, C); weight (in, out, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        # torch's fan_in for a transposed conv is out_channels * k
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        _uniform_(self.weight, fan_in, gen)
        if self.bias is not None:
            _uniform_(self.bias, fan_in, gen)

    def forward(self, x):
        y = F.conv_transpose1d(x.to(self.weight.dtype).transpose(1, 2),
                               self.weight, self.bias, stride=self.stride,
                               padding=self.padding)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim; float32 statistics, eps 1e-5; the
    output keeps the input's dtype.  Under ``compute_params`` its scale
    and bias stay float32, as the JAX module keeps them."""

    takes_f32_params = True

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class Embedding(nn.Module):
    """torch.nn.Embedding with padding_idx=0: row 0 reads as zeros.  The
    gather reads the table as it is and casts to ``dtype``; under
    ``compute_params`` the table stays float32, so its gradient is summed
    in float32, as the JAX module's is."""

    takes_f32_params = True

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=gen)

    def forward(self, ids, dtype: torch.dtype):
        y = self.weight[ids].to(dtype)
        return torch.where((ids != 0)[..., None], y, torch.zeros_like(y))


def reset_parameters(module: nn.Module, seed: int):
    """Native random init of ``module`` from one CPU ``torch.Generator``,
    in registration order.  Every module that holds parameters of its
    own defines ``reset_parameters(gen)`` for exactly those."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)


def compute_params(model: nn.Module, dtype: torch.dtype
                   ) -> Dict[str, torch.Tensor]:
    """The parameters a forward in ``dtype`` runs on, for
    ``torch.func.functional_call``: every float32 master cast to
    ``dtype``, except those of a module that sets ``takes_f32_params``
    (LayerNorm, the embedding tables, and the fused decoder block's
    convs), which pass as they are.  This is the JAX package's per-module
    casting: Linear and conv kernels cast to the compute dtype, LayerNorm
    applies float32 scale and bias, embeddings gather from the float32
    table and cast.  The casts are on the autograd tape, so the masters
    receive float32 gradients."""
    out = {}
    for prefix, module in model.named_modules():
        keep = getattr(module, "takes_f32_params", False)
        for name, p in module.named_parameters(recurse=False):
            key = f"{prefix}.{name}" if prefix else name
            out[key] = p if keep or p.dtype == dtype else p.to(dtype)
    return out


def cast_params_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model``'s parameters in place by ``compute_params``'s rule,
    for serving: Linear and conv weights to ``dtype``, LayerNorm and
    embedding parameters left float32, as the JAX modules keep them."""
    with torch.no_grad():
        for name, t in compute_params(model, dtype).items():
            model.get_parameter(name).data = t
    return model


def gelu_exact(x):
    """torch nn.GELU default: the exact erf form."""
    return F.gelu(x, approximate="none")


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, x * negative_slope)


def masked_fill(x: torch.Tensor, mask: Optional[torch.Tensor], value=0.0):
    """x.masked_fill(mask, value); mask True marks positions to overwrite
    and may have fewer trailing dims than x (broadcast on channels)."""
    if mask is None:
        return x
    while mask.dim() < x.dim():
        mask = mask[..., None]
    return x.masked_fill(mask, value)
