"""Mel spectrogram decoder: depthwise-separable conv blocks over
frame-rate features (counterpart of the JAX package's
``models/mel_decoder.py``).

Two kernel routes, as in the JAX package, with the same parameters:
``fused_norm`` takes the frame-rate LayerNorms through kernel K3, and
``fused_block`` takes each block-body iteration (mask, depthwise conv,
pointwise conv, tanh, LayerNorm) through kernel K4; with both, K3 runs
``proj_norm`` and each ``block{b}_skip_norm``.  The kernels take float32
parameters and cast inside, so the fused block's convs set
``takes_f32_params`` (see ``modules.compute_params``)."""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.modules import (
    Conv1d, LayerNorm, Linear, masked_fill)
from efficientspeech_tpu_torch.ops.kernels.decoder_block import (
    decoder_block_fused)
from efficientspeech_tpu_torch.ops.kernels.layer_norm import layer_norm_fused


class MelDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig, fused_norm: bool = False,
                 fused_block: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fused_norm = fused_norm
        self.fused_block = fused_block
        dim = cfg.filter_dim
        dim_x2 = min(4 * dim, 256)
        k = cfg.decoder_kernel_size
        self.proj_linear = Linear(4 * dim, dim_x2)
        self.proj_norm = LayerNorm(dim_x2)
        for b in range(cfg.n_blocks):
            for d in range(cfg.block_depth):
                dw = Conv1d(dim_x2, dim_x2, k, padding=k // 2, groups=dim_x2)
                pw = Conv1d(dim_x2, dim_x2, 1)
                dw.takes_f32_params = pw.takes_f32_params = fused_block
                self.add_module(f"block{b}_conv{d}_dw", dw)
                self.add_module(f"block{b}_conv{d}_pw", pw)
                self.add_module(f"block{b}_norm{d}", LayerNorm(dim_x2))
            self.add_module(f"block{b}_skip_norm", LayerNorm(dim_x2))
        self.mel_linear = Linear(dim_x2, cfg.n_mel_channels)

    def _norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        norm = getattr(self, name)
        if self.fused_norm:
            return layer_norm_fused(x, norm.weight, norm.bias, norm.eps)
        return norm(x)

    def forward(self, features: torch.Tensor,
                frame_pad_mask: Optional[torch.Tensor] = None):
        """features (B, M, 4*dim) frame-rate; frame_pad_mask (B, M) True =
        pad.  The padded frame tail is re-zeroed before every depthwise
        conv (the biased projection and LayerNorm revive it, and the k=5
        window would leak it into the last valid frames)."""
        cfg = self.cfg
        skip = self._norm("proj_norm", torch.tanh(self.proj_linear(features)))
        if self.fused_block:
            keep = (torch.ones(skip.shape[:2], device=skip.device)
                    if frame_pad_mask is None
                    else 1.0 - frame_pad_mask.float())
        for b in range(cfg.n_blocks):
            x = skip
            for d in range(cfg.block_depth):
                dw = getattr(self, f"block{b}_conv{d}_dw")
                pw = getattr(self, f"block{b}_conv{d}_pw")
                if self.fused_block:
                    norm = getattr(self, f"block{b}_norm{d}")
                    x = decoder_block_fused(
                        x, keep, dw.weight, dw.bias, pw.weight, pw.bias,
                        norm.weight, norm.bias, norm.eps)
                    continue
                x = masked_fill(x, frame_pad_mask)
                x = self._norm(f"block{b}_norm{d}", torch.tanh(pw(dw(x))))
            skip = self._norm(f"block{b}_skip_norm", x + skip)
        return self.mel_linear(skip)
