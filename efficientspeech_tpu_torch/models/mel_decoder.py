"""Mel spectrogram decoder: depthwise-separable conv blocks over
frame-rate features (counterpart of the JAX package's unfused
``models/mel_decoder.py``)."""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.modules import (
    Conv1d, LayerNorm, Linear, masked_fill)


class MelDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.filter_dim
        dim_x2 = min(4 * dim, 256)
        k = cfg.decoder_kernel_size
        self.proj_linear = Linear(4 * dim, dim_x2)
        self.proj_norm = LayerNorm(dim_x2)
        for b in range(cfg.n_blocks):
            for d in range(cfg.block_depth):
                self.add_module(f"block{b}_conv{d}_dw", Conv1d(
                    dim_x2, dim_x2, k, padding=k // 2, groups=dim_x2))
                self.add_module(f"block{b}_conv{d}_pw",
                                Conv1d(dim_x2, dim_x2, 1))
                self.add_module(f"block{b}_norm{d}", LayerNorm(dim_x2))
            self.add_module(f"block{b}_skip_norm", LayerNorm(dim_x2))
        self.mel_linear = Linear(dim_x2, cfg.n_mel_channels)

    def forward(self, features: torch.Tensor,
                frame_pad_mask: Optional[torch.Tensor] = None):
        """features (B, M, 4*dim) frame-rate; frame_pad_mask (B, M) True =
        pad.  The padded frame tail is re-zeroed before every depthwise
        conv (the biased projection and LayerNorm revive it, and the k=5
        window would leak it into the last valid frames)."""
        cfg = self.cfg
        skip = self.proj_norm(torch.tanh(self.proj_linear(features)))
        for b in range(cfg.n_blocks):
            x = skip
            for d in range(cfg.block_depth):
                x = masked_fill(x, frame_pad_mask)
                x = getattr(self, f"block{b}_conv{d}_dw")(x)
                x = getattr(self, f"block{b}_conv{d}_pw")(x)
                x = getattr(self, f"block{b}_norm{d}")(torch.tanh(x))
            skip = getattr(self, f"block{b}_skip_norm")(x + skip)
        return self.mel_linear(skip)
