"""HiFi-GAN generator (vocoder), mel → waveform, as plain convolutions.

It holds the vocoder's parameters (the folded path in
``hifigan_folded.py`` is built from them) and is the independent conv
reference the folded path is tested against.  Static-shape masking: the
generator runs on the padded mel with a per-sample valid length, and
after every conv the invalid tail is re-zeroed, so the valid region
equals an unpadded run, which sees implicit zeros at its edge.
"""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.modules import (
    Conv1d, ConvTranspose1d, leaky_relu)

LRELU_SLOPE = 0.1


def _mask_tail(x: torch.Tensor, valid_len: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Zero positions at or beyond ``valid_len`` (B,) per sample."""
    if valid_len is None:
        return x
    pos = torch.arange(x.shape[1], device=x.device)
    keep = pos[None, :] < valid_len[:, None]
    return torch.where(keep[:, :, None], x, torch.zeros_like(x))


class ResBlock1(nn.Module):
    """MRF residual block: 3 dilated + plain conv pairs."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations=(1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        k = kernel_size
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv1_{i}", Conv1d(
                channels, channels, k, padding=(k * d - d) // 2, dilation=d))
            self.add_module(f"conv2_{i}", Conv1d(
                channels, channels, k, padding=(k - 1) // 2))

    def forward(self, x, valid_len=None):
        for i in range(len(self.dilations)):
            xt = getattr(self, f"conv1_{i}")(leaky_relu(x, LRELU_SLOPE))
            xt = _mask_tail(xt, valid_len)
            xt = getattr(self, f"conv2_{i}")(leaky_relu(xt, LRELU_SLOPE))
            x = _mask_tail(xt, valid_len) + x
        return x


class ResBlock2(nn.Module):
    """Lighter MRF block: one dilated conv per dilation."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations=(1, 3)):
        super().__init__()
        self.dilations = tuple(dilations)
        k = kernel_size
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv_{i}", Conv1d(
                channels, channels, k, padding=(k * d - d) // 2, dilation=d))

    def forward(self, x, valid_len=None):
        for i in range(len(self.dilations)):
            xt = getattr(self, f"conv_{i}")(leaky_relu(x, LRELU_SLOPE))
            x = _mask_tail(xt, valid_len) + x
        return x


class HifiGanGenerator(nn.Module):
    def __init__(self, cfg: HifiGanConfig):
        super().__init__()
        self.cfg = cfg
        res_cls = ResBlock1 if cfg.resblock == "1" else ResBlock2
        c0 = cfg.upsample_initial_channel
        self.conv_pre = Conv1d(cfg.num_mels, c0, 7, padding=3)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.add_module(f"up{i}", ConvTranspose1d(
                c0 // (2 ** i), ch, k, stride=u, padding=(k - u) // 2))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                             cfg.resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}",
                                res_cls(ch, rk, tuple(rd)))
        ch_last = c0 // (2 ** len(cfg.upsample_rates))
        self.conv_post = Conv1d(ch_last, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor,
                valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T, num_mels) → wav (B, T * total_upsample); positions at
        or beyond ``valid_len`` (B,) frames stay exactly zero through the
        stack."""
        cfg = self.cfg
        num_kernels = len(cfg.resblock_kernel_sizes)
        x = _mask_tail(self.conv_pre(mel), valid_len)
        cur_valid = valid_len
        for i, u in enumerate(cfg.upsample_rates):
            x = getattr(self, f"up{i}")(leaky_relu(x, LRELU_SLOPE))
            if cur_valid is not None:
                cur_valid = cur_valid * u
            x = _mask_tail(x, cur_valid)
            xs = None
            for j in range(num_kernels):
                r = getattr(self, f"resblock_{i}_{j}")(x, cur_valid)
                xs = r if xs is None else xs + r
            x = xs / num_kernels
        # the final activation uses torch's default slope 0.01
        x = self.conv_post(leaky_relu(x, 0.01))
        x = torch.tanh(_mask_tail(x, cur_valid))
        return x[..., 0]
