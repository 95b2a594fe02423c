"""HiFi-GAN generator (vocoder), mel → waveform, as plain convolutions.

It holds the vocoder's parameters (the folded path in
``hifigan_folded.py`` is built from them) and is the independent conv
reference the folded path is tested against, and the vocoder of the
chunked serving mode (``chunked_vocoder_call``).  Static-shape masking:
the generator runs on the padded mel with a per-sample valid window
[valid_start, valid_len), and after every conv the positions outside it
are re-zeroed, so the valid region equals an unpadded run, which sees
implicit zeros at its edges.
"""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.modules import (
    Conv1d, ConvTranspose1d, leaky_relu)

LRELU_SLOPE = 0.1


def _mask_tail(x: torch.Tensor, valid_len: Optional[torch.Tensor],
               valid_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero positions outside [valid_start, valid_len) (each (B,) or None)
    per sample.  ``valid_start`` stands for virtual frames before the
    signal (the left halo of a leading chunk): an unpadded run sees
    implicit zeros there at every conv, so they are re-zeroed at every
    layer too (a biased conv would revive them)."""
    if valid_len is None and valid_start is None:
        return x
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    keep = None
    if valid_len is not None:
        keep = pos < valid_len[:, None]
    if valid_start is not None:
        ge = pos >= valid_start[:, None]
        keep = ge if keep is None else keep & ge
    # masked_fill, not where(keep, x, zeros_like(x)): the same values,
    # and a traced graph (ONNX) holds no zero tensor of x's size
    return x.masked_fill(~keep[:, :, None], 0.0)


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

    def forward(self, x, valid_len=None, valid_start=None):
        for i in range(len(self.dilations)):
            xt = getattr(self, f"conv1_{i}")(leaky_relu(x, LRELU_SLOPE))
            xt = _mask_tail(xt, valid_len, valid_start)
            xt = getattr(self, f"conv2_{i}")(leaky_relu(xt, LRELU_SLOPE))
            x = _mask_tail(xt, valid_len, valid_start) + x
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

    def forward(self, x, valid_len=None, valid_start=None):
        for i in range(len(self.dilations)):
            xt = getattr(self, f"conv_{i}")(leaky_relu(x, LRELU_SLOPE))
            x = _mask_tail(xt, valid_len, valid_start) + x
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
                valid_len: Optional[torch.Tensor] = None,
                valid_start: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T, num_mels) → wav (B, T * total_upsample); positions
        outside [valid_start, valid_len) (each (B,) frames, or None) stay
        exactly zero through the stack."""
        cfg = self.cfg
        num_kernels = len(cfg.resblock_kernel_sizes)
        cur_valid, cur_start = valid_len, valid_start
        x = _mask_tail(self.conv_pre(mel), cur_valid, cur_start)
        for i, u in enumerate(cfg.upsample_rates):
            x = getattr(self, f"up{i}")(leaky_relu(x, LRELU_SLOPE))
            if cur_valid is not None:
                cur_valid = cur_valid * u
            if cur_start is not None:
                cur_start = cur_start * u
            x = _mask_tail(x, cur_valid, cur_start)
            xs = None
            for j in range(num_kernels):
                r = getattr(self, f"resblock_{i}_{j}")(x, cur_valid,
                                                       cur_start)
                xs = r if xs is None else xs + r
            x = xs / num_kernels
        # the final activation uses torch's default slope 0.01
        x = self.conv_post(leaky_relu(x, 0.01))
        x = torch.tanh(_mask_tail(x, cur_valid, cur_start))
        return x[..., 0]


# Receptive-field halo (mel frames) for exact chunked vocoding: conv_pre
# ±3, the first stage's MRF (k = 11, dilations 1/3/5: ±60 samples at 8
# samples a frame, ±7.5 frames), later stages under a frame, the
# transposed convs' windows ±2.
CHUNK_HALO_FRAMES = 16


def chunked_vocoder_call(gen_fn, total_upsample: int, mel: torch.Tensor,
                         valid_len: Optional[torch.Tensor] = None,
                         chunk_frames: int = 128,
                         halo: int = CHUNK_HALO_FRAMES) -> torch.Tensor:
    """Run a generator callable over time-folded chunks: (B, T, M) →
    (B·n_chunks, halo + chunk + halo, M) → crop → (B, T·upsample).

    Folding time into the batch gives modest convs instead of one
    million-sample conv stack.  It equals the unchunked masked run: every
    conv is local with a receptive field under ``halo`` frames, each chunk
    carries real halo data, and per-chunk valid windows reproduce the
    masking at both ends of the signal.

    gen_fn: (chunks (N, span, M), local valid (N,), local start (N,)) →
    (N, span·u).
    """
    # Python ints: under torch.jit.trace a size is a CPU tensor
    b, t, m = (int(d) for d in mel.shape)
    dev = mel.device
    n_chunks = -(-t // chunk_frames)
    pad_t = n_chunks * chunk_frames
    mel = torch.nn.functional.pad(mel, (0, 0, halo, pad_t - t + halo))

    span = chunk_frames + 2 * halo
    starts = torch.arange(n_chunks, device=dev) * chunk_frames
    idx = starts[:, None] + torch.arange(span, device=dev)[None, :]
    chunks = mel[:, idx, :].reshape(b * n_chunks, span, m)

    # positions beyond the signal's end (the trailing chunk's right
    # padding) are virtual zeros at every layer of an unpadded run
    virtual_end = torch.clamp(t + halo - starts, 0, span)
    if valid_len is not None:
        # each chunk's valid window, in frames from its start (halo
        # included)
        local = valid_len[:, None] - (starts[None, :] - halo)
        local = torch.minimum(torch.clamp(local, 0, span),
                              virtual_end[None, :]).reshape(b * n_chunks)
    else:
        local = virtual_end.repeat(b)
    # ... and positions before the signal's start (the leading chunk's
    # left halo) likewise
    local_start = torch.clamp(halo - starts, 0, span).repeat(b)

    wav = gen_fn(chunks, local, local_start)
    u = total_upsample
    wav = wav.reshape(b, n_chunks, span * u)
    wav = wav[:, :, halo * u: (halo + chunk_frames) * u]
    return wav.reshape(b, pad_t * u)[:, : t * u]


def vocode_chunked(generator: HifiGanGenerator, mel: torch.Tensor,
                   valid_len: Optional[torch.Tensor] = None,
                   chunk_frames: int = 128,
                   halo: int = CHUNK_HALO_FRAMES) -> torch.Tensor:
    """``chunked_vocoder_call`` over a generator module."""
    return chunked_vocoder_call(
        lambda c, v, s: generator(c, valid_len=v, valid_start=s),
        generator.cfg.total_upsample, mel, valid_len, chunk_frames, halo)
