"""Phoneme-side acoustic model: pyramid encoder, feature fusion, and the
pitch/energy/duration decoders (counterpart of the JAX package's
``models/acoustic.py``, native masking semantics).

Static shapes: one (phoneme bucket, mel frames) shape per call; masks
carry validity, and attention logits of padded keys are masked.
Activations are (B, T, C) channels-last.
"""

from typing import Optional

import numpy as np
import torch
from torch import nn

from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.modules import (
    Conv1d,
    ConvTranspose1d,
    Embedding,
    LayerNorm,
    Linear,
    gelu_exact,
    masked_fill,
)
from efficientspeech_tpu_torch.ops.length_regulator import length_regulate
from efficientspeech_tpu_torch.text.symbols import VOCAB_SIZE


def pool_pad_mask(pad_mask: torch.Tensor, pool: int, out_len: int
                  ) -> torch.Tensor:
    """Downsample a (B, N) padding mask (True = pad) over stride-``pool``
    windows: a window is valid if any input in it is valid (the min over
    the window), which matches the strided conv's true output length."""
    if pool == 1:
        return pad_mask[:, :out_len]
    b, n = pad_mask.shape
    target = out_len * pool
    if target > n:
        pad_mask = torch.cat(
            [pad_mask, pad_mask.new_ones((b, target - n))], dim=1)
    else:
        pad_mask = pad_mask[:, :target]
    return pad_mask.reshape(b, out_len, pool).all(dim=-1)


class SelfAttention(nn.Module):
    """Full softmax self-attention.  Each of ``num_heads`` heads has the
    FULL ``dim`` width (qkv projects to dim*3*heads) while the softmax
    scale still uses ``(dim // num_heads) ** -0.5``."""

    def __init__(self, dim: int, num_heads: int = 1):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = Linear(dim, dim * 3 * num_heads, bias=False)
        self.proj = Linear(dim * num_heads, dim)

    def forward(self, x, pad_mask: Optional[torch.Tensor]):
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                  # (B, H, N, C)
        scale = (self.dim // h) ** -0.5
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if pad_mask is not None:
            attn = attn.masked_fill(pad_mask[:, None, None, :], -1e9)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v.to(x.dtype))
        out = out.permute(0, 2, 1, 3).reshape(b, n, h * c)
        return self.proj(out)


class MixFFN(nn.Module):
    """Linear → Conv1d(k=3) → GELU → Linear, with the hidden activations
    re-zeroed at padded positions before the conv (the biased mlp1 would
    otherwise leak pads into the last valid position)."""

    def __init__(self, dim: int, expansion: int = 1):
        super().__init__()
        hidden = dim * expansion
        self.mlp1 = Linear(dim, hidden)
        self.conv = Conv1d(hidden, hidden, 3, padding=1)
        self.mlp2 = Linear(hidden, dim)

    def forward(self, x, pad_mask=None):
        x = masked_fill(self.mlp1(x), pad_mask)
        return self.mlp2(gelu_exact(self.conv(x)))


class EncoderStage(nn.Module):
    """One pyramid stage: strided merge convs + attention + MixFFN."""

    def __init__(self, dim_in, dim_out, head, kernel, stride, padding,
                 expansion):
        super().__init__()
        self.merge3x3 = Conv1d(dim_in, dim_in, kernel, stride=stride,
                               padding=padding, bias=False)
        self.merge1x1 = Conv1d(dim_in, dim_out, 1, bias=False)
        self.attn = SelfAttention(dim_out, num_heads=head)
        self.norm1 = LayerNorm(dim_out)
        self.norm2 = LayerNorm(dim_out)
        self.mixffn = MixFFN(dim_out, expansion)

    def forward(self, x, stage_mask):
        x = self.merge1x1(self.merge3x3(x))
        x = self.norm1(self.attn(x, stage_mask) + x)
        x = masked_fill(x, stage_mask)
        x = self.norm2(self.mixffn(x, stage_mask) + x)
        return masked_fill(x, stage_mask)


def encoder_stage_geometry(cfg: ModelConfig, n: Optional[int] = None):
    """Static per-stage (dims_in, dims_out, heads, kernels, strides,
    paddings, lengths, pools) for input length ``n`` (default
    cfg.max_phoneme_len)."""
    small = cfg.embed_dim // cfg.reduction
    dim_ins = [cfg.embed_dim] + [small * (2 ** i) for i in range(cfg.depth - 1)]
    dim_outs = [small * (2 ** i) for i in range(cfg.depth)]
    heads = [cfg.head * (i + 1) for i in range(cfg.depth)]
    kernels = [cfg.kernel_size - (2 if i > 0 else 0) for i in range(cfg.depth)]
    paddings = [k // 2 for k in kernels]
    strides = [1] + [2] * (cfg.depth - 1)

    lengths, pools = [], []
    n = cfg.max_phoneme_len if n is None else n
    cur = n
    for i in range(cfg.depth):
        cur = (cur + 2 * paddings[i] - kernels[i]) // strides[i] + 1
        lengths.append(cur)
        pools.append(int(round(n / cur)))
    return dim_ins, dim_outs, heads, kernels, strides, paddings, lengths, pools


class Encoder(nn.Module):
    """Pyramid phoneme encoder."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dim_ins, dim_outs, heads, kernels, strides, paddings, _, _ = \
            encoder_stage_geometry(cfg)
        self.embed = Embedding(cfg.vocab_size or VOCAB_SIZE, cfg.embed_dim)
        for i in range(cfg.depth):
            self.add_module(f"stage{i}", EncoderStage(
                dim_ins[i], dim_outs[i], heads[i], kernels[i], strides[i],
                paddings[i], cfg.expansion))

    def forward(self, phoneme, pad_mask):
        cfg = self.cfg
        # a Python int: a traced size (torch.jit.trace) would be a tensor
        *_, lengths, pools = encoder_stage_geometry(
            cfg, int(phoneme.shape[1]))
        # the compute dtype is the convs' (see modules.compute_params)
        x = self.embed(phoneme, self.stage0.merge3x3.weight.dtype)
        features, masks = [], []
        for i in range(cfg.depth):
            stage_mask = pool_pad_mask(pad_mask, pools[i], lengths[i])
            x = getattr(self, f"stage{i}")(x, stage_mask)
            features.append(x)
            masks.append(stage_mask)
        return features, masks


class Fuse(nn.Module):
    """Project per-stage features to a common width, upsample back to the
    phoneme rate (sliced to the input length), concat, fuse."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dim = cfg.filter_dim
        _, dim_outs, *_ = encoder_stage_geometry(cfg)
        for i, d in enumerate(dim_outs):
            self.add_module(f"mlp{i}", Linear(d, dim))
            if d // dim > 1:
                self.add_module(f"upsample{i}", ConvTranspose1d(
                    dim, dim, cfg.kernel_size, stride=d // dim))
        self.fuse = Linear(dim * len(dim_outs), dim)

    def forward(self, features, masks):
        out_len = masks[0].shape[1]
        fused = []
        for i, feature in enumerate(features):
            x = getattr(self, f"mlp{i}")(feature)
            if hasattr(self, f"upsample{i}"):
                x = getattr(self, f"upsample{i}")(x)
            fused.append(x[:, :out_len, :])
        return masked_fill(self.fuse(torch.cat(fused, dim=-1)), masks[0])


class AcousticDecoder(nn.Module):
    """Pitch / energy / duration predictor.  The scalar head reads the
    PRE-norm2 activations; ``features`` is the post-norm2 output."""

    def __init__(self, dim: int, duration: bool = False):
        super().__init__()
        self.duration = duration
        self.conv1 = Conv1d(dim, dim, 3, padding=1)
        self.norm1 = LayerNorm(dim)
        self.conv2 = Conv1d(dim, dim, 3, padding=1)
        self.norm2 = LayerNorm(dim)
        self.linear = Linear(dim, 1)

    def forward(self, fused, pad_mask=None):
        y = torch.relu(self.conv1(fused))
        y = torch.relu(self.norm1(y))
        # biased conv1+LN revive pads; re-zero before the k=3 conv2
        y = masked_fill(y, pad_mask)
        y = torch.relu(self.conv2(y))
        features = self.norm2(y)
        out = self.linear(y)
        if self.duration:
            out = torch.relu(out)
        return out, features


def scalar_bins(lo: float, hi: float, n: int) -> np.ndarray:
    """The JAX package's ``jnp.linspace(lo, hi, n)`` bins, bit for bit in
    float32: a last-ulp difference moves values across bucket edges.  As
    XLA's CPU backend compiles it, with c = f32(1/div) and i = iota:
    ``fma(i, stop·c, start·(1 − i·c))``, stop appended.  The fused
    multiply-add is exact in float64 (a product of two float32 values)
    and rounded once more to float32."""
    s, e = np.float32(lo), np.float32(hi)
    div = n - 1
    i = np.arange(div, dtype=np.float32)
    c = np.float32(1.0) / np.float32(div)
    start_part = s * (np.float32(1.0) - i * c)
    out = (i.astype(np.float64) * np.float64(e * c)
           + start_part.astype(np.float64)).astype(np.float32)
    return np.concatenate([out, np.asarray([e], np.float32)])


class ScalarEmbedding(nn.Module):
    """Bucketized scalar → embedding for pitch/energy.  The bins are a
    fixed float32 linspace from dataset stats.  They are kept as their
    int32 bit patterns, so that casting the module to bf16 leaves them
    exact.  The caller casts the gathered rows, so under
    ``compute_params`` the table stays float32."""

    takes_f32_params = True

    def __init__(self, dim: int, stats):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dim))
        bins = scalar_bins(stats[0], stats[1], dim - 1)
        self.register_buffer("bins_bits",
                             torch.from_numpy(bins.view(np.int32).copy()),
                             persistent=False)

    def reset_parameters(self, gen: torch.Generator):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=gen)

    @property
    def bins(self) -> torch.Tensor:
        if torch.jit.is_tracing():
            # the TorchScript tracer (also under the ONNX exporter) cannot
            # record view(dtype); the bins enter its graph as a constant
            bits = self.bins_bits.cpu().numpy()
            return torch.from_numpy(bits.view(np.float32)).to(
                self.bins_bits.device)
        return self.bins_bits.view(torch.float32)

    def forward(self, value):
        # bucketize(v, bins) == searchsorted(bins, v, side='left'), the
        # JAX package's index; unlike searchsorted it exports to ONNX
        idx = torch.bucketize(value.float(), self.bins)
        return self.weight[idx]


class PhonemeEncoder(nn.Module):
    """Phonemes → frame-rate fused features + acoustic predictions.
    Inference embeds the predicted pitch/energy and expands by the rounded
    predicted durations; training (``train=True``) embeds the targets and
    expands by ``duration_target``, through the one-hot product."""

    # its own parameter is the speaker table, gathered and then cast
    takes_f32_params = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.filter_dim
        self.encoder = Encoder(cfg)
        self.fuse = Fuse(cfg)
        if cfg.n_speakers > 1:
            self.speaker_embedding = nn.Parameter(
                torch.empty(cfg.n_speakers, dim))
        self.pitch_decoder = AcousticDecoder(dim)
        self.pitch_embedding = ScalarEmbedding(dim, cfg.pitch_stats)
        self.energy_decoder = AcousticDecoder(dim)
        self.energy_embedding = ScalarEmbedding(dim, cfg.energy_stats)
        self.duration_decoder = AcousticDecoder(dim, duration=True)

    def reset_parameters(self, gen: torch.Generator):
        if self.cfg.n_speakers > 1:
            with torch.no_grad():
                self.speaker_embedding.normal_(0.0, 0.5, generator=gen)

    def forward(self, phoneme, pad_mask, max_mel_len: int,
                speaker: Optional[torch.Tensor] = None,
                pitch_target: Optional[torch.Tensor] = None,
                energy_target: Optional[torch.Tensor] = None,
                duration_target: Optional[torch.Tensor] = None,
                train: bool = False):
        features, masks = self.encoder(phoneme, pad_mask)
        mask0 = masks[0]                                 # (B, N) True = pad
        fused = self.fuse(features, masks)
        if self.cfg.n_speakers > 1:
            spk = (speaker if speaker is not None else torch.zeros(
                phoneme.shape[0], dtype=torch.long, device=phoneme.device))
            spk_feat = self.speaker_embedding[spk].to(fused.dtype)
            fused = masked_fill(fused + spk_feat[:, None, :], mask0)

        pitch_pred, _ = self.pitch_decoder(fused, mask0)
        pitch_src = pitch_target if train else pitch_pred[..., 0]
        pitch_feat = masked_fill(
            self.pitch_embedding(pitch_src).to(fused.dtype), mask0)
        energy_pred, _ = self.energy_decoder(fused, mask0)
        energy_src = energy_target if train else energy_pred[..., 0]
        energy_feat = masked_fill(
            self.energy_embedding(energy_src).to(fused.dtype), mask0)
        duration_pred, duration_feat = self.duration_decoder(fused, mask0)
        duration_feat = masked_fill(duration_feat, mask0)

        fused_cat = torch.cat(
            [fused, pitch_feat, energy_feat, duration_feat], dim=-1)
        # round half to even (torch.round), then clamp at 0 and zero pads
        durations = (duration_target if train
                     else torch.round(duration_pred[..., 0].float()))
        durations = torch.where(mask0, torch.zeros_like(durations),
                                durations.clamp_min(0))
        frames, frame_valid, mel_len = length_regulate(
            fused_cat, durations, max_mel_len, via_matmul=train)
        return {
            "pitch": pitch_pred,
            "energy": energy_pred,
            "duration": duration_pred,
            "mel_len": mel_len,
            "features": frames,
            "frame_valid": frame_valid,
        }
