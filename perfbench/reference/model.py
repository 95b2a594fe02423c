"""Plain PyTorch reference of EfficientSpeech and the HiFi-GAN generator,
functional over a state dict whose keys are the model's parameter names
(``phoneme2mel.*``, ``hifigan.*``).

It follows the published architecture (roatienza/efficientspeech, and
jik876/hifi-gan's generator with ResBlock 1) as the measured program
states it: channels-last activations, LayerNorm with eps 1e-5 and float32
statistics, exact GELU, padding row 0 of the phoneme table read as zeros,
masks that re-zero padded positions before every window, the length
regulator as a gather.  It imports nothing of the measured program.

Every product (linear, convolution, attention matmul) passes both of its
operands through ``prec.q``: the identity in float32, or a rounding to a
lower precision (``precision.py``); with ``prec.acts`` the biases and the
activations each layer writes are rounded to bfloat16 too.  Everything
else runs in float32.
"""

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

Params = Dict[str, torch.Tensor]


# --- primitives ------------------------------------------------------------

def linear(prec: Precision, P: Params, name: str, x, bias=True):
    w = P[name + ".weight"]
    b = prec.b(P.get(name + ".bias")) if bias else None
    return prec.a(F.linear(prec.q(x), prec.q(w), b))


def conv1d(prec: Precision, P: Params, name: str, x, stride=1, padding=0,
           dilation=1, groups=1):
    """x (B, T, C) → (B, T', C'); weight (out, in/groups, k)."""
    y = F.conv1d(prec.q(x).transpose(1, 2), prec.q(P[name + ".weight"]),
                 prec.b(P.get(name + ".bias")), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    return prec.a(y.transpose(1, 2))


def conv_transpose1d(prec: Precision, P: Params, name: str, x, stride,
                     padding=0):
    """x (B, T, C) → (B, T', C'); weight (in, out, k)."""
    y = F.conv_transpose1d(prec.q(x).transpose(1, 2),
                           prec.q(P[name + ".weight"]),
                           prec.b(P.get(name + ".bias")), stride=stride,
                           padding=padding)
    return prec.a(y.transpose(1, 2))


def layer_norm(P: Params, name: str, x, eps=1e-5, prec=None):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = ((x - mean) * torch.rsqrt(var + eps) * P[name + ".weight"]
         + P[name + ".bias"])
    return y if prec is None else prec.a(y)


def masked(x, mask):
    """Zero positions where ``mask`` (B, T) is True."""
    if mask is None:
        return x
    return x.masked_fill(mask[..., None], 0.0)


def scalar_bins(lo: float, hi: float, n: int) -> np.ndarray:
    """``n`` bucket edges from ``lo`` to ``hi``, the float32 linspace the
    model was defined with, rounded as a fused multiply-add per edge."""
    s, e = np.float32(lo), np.float32(hi)
    div = n - 1
    i = np.arange(div, dtype=np.float32)
    c = np.float32(1.0) / np.float32(div)
    start_part = s * (np.float32(1.0) - i * c)
    out = (i.astype(np.float64) * np.float64(e * c)
           + start_part.astype(np.float64)).astype(np.float32)
    return np.concatenate([out, np.asarray([e], np.float32)])


# --- acoustic model --------------------------------------------------------

def stage_geometry(cfg: dict, n: int):
    small = cfg["embed_dim"] // cfg["reduction"]
    depth = cfg["depth"]
    dim_ins = [cfg["embed_dim"]] + [small * 2 ** i for i in range(depth - 1)]
    dim_outs = [small * 2 ** i for i in range(depth)]
    heads = [cfg["head"] * (i + 1) for i in range(depth)]
    kernels = [cfg["kernel_size"] - (2 if i else 0) for i in range(depth)]
    paddings = [k // 2 for k in kernels]
    strides = [1] + [2] * (depth - 1)
    lengths, pools, cur = [], [], n
    for i in range(depth):
        cur = (cur + 2 * paddings[i] - kernels[i]) // strides[i] + 1
        lengths.append(cur)
        pools.append(int(round(n / cur)))
    return dict(dim_ins=dim_ins, dim_outs=dim_outs, heads=heads,
                kernels=kernels, paddings=paddings, strides=strides,
                lengths=lengths, pools=pools)


def pool_mask(pad_mask, pool: int, out_len: int):
    if pool == 1:
        return pad_mask[:, :out_len]
    b, n = pad_mask.shape
    target = out_len * pool
    if target > n:
        pad_mask = torch.cat([pad_mask, pad_mask.new_ones((b, target - n))],
                             dim=1)
    else:
        pad_mask = pad_mask[:, :target]
    return pad_mask.reshape(b, out_len, pool).all(dim=-1)


def attention(prec, P, name, x, mask, heads):
    b, n, c = x.shape
    qkv = linear(prec, P, name + ".qkv", x, bias=False)
    qkv = qkv.reshape(b, n, 3, heads, c).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    att = torch.matmul(prec.q(q), prec.q(k).transpose(-1, -2)) * (
        (c // heads) ** -0.5)
    att = torch.softmax(att.masked_fill(mask[:, None, None, :], -1e9), -1)
    out = prec.a(torch.matmul(prec.q(att), prec.q(v)))
    return linear(prec, P, name + ".proj",
                  out.permute(0, 2, 1, 3).reshape(b, n, heads * c))


def encoder(prec, P, cfg, phoneme, pad_mask):
    g = stage_geometry(cfg, phoneme.shape[1])
    pre = "phoneme2mel.encoder.encoder."
    x = prec.a(P[pre + "embed.weight"][phoneme]) * (phoneme != 0)[..., None]
    features, masks = [], []
    for i in range(cfg["depth"]):
        s = f"{pre}stage{i}"
        mask = pool_mask(pad_mask, g["pools"][i], g["lengths"][i])
        x = conv1d(prec, P, s + ".merge3x3", x, stride=g["strides"][i],
                   padding=g["paddings"][i])
        x = conv1d(prec, P, s + ".merge1x1", x)
        x = layer_norm(P, s + ".norm1", prec.a(
            attention(prec, P, s + ".attn", x, mask, g["heads"][i]) + x),
            prec=prec)
        x = masked(x, mask)
        h = masked(linear(prec, P, s + ".mixffn.mlp1", x), mask)
        h = prec.a(F.gelu(conv1d(prec, P, s + ".mixffn.conv", h,
                                 padding=1)))
        x = layer_norm(P, s + ".norm2", prec.a(
            linear(prec, P, s + ".mixffn.mlp2", h) + x), prec=prec)
        x = masked(x, mask)
        features.append(x)
        masks.append(mask)
    return features, masks, g


def fuse(prec, P, cfg, features, masks, g):
    pre = "phoneme2mel.encoder.fuse."
    dim = cfg["embed_dim"] // cfg["reduction"]
    out_len = masks[0].shape[1]
    parts = []
    for i, feat in enumerate(features):
        x = linear(prec, P, f"{pre}mlp{i}", feat)
        up = g["dim_outs"][i] // dim
        if up > 1:
            x = conv_transpose1d(prec, P, f"{pre}upsample{i}", x, stride=up)
        parts.append(x[:, :out_len])
    return masked(linear(prec, P, pre + "fuse", torch.cat(parts, -1)),
                  masks[0])


def variance_decoder(prec, P, name, x, mask, duration=False):
    """(scalar prediction (B, N), features (B, N, C))."""
    y = torch.relu(conv1d(prec, P, name + ".conv1", x, padding=1))
    y = masked(torch.relu(layer_norm(P, name + ".norm1", y, prec=prec)),
               mask)
    y = torch.relu(conv1d(prec, P, name + ".conv2", y, padding=1))
    out = linear(prec, P, name + ".linear", y)[..., 0]
    if duration:
        out = torch.relu(out)
    return out, layer_norm(P, name + ".norm2", y, prec=prec)


def bucket_embed(P, name, value, bins, prec):
    return prec.a(P[name + ".weight"][torch.bucketize(value.float(), bins)])


def scalar_tables(cfg, device):
    dim = cfg["embed_dim"] // cfg["reduction"]
    return {k: torch.from_numpy(scalar_bins(*cfg[k + "_stats"], dim - 1)
                                ).to(device)
            for k in ("pitch", "energy")}


def length_regulate(features, durations, max_frames: int):
    cum = torch.cumsum(durations.long(), dim=1)
    mel_len = cum[:, -1]
    pos = torch.arange(max_frames, device=features.device)
    idx = torch.searchsorted(cum, pos.expand(features.shape[0], -1)
                             .contiguous(), right=True)
    idx = idx.clamp_max(features.shape[1] - 1)
    frames = torch.gather(features, 1,
                          idx[..., None].expand(-1, -1, features.shape[2]))
    valid = pos[None, :] < mel_len[:, None]
    return frames * valid[..., None], valid, mel_len


def mel_decoder(prec, P, cfg, x, pad):
    pre = "phoneme2mel.decoder."
    skip = layer_norm(P, pre + "proj_norm", prec.a(
        torch.tanh(linear(prec, P, pre + "proj_linear", x))), prec=prec)
    k = cfg["decoder_kernel_size"]
    for b in range(cfg["n_blocks"]):
        x = skip
        for d in range(cfg["block_depth"]):
            x = masked(x, pad)
            x = conv1d(prec, P, f"{pre}block{b}_conv{d}_dw", x,
                       padding=k // 2, groups=x.shape[-1])
            x = conv1d(prec, P, f"{pre}block{b}_conv{d}_pw", x)
            x = layer_norm(P, f"{pre}block{b}_norm{d}",
                           prec.a(torch.tanh(x)), prec=prec)
        skip = layer_norm(P, f"{pre}block{b}_skip_norm", prec.a(x + skip),
                          prec=prec)
    return linear(prec, P, pre + "mel_linear", skip)


def acoustic(prec: Precision, P: Params, cfg: dict, phoneme, pad_mask,
             max_frames: int, judged: Optional[dict] = None):
    """The acoustic model on phoneme ids (B, N) → dict of the continuous
    predictions ``pitch``, ``energy``, ``duration`` (B, N), ``mel`` (B,
    max_frames, n_mels) zero beyond ``mel_len`` (B,).

    Its three discrete steps (the pitch and energy buckets, the rounded
    durations) take their inputs from ``judged`` where given: the
    continuous predictions of the side under judgement, so that the frames
    it produced follow from the same choices."""
    tables = scalar_tables(cfg, phoneme.device)
    features, masks, g = encoder(prec, P, cfg, phoneme, pad_mask)
    mask0 = masks[0]
    x = fuse(prec, P, cfg, features, masks, g)
    pre = "phoneme2mel.encoder."
    pitch, _ = variance_decoder(prec, P, pre + "pitch_decoder", x, mask0)
    energy, _ = variance_decoder(prec, P, pre + "energy_decoder", x, mask0)
    dur, dur_feat = variance_decoder(prec, P, pre + "duration_decoder", x,
                                     mask0, duration=True)
    src = judged or {"pitch": pitch, "energy": energy,
                                "duration": dur}
    pitch_feat = masked(bucket_embed(P, pre + "pitch_embedding",
                                     src["pitch"], tables["pitch"], prec),
                        mask0)
    energy_feat = masked(bucket_embed(P, pre + "energy_embedding",
                                      src["energy"], tables["energy"], prec),
                         mask0)
    cat = torch.cat([x, pitch_feat, energy_feat, masked(dur_feat, mask0)],
                    -1)
    durations = torch.round(src["duration"].float()).clamp_min(0)
    durations = durations.masked_fill(mask0, 0.0)
    frames, valid, mel_len = length_regulate(cat, durations, max_frames)
    mel = masked(mel_decoder(prec, P, cfg, frames, ~valid), ~valid)
    return {"pitch": pitch, "energy": energy, "duration": dur, "mel": mel,
            "mel_len": mel_len, "tables": tables}


# --- HiFi-GAN generator ----------------------------------------------------

LRELU = 0.1


def generator(prec: Precision, P: Params, hcfg: dict, mel):
    """mel (B, T, num_mels) of T valid frames → wav (B, T · upsample);
    the convolutions' zero padding stands for silence beyond both ends."""
    pre = "hifigan."
    x = conv1d(prec, P, pre + "conv_pre", mel, padding=3)
    n_k = len(hcfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(hcfg["upsample_rates"],
                                   hcfg["upsample_kernel_sizes"])):
        x = conv_transpose1d(prec, P, f"{pre}up{i}",
                             F.leaky_relu(x, LRELU), stride=u,
                             padding=(k - u) // 2)
        acc = None
        for j, (rk, dil) in enumerate(zip(hcfg["resblock_kernel_sizes"],
                                          hcfg["resblock_dilation_sizes"])):
            r = x
            for m, d in enumerate(dil):
                name = f"{pre}resblock_{i}_{j}"
                t = conv1d(prec, P, f"{name}.conv1_{m}",
                           F.leaky_relu(r, LRELU),
                           padding=(rk * d - d) // 2, dilation=d)
                t = conv1d(prec, P, f"{name}.conv2_{m}",
                           F.leaky_relu(t, LRELU), padding=(rk - 1) // 2)
                r = t + r
            acc = r if acc is None else acc + r
        x = acc / n_k
    x = conv1d(prec, P, pre + "conv_post", F.leaky_relu(x, 0.01), padding=3)
    return torch.tanh(x)[..., 0]


def int16_wire(wav):
    """The 16-bit PCM the answer carries, read back as float."""
    return torch.clamp(wav.float() * 32768.0, -32768.0,
                       32767.0).to(torch.int16).float() / 32768.0
