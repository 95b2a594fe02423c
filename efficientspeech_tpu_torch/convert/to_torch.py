"""Inverse converter: JAX-layout parameter trees → reference torch
state_dict (a copy of the JAX package's ``convert/to_torch.py``; a port
model's tree comes from ``weights.to_jax_params``).

Lets models trained in this framework be loaded by the reference PyTorch
implementation (the mirror of ``from_torch``): layout transposes inverted,
keys mapped back to the reference module paths (reference:
layers/networks.py, hifigan/models.py).
"""

import dataclasses
import json
import os
from typing import Dict, Mapping

import numpy as np


def _linear(p):
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _conv1d(p):
    out = {"weight": np.asarray(p["kernel"]).transpose(2, 1, 0)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _conv_transpose1d(p):
    out = {"weight": np.asarray(p["kernel"]).transpose(1, 2, 0)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _layernorm(p):
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _emit(sd: Dict, prefix: str, tensors: Mapping):
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v


def efficientspeech_params_to_state_dict(params: Mapping, depth: int = 2,
                                         n_blocks: int = 2,
                                         block_depth: int = 2,
                                         pitch_stats=None,
                                         energy_stats=None) -> Dict:
    """{'phoneme2mel': ...} pytree → reference ``phoneme2mel.*`` state_dict
    (numpy values; wrap with torch.from_numpy for torch.save)."""
    p2m = params["phoneme2mel"]
    enc = p2m["encoder"]
    sd: Dict = {}

    e = enc["encoder"]
    sd["phoneme2mel.encoder.encoder.embed.weight"] = np.asarray(
        e["embed"]["embedding"])
    for i in range(depth):
        s = e[f"stage{i}"]
        b = f"phoneme2mel.encoder.encoder.attn_blocks.{i}"
        _emit(sd, f"{b}.0", _conv1d(s["merge3x3"]))
        _emit(sd, f"{b}.1", _conv1d(s["merge1x1"]))
        _emit(sd, f"{b}.2.qkv", _linear(s["attn"]["qkv"]))
        _emit(sd, f"{b}.2.proj", _linear(s["attn"]["proj"]))
        _emit(sd, f"{b}.3.mlp1", _linear(s["mixffn"]["mlp1"]))
        _emit(sd, f"{b}.3.conv", _conv1d(s["mixffn"]["conv"]))
        _emit(sd, f"{b}.3.mlp2", _linear(s["mixffn"]["mlp2"]))
        _emit(sd, f"{b}.4", _layernorm(s["norm1"]))
        _emit(sd, f"{b}.5", _layernorm(s["norm2"]))

    f = enc["fuse"]
    for i in range(depth):
        _emit(sd, f"phoneme2mel.encoder.fuse.mlps.{i}.0", _linear(f[f"mlp{i}"]))
        if i > 0:
            _emit(sd, f"phoneme2mel.encoder.fuse.mlps.{i}.1",
                  _conv_transpose1d(f[f"upsample{i}"]))
    _emit(sd, "phoneme2mel.encoder.fuse.fuse", _linear(f["fuse"]))

    for name in ["pitch_decoder", "energy_decoder", "duration_decoder"]:
        d = enc[name]
        b = f"phoneme2mel.encoder.{name}"
        _emit(sd, f"{b}.conv1.0", _conv1d(d["conv1"]))
        _emit(sd, f"{b}.norm1", _layernorm(d["norm1"]))
        _emit(sd, f"{b}.conv2.0", _conv1d(d["conv2"]))
        _emit(sd, f"{b}.norm2", _layernorm(d["norm2"]))
        _emit(sd, f"{b}.linear", _linear(d["linear"]))

    sd["phoneme2mel.encoder.pitch_decoder.pitch_embedding.weight"] = \
        np.asarray(enc["pitch_embedding"]["embedding"])
    sd["phoneme2mel.encoder.energy_decoder.energy_embedding.weight"] = \
        np.asarray(enc["energy_embedding"]["embedding"])
    if pitch_stats is not None:
        dim = sd["phoneme2mel.encoder.pitch_decoder.pitch_embedding.weight"].shape[0]
        sd["phoneme2mel.encoder.pitch_decoder.pitch_bins"] = np.linspace(
            pitch_stats[0], pitch_stats[1], dim - 1).astype(np.float32)
    if energy_stats is not None:
        dim = sd["phoneme2mel.encoder.energy_decoder.energy_embedding.weight"].shape[0]
        sd["phoneme2mel.encoder.energy_decoder.energy_bins"] = np.linspace(
            energy_stats[0], energy_stats[1], dim - 1).astype(np.float32)

    dec = p2m["decoder"]
    _emit(sd, "phoneme2mel.decoder.proj.0", _linear(dec["proj_linear"]))
    _emit(sd, "phoneme2mel.decoder.proj.2", _layernorm(dec["proj_norm"]))
    for b in range(n_blocks):
        for d in range(block_depth):
            base = f"phoneme2mel.decoder.blocks.{b}.0.{d}"
            _emit(sd, f"{base}.0.0", _conv1d(dec[f"block{b}_conv{d}_dw"]))
            _emit(sd, f"{base}.0.1", _conv1d(dec[f"block{b}_conv{d}_pw"]))
            _emit(sd, f"{base}.1", _layernorm(dec[f"block{b}_norm{d}"]))
        _emit(sd, f"phoneme2mel.decoder.blocks.{b}.1",
              _layernorm(dec[f"block{b}_skip_norm"]))
    _emit(sd, "phoneme2mel.decoder.mel_linear", _linear(dec["mel_linear"]))
    return sd


def save_reference_checkpoint(path: str, params: Mapping, depth: int = 2,
                              n_blocks: int = 2, block_depth: int = 2,
                              pitch_stats=None, energy_stats=None,
                              hyper_parameters: Dict = None):
    """Write a Lightning-style .ckpt loadable by the reference."""
    import torch

    sd = efficientspeech_params_to_state_dict(
        params, depth=depth, n_blocks=n_blocks, block_depth=block_depth,
        pitch_stats=pitch_stats, energy_stats=energy_stats)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": sd,
                "hyper_parameters": hyper_parameters or {}}, path)


# --- HiFi-GAN inverse (our folded params → weight-normed torch sd) ----------

def _wn_conv1d(p):
    """Plain conv kernel → weight_norm'd torch Conv1d tensors: v = W,
    g = ||W|| per output channel (dim=0), so g·v/||v|| == W exactly."""
    W = np.asarray(p["kernel"]).transpose(2, 1, 0)  # (out, in, k)
    g = np.linalg.norm(W.reshape(W.shape[0], -1), axis=1).reshape(-1, 1, 1)
    return {"weight_g": g.astype(W.dtype), "weight_v": W,
            "bias": np.asarray(p["bias"])}


def _wn_conv_transpose1d(p):
    W = np.asarray(p["kernel"]).transpose(1, 2, 0)  # (in, out, k)
    g = np.linalg.norm(W.reshape(W.shape[0], -1), axis=1).reshape(-1, 1, 1)
    return {"weight_g": g.astype(W.dtype), "weight_v": W,
            "bias": np.asarray(p["bias"])}


def hifigan_params_to_state_dict(params: Mapping,
                                 num_kernels: int = 3) -> Dict:
    """HifiGanGenerator params → reference hifigan.Generator state_dict
    (weight-normalized layout, reference: hifigan/models.py:84-105);
    exact inverse of convert_hifigan_state_dict (round-trip tested)."""
    sd: Dict = {}
    _emit(sd, "conv_pre", _wn_conv1d(params["conv_pre"]))
    _emit(sd, "conv_post", _wn_conv1d(params["conv_post"]))
    ups = sorted(int(k[2:]) for k in params if k.startswith("up"))
    for i in ups:
        _emit(sd, f"ups.{i}", _wn_conv_transpose1d(params[f"up{i}"]))
    for key in params:
        if not key.startswith("resblock_"):
            continue
        i, j = (int(x) for x in key.split("_")[1:3])
        r = i * num_kernels + j
        block = params[key]
        if any(k.startswith("conv1_") for k in block):
            for m in range(len([k for k in block if k.startswith("conv1_")])):
                _emit(sd, f"resblocks.{r}.convs1.{m}",
                      _wn_conv1d(block[f"conv1_{m}"]))
                _emit(sd, f"resblocks.{r}.convs2.{m}",
                      _wn_conv1d(block[f"conv2_{m}"]))
        else:  # ResBlock2
            for m in range(len(block)):
                _emit(sd, f"resblocks.{r}.convs.{m}",
                      _wn_conv1d(block[f"conv_{m}"]))
    return sd


def save_hifigan_checkpoint(path: str, params: Mapping, hifigan_cfg=None,
                            num_kernels: int = 3):
    """Write a reference-style generator file, ``{"generator":
    state_dict}`` with weight-normed convs (reference: model.py:38-42);
    with ``hifigan_cfg``, also its ``config.json`` beside it, which
    ``build_synthesizer`` reads to choose the vocoder's shape."""
    import torch

    if hifigan_cfg is not None:
        num_kernels = len(hifigan_cfg.resblock_kernel_sizes)
        with open(os.path.join(os.path.dirname(os.path.abspath(path)),
                               "config.json"), "w") as f:
            json.dump(dataclasses.asdict(hifigan_cfg), f)
    sd = hifigan_params_to_state_dict(params, num_kernels=num_kernels)
    torch.save({"generator": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}}, path)
