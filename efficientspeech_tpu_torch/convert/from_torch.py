"""One-time converters: reference torch checkpoints → the JAX-layout
parameter tree (a copy of the JAX package's ``convert/from_torch.py``;
``weights.load_jax_params`` loads the tree into the port's modules).

Handles the released EfficientSpeech Lightning checkpoints
(tiny/small/base_eng, reference: README.md:35-87) and the bundled HiFi-GAN
generator (reference: hifigan/LJ_V2/generator_v2, loaded at
reference: model.py:23-48).  Weight-norm ``(g, v)`` pairs are folded into
plain kernels here, replicating ``remove_weight_norm`` semantics
(reference: model.py:44) without importing torch modules.

Layout conversions (torch → ours, channels-last (B, T, C)):
  Linear          (out, in)          → (in, out)
  Conv1d          (out, in/g, k)     → (k, in/g, out)
  ConvTranspose1d (in, out, k)       → (k, in, out)
  Embedding/LayerNorm                → unchanged (LN weight → 'scale')
"""

import re
from typing import Dict, Mapping

import numpy as np

Array = np.ndarray
StateDict = Dict[str, Array]


def fold_weight_norm(sd: Mapping[str, Array]) -> StateDict:
    """Fold every ``*.weight_g``/``*.weight_v`` pair into ``*.weight``.

    torch weight_norm (dim=0): w = g * v / ||v||, norm over all dims but 0.
    """
    out: StateDict = {}
    g_keys = [k for k in sd if k.endswith("weight_g")]
    folded_prefixes = {k[: -len("weight_g")] for k in g_keys}
    for k, v in sd.items():
        if k.endswith("weight_g"):
            prefix = k[: -len("weight_g")]
            g = np.asarray(sd[prefix + "weight_g"], dtype=np.float64)
            vv = np.asarray(sd[prefix + "weight_v"], dtype=np.float64)
            axes = tuple(range(1, vv.ndim))
            norm = np.sqrt(np.sum(vv * vv, axis=axes, keepdims=True))
            out[prefix + "weight"] = (g * vv / norm).astype(np.float32)
        elif k.endswith("weight_v"):
            continue
        elif any(k.startswith(p) for p in folded_prefixes) and k.endswith("weight"):
            continue  # shouldn't coexist, but be safe
        else:
            out[k] = np.asarray(v)
    return out


def _linear(sd, key):
    p = {"kernel": np.asarray(sd[key + ".weight"]).T}
    if key + ".bias" in sd:
        p["bias"] = np.asarray(sd[key + ".bias"])
    return p


def _conv1d(sd, key):
    p = {"kernel": np.asarray(sd[key + ".weight"]).transpose(2, 1, 0)}
    if key + ".bias" in sd:
        p["bias"] = np.asarray(sd[key + ".bias"])
    return p


def _conv_transpose1d(sd, key):
    p = {"kernel": np.asarray(sd[key + ".weight"]).transpose(2, 0, 1)}
    if key + ".bias" in sd:
        p["bias"] = np.asarray(sd[key + ".bias"])
    return p


def _layernorm(sd, key):
    return {"scale": np.asarray(sd[key + ".weight"]),
            "bias": np.asarray(sd[key + ".bias"])}


def _embedding(sd, key):
    return {"embedding": np.asarray(sd[key + ".weight"])}


def convert_hifigan_state_dict(sd: Mapping[str, Array], prefix: str = "",
                               num_kernels: int = 3) -> dict:
    """torch HiFi-GAN Generator state_dict → HifiGanGenerator params.

    ``sd`` may still contain weight_g/weight_v pairs (they are folded).
    ``prefix`` strips a leading module path (e.g. ``hifigan.`` inside a
    full EfficientSpeech checkpoint).
    """
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd = fold_weight_norm(sd)

    params: dict = {}
    params["conv_pre"] = _conv1d(sd, "conv_pre")
    params["conv_post"] = _conv1d(sd, "conv_post")

    n_ups = len([k for k in sd if re.fullmatch(r"ups\.\d+\.weight", k)])
    for i in range(n_ups):
        params[f"up{i}"] = _conv_transpose1d(sd, f"ups.{i}")

    n_res = len({int(m.group(1)) for k in sd
                 for m in [re.match(r"resblocks\.(\d+)\.", k)] if m})
    for r in range(n_res):
        i, j = divmod(r, num_kernels)
        block: dict = {}
        if any(k.startswith(f"resblocks.{r}.convs1.") for k in sd):
            for m in range(3):
                block[f"conv1_{m}"] = _conv1d(sd, f"resblocks.{r}.convs1.{m}")
                block[f"conv2_{m}"] = _conv1d(sd, f"resblocks.{r}.convs2.{m}")
        else:  # ResBlock2
            for m in range(2):
                block[f"conv_{m}"] = _conv1d(sd, f"resblocks.{r}.convs.{m}")
        params[f"resblock_{i}_{j}"] = block
    return params


def convert_efficientspeech_state_dict(sd: Mapping[str, Array],
                                       depth: int = 2,
                                       n_blocks: int = 2,
                                       block_depth: int = 2,
                                       num_kernels: int = 3) -> dict:
    """Reference EfficientSpeech state_dict (``phoneme2mel.*`` [+ ``hifigan.*``])
    → our EfficientSpeech params pytree.

    Key layout follows the reference modules (reference: layers/networks.py):
    ``encoder.encoder.attn_blocks.{i}.{0..5}`` = [merge3x3, merge1x1, attn,
    mixffn, norm1, norm2]; ``decoder.blocks.{b}`` etc.
    """
    enc: dict = {}
    p = "phoneme2mel.encoder.encoder"
    enc["embed"] = _embedding(sd, f"{p}.embed")
    for i in range(depth):
        b = f"{p}.attn_blocks.{i}"
        enc[f"stage{i}"] = {
            "merge3x3": _conv1d(sd, f"{b}.0"),
            "merge1x1": _conv1d(sd, f"{b}.1"),
            "attn": {"qkv": _linear(sd, f"{b}.2.qkv"),
                     "proj": _linear(sd, f"{b}.2.proj")},
            "mixffn": {"mlp1": _linear(sd, f"{b}.3.mlp1"),
                       "conv": _conv1d(sd, f"{b}.3.conv"),
                       "mlp2": _linear(sd, f"{b}.3.mlp2")},
            "norm1": _layernorm(sd, f"{b}.4"),
            "norm2": _layernorm(sd, f"{b}.5"),
        }

    fuse: dict = {}
    fp = "phoneme2mel.encoder.fuse"
    for i in range(depth):
        fuse[f"mlp{i}"] = _linear(sd, f"{fp}.mlps.{i}.0")
        if i > 0:
            fuse[f"upsample{i}"] = _conv_transpose1d(sd, f"{fp}.mlps.{i}.1")
    fuse["fuse"] = _linear(sd, f"{fp}.fuse")

    def acoustic_decoder(name):
        dp = f"phoneme2mel.encoder.{name}"
        return {
            "conv1": _conv1d(sd, f"{dp}.conv1.0"),
            "norm1": _layernorm(sd, f"{dp}.norm1"),
            "conv2": _conv1d(sd, f"{dp}.conv2.0"),
            "norm2": _layernorm(sd, f"{dp}.norm2"),
            "linear": _linear(sd, f"{dp}.linear"),
        }

    encoder_params = {
        "encoder": enc,
        "fuse": fuse,
        "pitch_decoder": acoustic_decoder("pitch_decoder"),
        "energy_decoder": acoustic_decoder("energy_decoder"),
        "duration_decoder": acoustic_decoder("duration_decoder"),
        # bins are recomputed from stats; only the embedding tables convert
        "pitch_embedding": _embedding(
            sd, "phoneme2mel.encoder.pitch_decoder.pitch_embedding"),
        "energy_embedding": _embedding(
            sd, "phoneme2mel.encoder.energy_decoder.energy_embedding"),
    }

    dec: dict = {
        "proj_linear": _linear(sd, "phoneme2mel.decoder.proj.0"),
        "proj_norm": _layernorm(sd, "phoneme2mel.decoder.proj.2"),
        "mel_linear": _linear(sd, "phoneme2mel.decoder.mel_linear"),
    }
    for b in range(n_blocks):
        for d in range(block_depth):
            dec[f"block{b}_conv{d}_dw"] = _conv1d(
                sd, f"phoneme2mel.decoder.blocks.{b}.0.{d}.0.0")
            dec[f"block{b}_conv{d}_pw"] = _conv1d(
                sd, f"phoneme2mel.decoder.blocks.{b}.0.{d}.0.1")
            dec[f"block{b}_norm{d}"] = _layernorm(
                sd, f"phoneme2mel.decoder.blocks.{b}.0.{d}.1")
        dec[f"block{b}_skip_norm"] = _layernorm(
            sd, f"phoneme2mel.decoder.blocks.{b}.1")

    params = {"phoneme2mel": {"encoder": encoder_params, "decoder": dec}}
    if any(k.startswith("hifigan.") for k in sd):
        params["hifigan"] = convert_hifigan_state_dict(
            sd, prefix="hifigan.", num_kernels=num_kernels)
    return params


def _torch_load_numpy(path: str) -> StateDict:
    """The tensors of a checkpoint as numpy arrays, on the host.  This
    UNPICKLES the file (``weights_only=False``), as the JAX package's
    loader does: a Lightning ``.ckpt`` carries ``hyper_parameters`` that
    the restricted loader refuses.  Load only files you trust."""
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    elif isinstance(raw, dict) and "generator" in raw:
        raw = raw["generator"]
    return {k: v.detach().cpu().numpy() for k, v in raw.items()
            if hasattr(v, "detach")}


def load_hifigan_checkpoint(path: str, num_kernels: int = 3) -> dict:
    """Load a raw HiFi-GAN ``{"generator": state_dict}`` torch checkpoint
    (reference: model.py:38-42) and convert to our params."""
    return convert_hifigan_state_dict(_torch_load_numpy(path),
                                      num_kernels=num_kernels)


def load_efficientspeech_checkpoint(path: str, depth: int = 2,
                                    n_blocks: int = 2, block_depth: int = 2,
                                    num_kernels: int = 3) -> dict:
    """Load a reference Lightning ``.ckpt`` and convert to our params."""
    return convert_efficientspeech_state_dict(
        _torch_load_numpy(path), depth=depth, n_blocks=n_blocks,
        block_depth=block_depth, num_kernels=num_kernels)
