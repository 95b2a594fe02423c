"""Weights for the port's modules: the bridge from the JAX package's
parameter tree, and a native seeded init.

The JAX tree (from its ``host_init``, ``restore_params`` or checkpoint
conversion) is a nested dict of numpy arrays with the subtrees
``phoneme2mel`` and ``hifigan``.  Its module paths are the port's module
paths; only the leaf names and layouts differ:

- ``kernel`` (in, out) → Linear ``weight`` (out, in);
- ``kernel`` (k, in/groups, out) → Conv1d ``weight`` (out, in/groups, k);
- ``kernel`` (k, in, out) of a transposed conv (``up<i>``,
  ``upsample<i>``) → ConvTranspose1d ``weight`` (in, out, k);
- ``kernel`` (kh, kw, in, out) → Conv2d ``weight`` (out, in, kh, kw);
- ``scale`` → LayerNorm ``weight``; ``embedding`` → ``weight``;
- ``bias`` and ``speaker_embedding`` keep their names.
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from efficientspeech_tpu_torch.models import modules
from efficientspeech_tpu_torch.models.acoustic import ScalarEmbedding
from efficientspeech_tpu_torch.models.modules import reset_parameters

_TRANSPOSED = re.compile(r"^(up|upsample)\d+$")


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree → the port's state dict (float32 copies)."""
    state = {}
    for path, leaf in _flatten(tree):
        *mods, name = path
        arr = np.asarray(leaf, np.float32)
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3 and _TRANSPOSED.match(mods[-1]):
                arr = arr.transpose(1, 2, 0)
            elif arr.ndim == 3:
                arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel "
                                 f"shape {arr.shape}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name not in ("bias", "speaker_embedding"):
            raise ValueError(f"{'/'.join(path)}: unknown leaf {name!r}")
        state[".".join([*mods, name])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return state


# the JAX leaf name of each module class's ``weight``
_WEIGHT_LEAF = {modules.Linear: "kernel", modules.Conv1d: "kernel",
                modules.Conv2d: "kernel",
                modules.ConvTranspose1d: "kernel", modules.LayerNorm: "scale",
                modules.Embedding: "embedding", ScalarEmbedding: "embedding"}


def to_jax_params(model: nn.Module) -> Dict:
    """The exact inverse of ``from_jax_params``: the model's parameters as
    a JAX parameter tree of float32 numpy arrays (what
    ``convert/to_torch.py`` writes out in the reference's formats)."""
    tree: Dict = {}
    for mod_name, mod in model.named_modules():
        for name, param in mod.named_parameters(recurse=False):
            arr = param.detach().float().cpu().numpy()
            path = mod_name.split(".") if mod_name else []
            if name == "weight":
                name = _WEIGHT_LEAF[type(mod)]
                if name == "kernel" and arr.ndim == 2:
                    arr = arr.T
                elif name == "kernel" and isinstance(
                        mod, modules.ConvTranspose1d):
                    arr = arr.transpose(2, 0, 1)
                elif name == "kernel" and arr.ndim == 4:
                    arr = arr.transpose(2, 3, 1, 0)
                elif name == "kernel":
                    arr = arr.transpose(2, 1, 0)
            elif name not in ("bias", "speaker_embedding"):
                raise ValueError(f"{mod_name}.{name}: unknown parameter")
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[name] = np.ascontiguousarray(arr)
    return tree


def load_jax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX parameter tree into ``model``; a leaf the model lacks, a
    parameter the tree lacks, or a shape mismatch raises."""
    state = from_jax_params(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    for key, val in state.items():
        if tuple(own[key].shape) != tuple(val.shape):
            raise ValueError(f"{key}: shape {tuple(val.shape)} does not fit "
                             f"{tuple(own[key].shape)}")
    model.load_state_dict(state, strict=True)
    return model


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Native random init from a seeded ``torch.Generator`` (torch's
    default bounds: uniform ±1/√fan_in kernels and biases, N(0, 1)
    embeddings, LayerNorm 1/0)."""
    reset_parameters(model, seed)
    return model


def set_duration_bias(model: nn.Module, bias: float) -> nn.Module:
    """The ``bench_duration_bias`` knob: with random weights the duration
    head predicts ~0 frames; its bias sets a realistic frame count."""
    with torch.no_grad():
        model.phoneme2mel.encoder.duration_decoder.linear.bias.fill_(
            float(bias))
    return model
