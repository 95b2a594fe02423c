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
- ``scale`` → LayerNorm ``weight``; ``embedding`` → ``weight``;
- ``bias`` and ``speaker_embedding`` keep their names.
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

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
