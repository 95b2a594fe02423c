"""Checkpoints of the train state: ``{step, params, optimizer}`` written
with ``torch.save`` as ``<dir>/step_<8 digits>.pt`` (counterpart of the
JAX package's ``training/checkpoint.py``).

This is the port's own format: the JAX package's orbax directories
cannot be read without JAX, and the port does not read them.  ``params``
is the model's state dict, in the parameter names that
``weights.from_jax_params`` produces.
"""

import os
import re
from typing import Optional

import torch

from efficientspeech_tpu_torch.training.state import TrainState

_NAME = re.compile(r"^step_(\d{8})\.pt$")


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    ckpt_dir = os.path.abspath(os.path.expanduser(ckpt_dir))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}.pt")
    tmp = path + ".tmp"
    torch.save({"step": state.step, "params": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    ckpt_dir = os.path.abspath(os.path.expanduser(ckpt_dir))
    if not os.path.isdir(ckpt_dir):
        return None
    names = sorted(n for n in os.listdir(ckpt_dir) if _NAME.match(n))
    return os.path.join(ckpt_dir, names[-1]) if names else None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into ``state`` (its model and optimizer, on their
    device)."""
    dev = next(state.model.parameters()).device
    payload = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(payload["params"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state
