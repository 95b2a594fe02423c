"""The training and evaluation steps (counterpart of the JAX package's
``training/step.py``): the train-mode forward in the compute dtype on
float32 masters, masked losses, backward, AdamW update.

The forward runs on ``compute_params(model, dtype)`` through
``torch.func.functional_call``: the casts are on the autograd tape, so
the masters receive float32 gradients.  Metrics stay on the device.
"""

from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call

from efficientspeech_tpu_torch.models.modules import compute_params
from efficientspeech_tpu_torch.training.losses import compute_losses
from efficientspeech_tpu_torch.training.state import (
    TrainState, apply_gradients)


def forward_losses(model, batch: Dict[str, torch.Tensor],
                   dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Teacher-forced forward of ``model`` (a ``Phoneme2Mel`` holding
    float32 masters) in ``dtype``, and its losses."""
    params = compute_params(model, dtype)
    pred = functional_call(
        model, params, (batch["phoneme"], batch["phoneme_mask"]),
        dict(speaker=batch.get("speaker"), pitch_target=batch["pitch"],
             energy_target=batch["energy"],
             duration_target=batch["duration"], train=True))
    return compute_losses(pred, batch)


def make_train_step(dtype: torch.dtype = torch.bfloat16
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """train_step(state, batch) → (state, metrics).  The batch's tensors
    are on the model's device; after the step the masters' ``.grad`` hold
    the step's gradients."""

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        state.optimizer.zero_grad(set_to_none=False)
        losses = forward_losses(state.model, batch, dtype)
        losses["loss"].backward()
        state = apply_gradients(state)
        return state, {k: v.detach() for k, v in losses.items()}

    return train_step


def make_eval_step(dtype: torch.dtype = torch.bfloat16):
    """eval_step(model, batch) → the teacher-forced losses, no grad."""

    @torch.no_grad()
    def eval_step(model, batch: Dict) -> Dict[str, torch.Tensor]:
        return forward_losses(model, batch, dtype)

    return eval_step
