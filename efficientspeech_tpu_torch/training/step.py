"""The training and evaluation steps (counterpart of the JAX package's
``training/step.py``): the train-mode forward in the compute dtype on
float32 masters, masked losses, backward, AdamW update.

The forward runs on ``compute_params(model, dtype)`` through
``torch.func.functional_call``: the casts are on the autograd tape, so
the masters receive float32 gradients.  Metrics stay on the device.

With a ``mesh`` each rank runs its rows of the global batch: its losses
are its share of the global losses (``compute_losses`` divides by the
global counts), so summing the gradients over the data group in one
all-reduce gives the gradient of the global loss, the update JAX's
GSPMD step makes.  The models are not wrapped in
``DistributedDataParallel``: the sum is placed here, after
``backward()``, and the vocoder's GAN step, which takes its gradients
with ``torch.autograd.grad``, places its own the same way.
"""

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from efficientspeech_tpu_torch.models.modules import compute_params
from efficientspeech_tpu_torch.parallel.comm import (
    Group, reduce_metrics, sum_gradients)
from efficientspeech_tpu_torch.parallel.mesh import Mesh
from efficientspeech_tpu_torch.training.losses import compute_losses
from efficientspeech_tpu_torch.training.state import (
    TrainState, apply_gradients)


def data_group(mesh: Optional[Mesh]) -> Group:
    """The data-parallel group of ``mesh`` (None without a mesh or on a
    one-rank data axis)."""
    return None if mesh is None else mesh.group("data")


def forward_losses(model, batch: Dict[str, torch.Tensor],
                   dtype: torch.dtype, group: Group = None,
                   loss_batch: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Teacher-forced forward of ``model`` (a ``Phoneme2Mel`` holding
    float32 masters) in ``dtype``, and its losses (this rank's share of
    the global ones over ``group``), taken against ``loss_batch`` where
    given (the same rows with more positions masked)."""
    params = compute_params(model, dtype)
    pred = functional_call(
        model, params, (batch["phoneme"], batch["phoneme_mask"]),
        dict(speaker=batch.get("speaker"), pitch_target=batch["pitch"],
             energy_target=batch["energy"],
             duration_target=batch["duration"], train=True))
    return compute_losses(pred, batch if loss_batch is None else loss_batch,
                          group=group)


def make_train_step(dtype: torch.dtype = torch.bfloat16,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict]]:
    """train_step(state, batch) → (state, metrics).  The batch's tensors
    are on the model's device (on a mesh: this rank's rows); after the
    step the masters' ``.grad`` hold the step's gradients (on a mesh
    their sum over the data group), and every rank's metrics are the
    global ones."""
    group = data_group(mesh)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict]:
        state.optimizer.zero_grad(set_to_none=False)
        losses = forward_losses(state.model, batch, dtype, group)
        losses["loss"].backward()
        sum_gradients(state.model.parameters(), group)
        state = apply_gradients(state)
        return state, reduce_metrics(losses, group)

    return train_step


def make_eval_step(dtype: torch.dtype = torch.bfloat16,
                   mesh: Optional[Mesh] = None):
    """eval_step(model, batch) → the teacher-forced losses, no grad (on a
    mesh the global losses of the ranks' rows)."""
    group = data_group(mesh)

    @torch.no_grad()
    def eval_step(model, batch: Dict) -> Dict[str, torch.Tensor]:
        return reduce_metrics(forward_losses(model, batch, dtype, group),
                              group)

    return eval_step
