"""Train state: float32 master parameters, AdamW and the step count
(counterpart of the JAX package's ``training/state.py``).

``torch.optim.AdamW`` with the learning rate set before each step is
optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay
``lr·wd·p`` on every parameter): the rate is the schedule at the step
count before the step, as optax's ``scale_by_schedule`` reads it.  The
JAX package's ``flat_optimizer`` option (measured slower there) is not
ported.
"""

import dataclasses
from typing import Callable

import torch
from torch import nn

from efficientspeech_tpu_torch.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module                    # float32 masters
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]


def make_optimizer(model: nn.Module, train_cfg: TrainConfig
                   ) -> torch.optim.AdamW:
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=train_cfg.weight_decay)


def create_train_state(model: nn.Module, train_cfg: TrainConfig,
                       schedule: Callable[[int], float]) -> TrainState:
    """Every parameter gets a gradient buffer, zero where a forward does
    not reach it (the pitch and energy decoders' norm2), so AdamW decays
    every parameter, as optax does."""
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model, train_cfg),
                      schedule=schedule)


def apply_gradients(state: TrainState) -> TrainState:
    """One AdamW update from the gradients in the masters' ``.grad``."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1
    return state
