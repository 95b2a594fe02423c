"""Tensor-parallel rules for the ("data", "model") mesh (counterpart of the
JAX package's ``parallel/sharding.py``).

The JAX package annotates four kernels of every encoder stage and lets
GSPMD partition the products:

  attention qkv   (in, 3·H·dim)  column-parallel  P(None, "model")
  attention proj  (H·dim, dim)   row-parallel     P("model", None)
  mixffn mlp1     (dim, hidden)  column-parallel
  mixffn mlp2     (hidden, dim)  row-parallel

Everything else is replicated.  A kernel is sharded only where its
dimension divides by the model size.  Here the rules pick the same
Linear modules by the port's parameter names (torch's (out, in)
weights, so a column split is over dim 0 and a row split over dim 1),
and ``shard_tensor_parallel`` puts modules in their place that hold this
rank's slice and place the collectives: a column-parallel linear
gathers its output columns (the ``qkv`` split matches neither q/k/v nor
the heads, so the whole projection is gathered before the attention's
reshape), a row-parallel one takes its slice of the input, sums the
partial products over the model group and adds the bias once.  Biases
are replicated, as the JAX rules leave them.  AdamW built on the
sharded model keeps its moments on the local shards; ``gather_params``
rebuilds the whole state dict, for checkpoints and
``weights.to_jax_params``.
"""

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from efficientspeech_tpu_torch.models.modules import Linear
from efficientspeech_tpu_torch.parallel.comm import (
    Group, all_gather, copy_in, gather_last, group_size, local_slice,
    reduce_sum, split_last)
from efficientspeech_tpu_torch.parallel.mesh import Mesh

# (weight name, kind, the torch weight's split dim)
TP_RULES = [
    (re.compile(r"(.*\.)?attn\.qkv\.weight$"), "column", 0),
    (re.compile(r"(.*\.)?attn\.proj\.weight$"), "row", 1),
    (re.compile(r"(.*\.)?mixffn\.mlp1\.weight$"), "column", 0),
    (re.compile(r"(.*\.)?mixffn\.mlp2\.weight$"), "row", 1),
]


def _rule(name: str, weight: torch.Tensor, model_size: int
          ) -> Optional[Tuple[str, int]]:
    if model_size > 1:
        for rx, kind, dim in TP_RULES:
            if rx.match(name) and weight.shape[dim] % model_size == 0:
                return kind, dim
    return None


def tp_param_shardings(model: nn.Module, mesh: Mesh
                       ) -> Dict[str, Optional[Tuple[int, int]]]:
    """{parameter name: (split dim of its torch weight, model size), or
    None where it is replicated}, by the rules on the unsharded model."""
    n = mesh.axis_size("model")
    out = {}
    for name, p in model.named_parameters():
        rule = _rule(name, p, n)
        out[name] = None if rule is None else (rule[1], n)
    return out


class ColumnParallelLinear(Linear):
    """This rank's rows of a Linear's (out, in) weight; the output columns
    gathered over the model group, then the whole bias added."""

    def __init__(self, full: Linear, group: Group):
        nn.Module.__init__(self)
        self.group = group
        self.weight = nn.Parameter(
            local_slice(full.weight.detach(), group, dim=0).clone())
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach().clone()))

    def forward(self, x):
        x = copy_in(x.to(self.weight.dtype), self.group)
        y = gather_last(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class RowParallelLinear(Linear):
    """This rank's columns of a Linear's (out, in) weight, applied to its
    slice of the input; the partial products summed over the model
    group, then the bias added once."""

    def __init__(self, full: Linear, group: Group):
        nn.Module.__init__(self)
        self.group = group
        self.weight = nn.Parameter(
            local_slice(full.weight.detach(), group, dim=1).clone())
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach().clone()))

    def forward(self, x):
        x = split_last(x.to(self.weight.dtype), self.group)
        y = reduce_sum(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


_KINDS = {"column": ColumnParallelLinear, "row": RowParallelLinear}


def shard_tensor_parallel(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace, in place, each Linear the rules shard with its parallel
    form holding this rank's slice (parameter names unchanged, shapes
    local).  Build the optimizer after this."""
    group = mesh.group("model")
    n = group_size(group)
    for name, module in list(model.named_modules()):
        if type(module) is not Linear:
            continue
        rule = _rule(f"{name}.weight", module.weight, n)
        if rule is None:
            continue
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, attr,
                _KINDS[rule[0]](module, group))
    return model


def gather_params(model: nn.Module,
                  values: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """The unsharded state dict of a ``shard_tensor_parallel`` model: each
    sharded weight gathered along its split dim over the model group
    (every rank of the group must call this).  ``values``: {parameter
    name: a tensor shaped like the local parameter} to gather in place of
    the parameters, such as their gradients."""
    state = {}
    for name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            key = f"{name}.{pname}" if name else pname
            t = (p if values is None else values[key]).detach()
            if pname == "weight" and isinstance(module, ColumnParallelLinear):
                t = all_gather(t, module.group, dim=0)
            elif pname == "weight" and isinstance(module, RowParallelLinear):
                t = all_gather(t, module.group, dim=1)
            state[key] = t.clone()
    return state
