"""The collectives the port places itself (XLA inserts them for the JAX
package): a sum, an all-gather and a halo exchange, all built on
``dist.all_reduce`` alone, and the differentiable forms that tensor
parallelism needs: the all-gather of a column-parallel output (backward:
this rank's slice) and the sum of row-parallel partials (backward: the
identity), with their duals on the way in, the slice of a row-parallel
input (backward: the gather) and the copy of a column-parallel input
(backward: the sum of the ranks' partial input gradients).

One primitive keeps one code path for gloo on the CPU, gloo on CUDA
tensors (which supports only broadcast and all-reduce) and NCCL.  An
all-gather writes this rank's slot of a zeroed buffer and sums the
buffers; a halo exchange does the same with each rank's edge rows.  The
sum adds zeros to each value, so the gathered values are exact.
Transport is float32 (gloo has no bf16 reduction everywhere); a lower
float dtype is widened and narrowed back, which is exact.

``group`` None means a one-rank axis: every function is then the
identity.
"""

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _wide(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() and t.dtype != torch.float32 \
        and t.dtype != torch.float64 else t


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks (a new tensor; ``t`` is
    left as it was)."""
    if group is None:
        return t
    buf = _wide(t).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, group: Group, dim: int = -1
               ) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order: this
    rank's slot of a zeroed buffer, summed over the group."""
    n = group_size(group)
    if n == 1:
        return t
    dim = dim % t.dim()
    src = _wide(t)
    buf = src.new_zeros((n,) + tuple(src.shape))
    buf[group_rank(group)] = src
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return torch.cat(buf.unbind(0), dim=dim).to(t.dtype)


def local_slice(t: torch.Tensor, group: Group, dim: int = -1
                ) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dimension {size} does not split over {n} ranks")
    k = size // n
    return t.narrow(dim, group_rank(group) * k, k)


def halo_exchange(x: torch.Tensor, w: int, group: Group, dim: int = 1
                  ) -> torch.Tensor:
    """x (..., T_local, ...) → (..., T_local + 2w, ...) along ``dim``: the
    left neighbour's last ``w`` rows before, the right neighbour's first
    ``w`` after, zeros at the ends of the global axis (the zero padding
    of the single-device window).  Each rank needs ``T_local >= w``."""
    if w == 0:
        return x
    n, i = group_size(group), group_rank(group)
    first, last = x.narrow(dim, 0, w), x.narrow(dim, x.shape[dim] - w, w)
    if n == 1:
        left, right = torch.zeros_like(last), torch.zeros_like(first)
    else:
        src = _wide(x)
        # slot [rank, 0] its first rows, [rank, 1] its last
        buf = src.new_zeros((n, 2) + tuple(first.shape))
        buf[i, 0] = _wide(first)
        buf[i, 1] = _wide(last)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        zeros = torch.zeros_like(buf[0, 0])
        left = (buf[i - 1, 1] if i > 0 else zeros).to(x.dtype)
        right = (buf[i + 1, 0] if i < n - 1 else zeros).to(x.dtype)
    return torch.cat([left, x, right], dim=dim)


class _Gather(torch.autograd.Function):
    """All-gather along the last dim; backward: this rank's slice of the
    incoming gradient (every rank computes the same loss from the
    gathered tensor, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return local_slice(grad, ctx.group, dim=-1).contiguous(), None


class _Split(torch.autograd.Function):
    """This rank's slice of the last dim of a replicated tensor; backward:
    the ranks' slice gradients gathered, so the replicated input gets the
    whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return local_slice(x, group, dim=-1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, dim=-1), None


class _ReduceSum(torch.autograd.Function):
    """Sum of the ranks' partial results; backward: the identity (each
    partial sum enters the total once)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """The identity on a replicated input; backward: the sum of the ranks'
    partial gradients (each rank's column shard gives only its share of
    the input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


def copy_in(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable identity whose backward sums over the group."""
    return x if group is None else _Copy.apply(x, group)


def gather_last(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable all-gather of column shards (last dim)."""
    return x if group is None else _Gather.apply(x, group)


def split_last(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable slice of a replicated tensor's last dim."""
    return x if group is None else _Split.apply(x, group)


def reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable sum of partial results over the group."""
    return x if group is None else _ReduceSum.apply(x, group)


def sum_gradients(params, group: Group, scale: float = 1.0):
    """Sum the ``.grad`` of ``params`` over the group in one all-reduce of
    one flat buffer, then multiply by ``scale``; every parameter must
    hold a gradient."""
    params = list(params)
    if group is None and scale == 1.0:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    if group is not None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset: offset + n].view_as(p.grad))
        offset += n


def reduce_metrics(metrics, group: Group, scale: float = 1.0):
    """{name: scalar tensor} summed over the group in one all-reduce,
    times ``scale``, detached."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is None and scale == 1.0:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].float() for k in keys])
    if group is not None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if scale != 1.0:
        flat = flat * scale
    return dict(zip(keys, flat.unbind(0)))
