"""Sequence-parallel folded vocoder: the frame axis split over ranks
(counterpart of the JAX package's ``parallel/seq_vocoder.py``).

The folded generator (``models/hifigan_folded.py``) is a chain of
windowed products ``y[t] = concat(x[t−w..t+w]) @ W``: a halo pattern.
For long-form synthesis each rank holds a contiguous block of frames,
and before each op it takes ``w`` edge rows from each neighbour
(``comm.halo_exchange``; zeros at the ends of the global axis, the zero
padding of the single-device window):

- each op applies its pre-activation first, so the halos carry activated
  rows;
- row masks compare global row indices (the shard's offset added), so a
  valid length that ends in an earlier shard masks there as on one
  device;
- the polyphase row split is per row, so it stays local;
- the product is ``torch.matmul`` on the concatenated window with the
  operands rounded to ``dtype`` and float32 products and sums, as the
  plain folded route computes it (the JAX package uses ``jnp.dot``
  outside any Pallas kernel here too).

Halos are one hop: each shard must hold at least the widest window.
"""

from typing import Dict, Optional

import torch

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.hifigan_folded import LRELU_SLOPE
from efficientspeech_tpu_torch.ops.kernels.folded_matmul import leaky
from efficientspeech_tpu_torch.parallel.comm import halo_exchange
from efficientspeech_tpu_torch.parallel.mesh import Mesh, shard_rows


def _windowed_matmul(xp: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
                     w: int, dtype) -> torch.Tensor:
    """xp (B, Tl + 2w, D_in) with its halos → (B, Tl, D_out) float32."""
    t = xp.shape[1] - 2 * w
    window = xp if w == 0 else torch.cat(
        [xp[:, i: i + t] for i in range(2 * w + 1)], dim=-1)
    return (window.to(dtype).float() @ W.to(dtype).float()
            + b.to(dtype).float())


def seq_parallel_vocode(arrays: Dict, meta, cfg: HifiGanConfig,
                        mel: torch.Tensor, mesh: Mesh,
                        valid_len: Optional[torch.Tensor] = None,
                        axis: str = "sp", batch_axis: Optional[str] = None,
                        dtype=torch.bfloat16) -> torch.Tensor:
    """mel (B, T, n_mels), the whole batch on every rank, with T divisible
    by the ``axis`` size → this rank's block of the waveform, (B_local,
    T / n · total_upsample): rows ``batch_axis``'s split of B (all of B
    without one), samples the rank's frames [i·T/n, (i+1)·T/n) times the
    upsampling.  Rank order along ``axis`` is frame order, so the blocks
    concatenated in rank order are the single-device waveform.

    ``arrays``/``meta`` from ``fold_hifigan`` (on this rank's device).
    ``valid_len`` (B,) int: frames past it are masked, as
    ``folded_plan_apply`` masks them.  ``batch_axis`` composes the split
    with data parallelism: the halos ride ``axis`` alone.  ResBlock "1"
    generators, as in the JAX package."""
    if cfg.resblock != "1":
        raise ValueError("the sequence-parallel vocoder takes ResBlock 1")
    n = mesh.axis_size(axis)
    if mel.shape[1] % n:
        raise ValueError(f"{mel.shape[1]} frames do not split over {n} "
                         f"{axis!r} ranks")
    widths, reshape = meta["widths"], meta["reshape"]
    valid_mult = meta["valid_mult"]
    # halos are one hop: a shard holds at least the widest window (rows
    # a shard only grow downstream, widths only shrink)
    if mel.shape[1] // n < max(widths.values()):
        raise ValueError(f"frames/shard {mel.shape[1] // n} < max window "
                         f"{max(widths.values())}")
    if valid_len is None:
        valid_len = torch.full((mel.shape[0],), mel.shape[1],
                               dtype=torch.int32, device=mel.device)
    rows = (shard_rows(mel.shape[0], mesh, batch_axis)
            if batch_axis is not None else slice(None))
    frames = shard_rows(mel.shape[1], mesh, axis)
    x = mel[rows, frames].float()
    vlen = valid_len[rows]
    group = mesh.group(axis)
    idx = mesh.index(axis)
    num_kernels = len(cfg.resblock_kernel_sizes)

    def apply_op(inp, key, pre_lrelu, slope=LRELU_SLOPE, residual=None):
        W, b = arrays[key]
        w = widths[key]
        src = leaky(inp, slope) if pre_lrelu else inp
        out = _windowed_matmul(halo_exchange(src, w, group), W, b, w, dtype)
        if residual is not None:
            out = out + residual
        # mask with global row indices
        tl = out.shape[1]
        grow = torch.arange(tl, device=out.device) + idx * tl
        keep = grow[None, :] < (vlen * valid_mult[key])[:, None]
        out = torch.where(keep[:, :, None], out, torch.zeros_like(out))
        split = reshape.get(key, 1)
        if split > 1:
            b_, t_, d_ = out.shape
            out = out.reshape(b_, t_ * split, d_ // split)
        return out

    x = apply_op(x, "pre", pre_lrelu=False)
    for i in range(len(cfg.upsample_rates)):
        x = apply_op(x, f"up{i}", pre_lrelu=True)
        xs = None
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            v = x
            for m in range(len(rd)):
                t1 = apply_op(v, f"rb{i}_{j}_c1_{m}", pre_lrelu=True)
                v = apply_op(t1, f"rb{i}_{j}_c2_{m}", pre_lrelu=True,
                             residual=v)
            xs = v if xs is None else xs + v
        x = xs / num_kernels
    # the final activation uses torch's default slope 0.01
    x = torch.tanh(apply_op(x, "post", pre_lrelu=True, slope=0.01))
    b_, t_, d_ = x.shape
    return x.reshape(b_, t_ * d_)
