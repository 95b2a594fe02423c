"""Training losses: mask-weighted means (counterpart of the JAX package's
``training/losses.py``).

``sum(err · m) / sum(m)`` equals the reference's mean over a
``masked_select`` gather, at a static shape.

On a data-parallel mesh each rank holds some rows of the global batch,
and the JAX package's loss is the mean over all of them.  So each rank
divides its masked sum by the global count (summed over the data group
in one all-reduce, outside the gradient, clamped to 1 as a whole): the
ranks' losses then add up to the global loss, and their gradients to
its gradient.  A mean of per-rank means would weight each rank alike,
whatever its number of valid frames.
"""

from typing import Dict, Sequence

import torch

from efficientspeech_tpu_torch.parallel.comm import Group, all_reduce_sum

LOSS_WEIGHTS = (10.0, 2.0, 2.0, 1.0)


def _masked_sum_count(err: torch.Tensor, mask: torch.Tensor):
    """(sum of err where mask, the count of those elements); a trailing
    channel dim of err counts toward the mean, as masked_select does."""
    if err.dim() == mask.dim() + 1:
        mask = mask[..., None]
    weight = mask.to(err.dtype)
    return (err * weight).sum(), weight.sum() * (err.numel() / mask.numel())


def compute_losses(pred: Dict, batch: Dict,
                   weights: Sequence[float] = LOSS_WEIGHTS,
                   group: Group = None) -> Dict[str, torch.Tensor]:
    """pred: the train-mode ``Phoneme2Mel`` output; batch: ``mel`` (B, M,
    80), ``pitch``/``energy`` (B, N) float32, ``duration`` (B, N) int,
    ``phoneme_mask`` (B, N) and ``mel_mask`` (B, M), True = pad.  Returns
    float32 scalars; loss = 10·mel + 2·pitch + 2·energy + duration.
    ``group``: the data-parallel group whose ranks hold the rest of the
    batch; each rank's losses are then its share of the global ones."""
    phon_valid = ~batch["phoneme_mask"]
    dur_pred = pred["duration"][..., 0].float()
    parts = [
        _masked_sum_count((pred["mel"].float() - batch["mel"].float()).abs(),
                          ~batch["mel_mask"]),
        _masked_sum_count((pred["pitch"][..., 0].float()
                           - batch["pitch"]).square(), phon_valid),
        _masked_sum_count((pred["energy"][..., 0].float()
                           - batch["energy"]).square(), phon_valid),
        # log-domain duration MSE
        _masked_sum_count((torch.log(dur_pred + 1.0)
                           - torch.log(batch["duration"].float() + 1.0)
                           ).square(), phon_valid)]
    counts = [c for _, c in parts]
    if group is not None:
        counts = all_reduce_sum(torch.stack(counts).detach(),
                                group).unbind(0)
    mel_loss, pitch_loss, energy_loss, dur_loss = (
        s / torch.clamp(c, min=1.0) for (s, _), c in zip(parts, counts))
    w_mel, w_pitch, w_energy, w_dur = weights
    total = (w_mel * mel_loss + w_pitch * pitch_loss
             + w_energy * energy_loss + w_dur * dur_loss)
    return {"loss": total, "mel_loss": mel_loss, "pitch_loss": pitch_loss,
            "energy_loss": energy_loss, "duration_loss": dur_loss}
