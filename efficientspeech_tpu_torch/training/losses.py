"""Training losses: mask-weighted means (counterpart of the JAX package's
``training/losses.py``).

``sum(err · m) / sum(m)`` equals the reference's mean over a
``masked_select`` gather, at a static shape.
"""

from typing import Dict, Sequence

import torch

LOSS_WEIGHTS = (10.0, 2.0, 2.0, 1.0)


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of err where mask (True = valid); a trailing channel dim of err
    counts toward the mean, as masked_select does."""
    if err.dim() == mask.dim() + 1:
        mask = mask[..., None]
    weight = mask.to(err.dtype)
    denom = torch.clamp(weight.sum() * (err.numel() / mask.numel()), min=1.0)
    return (err * weight).sum() / denom


def compute_losses(pred: Dict, batch: Dict,
                   weights: Sequence[float] = LOSS_WEIGHTS
                   ) -> Dict[str, torch.Tensor]:
    """pred: the train-mode ``Phoneme2Mel`` output; batch: ``mel`` (B, M,
    80), ``pitch``/``energy`` (B, N) float32, ``duration`` (B, N) int,
    ``phoneme_mask`` (B, N) and ``mel_mask`` (B, M), True = pad.  Returns
    float32 scalars; loss = 10·mel + 2·pitch + 2·energy + duration."""
    phon_valid = ~batch["phoneme_mask"]
    mel_loss = _masked_mean(
        (pred["mel"].float() - batch["mel"].float()).abs(),
        ~batch["mel_mask"])
    pitch_loss = _masked_mean(
        (pred["pitch"][..., 0].float() - batch["pitch"]).square(), phon_valid)
    energy_loss = _masked_mean(
        (pred["energy"][..., 0].float() - batch["energy"]).square(),
        phon_valid)
    # log-domain duration MSE
    dur_pred = pred["duration"][..., 0].float()
    dur_loss = _masked_mean(
        (torch.log(dur_pred + 1.0)
         - torch.log(batch["duration"].float() + 1.0)).square(), phon_valid)
    w_mel, w_pitch, w_energy, w_dur = weights
    total = (w_mel * mel_loss + w_pitch * pitch_loss
             + w_energy * energy_loss + w_dur * dur_loss)
    return {"loss": total, "mel_loss": mel_loss, "pitch_loss": pitch_loss,
            "energy_loss": energy_loss, "duration_loss": dur_loss}
