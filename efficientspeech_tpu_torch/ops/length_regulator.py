"""Static-shape length regulator (duration-driven feature upsampling).

With ``cum = cumsum(durations)``, mel frame ``f`` belongs to the first
phoneme ``j`` with ``cum[j] > f``, i.e. ``searchsorted(cum, f,
right=True)``.  A gather plus the mask ``f < mel_len`` equals
repeat_interleave + padding at a fixed (max_mel_len) output shape, so the
mel length never has to reach the host.
"""

from typing import Tuple

import torch


def length_regulate(features: torch.Tensor, durations: torch.Tensor,
                    max_mel_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """features (B, N, C), durations (B, N) non-negative ints (padded
    phonemes carry 0) → (frames (B, M, C) zero beyond mel_len,
    frame_valid (B, M) bool, mel_len (B,) int32, which may exceed M)."""
    durations = durations.to(torch.int32)
    cum = torch.cumsum(durations, dim=1, dtype=torch.int32)     # (B, N)
    mel_len = cum[:, -1]
    b = features.shape[0]
    frame_pos = torch.arange(max_mel_len, dtype=torch.int32,
                             device=features.device)
    frame_valid = frame_pos[None, :] < mel_len[:, None]          # (B, M)
    idx = torch.searchsorted(cum, frame_pos.expand(b, -1).contiguous(),
                             right=True)
    idx = idx.clamp_max(features.shape[1] - 1)
    frames = torch.gather(
        features, 1, idx[:, :, None].expand(-1, -1, features.shape[2]))
    frames = torch.where(frame_valid[:, :, None], frames,
                         torch.zeros_like(frames))
    return frames, frame_valid, mel_len
