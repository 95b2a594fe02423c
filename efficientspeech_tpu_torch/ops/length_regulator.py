"""Static-shape length regulator (duration-driven feature upsampling).

With ``cum = cumsum(durations)``, mel frame ``f`` belongs to the first
phoneme ``j`` with ``cum[j] > f``, i.e. ``searchsorted(cum, f,
right=True)``, which is also the count of ``cum[j] <= f`` (the form an
ONNX export takes).  A gather plus the mask ``f < mel_len`` equals
repeat_interleave + padding at a fixed (max_mel_len) output shape, so the
mel length never has to reach the host.

Training in bf16 expands through a one-hot product instead
(``via_matmul``): each output row selects one feature row, so 1.0 × bf16
accumulated in float32 is bit-exact with the gather, and the backward is
a product instead of the gather's scatter-add.
"""

from typing import Tuple

import torch


def length_regulate(features: torch.Tensor, durations: torch.Tensor,
                    max_mel_len: int, via_matmul: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """features (B, N, C), durations (B, N) non-negative ints (padded
    phonemes carry 0) → (frames (B, M, C) zero beyond mel_len,
    frame_valid (B, M) bool, mel_len (B,) int32, which may exceed M).
    ``via_matmul`` takes the one-hot product for bf16 features (other
    dtypes keep the gather, as the JAX package does)."""
    durations = durations.to(torch.int32)
    cum = torch.cumsum(durations, dim=1, dtype=torch.int32)     # (B, N)
    mel_len = cum[:, -1]
    b = features.shape[0]
    frame_pos = torch.arange(max_mel_len, dtype=torch.int32,
                             device=features.device)
    frame_valid = frame_pos[None, :] < mel_len[:, None]          # (B, M)
    if via_matmul and features.dtype == torch.bfloat16:
        # onehot[b, f, j] = 1 iff cum[b, j-1] <= f < cum[b, j]
        prev = cum - durations
        f = frame_pos[None, :, None]
        onehot = (f < cum[:, None, :]) & (f >= prev[:, None, :])
        frames = torch.bmm(onehot.to(features.dtype), features)
        frames = torch.where(frame_valid[:, :, None], frames,
                             torch.zeros_like(frames))
        return frames, frame_valid, mel_len
    if torch.onnx.is_in_onnx_export():
        # aten::searchsorted has no ONNX export; this count is the same
        # index, at (B, M, N) memory, which only the fixed-size exported
        # graph can afford
        idx = (cum[:, None, :] <= frame_pos[None, :, None]).sum(-1)
    else:
        idx = torch.searchsorted(cum, frame_pos.expand(b, -1).contiguous(),
                                 right=True)
    # a Python int: under torch.jit.trace a size is a CPU tensor, which
    # clamp_max refuses beside a CUDA one
    idx = idx.clamp_max(int(features.shape[1]) - 1)
    frames = torch.gather(
        features, 1, idx[:, :, None].expand(-1, -1, features.shape[2]))
    # masked_fill keeps a traced graph (ONNX) free of a zero tensor of
    # the frames' size
    frames = frames.masked_fill(~frame_valid[:, :, None], 0.0)
    return frames, frame_valid, mel_len
