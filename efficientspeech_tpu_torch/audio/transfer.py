"""PCM wire formats between the card and the host.

The waveform is encoded on the card, so that only the chosen format's
bytes cross to the host, and decoded there:

- ``"f32"``   raw float32 (4 B/sample), exact;
- ``"int16"`` linear 16-bit PCM (2 B/sample), the WAV format itself;
- ``"mulaw"`` G.711-style µ-law 8-bit PCM (1 B/sample); decode is a
  256-entry table lookup.
"""

import numpy as np
import torch

MULAW_MU = 255.0

# host-side decode table: uint8 code -> float32 sample
_dec_y = (np.arange(256, dtype=np.float64) / 127.5) - 1.0
MULAW_DECODE_LUT = (np.sign(_dec_y)
                    * ((1.0 + MULAW_MU) ** np.abs(_dec_y) - 1.0)
                    / MULAW_MU).astype(np.float32)

FORMATS = ("f32", "int16", "mulaw")


def encode_device(wav: torch.Tensor, fmt: str) -> torch.Tensor:
    """Encode a float waveform (values in [-1, 1]) on its device."""
    if fmt == "f32":
        return wav.float()
    if fmt == "int16":
        return torch.clamp(wav.float() * 32768.0,
                           -32768.0, 32767.0).to(torch.int16)
    if fmt == "mulaw":
        x = torch.clamp(wav.float(), -1.0, 1.0)
        y = (torch.sign(x) * torch.log1p(MULAW_MU * torch.abs(x))
             / float(np.log1p(MULAW_MU)))
        return torch.round((y + 1.0) * 127.5).to(torch.uint8)
    raise ValueError(f"unknown transfer format {fmt!r}; pick from {FORMATS}")


def decode_host(arr: np.ndarray, fmt: str) -> np.ndarray:
    """Decode a fetched wire buffer back to float32 on the host."""
    arr = np.asarray(arr)
    if fmt == "f32":
        return arr.astype(np.float32, copy=False)
    if fmt == "int16":
        return arr.astype(np.float32) / 32768.0
    if fmt == "mulaw":
        return MULAW_DECODE_LUT[arr]
    raise ValueError(f"unknown transfer format {fmt!r}; pick from {FORMATS}")
