"""PCM wire formats between the card and the host.

The waveform is encoded on the card, so that only the chosen format's
bytes cross to the host, and decoded there:

- ``"f32"``    raw float32 (4 B/sample), exact;
- ``"int16"``  linear 16-bit PCM (2 B/sample), the WAV format itself;
- ``"mulaw"``  G.711-style µ-law 8-bit PCM (1 B/sample); decode is a
  256-entry table lookup;
- ``"adpcm4"`` fixed-step block-ADPCM, 4.125 bits/sample (see
  ``audio/adpcm.py``; its encoder is a CUDA kernel on the card);
- ``"adpcm3"`` the 3-bit variant, 3.125 bits/sample;
- ``"adpcm2"`` the 2-bit variant, 2.125 bits/sample (audibly gritty:
  for callers bound by the wire's bandwidth).

The ADPCM formats need the sample count to be a multiple of their
256-sample block, as every serving buffer is (a mel frame is 256
samples).
"""

import numpy as np
import torch

from efficientspeech_tpu_torch.audio import adpcm

MULAW_MU = 255.0

# host-side decode table: uint8 code -> float32 sample
_dec_y = (np.arange(256, dtype=np.float64) / 127.5) - 1.0
MULAW_DECODE_LUT = (np.sign(_dec_y)
                    * ((1.0 + MULAW_MU) ** np.abs(_dec_y) - 1.0)
                    / MULAW_MU).astype(np.float32)

# the block codecs: encoder on the card, decoder on the host, wire sizes
_ADPCM = {
    "adpcm4": (adpcm.encode_blocks_device, adpcm.decode_blocks_host,
               adpcm.elements_for_samples, adpcm.samples_for_elements),
    "adpcm3": (adpcm.encode3_blocks_device, adpcm.decode3_blocks_host,
               adpcm.elements3_for_samples, adpcm.samples3_for_elements),
    "adpcm2": (adpcm.encode2_blocks_device, adpcm.decode2_blocks_host,
               adpcm.elements2_for_samples, adpcm.samples2_for_elements),
}

FORMATS = ("f32", "int16", "mulaw") + tuple(_ADPCM)


def encode_device(wav: torch.Tensor, fmt: str) -> torch.Tensor:
    """Encode a float waveform (values in [-1, 1]) on its device.  The
    ADPCM formats take (B, T), T a multiple of 256."""
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
    if fmt in _ADPCM:
        return _ADPCM[fmt][0](wav)
    raise ValueError(f"unknown transfer format {fmt!r}; pick from {FORMATS}")


def decode_host(arr: np.ndarray, fmt: str) -> np.ndarray:
    """Decode a fetched wire buffer back to float32 on the host.  The
    ADPCM formats decode whole blocks, so the caller trims the samples."""
    arr = np.asarray(arr)
    if fmt == "f32":
        return arr.astype(np.float32, copy=False)
    if fmt == "int16":
        return arr.astype(np.float32) / 32768.0
    if fmt == "mulaw":
        return MULAW_DECODE_LUT[arr]
    if fmt in _ADPCM:
        return _ADPCM[fmt][1](arr)
    raise ValueError(f"unknown transfer format {fmt!r}; pick from {FORMATS}")


def bytes_per_sample(fmt: str) -> float:
    return {"f32": 4, "int16": 2, "mulaw": 1, "adpcm4": 0.516,
            "adpcm3": 0.391, "adpcm2": 0.266}[fmt]


def elements_for_samples(fmt: str, n_samples: int) -> int:
    """Length of the wire array that carries n_samples (whole blocks for
    the ADPCM formats; the others are one element a sample)."""
    if fmt in _ADPCM:
        return _ADPCM[fmt][2](n_samples)
    return n_samples


def samples_for_elements(fmt: str, n_elements: int) -> int:
    """Samples that ``n_elements`` of the wire array carry."""
    if fmt in _ADPCM:
        return _ADPCM[fmt][3](n_elements)
    return n_elements
