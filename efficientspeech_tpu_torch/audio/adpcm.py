"""Block-parallel fixed-step ADPCM wire codecs, card → host (counterpart of
the JAX package's ``audio/adpcm.py``).

Each 256-sample block is one lane: its step is fixed for the whole block,
chosen from the block's diff statistics (step ≈ max(C_MEAN·mean|Δ|,
max|Δ|/C_MAX), snapped up to the IMA step table), so the 255-step
quantiser loop is pure integer arithmetic with no table lookup inside.

- ENCODE (card): ``encode{,3,2}_blocks_device`` launch the CUDA kernel of
  ``ops/kernels/adpcm.py`` on a CUDA tensor (one launch a call) and take
  the plain PyTorch version, ``encode{,3,2}_blocks_plain``, on a CPU
  tensor.  The plain version runs the blocks as lanes of a Python loop
  over the 255 time steps.
- DECODE (host): C++ (``csrc/adpcm_decode.cpp``, built with g++ at first
  use and loaded by ctypes; a missing compiler or a failed build raises).
  Its plain twins, the numpy decoders vectorised across blocks
  (``_decode{,3,2}_numpy``), are what the tests hold it against.

Wire layout per block: a 4-byte header (pred0 int16 little-endian, step
index u8, reserved 0) and the 255 codes plus one pad code, packed
LSB-first: 4-bit codes in 128 bytes (4.125 bits a sample), 3-bit in 96
(3.125), 2-bit in 64 (2.125).

Every value the encoder computes is exact in float32 or int32 (the sum of
255 values of |Δ| ≤ 65,535 is below 2^24), so the kernel, the plain
version and the JAX encoder agree bit for bit.  The input must be finite.
"""

import ctypes
from typing import Callable

import numpy as np
import torch

BLOCK = 256
HEADER_BYTES = 4
CODE_BYTES = BLOCK // 2  # 255 nibbles + 1 pad
BLOCK_BYTES = HEADER_BYTES + CODE_BYTES

# step selection: step >= C_MEAN * mean|diff| and >= max|diff| / C_MAX
C_MEAN = 1.5
C_MAX = 3.0

STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484,
    7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818,
    18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int32)

# 3-bit variant (sign + 2 magnitude bits): vpdiff = step/4 + b1·step +
# b0·step/2; 8 codes pack into 3 bytes
BLOCK3 = 256
CODE3_BYTES = BLOCK3 * 3 // 8
BLOCK3_BYTES = HEADER_BYTES + CODE3_BYTES
C3_MEAN = 1.0
C3_MAX = 2.0

# 2-bit variant (sign + 1 magnitude bit): vpdiff = step/2 + b0·step; 4
# codes pack into a byte
BLOCK2 = 256
CODE2_BYTES = BLOCK2 // 4
BLOCK2_BYTES = HEADER_BYTES + CODE2_BYTES
C2_MEAN = 1.3
C2_MAX = 3.0

# bits a code → (block bytes, C_MEAN, C_MAX)
VARIANTS = {4: (BLOCK_BYTES, C_MEAN, C_MAX),
            3: (BLOCK3_BYTES, C3_MEAN, C3_MAX),
            2: (BLOCK2_BYTES, C2_MEAN, C2_MAX)}


# --- encoder, plain PyTorch ---

def _quantise(bits: int, d: torch.Tensor, step: torch.Tensor):
    """(code magnitude, vpdiff) of |diff| ``d`` at a block's ``step``."""
    h = step >> 1
    if bits == 4:
        q, s8 = step >> 2, step >> 3
        b2 = (d >= step).to(torch.int32)
        d = d - b2 * step
        b1 = (d >= h).to(torch.int32)
        d = d - b1 * h
        b0 = (d >= q).to(torch.int32)
        return b2 * 4 + b1 * 2 + b0, s8 + b2 * step + b1 * h + b0 * q
    if bits == 3:
        b1 = (d >= step).to(torch.int32)
        d = d - b1 * step
        b0 = (d >= h).to(torch.int32)
        return b1 * 2 + b0, (step >> 2) + b1 * step + b0 * h
    b0 = (d >= step).to(torch.int32)
    return b0, h + b0 * step


def encode_plain(wav: torch.Tensor, bits: int) -> torch.Tensor:
    """(B, T) float, T % 256 == 0 → (B, T/256 · block bytes) uint8, as the
    JAX encoder computes it."""
    block_bytes, c_mean, c_max = VARIANTS[bits]
    b, t = wav.shape
    if t % BLOCK:
        raise ValueError(f"adpcm: T {t} is not a multiple of {BLOCK}")
    nb = t // BLOCK
    dev = wav.device
    x = torch.clamp(wav.float(), -1.0, 1.0)
    lanes = torch.round(x * 32767.0).to(torch.int32).reshape(b * nb, BLOCK)
    steps_tab = torch.from_numpy(STEP_TABLE).to(dev)

    pred = lanes[:, 0]
    adiff = (lanes[:, 1:] - lanes[:, :-1]).abs().float()
    # a true division, as jnp.mean takes it (a scalar divisor may become a
    # multiply by its reciprocal)
    n = torch.full_like(pred, BLOCK - 1, dtype=torch.float32)
    mean = adiff.sum(dim=1) / n
    peak = adiff.amax(dim=1) / torch.full_like(n, c_max)
    target = torch.maximum(c_mean * mean, peak).to(torch.int32)
    idx0 = torch.clamp(torch.searchsorted(steps_tab, target), 0, 88).to(
        torch.int32)
    step = steps_tab[idx0]

    codes = torch.zeros((b * nb, BLOCK), dtype=torch.int32, device=dev)
    sign_bit = 1 << (bits - 1)
    for i in range(1, BLOCK):
        diff = lanes[:, i] - pred
        sign = (diff < 0).to(torch.int32)
        mag, vpdiff = _quantise(bits, diff.abs(), step)
        pred = torch.clamp(pred + torch.where(sign == 1, -vpdiff, vpdiff),
                           -32768, 32767)
        codes[:, i - 1] = mag + sign * sign_bit
    # LSB-first bit stream: code i at bits i·bits .. i·bits + bits - 1
    per_byte = 8 // bits if bits != 3 else None
    if per_byte:
        c = codes.reshape(b * nb, BLOCK // per_byte, per_byte)
        packed = sum(c[..., k] << (bits * k) for k in range(per_byte))
    else:
        c = codes.reshape(b * nb, BLOCK // 8, 8)
        b0 = c[..., 0] | (c[..., 1] << 3) | ((c[..., 2] & 3) << 6)
        b1 = ((c[..., 2] >> 2) | (c[..., 3] << 1) | (c[..., 4] << 4)
              | ((c[..., 5] & 1) << 7))
        b2 = (c[..., 5] >> 1) | (c[..., 6] << 2) | (c[..., 7] << 5)
        packed = torch.stack([b0, b1, b2], dim=-1).reshape(b * nb, -1)
    pred0 = lanes[:, 0]
    header = torch.stack([pred0 & 0xFF, (pred0 >> 8) & 0xFF, idx0,
                          torch.zeros_like(idx0)], dim=1)
    out = torch.cat([header, packed], dim=1).to(torch.uint8)
    return out.reshape(b, nb * block_bytes)


def encode_blocks_plain(wav: torch.Tensor) -> torch.Tensor:
    """4-bit encode in plain PyTorch."""
    return encode_plain(wav, 4)


def encode3_blocks_plain(wav: torch.Tensor) -> torch.Tensor:
    """3-bit encode in plain PyTorch."""
    return encode_plain(wav, 3)


def encode2_blocks_plain(wav: torch.Tensor) -> torch.Tensor:
    """2-bit encode in plain PyTorch."""
    return encode_plain(wav, 2)


def _device(bits: int) -> Callable:
    def encode(wav: torch.Tensor) -> torch.Tensor:
        from efficientspeech_tpu_torch.ops.kernels.adpcm import adpcm_encode

        return adpcm_encode(wav.float(), bits)
    encode.__doc__ = (f"(B, T) float in [-1, 1], T % 256 == 0 → uint8 wire "
                      f"bytes at {bits} bits a code: the CUDA kernel on a "
                      f"CUDA tensor, the plain version on a CPU tensor.")
    return encode


encode_blocks_device = _device(4)
encode3_blocks_device = _device(3)
encode2_blocks_device = _device(2)


# --- decoders (host): the plain numpy twins, then the C++ library ---

def _header(blocks: np.ndarray):
    pred = (blocks[:, 0].astype(np.int32)
            | (blocks[:, 1].astype(np.int32) << 8))
    pred = (pred ^ 0x8000) - 0x8000  # sign-extend int16
    idx = np.clip(blocks[:, 2].astype(np.int32), 0, 88)
    return pred, STEP_TABLE[idx]


def _decode_numpy(data: np.ndarray, n_blocks: int) -> np.ndarray:
    """4-bit decode, vectorised across blocks (sequential over the 255
    steps)."""
    blocks = data.reshape(n_blocks, BLOCK_BYTES)
    pred, step = _header(blocks)
    h, q, s8 = step >> 1, step >> 2, step >> 3
    packed = blocks[:, HEADER_BYTES:]
    codes = np.empty((n_blocks, BLOCK), np.int32)
    codes[:, 0:BLOCK:2] = packed & 0x0F
    codes[:, 1:BLOCK:2] = packed >> 4
    out = np.empty((n_blocks, BLOCK), np.int32)
    out[:, 0] = pred
    for t in range(1, BLOCK):
        code = codes[:, t - 1]
        vpdiff = (s8 + np.where(code & 4, step, 0)
                  + np.where(code & 2, h, 0)
                  + np.where(code & 1, q, 0))
        pred = np.clip(pred + np.where(code & 8, -vpdiff, vpdiff),
                       -32768, 32767)
        out[:, t] = pred
    return (out.reshape(-1) / 32767.0).astype(np.float32)


def _decode3_numpy(data: np.ndarray, n_blocks: int) -> np.ndarray:
    """3-bit decode."""
    blocks = data.reshape(n_blocks, BLOCK3_BYTES)
    pred, step = _header(blocks)
    h, s4 = step >> 1, step >> 2
    packed = blocks[:, HEADER_BYTES:].reshape(n_blocks, BLOCK3 // 8, 3)
    packed = packed.astype(np.int32)
    b0_, b1_, b2_ = packed[..., 0], packed[..., 1], packed[..., 2]
    codes = np.empty((n_blocks, BLOCK3 // 8, 8), np.int32)
    codes[..., 0] = b0_ & 7
    codes[..., 1] = (b0_ >> 3) & 7
    codes[..., 2] = ((b0_ >> 6) & 3) | ((b1_ & 1) << 2)
    codes[..., 3] = (b1_ >> 1) & 7
    codes[..., 4] = (b1_ >> 4) & 7
    codes[..., 5] = ((b1_ >> 7) & 1) | ((b2_ & 3) << 1)
    codes[..., 6] = (b2_ >> 2) & 7
    codes[..., 7] = (b2_ >> 5) & 7
    codes = codes.reshape(n_blocks, BLOCK3)
    out = np.empty((n_blocks, BLOCK3), np.int32)
    out[:, 0] = pred
    for t in range(1, BLOCK3):
        code = codes[:, t - 1]
        vpdiff = (s4 + np.where(code & 2, step, 0)
                  + np.where(code & 1, h, 0))
        pred = np.clip(pred + np.where(code & 4, -vpdiff, vpdiff),
                       -32768, 32767)
        out[:, t] = pred
    return (out.reshape(-1) / 32767.0).astype(np.float32)


def _decode2_numpy(data: np.ndarray, n_blocks: int) -> np.ndarray:
    """2-bit decode."""
    blocks = data.reshape(n_blocks, BLOCK2_BYTES)
    pred, step = _header(blocks)
    h = step >> 1
    packed = blocks[:, HEADER_BYTES:].astype(np.int32)   # (nb, 64)
    codes = np.empty((n_blocks, BLOCK2 // 4, 4), np.int32)
    codes[..., 0] = packed & 3
    codes[..., 1] = (packed >> 2) & 3
    codes[..., 2] = (packed >> 4) & 3
    codes[..., 3] = (packed >> 6) & 3
    codes = codes.reshape(n_blocks, BLOCK2)
    out = np.empty((n_blocks, BLOCK2), np.int32)
    out[:, 0] = pred
    for t in range(1, BLOCK2):
        code = codes[:, t - 1]
        vpdiff = h + np.where(code & 1, step, 0)
        pred = np.clip(pred + np.where(code & 2, -vpdiff, vpdiff),
                       -32768, 32767)
        out[:, t] = pred
    return (out.reshape(-1) / 32767.0).astype(np.float32)


_U8P, _F32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
_DECODE_SIGNATURES = {
    f"adpcm{bits}_decode": ([_U8P, ctypes.c_int, _F32P], None)
    for bits in VARIANTS}


def decode_lib() -> ctypes.CDLL:
    """The C++ decoders, built with g++ at first use."""
    from efficientspeech_tpu_torch.ops.kernels import build

    return build.load_host("adpcm_decode", _DECODE_SIGNATURES)


def _host_decoder(bits: int) -> Callable:
    block_bytes = VARIANTS[bits][0]

    def decode_host(data: np.ndarray) -> np.ndarray:
        data = np.ascontiguousarray(data, np.uint8)
        n_blocks = len(data) // block_bytes
        out = np.empty(n_blocks * BLOCK, np.float32)
        getattr(decode_lib(), f"adpcm{bits}_decode")(
            data.ctypes.data_as(_U8P), n_blocks, out.ctypes.data_as(_F32P))
        return out
    decode_host.__doc__ = (f"uint8 wire bytes at {bits} bits a code (whole "
                           f"blocks; a partial block at the end is dropped) "
                           f"→ float32 samples, decoded in C++.")
    return decode_host


decode_blocks_host = _host_decoder(4)
decode3_blocks_host = _host_decoder(3)
decode2_blocks_host = _host_decoder(2)


# --- wire sizes ---

def elements_for_samples(n_samples: int) -> int:
    """Wire bytes holding n_samples (whole blocks)."""
    return -(-n_samples // BLOCK) * BLOCK_BYTES


def samples_for_elements(n_elements: int) -> int:
    return (n_elements // BLOCK_BYTES) * BLOCK


def elements3_for_samples(n_samples: int) -> int:
    return -(-n_samples // BLOCK3) * BLOCK3_BYTES


def samples3_for_elements(n_elements: int) -> int:
    return (n_elements // BLOCK3_BYTES) * BLOCK3


def elements2_for_samples(n_samples: int) -> int:
    return -(-n_samples // BLOCK2) * BLOCK2_BYTES


def samples2_for_elements(n_elements: int) -> int:
    return (n_elements // BLOCK2_BYTES) * BLOCK2
