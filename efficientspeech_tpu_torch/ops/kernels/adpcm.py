"""Block-ADPCM wire encoder: the CUDA kernel (``csrc/adpcm_encode.cu``)
for 4-, 3- and 2-bit codes.  Its plain PyTorch version is
``audio/adpcm.py::encode_plain``, which the CPU takes; a CUDA tensor
launches the kernel or raises.  Kernel and plain version are bit-equal
(integer arithmetic and float32 values that are exact; see the source's
note)."""

import ctypes

import torch

from efficientspeech_tpu_torch.audio.adpcm import BLOCK, VARIANTS, encode_plain
from efficientspeech_tpu_torch.ops.kernels import build

# the code widths the kernel is built for
BITS = (4, 3, 2)

# kernel launches by code width since the counts were last set to 0
launches = dict.fromkeys(BITS, 0)

adpcm_encode_plain = encode_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"adpcm_encode_launch": ([_P, _P, _I, _I, _P], _I)}


def _lib():
    return build.load("adpcm_encode", _SIGNATURES)


def adpcm_encode(wav: torch.Tensor, bits: int) -> torch.Tensor:
    """wav (B, T) float32, T a multiple of 256 → (B, T/256 · block bytes)
    uint8 wire bytes at ``bits`` (4, 3 or 2) bits a code."""
    if bits not in BITS:
        raise ValueError(f"adpcm_encode: bits {bits} not one of {BITS}")
    if wav.device.type == "cpu":
        return encode_plain(wav, bits)
    if wav.device.type != "cuda":
        raise ValueError(f"adpcm_encode: unsupported device {wav.device}")
    if wav.dim() != 2 or wav.shape[1] % BLOCK or wav.numel() == 0:
        raise ValueError(f"adpcm_encode: wav must be (B, T), T a positive "
                         f"multiple of {BLOCK}, got {tuple(wav.shape)}")
    b, t = wav.shape
    dev = wav.device
    build.check_tensor("wav", wav, torch.float32, (b, t), dev)
    n_lanes = b * t // BLOCK
    out = torch.empty((b, t // BLOCK * VARIANTS[bits][0]), dtype=torch.uint8,
                      device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adpcm_encode_launch(wav.data_ptr(), out.data_ptr(),
                                      n_lanes, bits, stream)
    build.check(lib, err, "adpcm_encode")
    launches[bits] += 1
    return out
