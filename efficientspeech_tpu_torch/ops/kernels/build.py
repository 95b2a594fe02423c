"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each source is a plain C interface (no PyTorch headers), compiled for
``sm_90a`` into ``build/kernels/`` at the repository root at first use;
the library name carries a hash of its source and of the headers in
``csrc/`` (``*.cuh``, which sources share), so an edited source or header
is rebuilt and a stale library never loads.  Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("folded_matmul", "mrf_block", "layer_norm", "decoder_block",
           "int8_window", "tf32_probe", "adpcm_encode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ at first use and need the CUDA "
                           "toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together.  Returns the seconds spent;
    raises with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed, with
    ``argtypes``/``restype`` set from ``{function: (argtypes, restype)}``
    (every source also exports ``kernel_error_string``)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        sigs = dict(signatures,
                    kernel_error_string=([ctypes.c_int], ctypes.c_char_p))
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def check_tensor(name: str, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous, 32-byte aligned ``dtype`` tensor
    of ``shape`` on ``device``: what a kernel's pointer arguments need."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"{name} must be contiguous and 32-byte aligned")


def check_valid(name: str, valid, device):
    """``valid`` reaches a kernel as a pointer: one int32 on the card."""
    if (not isinstance(valid, torch.Tensor) or valid.device != device
            or valid.dtype != torch.int32 or valid.numel() != 1):
        raise ValueError(f"{name}: on CUDA, valid is one int32 tensor on "
                         f"{device}")


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cuda error {err})")
