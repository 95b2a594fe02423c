"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each source is a plain C interface (no PyTorch headers), compiled for
``sm_90a`` into ``build/kernels/`` at the repository root at first use;
the library name carries a hash of its source and of the headers in
``csrc/`` (``*.cuh``, which sources share), so an edited source or header
is rebuilt and a stale library never loads.  The host's C++ sources
(``csrc/*.cpp``: the ADPCM wire decoder) are built the same way with g++
into ``build/host/`` (``load_host``), their names also hashing the CPU
that ``-march=native`` built for.  Nothing here runs at import.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("folded_matmul", "mrf_block", "layer_norm", "decoder_block",
           "int8_window", "tf32_probe", "adpcm_encode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
# -march=native: a host library's name also hashes g++'s view of the CPU
# (``_host_target``), so one built on another CPU is rebuilt, not loaded
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")

_loaded: Dict[str, ctypes.CDLL] = {}  # by source file name
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ at first use and need the CUDA "
                           "toolkit")
    return nvcc


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: csrc/*.cpp is built at first "
                           "use and needs a C++ compiler")
    return gxx


@functools.lru_cache(maxsize=None)
def _host_target(gxx: str) -> bytes:
    """What ``-march=native`` selects on this CPU, as g++ reports it."""
    return subprocess.run([gxx, *GXX_FLAGS, "-Q", "--help=target"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          check=True).stdout


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _host_lib_path(name: str, gxx: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(_host_target(gxx))
    return HOST_BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _compile(tool: str, jobs: Dict[str, Tuple[Sequence[str], Path]]):
    """Run every ``{name: (command, library)}`` job at once, each command
    writing a temporary file (its ``-o``) that then replaces the library;
    raise with the compiler's output of every job that failed."""
    procs = []
    for name, (cmd, out) in jobs.items():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"{tool} failed for " + "\n".join(failed))


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together.  Returns the seconds spent;
    raises with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    _compile("nvcc", {n: ([nvcc, *NVCC_FLAGS, str(CSRC / f"{n}.cu")],
                          _lib_path(n)) for n in todo})
    return time.perf_counter() - t0


def _load(source: str, path_and_build, signatures: Dict[str, tuple]
          ) -> ctypes.CDLL:
    """The library of ``source``, loaded once a process: on a miss,
    ``path_and_build()`` builds it if needed and returns its path, and
    ``argtypes``/``restype`` are set from ``{function: (argtypes,
    restype)}``."""
    lib = _loaded.get(source)
    if lib is None:
        with _lock:
            lib = _loaded.get(source)
            if lib is None:
                lib = ctypes.CDLL(str(path_and_build()))
                for fn, (argtypes, restype) in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                _loaded[source] = lib
    return lib


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed
    (every source also exports ``kernel_error_string``)."""
    def path_and_build():
        build([name])
        return _lib_path(name)
    return _load(f"{name}.cu", path_and_build, dict(
        signatures, kernel_error_string=([ctypes.c_int], ctypes.c_char_p)))


def load_host(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded host library of ``csrc/<name>.cpp``, built with g++ into
    ``build/host/`` first if missing.  Raises with the compiler's output
    if there is no g++ or the build fails: there is no slower fallback to
    take quietly."""
    def path_and_build():
        gxx = _gxx()
        path = _host_lib_path(name, gxx)
        if not path.exists():
            _compile("g++", {name: ([gxx, *GXX_FLAGS,
                                     str(CSRC / f"{name}.cpp")], path)})
        return path
    return _load(f"{name}.cpp", path_and_build, signatures)


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
