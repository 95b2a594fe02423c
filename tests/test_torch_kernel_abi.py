"""The ctypes signatures each kernel wrapper declares against the C
functions its source in ``csrc/`` exports: a wrong count or kind of
argument only shows when a call reaches the card, so it is checked here,
where the sources are read as text."""

import ctypes
import importlib
import re

import pytest

from efficientspeech_tpu_torch.ops.kernels import build

MODULES = {"folded_matmul": "ops.kernels.folded_matmul",
           "mrf_block": "ops.kernels.mrf_block",
           "layer_norm": "ops.kernels.layer_norm",
           "decoder_block": "ops.kernels.decoder_block",
           "int8_window": "ops.kernels.int8_window",
           "tf32_probe": "probes.tf32_wgmma",
           "adpcm_encode": "ops.kernels.adpcm"}


def _c_params(source: str, fn: str):
    """The parameter list of ``fn`` in the extern "C" block of a source."""
    exported = source[source.index('extern "C" {'):]
    m = re.search(r"\b(?:int|const char\s*\*)\s+" + fn + r"\s*\(([^)]*)\)",
                  exported)
    assert m, f"{fn} is not exported"
    params = [p.strip() for p in m.group(1).split(",")]
    return [p for p in params if p and p != "void"]


def _kind(c_type) -> str:
    if c_type is ctypes.c_void_p or hasattr(c_type, "contents"):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float"}[c_type]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_wrapper_signatures_match_sources(name):
    module = importlib.import_module(
        f"efficientspeech_tpu_torch.{MODULES[name]}")
    source = (build.CSRC / f"{name}.cu").read_text()
    assert name in build.SOURCES
    for fn, (argtypes, _) in module._SIGNATURES.items():
        params = _c_params(source, fn)
        want = ["pointer" if "*" in p else
                "float" if p.startswith("float") else "int" for p in params]
        assert [_kind(a) for a in argtypes] == want, fn
