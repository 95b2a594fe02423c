"""ONNX and TorchScript export of the port's own modules (the reference's
interchange contract, convert.py:35-48): input ``inputs`` (1, insize)
int → outputs ``wav``, ``lengths`` (the mel length) and ``duration``.

The graph is ``EfficientSpeech.predict`` in float32 at a FIXED
``insize`` (``max_mel_len`` follows from it), with the pad mask taken
from the pad ID inside the graph; no axis is dynamic.  ONNX goes through
torch's TorchScript-based exporter (``dynamo=False``).  Without the
``onnx`` package that exporter only lacks a post-pass that splices custom
onnxscript functions into the proto, a no-op for this graph of aten ops,
so the pass is shimmed to the identity; where torch lays its exporter out
otherwise, export raises instead of writing a file.  Running the file
needs onnxruntime, which the demo asks for (``demo.run_onnx``).
"""

import os

import torch
from torch import nn

from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.convert.export import (
    example_inputs, fixed_size_model)
from efficientspeech_tpu_torch.models.efficientspeech import EfficientSpeech
from efficientspeech_tpu_torch.text.symbols import PAD_ID

# where torch keeps the exporter's onnxscript pass, newest layout first
_PROTO_UTILS = ("torch.onnx._internal.torchscript_exporter.onnx_proto_utils",
                "torch.onnx._internal.onnx_proto_utils")


class TextToWav(nn.Module):
    """The exported graph: phoneme IDs (1, insize) → (wav, lengths,
    duration)."""

    def __init__(self, model: EfficientSpeech):
        super().__init__()
        self.model = model

    def forward(self, phoneme):
        wav, _, mel_len, duration = self.model.predict(phoneme,
                                                       phoneme == PAD_ID)
        return wav, mel_len, duration


def _shim_missing_onnx_package():
    try:
        import onnx  # noqa: F401
        return
    except ImportError:
        pass
    import importlib

    utils = None
    for name in _PROTO_UTILS:
        try:
            utils = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(utils, "_add_onnxscript_fn"):
            break
        utils = None
    if utils is None:
        raise RuntimeError(
            f"the onnx package is missing and torch {torch.__version__} "
            "keeps its ONNX exporter in no known place; install onnx to "
            "export")
    if getattr(utils._add_onnxscript_fn, "_es_shim", False):
        return

    def _passthrough(model_bytes, custom_opsets):
        # the real pass only splices custom onnxscript functions into the
        # proto; this graph is pure aten, so the proto is already complete
        return model_bytes

    _passthrough._es_shim = True
    utils._add_onnxscript_fn = _passthrough


def export_model(cfg: ModelConfig, hifigan_cfg: HifiGanConfig,
                 model: EfficientSpeech, insize: int = 128,
                 mel_expansion: int = 16) -> TextToWav:
    """The float32 graph ONNX and TorchScript are traced from, on the
    device of ``model``'s parameters."""
    return TextToWav(fixed_size_model(cfg, hifigan_cfg, model, insize,
                                      mel_expansion, torch.float32)).eval()


def export_onnx(cfg: ModelConfig, hifigan_cfg: HifiGanConfig,
                model: EfficientSpeech, path: str, insize: int = 128,
                opset: int = 17, mel_expansion: int = 16) -> int:
    """Write a fixed-insize ``.onnx``; returns the file's size in
    bytes."""
    _shim_missing_onnx_package()
    graph = export_model(cfg, hifigan_cfg, model, insize, mel_expansion)
    phoneme, _ = example_inputs(insize, next(graph.parameters()).device)
    with torch.no_grad():
        torch.onnx.export(
            graph, (phoneme,), path, opset_version=opset,
            do_constant_folding=True, input_names=["inputs"],
            output_names=["wav", "lengths", "duration"], dynamo=False)
    return os.path.getsize(path)


def export_torchscript(cfg: ModelConfig, hifigan_cfg: HifiGanConfig,
                       model: EfficientSpeech, path: str, insize: int = 128,
                       mel_expansion: int = 16) -> int:
    """Write a traced TorchScript module of the fixed-insize graph
    (``torch.jit.load`` it on the device it was traced on); returns the
    file's size in bytes."""
    graph = export_model(cfg, hifigan_cfg, model, insize, mel_expansion)
    phoneme, _ = example_inputs(insize, next(graph.parameters()).device)
    with torch.no_grad():
        traced = torch.jit.trace(graph, (phoneme,))
    traced.save(path)
    return os.path.getsize(path)
