"""Model export: the phoneme → wav program as a ``torch.export`` archive
(``.pt2``), the counterpart of the JAX package's StableHLO export.

Like the reference's ONNX path, the program has a FIXED phoneme input
size: ``insize`` phonemes, ``insize · mel_expansion`` mel frames.  It is
``EfficientSpeech.predict`` on the plain route, traced on the device the
model's parameters are on, and ``load_exported`` runs it there again (or
on another device it moves the program to).
"""

import copy
import dataclasses
import os

import torch
from torch import nn

from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.models.efficientspeech import EfficientSpeech
from efficientspeech_tpu_torch.models.modules import cast_params_


class Predict(nn.Module):
    """``EfficientSpeech.predict`` as a module's forward, for tracing:
    (phoneme (1, insize) int32, pad_mask (1, insize) bool) → (wav,
    wav_len, mel_len, duration)."""

    def __init__(self, model: EfficientSpeech):
        super().__init__()
        self.model = model

    def forward(self, phoneme, pad_mask):
        return self.model.predict(phoneme, pad_mask)


def fixed_size_model(cfg: ModelConfig, hifigan_cfg: HifiGanConfig,
                     model: EfficientSpeech, insize: int = 128,
                     mel_expansion: int = 16,
                     dtype=torch.float32) -> EfficientSpeech:
    """A copy of ``model`` on its device with ``max_phoneme_len = insize``
    and ``max_mel_len = insize · mel_expansion``, its Linear and conv
    weights cast to ``dtype`` (LayerNorm and embeddings stay float32, as
    serving keeps them), in eval mode; ``model`` is left as it was."""
    cfg = dataclasses.replace(cfg, max_phoneme_len=insize,
                              max_mel_len=insize * mel_expansion)
    device = next(model.parameters()).device
    out = EfficientSpeech(cfg, hifigan_cfg).to(device)
    out.load_state_dict(copy.deepcopy(model.state_dict()))
    cast_params_(out.phoneme2mel, dtype)
    cast_params_(out.hifigan, dtype)
    return out.eval()


def example_inputs(insize: int, device) -> tuple:
    """A (1, insize) int32 phoneme row with no padding, and its mask."""
    gen = torch.Generator().manual_seed(0)
    phoneme = torch.randint(70, 146, (1, insize), generator=gen,
                            dtype=torch.int32).to(device)
    return phoneme, torch.zeros_like(phoneme, dtype=torch.bool)


def export_text_to_wav(cfg: ModelConfig, hifigan_cfg: HifiGanConfig,
                       model: EfficientSpeech, insize: int = 128,
                       mel_expansion: int = 16, dtype=torch.bfloat16
                       ) -> torch.export.ExportedProgram:
    """The full phoneme → wav program at a fixed input size, through
    ``torch.export.export`` on the device of ``model``'s parameters.
    ``insize`` mirrors the reference's ``--onnx-insize`` (default 128)."""
    fixed = fixed_size_model(cfg, hifigan_cfg, model, insize, mel_expansion,
                             dtype)
    args = example_inputs(insize, next(fixed.parameters()).device)
    with torch.no_grad():
        return torch.export.export(Predict(fixed), args)


def save_exported(path: str, program: torch.export.ExportedProgram) -> int:
    """Write the program as a ``.pt2`` archive; returns its size in
    bytes."""
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_exported(path: str, device=None):
    """A callable (phoneme, pad_mask) → (wav, wav_len, mel_len, duration)
    from a ``.pt2`` written by ``save_exported``, on ``device`` (default:
    the device it was exported on)."""
    program = torch.export.load(path)
    if device is not None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, torch.device(device))
    module = program.module()

    def run(phoneme, pad_mask):
        with torch.no_grad():
            return tuple(module(phoneme, pad_mask))

    return run
