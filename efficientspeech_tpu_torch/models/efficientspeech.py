"""The full model: ``phoneme2mel`` (the acoustic model) and ``hifigan``
(the vocoder), the two subtrees of the JAX package's parameter tree.

``predict`` chains them into one text → wav forward on the plain route
(static shapes, no host read, no kernel): the graph ``convert/export.py``
and ``convert/onnx_export.py`` write.  Serving composes the same
parameters in ``infer.py``, through the folded vocoder and its kernels.
"""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.models.hifigan import (
    HifiGanGenerator, vocode_chunked)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel


class EfficientSpeech(nn.Module):
    # the vocoder folds its time axis into batch chunks of this many mel
    # frames (exact; ``models.hifigan.chunked_vocoder_call``), as the JAX
    # package's ``vocoder_chunk_frames`` default does
    VOCODER_CHUNK_FRAMES = 128

    def __init__(self, cfg: ModelConfig, hifigan_cfg: HifiGanConfig):
        super().__init__()
        self.cfg = cfg
        self.hifigan_cfg = hifigan_cfg
        self.phoneme2mel = Phoneme2Mel(cfg)
        self.hifigan = HifiGanGenerator(hifigan_cfg)

    def predict(self, phoneme: torch.Tensor, pad_mask: torch.Tensor):
        """Phoneme IDs (B, N), pad_mask (B, N) True = pad → (wav (B,
        max_mel_len · upsample), wav_len, mel_len, duration), as the JAX
        package's ``EfficientSpeech.predict``: the vocoder sees mel_len
        clipped to ``max_mel_len``, wav_len = that · upsample, and mel_len
        is returned unclipped."""
        pred = self.phoneme2mel(phoneme, pad_mask)
        mel_len = torch.clamp(pred["mel_len"], max=self.cfg.max_mel_len)
        wav = self.vocode(pred["mel"], mel_len)
        wav_len = mel_len * self.hifigan_cfg.total_upsample
        return wav, wav_len, pred["mel_len"], pred["duration"]

    def vocode(self, mel: torch.Tensor,
               mel_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel (B, T, n_mels) → wav (B, T · upsample), zero beyond
        mel_len."""
        chunk = self.VOCODER_CHUNK_FRAMES
        if mel.shape[1] > chunk:
            return vocode_chunked(self.hifigan, mel, mel_len, chunk)
        return self.hifigan(mel, valid_len=mel_len)
