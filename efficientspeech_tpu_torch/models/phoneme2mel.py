"""Phoneme sequence → mel spectrogram (inference)."""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.acoustic import PhonemeEncoder
from efficientspeech_tpu_torch.models.mel_decoder import MelDecoder
from efficientspeech_tpu_torch.models.modules import masked_fill


class Phoneme2Mel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = PhonemeEncoder(cfg)
        self.decoder = MelDecoder(cfg)

    def forward(self, phoneme: torch.Tensor, pad_mask: torch.Tensor,
                max_mel_len: Optional[int] = None,
                speaker: Optional[torch.Tensor] = None):
        """phoneme (B, N) int, pad_mask (B, N) True = pad → the prediction
        dict of ``PhonemeEncoder`` plus ``mel`` (B, max_mel_len, n_mels),
        zero beyond each ``mel_len``."""
        if max_mel_len is None:
            max_mel_len = self.cfg.max_mel_len
        pred = self.encoder(phoneme, pad_mask, max_mel_len, speaker=speaker)
        pad = ~pred["frame_valid"]
        pred["mel"] = masked_fill(self.decoder(pred["features"], pad), pad)
        return pred
