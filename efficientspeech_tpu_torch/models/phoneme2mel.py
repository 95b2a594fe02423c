"""Phoneme sequence → mel spectrogram, for inference and for training."""

from typing import Optional

import torch
from torch import nn

from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.acoustic import PhonemeEncoder
from efficientspeech_tpu_torch.models.mel_decoder import MelDecoder
from efficientspeech_tpu_torch.models.modules import masked_fill


class Phoneme2Mel(nn.Module):
    """``fused_decoder_norm`` / ``fused_decoder_block`` route the mel
    decoder through kernels K3 / K4 (see ``MelDecoder``); the parameters
    are the same either way."""

    def __init__(self, cfg: ModelConfig, fused_decoder_norm: bool = False,
                 fused_decoder_block: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder = PhonemeEncoder(cfg)
        self.decoder = MelDecoder(cfg, fused_norm=fused_decoder_norm,
                                  fused_block=fused_decoder_block)

    def forward(self, phoneme: torch.Tensor, pad_mask: torch.Tensor,
                max_mel_len: Optional[int] = None,
                speaker: Optional[torch.Tensor] = None,
                pitch_target: Optional[torch.Tensor] = None,
                energy_target: Optional[torch.Tensor] = None,
                duration_target: Optional[torch.Tensor] = None,
                train: bool = False):
        """phoneme (B, N) int, pad_mask (B, N) True = pad → the prediction
        dict of ``PhonemeEncoder`` plus ``mel`` (B, max_mel_len, n_mels),
        zero beyond each ``mel_len``.  ``train=True`` teacher-forces the
        pitch, energy and duration targets (B, N)."""
        if max_mel_len is None:
            max_mel_len = self.cfg.max_mel_len
        pred = self.encoder(phoneme, pad_mask, max_mel_len, speaker=speaker,
                            pitch_target=pitch_target,
                            energy_target=energy_target,
                            duration_target=duration_target, train=train)
        pad = ~pred["frame_valid"]
        pred["mel"] = masked_fill(self.decoder(pred["features"], pad), pad)
        return pred
