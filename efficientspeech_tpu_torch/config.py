"""Configuration dataclasses for the PyTorch port of EfficientSpeech-TPU.

A copy of the JAX package's config module, so that the port imports
nothing of that package; the two must stay field-for-field identical.

The reference drives everything from a single ~35-flag argparse surface
(reference: utils/tools.py:316-472) plus YAML preprocess configs
(reference: config/LJSpeech/preprocess.yaml).  Here the same knobs are
structured dataclasses; the tiny/small/base model tiers of the reference
README (reference: README.md:186-196) are provided as named presets.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import yaml


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Audio/STFT parameters (reference: config/LJSpeech/preprocess.yaml)."""

    sampling_rate: int = 22050
    max_wav_value: float = 32768.0
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = 8000.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Acoustic-model architecture hyperparameters.

    Mirrors the reference CLI flags (reference: utils/tools.py:354-389) that
    select the tiny (266k) / small (952k) / base (4M) tiers
    (reference: README.md:186-196).
    """

    depth: int = 2
    reduction: int = 4
    head: int = 1
    embed_dim: int = 128
    kernel_size: int = 3
    expansion: int = 1
    # mel decoder
    n_blocks: int = 2
    block_depth: int = 2
    # reference CLI default --decoder-kernel-size 5 (utils/tools.py); all
    # named presets use 5 too — a bare ModelConfig() must match so directly
    # constructed configs load reference checkpoints
    decoder_kernel_size: int = 5
    n_mel_channels: int = 80
    # dataset normalization stats (stats.json pitch/energy [min, max])
    pitch_stats: Tuple[float, float] = (-2.917079304729967, 11.391254536985771)
    energy_stats: Tuple[float, float] = (-1.431044578552246, 8.184337615966797)
    # static shape buckets (one program shape per bucket)
    max_phoneme_len: int = 256
    max_mel_len: int = 2048
    # multi-speaker hook (beyond the single-speaker reference): >1 adds a
    # learned speaker embedding to the fused encoder features
    # (FastSpeech2-style).  1 = no extra parameters, checkpoint-compatible.
    n_speakers: int = 1
    # embedding rows; None = the default English inventory (VOCAB_SIZE).
    # A Tagalog (t1) model sets text.symbols.TAGALOG_VOCAB_SIZE after
    # text.enable_tagalog_symbols().
    vocab_size: int = None

    @property
    def filter_dim(self) -> int:
        return self.embed_dim // self.reduction

    @classmethod
    def preset(cls, name: str, **overrides) -> "ModelConfig":
        presets = {
            # reference: README.md:35-87 demo flags + utils/tools.py:354-389 defaults
            "tiny": dict(depth=2, reduction=4, head=1, embed_dim=128,
                         kernel_size=3, expansion=1, n_blocks=2, block_depth=2,
                         decoder_kernel_size=5),
            "small": dict(depth=2, reduction=2, head=1, embed_dim=128,
                          kernel_size=3, expansion=1, n_blocks=3, block_depth=2,
                          decoder_kernel_size=5),
            "base": dict(depth=2, reduction=1, head=2, embed_dim=128,
                         kernel_size=5, expansion=2, n_blocks=3, block_depth=3,
                         decoder_kernel_size=5),
        }
        if name not in presets:
            raise ValueError(f"unknown model preset {name!r}; pick from {sorted(presets)}")
        cfg = dict(presets[name])
        cfg.update(overrides)
        return cls(**cfg)


# the reference exposes each architecture hyperparameter as its own CLI
# flag (reference: utils/tools.py:354-389); the named presets cover the
# published tiers, these let a CLI override any field of a preset — so a
# custom-size reference checkpoint (e.g. --n-blocks 3 --reduction 2) can
# be trained/served/exported here with the same flags
ARCH_FLAGS = ("depth", "reduction", "head", "embed_dim", "kernel_size",
              "expansion", "n_blocks", "block_depth", "decoder_kernel_size")


def add_arch_args(parser):
    """Add the reference's architecture flags to an argparse parser.

    Defaults are None = "use the --preset value"; a flag that is given
    overrides that single field of the preset (reference CLI parity:
    utils/tools.py:354-389)."""
    group = parser.add_argument_group("architecture overrides")
    for name in ARCH_FLAGS:
        group.add_argument("--" + name.replace("_", "-"), type=int,
                           default=None,
                           help=f"override the preset's {name}")
    return parser


def arch_overrides(args) -> dict:
    """Extract the non-None architecture overrides from parsed args."""
    return {k: getattr(args, k) for k in ARCH_FLAGS
            if getattr(args, k, None) is not None}


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    """HiFi-GAN generator hyperparameters (reference: hifigan/LJ_V2/config.json)."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 128
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80

    @classmethod
    def from_json(cls, path: str) -> "HifiGanConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            resblock=str(raw["resblock"]),
            upsample_rates=tuple(raw["upsample_rates"]),
            upsample_kernel_sizes=tuple(raw["upsample_kernel_sizes"]),
            upsample_initial_channel=int(raw["upsample_initial_channel"]),
            resblock_kernel_sizes=tuple(raw["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in raw["resblock_dilation_sizes"]),
            num_mels=int(raw["num_mels"]),
        )

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Dataset preprocessing parameters (reference: config/LJSpeech/preprocess.yaml)."""

    dataset: str = "LJSpeech"
    corpus_path: str = "/data/tts/LJSpeech-1.1"
    lexicon_path: str = "lexicon/builtin-en.txt"
    raw_path: str = "/data/tts/LJSpeech-1.1/wavs"
    preprocessed_path: str = "./preprocessed_data/LJSpeech"
    val_size: int = 512
    text_cleaners: Tuple[str, ...] = ("english_cleaners",)
    language: str = "en"
    max_length: int = 4096
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    pitch_feature: str = "phoneme_level"
    energy_feature: str = "phoneme_level"
    pitch_normalization: bool = True
    energy_normalization: bool = True

    @classmethod
    def from_yaml(cls, path: str) -> "PreprocessConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        p = raw.get("path", {})
        pp = raw.get("preprocessing", {})
        audio_raw = pp.get("audio", {})
        stft_raw = pp.get("stft", {})
        mel_raw = pp.get("mel", {})
        audio = AudioConfig(
            sampling_rate=audio_raw.get("sampling_rate", 22050),
            max_wav_value=audio_raw.get("max_wav_value", 32768.0),
            filter_length=stft_raw.get("filter_length", 1024),
            hop_length=stft_raw.get("hop_length", 256),
            win_length=stft_raw.get("win_length", 1024),
            n_mel_channels=mel_raw.get("n_mel_channels", 80),
            mel_fmin=mel_raw.get("mel_fmin", 0.0),
            mel_fmax=mel_raw.get("mel_fmax", 8000.0),
        )
        return cls(
            dataset=raw.get("dataset", "LJSpeech"),
            corpus_path=p.get("corpus_path", ""),
            lexicon_path=p.get("lexicon_path", ""),
            raw_path=p.get("raw_path", ""),
            preprocessed_path=p.get("preprocessed_path", ""),
            val_size=pp.get("val_size", 512),
            text_cleaners=tuple(pp.get("text", {}).get("text_cleaners", ("english_cleaners",))),
            language=pp.get("text", {}).get("language", "en"),
            max_length=pp.get("text", {}).get("max_length", 4096),
            audio=audio,
            pitch_feature=pp.get("pitch", {}).get("feature", "phoneme_level"),
            energy_feature=pp.get("energy", {}).get("feature", "phoneme_level"),
            pitch_normalization=pp.get("pitch", {}).get("normalization", True),
            energy_normalization=pp.get("energy", {}).get("normalization", True),
        )

    def load_stats(self) -> dict:
        path = os.path.join(self.preprocessed_path, "stats.json")
        with open(path) as f:
            return json.load(f)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer/schedule/runtime knobs (reference: utils/tools.py:316-352, model.py:279-283)."""

    lr: float = 1e-3
    weight_decay: float = 1e-5  # reference CLI default (utils/tools.py:337-341)
    batch_size: int = 128
    max_epochs: int = 5000
    warmup_epochs: int = 50
    # loss weights (reference: model.py:217)
    mel_loss_weight: float = 10.0
    pitch_loss_weight: float = 2.0
    energy_loss_weight: float = 2.0
    duration_loss_weight: float = 1.0
    # runtime
    precision: str = "bf16"  # compute dtype; params/optimizer always f32
    seed: int = 0
    val_every_n_epochs: int = 10
    # device-resident corpus (data/device_cache.py): the whole train and
    # val sets on the card, batches gathered there; optional bf16 mel
    # targets.  device_data_scan_steps is the JAX package's steps per
    # host call (one XLA scan); eager PyTorch has no such program, so
    # here it is accepted for the same flags and runs K single steps
    device_data: bool = False
    device_cache_bf16_mel: bool = False
    device_data_scan_steps: int = 1
    # data-parallel ranks of the Trainer's mesh (parallel/mesh.py); 1 = one
    # device.  The JAX config's flat-optimizer field is left out: the port
    # has no flat optimizer
    num_data_axis: int = 1
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    wav_path: str = "wavs"
