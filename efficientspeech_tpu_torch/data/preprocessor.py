"""Offline dataset preprocessing: wav + MFA TextGrid → features on disk
(counterpart of the JAX package's ``data/preprocessor.py``).

Re-implementation of the reference pipeline
(reference: preprocessor/preprocessor.py:16-314): per utterance —
alignment-driven silence trimming, frame-count durations, F0
(pyworld, else DIO + StoneMask; see audio/pitch.py), mel + energy
(``audio/stft.MelSpectrogram``, on the card unless ``device="cpu"``),
unvoiced-pitch interpolation, phoneme-level averaging, per-utterance .npy
saves, then global z-normalization with IQR outlier removal for stats and a
shuffled train/val split.  The wav, the TextGrid and the pitch stay on the
host, as float64 numpy; only the mel and energy are computed on the
device.

On-disk layout is byte-compatible with the reference so datasets can be
swapped between the two frameworks:
``{mel,pitch,energy,duration}/<speaker>-<kind>-<base>.npy`` +
``train.txt``/``val.txt``/``stats.json``/``speakers.json``.
"""

import json
import os
import random
from typing import List, Tuple

import numpy as np

from efficientspeech_tpu_torch.audio.pitch import (
    extract_pitch, extractor_name, interpolate_unvoiced)
from efficientspeech_tpu_torch.audio.stft import MelSpectrogram
from efficientspeech_tpu_torch.config import PreprocessConfig
from efficientspeech_tpu_torch.data.textgrid import read_textgrid

SIL_PHONES = ["sil", "sp", "spn"]


class RunningScaler:
    """Streaming mean/std (replaces sklearn StandardScaler.partial_fit)."""

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, values: np.ndarray):
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.n += 1
            delta = v - self.mean
            self.mean += delta / self.n
            self.m2 += delta * (v - self.mean)

    @property
    def std(self) -> float:
        return float(np.sqrt(self.m2 / self.n)) if self.n > 1 else 1.0


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Read a wav as float32 in [-1, 1], resampling if needed (the reference
    uses librosa.load at its default 22.05 kHz; LJSpeech is already 22050)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if sr != target_sr:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(sr, target_sr)
        wav = resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
    return wav


# --- process-pool plumbing (top level so it pickles) ------------------------
# The workers run the host part of an utterance (wav, TextGrid, pitch) and
# never touch a device: the parent computes every mel on its own device.
_POOL_PP = None


def _pool_init(config):
    global _POOL_PP
    _POOL_PP = Preprocessor(config, device="cpu")


def _pool_process(task):
    speaker, basename = task
    return _POOL_PP.load_utterance(speaker, basename)


class Preprocessor:
    """``device`` is where the mel and energy are computed: the card by
    default, which raises without one; ``"cpu"`` on the host."""

    def __init__(self, config: PreprocessConfig, device=None):
        self.config = config
        self.in_dir = config.raw_path
        self.out_dir = config.preprocessed_path
        self.val_size = config.val_size
        self.sampling_rate = config.audio.sampling_rate
        self.hop_length = config.audio.hop_length
        self.pitch_phoneme_averaging = config.pitch_feature == "phoneme_level"
        self.energy_phoneme_averaging = config.energy_feature == "phoneme_level"
        self.pitch_normalization = config.pitch_normalization
        self.energy_normalization = config.energy_normalization
        self.stft = MelSpectrogram(
            config.audio.filter_length, config.audio.hop_length,
            config.audio.win_length, config.audio.n_mel_channels,
            config.audio.sampling_rate, config.audio.mel_fmin,
            config.audio.mel_fmax, device=device)

    # -- alignment (reference: preprocessor/preprocessor.py:253-291) --------
    def get_alignment(self, tier) -> Tuple[List[str], List[int], float, float]:
        phones: List[str] = []
        durations: List[int] = []
        start_time = end_time = 0.0
        end_idx = 0
        for t in tier:
            s, e, p = t.start_time, t.end_time, t.text
            if phones == []:
                if p in SIL_PHONES:
                    continue  # trim leading silences
                start_time = s
            if p not in SIL_PHONES:
                phones.append(p)
                end_time = e
                end_idx = len(phones)
            else:
                phones.append(p)
            durations.append(int(
                np.round(e * self.sampling_rate / self.hop_length)
                - np.round(s * self.sampling_rate / self.hop_length)))
        return phones[:end_idx], durations[:end_idx], start_time, end_time

    # -- one utterance (reference: preprocessor/preprocessor.py:155-251) ----
    def load_utterance(self, speaker: str, basename: str):
        """The host part of one utterance: alignment, trimmed wav and
        frame-rate pitch, or None where the reference skips it."""
        wav_path = os.path.join(self.in_dir, speaker, f"{basename}.wav")
        text_path = os.path.join(self.in_dir, speaker, f"{basename}.lab")
        tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                               f"{basename}.TextGrid")

        tiers = read_textgrid(tg_path)
        if "phones" not in tiers:
            return None
        phone, duration, start, end = self.get_alignment(tiers["phones"])
        text = "{" + " ".join(phone) + "}"
        if start >= end:
            return None

        wav = load_wav(wav_path, self.sampling_rate)
        wav = wav[int(self.sampling_rate * start):
                  int(self.sampling_rate * end)].astype(np.float32)

        with open(text_path) as f:
            raw_text = f.readline().strip("\n")

        pitch = extract_pitch(wav, self.sampling_rate, self.hop_length)
        pitch = pitch[:sum(duration)]
        if np.sum(pitch != 0) <= 1:
            return None
        return speaker, basename, text, raw_text, duration, wav, pitch

    def finish_utterance(self, loaded):
        """The device part of one utterance (mel and energy), then the
        phoneme-level averages and the .npy saves."""
        speaker, basename, text, raw_text, duration, wav, pitch = loaded
        total = sum(duration)
        # bucketed extraction: identical values, one cuFFT plan per length
        # bucket instead of one per utterance
        mel, energy = self.stft.extract_bucketed(wav[None, :])
        mel = np.array(mel[0][:total])              # (frames, 80)
        energy = np.array(energy[0][:total])        # writable host copies

        if self.pitch_phoneme_averaging:
            pitch = interpolate_unvoiced(pitch)
            pos = 0
            for i, d in enumerate(duration):
                pitch[i] = np.mean(pitch[pos:pos + d]) if d > 0 else 0
                pos += d
            pitch = pitch[:len(duration)]

        if self.energy_phoneme_averaging:
            pos = 0
            for i, d in enumerate(duration):
                energy[i] = np.mean(energy[pos:pos + d]) if d > 0 else 0
                pos += d
            energy = energy[:len(duration)]

        np.save(os.path.join(self.out_dir, "duration",
                             f"{speaker}-duration-{basename}.npy"), duration)
        np.save(os.path.join(self.out_dir, "pitch",
                             f"{speaker}-pitch-{basename}.npy"), pitch)
        np.save(os.path.join(self.out_dir, "energy",
                             f"{speaker}-energy-{basename}.npy"), energy)
        np.save(os.path.join(self.out_dir, "mel",
                             f"{speaker}-mel-{basename}.npy"), mel)

        return ("|".join([basename, speaker, text, raw_text]),
                self.remove_outlier(pitch),
                self.remove_outlier(energy),
                mel.shape[0])

    def process_utterance(self, speaker: str, basename: str):
        loaded = self.load_utterance(speaker, basename)
        return None if loaded is None else self.finish_utterance(loaded)

    @staticmethod
    def remove_outlier(values: np.ndarray) -> np.ndarray:
        """IQR fence (reference: preprocessor/preprocessor.py:293-301)."""
        values = np.array(values)
        p25, p75 = np.percentile(values, 25), np.percentile(values, 75)
        lower = p25 - 1.5 * (p75 - p25)
        upper = p75 + 1.5 * (p75 - p25)
        return values[np.logical_and(values > lower, values < upper)]

    def normalize(self, in_dir: str, mean: float, std: float):
        """Rewrite .npy files as z-scores; track global min/max
        (reference: preprocessor/preprocessor.py:303-314)."""
        max_value, min_value = np.finfo(np.float64).min, np.finfo(np.float64).max
        for filename in os.listdir(in_dir):
            path = os.path.join(in_dir, filename)
            values = (np.load(path) - mean) / std
            np.save(path, values)
            max_value = max(max_value, float(np.max(values)))
            min_value = min(min_value, float(np.min(values)))
        return min_value, max_value

    # -- full corpus (reference: preprocessor/preprocessor.py:53-153) -------
    def _utterance_list(self):
        """(speaker, basename) pairs with both wav and TextGrid on disk,
        plus the speaker→id table, in the reference's iteration order."""
        tasks, speakers = [], {}
        speaker_list = sorted(os.listdir(self.in_dir))
        for i, speaker in enumerate(speaker_list):
            if not os.path.isdir(os.path.join(self.in_dir, speaker)):
                continue
            speakers[speaker] = i
            wavs = sorted(os.listdir(os.path.join(self.in_dir, speaker)))
            for wav_name in wavs:
                if ".wav" not in wav_name:
                    continue
                basename = wav_name.split(".")[0]
                tg_path = os.path.join(self.out_dir, "TextGrid", speaker,
                                       f"{basename}.TextGrid")
                if os.path.exists(tg_path):
                    tasks.append((speaker, basename))
        return tasks, speakers

    def build_from_path(self, verbose: bool = True, num_workers: int = 0):
        """num_workers > 1 fans the host part of each utterance (wav,
        TextGrid, pitch) over a pool of ``spawn``ed processes, which touch
        no device, while this process computes each mel on its device as
        the results arrive in order (the reference is single-process).
        The scalers see the same values in the same order as with
        ``num_workers=0``, so the outputs and stats.json are the same."""
        for sub in ["mel", "pitch", "energy", "duration"]:
            os.makedirs(os.path.join(self.out_dir, sub), exist_ok=True)

        out, n_frames = [], 0
        pitch_scaler, energy_scaler = RunningScaler(), RunningScaler()
        tasks, speakers = self._utterance_list()

        def add(ret):
            nonlocal n_frames
            if ret is None:
                return
            info, pitch, energy, n = ret
            out.append(info)
            if len(pitch) > 0:
                pitch_scaler.update(pitch)
            if len(energy) > 0:
                energy_scaler.update(energy)
            n_frames += n
            if verbose and len(out) % 500 == 0:
                print(f"  processed {len(out)} utterances")

        if num_workers and num_workers > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(
                    max_workers=num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_pool_init,
                    initargs=(self.config,)) as ex:
                for loaded in ex.map(_pool_process, tasks, chunksize=8):
                    add(None if loaded is None
                        else self.finish_utterance(loaded))
        else:
            for speaker, basename in tasks:
                add(self.process_utterance(speaker, basename))

        pitch_mean = pitch_scaler.mean if self.pitch_normalization else 0.0
        pitch_std = pitch_scaler.std if self.pitch_normalization else 1.0
        energy_mean = energy_scaler.mean if self.energy_normalization else 0.0
        energy_std = energy_scaler.std if self.energy_normalization else 1.0

        pitch_min, pitch_max = self.normalize(
            os.path.join(self.out_dir, "pitch"), pitch_mean, pitch_std)
        energy_min, energy_max = self.normalize(
            os.path.join(self.out_dir, "energy"), energy_mean, energy_std)

        with open(os.path.join(self.out_dir, "speakers.json"), "w") as f:
            json.dump(speakers, f)
        with open(os.path.join(self.out_dir, "stats.json"), "w") as f:
            json.dump({
                "pitch": [float(pitch_min), float(pitch_max),
                          float(pitch_mean), float(pitch_std)],
                "energy": [float(energy_min), float(energy_max),
                           float(energy_mean), float(energy_std)],
                # extra key (the reference writes only pitch/energy):
                # records which F0 backend built this dataset so
                # mixed-extractor datasets are detectable
                "pitch_extractor": extractor_name(),
            }, f)

        if verbose:
            hours = n_frames * self.hop_length / self.sampling_rate / 3600
            print(f"Total time: {hours:.2f} hours")

        random.shuffle(out)
        with open(os.path.join(self.out_dir, "train.txt"), "w",
                  encoding="utf-8") as f:
            for m in out[self.val_size:]:
                f.write(m + "\n")
        with open(os.path.join(self.out_dir, "val.txt"), "w",
                  encoding="utf-8") as f:
            for m in out[:self.val_size]:
                f.write(m + "\n")
        return out
