"""Inference engine: text → waveform on one card (counterpart of the JAX
package's ``infer.py``).

The host does the text frontend (cleaners + lexicon/G2P) and pads the
phoneme IDs to a length bucket.  On the card, the fused route runs the
acoustic model into a mel buffer sized speculatively from the phoneme
count, the folded HiFi-GAN vocodes it, and the waveform is wire-encoded.
The mel length is clamped on the card and reaches the vocoder (and its
kernels) as a device tensor, so nothing waits for the host between the
two models; the host reads the mel length once at the end and copies only
the valid ``mel_len × hop`` samples.  ``tts_batch`` runs a whole batch
through one such program (the vocoder's kernels row by row);
``tts_stream`` yields the audio of each pause-bounded segment as it is
done.  The split pipeline (``vocoder_mode="chunked"`` or
``fused_pipeline=False``) runs the acoustic model at the bucket's full
mel size, reads the mel length, and vocodes only the chunks that cover
it.

Every wait of the host for the card goes through one
``Synthesizer._device_get``, which a server arms with a deadline
(``fetch_timeout_s``): a read that misses it raises ``SynthesisTimeout``.

Each host phase is a span of ``utils/spans.py`` carrying the
synthesizer's id (``synth``): ``tts_batch`` (a call, id ``call``) with
``tts_batch.frontend``, ``.pack`` and ``.decode``; ``tts`` with
``tts.frontend``; ``tts_stream.frontend`` and ``tts_stream.segment``;
inside any of them ``synth.upload``, ``synth.acoustic``,
``synth.vocoder`` (``synth.vocoder.row`` per row of the kernel route),
``synth.encode``, ``synth.fetch.wait`` (the host blocked on the card) and
``synth.fetch.copy``; counters ``synth.rows``, ``synth.pad_rows``,
``synth.reruns`` and the vocoder's rows by route,
``synth.vocoder.kernel_rows`` and ``synth.vocoder.plain_rows``, with
``synth.vocoder.wide_rows`` (kernel-route rows whose 256-wide stage ran
in ``mrf_fused``) and K2's ``k2.wide_launches``.  The timings in each
call's info are read from these spans' stamps.
"""

import collections
import itertools
import os
import pickle
import threading
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from efficientspeech_tpu_torch.audio.transfer import (
    FORMATS, decode_host, elements_for_samples, encode_device,
    samples_for_elements)
from efficientspeech_tpu_torch.config import (
    HifiGanConfig, ModelConfig, PreprocessConfig)
from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.models.efficientspeech import EfficientSpeech
from efficientspeech_tpu_torch.models.hifigan import chunked_vocoder_call
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, folded_plan_apply, prepare_for_kernels)
from efficientspeech_tpu_torch.models.modules import cast_params_
from efficientspeech_tpu_torch.text.g2p import (
    get_lexicon_and_g2p, text2phoneme)
from efficientspeech_tpu_torch.text.symbols import PAD_ID, symbols
from efficientspeech_tpu_torch.utils import spans
from efficientspeech_tpu_torch.utils.tools import next_bucket
from efficientspeech_tpu_torch.weights import (
    init_params, load_jax_params, set_duration_bias)

DEFAULT_PHONEME_BUCKETS = (32, 64, 128, 256, 512)
# mel bucket = phoneme bucket × this (LJSpeech averages ~6.5 frames per
# phoneme; 16× leaves ample headroom)
MEL_EXPANSION = 16
# the mel buffer is sized speculatively from the phoneme count: 8 frames
# per phoneme until the tracker has observed the served model's ratio; an
# undershoot re-runs at the then-known length
SPEC_EXPANSION = 8
SPEC_MIN_FRAMES = 512
# the "folded_kernel" vocoder takes the kernel route (K1 and K2, row by
# row) on the card at every frame count: on an H100 it is 4.4-33x faster
# than the plain route at every shape measured, 1-32 rows at 128-8,192
# frames, bf16 and float32, fused and split callers
# (``probes/vocoder_route.py``; the table is in PERF.md §5, "The vocoder's
# two routes").  Off the card, where the kernel route runs the kernels'
# plain versions row by row, it starts at this many speculative frames:
# the JAX package's TPU v5e threshold, kept for the CPU only and not
# measured there
KERNEL_MIN_FRAMES = 2048
VOCODER_MODES = ("folded", "folded_kernel", "chunked")
# precompile's rows: this text's phonemes, repeated to fill each bucket
PRECOMPILE_TEXT = "the quick brown fox jumps over the lazy dog"


class SynthesisTimeout(TimeoutError):
    """A read from the card exceeded ``Synthesizer.fetch_timeout_s``.

    The serving layer maps it to HTTP 503 with Retry-After and opens its
    circuit breaker (``serve.py``): a card that is wedged or far behind
    fails its clients fast instead of holding them indefinitely."""


def to_host(tensors):
    """The read itself: each tensor copied to a numpy array."""
    return [t.cpu().numpy() for t in tensors]


class Synthesizer:
    """Holds the model on its device and serves ``tts(text)``."""

    # the speculation tracker is a max over this many recent syntheses, so
    # one outlier inflates the buffers for at most this many requests
    OBS_WINDOW = 64

    # the split pipeline vocodes the mel in chunks of VOCODER_CHUNK frames
    # (the chunk count rounded up to a power of two); the chunked mode's
    # conv generator gives each chunk a halo of VOCODER_HALO frames, more
    # than its receptive field (~13.7 frames)
    VOCODER_CHUNK = 128
    VOCODER_HALO = 16
    # mel frames per phoneme the split pipeline's first vocoder call
    # assumes (an undershoot re-runs the vocoder at the known length)
    SPECULATIVE_EXPANSION = 9

    def __init__(self, cfg: ModelConfig, hifigan_cfg: HifiGanConfig,
                 model: EfficientSpeech,
                 preprocess_cfg: Optional[PreprocessConfig] = None,
                 dtype=torch.bfloat16,
                 phoneme_buckets=DEFAULT_PHONEME_BUCKETS,
                 mel_expansion: int = MEL_EXPANSION,
                 vocoder_mode: str = "folded_kernel",
                 fused_pipeline: bool = True,
                 transfer: str = "int16",
                 spec_expansion: int = SPEC_EXPANSION,
                 device=None):
        """``vocoder_mode``: "folded" runs every vocoder op as a plain
        matmul; "folded_kernel" runs the 128-wide ops and each stage's MRF
        in the CUDA kernels (on the card at every frame count, elsewhere
        from ``KERNEL_MIN_FRAMES`` speculative frames on); "chunked" runs
        the conv generator over time-folded chunks in the split pipeline,
        which ``fused_pipeline=False`` selects for the folded modes too.
        ``transfer``: the PCM wire format of the fused route (one of
        ``FORMATS``).  ``dtype``: the acoustic model's compute dtype and
        the vocoder's matmul operand precision."""
        if vocoder_mode not in VOCODER_MODES:
            raise ValueError(f"vocoder_mode {vocoder_mode!r} not in "
                             f"{VOCODER_MODES}")
        if transfer not in FORMATS:
            raise ValueError(f"transfer {transfer!r} not in {FORMATS}")
        if transfer == "adpcm2":
            warnings.warn(
                "transfer='adpcm2' is a bandwidth-stretch codec (27 dB SNR "
                "on speech, audibly gritty); prefer 'adpcm4' unless the "
                "batched wire's bandwidth is the bottleneck", stacklevel=2)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hifigan_cfg = hifigan_cfg
        self.dtype = dtype
        self.vocoder_mode = vocoder_mode
        self.fused_pipeline = fused_pipeline
        self.transfer = transfer
        self.phoneme_buckets = tuple(phoneme_buckets)
        self.mel_expansion = mel_expansion
        self.spec_expansion = spec_expansion
        self.spec_min_frames = SPEC_MIN_FRAMES
        self.preprocess_cfg = preprocess_cfg or PreprocessConfig()
        self.lexicon, self.g2p = get_lexicon_and_g2p(self.preprocess_cfg)
        self.sampling_rate = self.preprocess_cfg.audio.sampling_rate
        self.hop_length = self.preprocess_cfg.audio.hop_length
        self._obs_ratio = None
        self._obs_recent = collections.deque(maxlen=self.OBS_WINDOW)
        # the deadline of every read from the card (seconds; None waits
        # forever, a library caller's default); ``_fetch_fn`` stands in for
        # the read (``to_host``) in tests; ``_live_fetches`` counts the
        # reads in flight, those a deadline abandoned included
        self.fetch_timeout_s = None
        self._fetch_fn = None
        self._live_fetches = 0
        self._fetch_lock = threading.Lock()
        # every span of this synthesizer carries its id ``synth``; each
        # ``tts_batch`` / ``tts`` call takes the next ``call`` id
        self.span_id = spans.new_synth()
        self._calls = itertools.count()

        model = model.to(self.device).eval()
        # Linear and conv weights in ``dtype``; LayerNorm and embedding
        # parameters stay float32, as the JAX modules keep them
        self.acoustic = cast_params_(model.phoneme2mel, dtype)
        with torch.no_grad():
            arrays, self.fold_meta = fold_hifigan(model.hifigan, dtype)
            self.folded, self.mrf = prepare_for_kernels(
                arrays, self.fold_meta, hifigan_cfg)
        # the conv generator, computing in ``dtype``: the chunked mode's
        self.generator = cast_params_(model.hifigan, dtype)

    def _span(self, name: str, **ids):
        return spans.span(name, synth=self.span_id, **ids)

    # --- frontend ----------------------------------------------------------
    def phonemize(self, text: str) -> np.ndarray:
        return text2phoneme(self.lexicon, self.g2p, text, self.preprocess_cfg)

    def _pad_to_bucket(self, seq: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
        n = len(seq)
        bucket = next_bucket(n, self.phoneme_buckets)
        n = min(n, bucket)
        phoneme = np.zeros((1, bucket), dtype=np.int32)
        phoneme[0, :n] = seq[:n]
        pad_mask = np.ones((1, bucket), dtype=bool)
        pad_mask[0, :n] = False
        return phoneme, pad_mask, bucket

    # --- speculative buffer sizing -------------------------------------------
    def _observe_ratio(self, mel_len: int, n_phonemes: int):
        """Track the served model's frames per phoneme as the max over the
        last ``OBS_WINDOW`` syntheses."""
        if n_phonemes > 0 and mel_len > 0:
            self._obs_recent.append(mel_len / n_phonemes)
            self._obs_ratio = max(self._obs_recent)

    def _spec_levels(self, bucket: int):
        """{pow2, 1.5·pow2} frame-count ladder up to the bucket's cap."""
        cap = bucket * self.mel_expansion
        levels, f = [], self.spec_min_frames
        while f < cap:
            levels.append(f)
            if f * 3 // 2 < cap and f * 3 % 2 == 0 and f >= 1024:
                levels.append(f * 3 // 2)
            f *= 2
        levels.append(cap)
        return sorted(set(levels))

    def _spec_frames(self, n_phonemes: int, bucket: int,
                     min_frames: int = 0) -> int:
        """Speculative mel-frame count: observed ratio × 1.2 once warm
        (else the static expansion), quantized up to the level ladder;
        ``min_frames`` forces a floor (the undershoot re-run)."""
        exp = self.spec_expansion
        if self._obs_ratio is not None:
            exp = min(exp, max(4.0, self._obs_ratio * 1.2))
        need = max(self.spec_min_frames, int(np.ceil(n_phonemes * exp)),
                   min_frames)
        for level in self._spec_levels(bucket):
            if level >= need:
                return level
        return bucket * self.mel_expansion

    # --- reads from the card ------------------------------------------------
    def _device_get(self, *tensors):
        """Copy ``tensors`` to the host as numpy arrays: the one place a
        request waits for the card.  On the card, an event recorded on the
        current stream (the one stream all synthesis runs on) marks the end
        of the work queued so far; the read waits for it, then copies.
        With ``fetch_timeout_s`` set, the read runs on a daemon thread and
        the caller gets ``SynthesisTimeout`` once the deadline passes; the
        thread stays parked on the event until the card gets there (a
        launched kernel cannot be cancelled), and ``pending_fetches``
        counts it until then."""
        fetch = self._fetch_fn or to_host
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        # the read's spans belong to the caller's, on whichever thread
        caller = spans.current()

        def read():
            try:
                with spans.span("synth.fetch.wait", parent=caller,
                                synth=self.span_id):
                    if done is not None:
                        done.synchronize()
                with spans.span("synth.fetch.copy", parent=caller,
                                synth=self.span_id):
                    return fetch(tensors)
            finally:
                with self._fetch_lock:
                    self._live_fetches -= 1

        with self._fetch_lock:
            self._live_fetches += 1
        if self.fetch_timeout_s is None:
            return read()
        box = {}

        def run():
            try:
                box["out"] = read()
            except BaseException as e:  # raised in the caller below
                box["err"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(self.fetch_timeout_s)
        if t.is_alive():
            raise SynthesisTimeout(
                f"read from the card exceeded the {self.fetch_timeout_s:.1f}"
                f" s deadline (card wedged or far behind)")
        if "err" in box:
            raise box["err"]
        return box["out"]

    def pending_fetches(self) -> int:
        """Reads from the card in flight, with a deadline or without one,
        those a deadline abandoned included (their threads still wait on
        the card).  A worker recycle waits for 0 before it re-execs."""
        with self._fetch_lock:
            return self._live_fetches

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → card tensor without a host wait: through pinned
        memory, copied in stream order (a pageable copy would wait for the
        stream's earlier work: outside any deadline, and between programs
        that could have queued back to back).  PyTorch's pinned
        allocator keeps the staging block until the copy has run."""
        with self._span("synth.upload"):
            t = torch.from_numpy(arr)
            if self.device.type != "cuda":
                return t
            return t.pin_memory().to(self.device, non_blocking=True)

    # --- the device programs --------------------------------------------
    def _predict(self, phoneme: np.ndarray, frames: int,
                 speaker: Optional[int] = None):
        """The acoustic model on phoneme IDs (B, bucket) at ``frames`` mel
        frames, on the card.  With ``fetch_timeout_s`` set, the host first
        waits within the deadline for the work already queued
        (``_device_get()`` of nothing): a program adds no launches to a
        stream that is wedged or behind, where a full launch queue would
        hold the host outside any deadline, and no program starts while
        one whose read a deadline abandoned is still running.  Without a
        deadline nothing waits here, so programs queue back to back."""
        if self.device.type == "cuda" and self.fetch_timeout_s is not None:
            self._device_get()
        ph = self._upload(phoneme)
        spk = (None if speaker is None else
               self._upload(np.array([speaker], np.int64)))
        with self._span("synth.acoustic"):
            return self.acoustic(ph, ph == PAD_ID, max_mel_len=frames,
                                 speaker=spk)

    def _vocode_folded(self, mel: torch.Tensor,
                       mel_len: torch.Tensor) -> torch.Tensor:
        """The folded vocoder (B, T, M) → (B, T·hop) float32, through the
        kernels in "folded_kernel" mode (row by row at B > 1; off the card
        from ``KERNEL_MIN_FRAMES`` frames on); ``mel_len`` (B,) stays on
        the card.  The B rows count under ``synth.vocoder.kernel_rows`` or
        ``.plain_rows``."""
        use_kernel = (self.vocoder_mode == "folded_kernel"
                      and (self.device.type == "cuda"
                           or mel.shape[1] >= KERNEL_MIN_FRAMES))
        spans.count("synth.vocoder.kernel_rows" if use_kernel
                    else "synth.vocoder.plain_rows", mel.shape[0],
                    synth=self.span_id)
        with self._span("synth.vocoder"):
            return folded_plan_apply(
                self.folded, self.fold_meta, self.hifigan_cfg, mel,
                valid_len=torch.clamp(mel_len, max=mel.shape[1]),
                dtype=self.dtype, use_kernel=use_kernel, fuse_mrf=use_kernel,
                mrf=self.mrf)

    @torch.no_grad()
    def _run(self, phoneme: np.ndarray, frames: int,
             speaker: Optional[int] = None):
        """The fused route's program: phoneme IDs (B, bucket) → (wire-
        encoded PCM (B, ·) on the card, unclamped mel_len (B,) on the
        card, durations)."""
        pred = self._predict(phoneme, frames, speaker)
        wav = self._vocode_folded(pred["mel"], pred["mel_len"])
        with self._span("synth.encode"):
            pcm = encode_device(wav, self.transfer)
        return pcm, pred["mel_len"], pred["duration"]

    @torch.no_grad()
    def _acoustic_split(self, phoneme: np.ndarray,
                        speaker: Optional[int] = None):
        """The split pipeline's acoustic call, at the bucket's full
        ``bucket × mel_expansion`` frames: (mel, unclamped mel_len,
        durations) on the card."""
        pred = self._predict(phoneme, phoneme.shape[1] * self.mel_expansion,
                             speaker)
        return pred["mel"], pred["mel_len"], pred["duration"]

    @torch.no_grad()
    def _vocode_split(self, mel: torch.Tensor,
                      mel_len: torch.Tensor) -> torch.Tensor:
        """The split pipeline's vocoder on a mel slice (B, slice, M): the
        folded vocoder to int16 PCM, or in the chunked mode the conv
        generator over VOCODER_CHUNK-frame chunks to float."""
        if self.vocoder_mode == "chunked":
            with self._span("synth.vocoder"):
                return chunked_vocoder_call(
                    lambda c, v, st: self.generator(c, valid_len=v,
                                                    valid_start=st),
                    self.hifigan_cfg.total_upsample, mel, mel_len,
                    chunk_frames=self.VOCODER_CHUNK,
                    halo=self.VOCODER_HALO).float()
        wav = self._vocode_folded(mel, mel_len)
        with self._span("synth.encode"):
            return encode_device(wav, "int16")

    @staticmethod
    def _chunk_bucket(n_chunks: int) -> int:
        """The least power of two >= n_chunks (a chunk count or a batch
        size)."""
        b = 1
        while b < n_chunks:
            b *= 2
        return b

    def _split_slice(self, mel_len: int, max_frames: int) -> int:
        """Frames the split pipeline vocodes for ``mel_len``: whole
        chunks, their count rounded up to a power of two."""
        chunk = self.VOCODER_CHUNK
        n_chunks = self._chunk_bucket(max(1, -(-mel_len // chunk)))
        return min(n_chunks * chunk, max_frames)

    @staticmethod
    def _to_float(wav: np.ndarray) -> np.ndarray:
        if wav.dtype == np.int16:
            return wav.astype(np.float32) / 32768.0
        return np.asarray(wav, np.float32)

    def synthesize_ids(self, seq: np.ndarray, speaker: Optional[int] = None):
        """Phoneme IDs → (wav float32 numpy, trimmed; mel_len; durations on
        the card).  If the speculative buffer undershoots the true mel
        length, the utterance re-runs at a size that holds it."""
        phoneme, _, bucket = self._pad_to_bucket(seq)
        spans.count("synth.rows", synth=self.span_id)
        if not self.fused_pipeline or self.vocoder_mode == "chunked":
            return self._synthesize_split(seq, phoneme, speaker)
        n_valid = int(min(len(seq), bucket))
        spec = self._spec_frames(n_valid, bucket)
        pcm, mel_len_dev, duration = self._run(phoneme, spec, speaker)
        mel_len = int(self._device_get(mel_len_dev[:1])[0][0])
        self._observe_ratio(mel_len, n_valid)
        if mel_len > spec:
            full = bucket * self.mel_expansion
            if spec < full:
                spans.count("synth.reruns", synth=self.span_id)
                spec = self._spec_frames(n_valid, bucket,
                                         min_frames=min(mel_len, full))
                pcm, mel_len_dev, duration = self._run(phoneme, spec,
                                                       speaker)
                mel_len = int(self._device_get(mel_len_dev[:1])[0][0])
            mel_len = min(mel_len, full)
        n = mel_len * self.hifigan_cfg.total_upsample
        pcm = pcm[0, :elements_for_samples(self.transfer, n)]
        wav = decode_host(self._device_get(pcm)[0], self.transfer)[:n]
        return wav, mel_len, duration

    def _synthesize_split(self, seq: np.ndarray, phoneme: np.ndarray,
                          speaker: Optional[int] = None):
        """The split pipeline: the acoustic call, then the vocoder on a
        slice sized for SPECULATIVE_EXPANSION frames a phoneme; an
        undershoot vocodes again at the now-known length."""
        n_valid = int(min(len(seq), self.phoneme_buckets[-1]))
        mel, mel_len_dev, duration = self._acoustic_split(phoneme, speaker)
        slice_len = self._split_slice(
            n_valid * self.SPECULATIVE_EXPANSION, mel.shape[1])
        wav = self._vocode_split(mel[:, :slice_len], mel_len_dev)
        mel_len = min(int(self._device_get(mel_len_dev[:1])[0][0]),
                      mel.shape[1])
        if mel_len > slice_len:
            spans.count("synth.reruns", synth=self.span_id)
            slice_len = self._split_slice(mel_len, mel.shape[1])
            wav = self._vocode_split(mel[:, :slice_len], mel_len_dev)
        n = mel_len * self.hifigan_cfg.total_upsample
        return (self._to_float(self._device_get(wav[0, :n])[0]), mel_len,
                duration)

    def tts_ids_timed(self, seq: np.ndarray, speaker: Optional[int] = None):
        """Synthesize a phoneme sequence of any length: segments beyond the
        largest bucket and concatenates the waveforms."""
        segments = self._segment(seq)
        if len(segments) == 1:
            return self.synthesize_ids(segments[0], speaker=speaker)
        wavs, total_mel, duration = [], 0, None
        for seg in segments:
            w, m, duration = self.synthesize_ids(seg, speaker=speaker)
            wavs.append(w)
            total_mel += m
        return np.concatenate(wavs), total_mel, duration

    def _segment(self, seq: np.ndarray, max_len: Optional[int] = None):
        """Split a phoneme sequence longer than ``max_len`` (default: the
        largest bucket) at pause ({sp}) boundaries, or hard boundaries as a
        fallback."""
        max_bucket = max_len or self.phoneme_buckets[-1]
        if len(seq) <= max_bucket:
            return [np.asarray(seq)]
        sp_id = symbols.index("@sp")
        segments, start = [], 0
        while len(seq) - start > max_bucket:
            window = seq[start: start + max_bucket]
            cuts = np.where(window == sp_id)[0]
            cut = int(cuts[-1]) + 1 if len(cuts) else max_bucket
            segments.append(np.asarray(seq[start: start + cut]))
            start += cut
        if start < len(seq):
            segments.append(np.asarray(seq[start:]))
        return segments

    def tts(self, text: str, verbose: bool = False,
            speaker: Optional[int] = None):
        """Text → (wav, info with stage timings and RTF)."""
        with self._span("tts", call=next(self._calls)) as call:
            with spans.span("tts.frontend") as frontend:
                seq = self.phonemize(text)
            wav, mel_len, _ = self.tts_ids_timed(seq, speaker=speaker)
        voice_len = len(wav) / self.sampling_rate
        elapsed = call.secs
        model = (call.end_ns - frontend.end_ns) / 1e9
        info = {
            "phoneme_len": len(seq),
            "mel_len": mel_len,
            "voice_secs": voice_len,
            "frontend_secs": frontend.secs,
            "model_secs": model,
            "total_secs": elapsed,
            "rtf": voice_len / elapsed if elapsed > 0 else float("inf"),
            "model_rtf": voice_len / model if model > 0 else float("inf"),
        }
        if verbose:
            print(f"voice: {voice_len:.2f}s  synth: {elapsed * 1e3:.2f}ms  "
                  f"RTF: {info['rtf']:.1f}")
        return wav, info

    def tts_stream(self, text: str, segment_phonemes: Optional[int] = None):
        """Streaming synthesis: yields (wav float32, info) per pause-bounded
        ({sp}) segment of at most ``segment_phonemes`` (default a quarter
        of the largest bucket), so the first audio waits for one
        segment's synthesis, not the whole text's."""
        call = next(self._calls)
        with self._span("tts_stream.frontend", call=call):
            seq = self.phonemize(text)
            max_len = min(
                segment_phonemes or self.phoneme_buckets[-1] // 4 or 1,
                self.phoneme_buckets[-1])
            segments = self._segment(seq, max_len)
        for idx, seg in enumerate(segments):
            # closed before the yield: the caller's code runs in between
            with self._span("tts_stream.segment", call=call,
                            segment=idx) as sp:
                wav, mel_len, _ = self.synthesize_ids(seg)
            yield wav, {"segment": idx, "n_segments": len(segments),
                        "mel_len": mel_len, "phonemes": len(seg),
                        "secs": sp.secs}

    def tts_batch(self, texts):
        """Batched synthesis (serving throughput): every text is
        phonemized and segmented at its pauses beyond the largest bucket
        (never truncated), and all segments run through one fused program:
        the batch padded to a power of two (the extra rows all PAD, mel
        length 0), one bucket, speculative frames sized from the longest
        row.  The host then copies the real rows once, cut at the longest
        row's samples.  Returns (wav float32, info) per text."""
        if not self.fused_pipeline or self.vocoder_mode == "chunked":
            return self._tts_batch_split(texts)
        with self._span("tts_batch", call=next(self._calls)):
            with spans.span("tts_batch.frontend"):
                rows, owner = [], []
                for ti, text in enumerate(texts):
                    for seg in self._segment(self.phonemize(text)):
                        rows.append(seg)
                        owner.append(ti)
            with spans.span("tts_batch.pack") as pack:
                b = len(rows)
                b_pad = self._chunk_bucket(b)
                spans.count("synth.rows", b)
                spans.count("synth.pad_rows", b_pad - b)
                max_len = max(len(r) for r in rows)
                bucket = next_bucket(max_len, self.phoneme_buckets)
                spec = self._spec_frames(min(max_len, bucket), bucket)
                phoneme = np.zeros((b_pad, bucket), np.int32)
                for i, r in enumerate(rows):
                    phoneme[i, : len(r)] = r[: bucket]
            up = self.hifigan_cfg.total_upsample

            def run(spec):
                pcm, mel_len_dev, _ = self._run(phoneme, spec)
                mel_lens = self._device_get(mel_len_dev[:b])[0]
                n = min(int(mel_lens.max()), spec) * up
                cut = elements_for_samples(self.transfer, n)
                return self._device_get(pcm[:b, :cut])[0], mel_lens

            pcm_np, mel_lens = run(spec)
            for i, r in enumerate(rows):
                self._observe_ratio(int(mel_lens[i]), len(r))
            full = bucket * self.mel_expansion
            if mel_lens.max() > spec and spec < full:  # undershoot: re-run
                spans.count("synth.reruns")
                spec = self._spec_frames(
                    min(max_len, bucket), bucket,
                    min_frames=min(int(mel_lens.max()), full))
                pcm_np, mel_lens = run(spec)
            mel_lens = np.minimum(mel_lens, samples_for_elements(
                self.transfer, pcm_np.shape[1]) // up)
            with spans.span("tts_batch.decode") as decode:
                # the program and its reads, the re-run included
                elapsed = (decode.start_ns - pack.end_ns) / 1e9
                per_text_wavs = [[] for _ in texts]
                per_text_mel = [0] * len(texts)
                for i in range(b):
                    n = int(mel_lens[i]) * up
                    w = decode_host(
                        pcm_np[i][: elements_for_samples(self.transfer, n)],
                        self.transfer)[:n]
                    per_text_wavs[owner[i]].append(w)
                    per_text_mel[owner[i]] += int(mel_lens[i])
                out = []
                for ti in range(len(texts)):
                    w = (np.concatenate(per_text_wavs[ti])
                         if per_text_wavs[ti] else np.zeros(0, np.float32))
                    out.append((w, {"voice_secs": len(w) / self.sampling_rate,
                                    "batch_secs": elapsed,
                                    "mel_len": per_text_mel[ti]}))
        return out

    def _tts_batch_split(self, texts):
        """Batched synthesis on the split pipeline (the chunked mode's):
        one acoustic call for the batch, then one vocoder call on the
        chunks that cover the longest row.  Each text takes one row, cut
        at the largest bucket."""
        with self._span("tts_batch", call=next(self._calls)):
            with spans.span("tts_batch.frontend"):
                seqs = [self.phonemize(t) for t in texts]
            with spans.span("tts_batch.pack") as pack:
                b = len(seqs)
                spans.count("synth.rows", b)
                bucket = next_bucket(max(len(s) for s in seqs),
                                     self.phoneme_buckets)
                phoneme = np.zeros((b, bucket), np.int32)
                for i, s in enumerate(seqs):
                    n = min(len(s), bucket)
                    phoneme[i, :n] = s[:n]

            mel, mel_len_dev, _ = self._acoustic_split(phoneme)
            mel_lens = np.minimum(self._device_get(mel_len_dev)[0],
                                  mel.shape[1])
            slice_len = self._split_slice(int(mel_lens.max()), mel.shape[1])
            wavs = self._vocode_split(mel[:, :slice_len], mel_len_dev)
            wavs = self._device_get(wavs)[0]

            with spans.span("tts_batch.decode") as decode:
                elapsed = (decode.start_ns - pack.end_ns) / 1e9
                out = []
                up = self.hifigan_cfg.total_upsample
                for i in range(b):
                    w = self._to_float(wavs[i, : int(mel_lens[i]) * up])
                    out.append((w, {"voice_secs": len(w) / self.sampling_rate,
                                    "batch_secs": elapsed,
                                    "mel_len": int(mel_lens[i])}))
        return out

    def warmup(self, text: str, iters: int = 10) -> int:
        """Run this text's shapes ``iters`` times; returns its phoneme
        count."""
        seq = self.phonemize(text)
        for _ in range(iters):
            self.synthesize_ids(seq)
        return len(seq)

    @torch.no_grad()
    def precompile(self, buckets, batch_sizes=(1,)):
        """Pay the first-use costs of serving shapes before traffic: for
        each bucket (at its speculative frames for a full bucket) and batch
        size, one eager run with real phonemes in every row, its output
        discarded.  That builds and loads the kernel libraries, encodes
        K2's tensor maps, sets up the libraries' handles and grows the
        caching allocator.  The speculation tracker is left as it was:
        warm runs are not traffic.  Returns the (batch, bucket, frames)
        shapes warmed."""
        text = self.phonemize(PRECOMPILE_TEXT)
        done = []
        for b in sorted(set(buckets)):
            row = np.resize(text, b).astype(np.int32)
            frames = self._spec_frames(b, b)
            for bs in sorted(set(batch_sizes)):
                phoneme = np.tile(row, (bs, 1))
                if self.fused_pipeline and self.vocoder_mode != "chunked":
                    _, mel_len, _ = self._run(phoneme, frames)
                else:
                    mel, mel_len, _ = self._acoustic_split(phoneme)
                    self._vocode_split(mel[:, :self._split_slice(
                        b * self.SPECULATIVE_EXPANSION, mel.shape[1])],
                        mel_len)
                self._device_get(mel_len)
                done.append((bs, b, frames))
        return done


def load_checkpoint_params(model: EfficientSpeech, checkpoint: str) -> bool:
    """Load a checkpoint of the port into ``model``: a ``step_*.pt`` file
    of its trainer, or a directory whose latest one is read, into
    ``model.phoneme2mel``; a parameter file of the convert CLI
    (``save_model_params``) also into ``model.hifigan``.  Returns whether
    the vocoder was among them."""
    from efficientspeech_tpu_torch.training.checkpoint import (
        latest_checkpoint)

    path = checkpoint
    if os.path.isdir(checkpoint):
        path = latest_checkpoint(checkpoint)
        if path is None:
            raise FileNotFoundError(f"no step_*.pt checkpoint in "
                                    f"{checkpoint}")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.phoneme2mel.load_state_dict(payload["params"], strict=True)
    if "hifigan" in payload:
        model.hifigan.load_state_dict(payload["hifigan"], strict=True)
    return "hifigan" in payload


def save_model_params(path: str, model: EfficientSpeech):
    """The port's native parameter file: ``{"params": the acoustic
    model's state dict, "hifigan": the vocoder's}``, float32 as the
    model holds them, which ``build_synthesizer(checkpoint=)`` and every
    CLI's ``--checkpoint`` load."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": model.phoneme2mel.state_dict(),
                "hifigan": model.hifigan.state_dict()}, path)


def _is_port_checkpoint(path: str) -> bool:
    """A directory of ``step_*.pt`` files, or a file holding the port
    trainer's payload (``params``), as opposed to a reference ``.ckpt``
    (a ``state_dict`` of ``phoneme2mel.*`` keys), whatever its name."""
    if os.path.isdir(path):
        return True
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a Lightning file's hyper_parameters
        return False
    return isinstance(payload, dict) and "params" in payload


def load_reference_params(model: EfficientSpeech, checkpoint: str):
    """Load a reference EfficientSpeech checkpoint (a Lightning ``.ckpt``,
    or a ``.pt``/``.pth`` of the same state dict) into ``model``: its
    ``phoneme2mel.*`` weights, and its ``hifigan.*`` ones where it has
    them (counterpart of the JAX package's ``infer.py:1085-1091``).
    Returns whether the vocoder was among them."""
    from efficientspeech_tpu_torch.convert.from_torch import (
        _torch_load_numpy, convert_efficientspeech_state_dict)

    sd = _torch_load_numpy(checkpoint)
    if not any(k.startswith("phoneme2mel.") for k in sd):
        raise ValueError(f"{checkpoint}: neither a reference checkpoint "
                         "(no phoneme2mel.* weights) nor one of the "
                         "port's trainer")
    cfg = model.cfg
    tree = convert_efficientspeech_state_dict(
        sd, depth=cfg.depth, n_blocks=cfg.n_blocks,
        block_depth=cfg.block_depth,
        num_kernels=len(model.hifigan_cfg.resblock_kernel_sizes))
    for name, subtree in tree.items():
        load_jax_params(getattr(model, name), subtree)
    return "hifigan" in tree


def build_model(preset: str = "tiny",
                params=None,
                checkpoint: Optional[str] = None,
                hifigan_checkpoint: Optional[str] = None,
                hifigan_cfg: Optional[HifiGanConfig] = None,
                hifigan_config: Optional[str] = None,
                stats: Optional[dict] = None,
                seed: int = 0,
                bench_duration_bias: Optional[float] = None,
                model_overrides: Optional[dict] = None) -> EfficientSpeech:
    """The float32 ``EfficientSpeech`` on the CPU (its ``cfg`` and
    ``hifigan_cfg`` attached) from a JAX-layout parameter tree
    (``params``, with ``phoneme2mel`` and ``hifigan`` subtrees) or,
    without one, from a native random init seeded by ``seed``; the
    arguments are ``build_synthesizer``'s."""
    overrides = dict(model_overrides or {})
    if stats is not None:
        overrides.setdefault("pitch_stats", tuple(stats["pitch"][:2]))
        overrides.setdefault("energy_stats", tuple(stats["energy"][:2]))
    cfg = ModelConfig.preset(preset, **overrides)
    if hifigan_config is None and hifigan_checkpoint:
        beside = os.path.join(os.path.dirname(hifigan_checkpoint),
                              "config.json")
        hifigan_config = beside if os.path.isfile(beside) else None
    if hifigan_cfg is None:
        hifigan_cfg = (HifiGanConfig.from_json(hifigan_config)
                       if hifigan_config else HifiGanConfig())
    model = EfficientSpeech(cfg, hifigan_cfg)
    vocoder_loaded = params is not None
    if params is not None:
        load_jax_params(model, params)
    else:
        init_params(model, seed)
        if bench_duration_bias is not None:
            set_duration_bias(model, bench_duration_bias)
    if checkpoint is not None:
        if _is_port_checkpoint(checkpoint):
            vocoder_loaded |= load_checkpoint_params(model, checkpoint)
        else:
            vocoder_loaded |= load_reference_params(model, checkpoint)
    if (not vocoder_loaded and hifigan_checkpoint
            and os.path.isfile(hifigan_checkpoint)):
        from efficientspeech_tpu_torch.convert.from_torch import (
            load_hifigan_checkpoint)

        load_jax_params(model.hifigan, load_hifigan_checkpoint(
            hifigan_checkpoint,
            num_kernels=len(hifigan_cfg.resblock_kernel_sizes)))
    return model


def build_synthesizer(preset: str = "tiny",
                      params=None,
                      checkpoint: Optional[str] = None,
                      hifigan_checkpoint: Optional[str] = None,
                      hifigan_cfg: Optional[HifiGanConfig] = None,
                      hifigan_config: Optional[str] = None,
                      preprocess_cfg: Optional[PreprocessConfig] = None,
                      stats: Optional[dict] = None,
                      dtype=torch.bfloat16,
                      seed: int = 0,
                      bench_duration_bias: Optional[float] = None,
                      transfer: str = "int16",
                      vocoder_mode: str = "folded_kernel",
                      model_overrides: Optional[dict] = None,
                      device=None) -> Synthesizer:
    """Build a Synthesizer from a JAX-layout parameter tree (``params``,
    with ``phoneme2mel`` and ``hifigan`` subtrees) or, without one, from a
    native random init seeded by ``seed``.

    ``checkpoint`` then replaces the acoustic model's parameters: a
    reference EfficientSpeech checkpoint (``.ckpt``/``.pt``/``.pth``
    holding ``phoneme2mel.*`` weights, and the vocoder's too where it has
    ``hifigan.*`` ones), a checkpoint of the port's trainer (a
    ``step_*.pt`` file or its directory), or a parameter file of the
    port's convert CLI (``save_model_params``, the vocoder's too); the
    file's contents tell them apart.  ``hifigan_checkpoint``, when that
    file exists, is a reference HiFi-GAN generator file (``{"generator": state_dict}``) that replaces
    the vocoder's parameters, unless ``params`` or ``checkpoint`` brought
    them.  Otherwise the vocoder stays the random init.

    ``hifigan_cfg`` / ``hifigan_config`` (a config.json path; default the
    ``config.json`` beside ``hifigan_checkpoint`` where there is one)
    choose the vocoder's shape, else the LJ_V2 widths.  ``stats`` (the
    corpus's stats.json) sets the pitch and energy bins.
    ``bench_duration_bias`` sets the duration head's bias of a random init
    only (random weights otherwise predict ~0 frames); loaded ``params``
    keep their own, as in the JAX package.  ``device`` defaults to the
    card and raises without one."""
    device = resolve_device(device)
    model = build_model(preset, params=params, checkpoint=checkpoint,
                        hifigan_checkpoint=hifigan_checkpoint,
                        hifigan_cfg=hifigan_cfg,
                        hifigan_config=hifigan_config, stats=stats,
                        seed=seed, bench_duration_bias=bench_duration_bias,
                        model_overrides=model_overrides)
    return Synthesizer(model.cfg, model.hifigan_cfg, model,
                       preprocess_cfg=preprocess_cfg, dtype=dtype,
                       transfer=transfer, vocoder_mode=vocoder_mode,
                       device=device)
