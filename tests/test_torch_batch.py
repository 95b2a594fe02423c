"""Batched, streamed and chunked serving: the port's Synthesizer against
the JAX package's on the same parameters (the small fixture of
test_torch_synth.py), the chunked vocoder call against the JAX one and
the unchunked generator, and the kernel route at batch > 1 (the kernels'
plain versions on the CPU) against the folded route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.infer import Synthesizer as JaxSynthesizer
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu.models.hifigan import (
    vocode_chunked as jax_vocode_chunked)
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.infer import build_synthesizer
from efficientspeech_tpu_torch.models.hifigan import (
    CHUNK_HALO_FRAMES, HifiGanGenerator, vocode_chunked)
from efficientspeech_tpu_torch.weights import load_jax_params

from test_torch_synth import SMALL_HIFIGAN, _small_setup, synths  # noqa: F401

torch.set_num_threads(2)

TEXTS = ["hello world", "a much longer sentence spoken here", "hi"]
# more phonemes than the fixture's one bucket (16): segmented at pauses
OVERLONG = "hello there, my friend. " * 3
# test_synthesize_ids_matches_jax's tolerance: float32 on both sides,
# sums in another order
RTOL, ATOL = 1e-3, 2e-4


def _reset(*synths):
    """Forget the observed frames-per-phoneme ratio, so both packages size
    their buffers alike."""
    for s in synths:
        s._obs_ratio = None
        if s._obs_recent is not None:
            s._obs_recent.clear()


def _assert_outs_match(outs_p, outs_j):
    assert len(outs_p) == len(outs_j)
    for (wav_p, info_p), (wav_j, info_j) in zip(outs_p, outs_j):
        assert info_p["mel_len"] == info_j["mel_len"] > 0
        assert wav_p.shape == wav_j.shape
        np.testing.assert_allclose(wav_p, wav_j, rtol=RTOL, atol=ATOL)


def test_tts_batch_matches_jax(synths):
    """The fused batch (folded, f32 wire), an overlong text segmented."""
    jsynth, psynth = synths
    assert len(psynth.phonemize(OVERLONG)) > psynth.phoneme_buckets[-1]
    texts = TEXTS + [OVERLONG]
    _reset(jsynth, psynth)
    outs_j = jsynth.tts_batch(texts)
    outs_p = psynth.tts_batch(texts)
    _assert_outs_match(outs_p, outs_j)
    hop = psynth.hifigan_cfg.total_upsample
    for wav, info in outs_p:
        assert wav.shape == (info["mel_len"] * hop,)
        assert info["voice_secs"] == len(wav) / psynth.sampling_rate


def test_tts_batch_rows_match_single_requests(synths):
    """Each text's batched waveform is its single request's."""
    _, psynth = synths
    _reset(psynth)
    outs = psynth.tts_batch(TEXTS + [OVERLONG])
    for text, (wav_b, info) in zip(TEXTS + [OVERLONG], outs):
        wav_s, mel_s, _ = psynth.tts_ids_timed(psynth.phonemize(text))
        assert info["mel_len"] == mel_s
        np.testing.assert_allclose(wav_b, wav_s, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", ["adpcm4", "adpcm3", "adpcm2"])
def test_tts_batch_on_adpcm_wires(synths, fmt):
    """A batch on an ADPCM wire gives each text the f32 wire's length,
    and the decoded waveform of each row is the f32 wire's waveform
    through the same codec."""
    from efficientspeech_tpu_torch.audio import transfer

    _, psynth = synths
    _reset(psynth)
    ref = psynth.tts_batch(TEXTS)
    psynth.transfer = fmt
    try:
        _reset(psynth)
        outs = psynth.tts_batch(TEXTS)
    finally:
        psynth.transfer = "f32"
    for (wav, info), (wav_f, info_f) in zip(outs, ref):
        assert info["mel_len"] == info_f["mel_len"]
        pad = -len(wav_f) % 256
        wire = transfer.encode_device(torch.from_numpy(
            np.pad(wav_f, (0, pad))[None]), fmt).numpy()[0]
        want = transfer.decode_host(wire, fmt)[: len(wav_f)]
        np.testing.assert_array_equal(wav, want)


def test_kernel_route_at_batch_matches_folded_route(synths, monkeypatch):
    """With the kernel threshold lowered, a batch of three runs the kernel
    route row by row (the kernels' plain versions on the CPU, launching
    nothing) and gives the folded route's waveforms."""
    from efficientspeech_tpu_torch import infer
    from efficientspeech_tpu_torch.ops.kernels import (
        adpcm, folded_matmul, mrf_block)

    _, psynth = synths
    _reset(psynth)
    want = psynth.tts_batch(TEXTS)
    monkeypatch.setattr(infer, "KERNEL_MIN_FRAMES", 0)
    monkeypatch.setattr(psynth, "vocoder_mode", "folded_kernel")
    calls = []
    real = infer.folded_plan_apply

    def spy(*args, **kwargs):
        calls.append((args[3].shape[0], kwargs["use_kernel"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(infer, "folded_plan_apply", spy)
    before = [dict(m.launches) for m in (folded_matmul, mrf_block, adpcm)]
    _reset(psynth)
    got = psynth.tts_batch(TEXTS)
    assert [dict(m.launches) for m in (folded_matmul, mrf_block,
                                       adpcm)] == before
    assert calls == [(4, True)]
    for (wav_k, info_k), (wav_f, info_f) in zip(got, want):
        assert info_k["mel_len"] == info_f["mel_len"]
        np.testing.assert_allclose(wav_k, wav_f, rtol=1e-4, atol=1e-5)


def test_tts_stream_matches_jax(synths):
    jsynth, psynth = synths
    text = "the quick brown fox jumps over the lazy dog"
    _reset(jsynth, psynth)
    seg_j = list(jsynth.tts_stream(text, segment_phonemes=8))
    seg_p = list(psynth.tts_stream(text, segment_phonemes=8))
    assert len(seg_p) == len(seg_j) > 1
    for (wav_p, info_p), (wav_j, info_j) in zip(seg_p, seg_j):
        for key in ("segment", "n_segments", "mel_len", "phonemes"):
            assert info_p[key] == info_j[key], key
        np.testing.assert_allclose(wav_p, wav_j, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def split_synths(synths):
    """Both packages' split pipelines on the fixture's parameters: the
    chunked conv vocoder, and the folded vocoder to int16."""
    jsynth, _ = synths
    out = {}
    for mode, fused in (("chunked", True), ("folded", False)):
        j = _small_setup(JaxSynthesizer(
            jsynth.cfg, jsynth.hifigan_cfg, jsynth.params,
            dtype=jnp.float32, vocoder_mode=mode, fused_pipeline=fused,
            transfer="f32"))
        p = _small_setup(build_synthesizer(
            preset="tiny", params=jsynth.params,
            hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN), dtype=torch.float32,
            transfer="f32", vocoder_mode=mode, device="cpu"))
        p.fused_pipeline = fused
        out[mode] = (j, p)
    return out


@pytest.mark.parametrize("mode", ["chunked", "folded"],
                         ids=["chunked", "split_folded"])
def test_split_synthesize_ids_matches_jax(split_synths, mode):
    jsynth, psynth = split_synths[mode]
    for n in (5, 12):
        seq = np.random.default_rng(n).integers(70, 146, size=n).astype(
            np.int32)
        wav_j, mel_j, _ = jsynth.synthesize_ids(seq)
        wav_p, mel_p, _ = psynth.synthesize_ids(seq)
        assert mel_p == mel_j > 0
        assert wav_p.dtype == np.float32 and wav_p.shape == wav_j.shape
        np.testing.assert_allclose(wav_p, wav_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["chunked", "folded"],
                         ids=["chunked", "split_folded"])
def test_tts_batch_split_matches_jax(split_synths, mode):
    jsynth, psynth = split_synths[mode]
    _assert_outs_match(psynth.tts_batch(TEXTS), jsynth.tts_batch(TEXTS))


def test_chunked_mode_matches_folded_route(synths, split_synths):
    """The chunked conv vocoder and the folded vocoder give one waveform
    (float32, another summation order)."""
    _, folded = synths
    _, chunked = split_synths["chunked"]
    seq = np.random.default_rng(3).integers(70, 146, size=12).astype(
        np.int32)
    _reset(folded)
    wav_f, mel_f, _ = folded.synthesize_ids(seq)
    wav_c, mel_c, _ = chunked.synthesize_ids(seq)
    assert mel_c == mel_f
    np.testing.assert_allclose(wav_c, wav_f, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def generators(synths):
    jsynth, _ = synths
    params = jsynth.params["hifigan"]
    gen = load_jax_params(HifiGanGenerator(HifiGanConfig(**SMALL_HIFIGAN)),
                          params)
    return JaxGen(JaxHifiGanConfig(**SMALL_HIFIGAN)), params, gen


@pytest.mark.parametrize("t,valid", [(96, 77), (96, None), (130, 96)])
def test_chunked_vocoder_call_matches_jax_and_unchunked(generators, t,
                                                         valid):
    """tests/test_vocoder_chunked.py's cases: the chunked call equals the
    JAX chunked call and the port's unchunked masked generator (the JAX
    test's tolerance)."""
    jgen, params, gen = generators
    rng = np.random.default_rng(0)
    mel = rng.normal(-3, 2, size=(2, t, 80)).astype(np.float32)
    valid_j = valid_p = None
    if valid is not None:
        mel[:, valid:] = 0.0
        valid_j = jnp.asarray([valid, valid - 9])
        valid_p = torch.tensor([valid, valid - 9])
        mel[1, valid - 9:] = 0.0
    want = np.asarray(jax_vocode_chunked(
        jgen, params, jnp.asarray(mel), valid_len=valid_j, chunk_frames=32,
        halo=CHUNK_HALO_FRAMES))
    with torch.no_grad():
        got = vocode_chunked(gen, torch.from_numpy(mel), valid_len=valid_p,
                             chunk_frames=32).numpy()
        full = gen(torch.from_numpy(mel), valid_len=valid_p).numpy()
    assert got.shape == want.shape == (2, t * gen.cfg.total_upsample)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(got, full, rtol=1e-4, atol=2e-5)
