"""The slice as a whole: the port's Synthesizer against the JAX package's
on the same parameters, and the wire codecs against the JAX encoders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.audio.transfer import (
    encode_device as jax_encode_device)
from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.infer import build_synthesizer as jax_build
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu.models.phoneme2mel import Phoneme2Mel as JaxP2M
from efficientspeech_tpu_torch.audio.transfer import (
    decode_host, encode_device)
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.infer import build_synthesizer
from efficientspeech_tpu_torch.models.modules import Embedding, LayerNorm

torch.set_num_threads(2)

# ResBlock1 layout at small channels (the fixture of the ONNX export test)
SMALL_HIFIGAN = dict(upsample_rates=(8, 8),
                     upsample_kernel_sizes=(16, 16),
                     upsample_initial_channel=32,
                     resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def _small_setup(synth):
    synth.phoneme_buckets = (16,)
    synth.mel_expansion = 8
    synth.spec_min_frames = 128
    return synth


@pytest.fixture(scope="module")
def synths():
    h_cfg = JaxHifiGanConfig(**SMALL_HIFIGAN)
    jsynth = _small_setup(jax_build(preset="tiny", hifigan_checkpoint="",
                                    dtype=jnp.float32,
                                    bench_duration_bias=4.0))
    shapes = jax.eval_shape(lambda: JaxGen(h_cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 80)))["params"])
    rng = np.random.default_rng(0)

    def leaf(path, s):
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = dict(jsynth.params)
    params["hifigan"] = jax.tree_util.tree_map_with_path(leaf, shapes)
    jsynth.params = params
    jsynth.hifigan_cfg = h_cfg
    jsynth.transfer = "f32"

    psynth = _small_setup(build_synthesizer(
        preset="tiny", params=params,
        hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN), dtype=torch.float32,
        transfer="f32", vocoder_mode="folded", device="cpu"))
    return jsynth, psynth


def test_synthesize_ids_matches_jax(synths):
    jsynth, psynth = synths
    rng = np.random.default_rng(5)
    seq = rng.integers(70, 146, size=12).astype(np.int32)
    wav_j, mel_len_j, _ = jsynth.synthesize_ids(seq)
    wav_p, mel_len_p, _ = psynth.synthesize_ids(seq)
    assert mel_len_p == mel_len_j > 0
    hop = psynth.hifigan_cfg.total_upsample
    assert wav_p.shape == wav_j.shape == (mel_len_j * hop,)
    np.testing.assert_allclose(wav_p, wav_j, rtol=1e-3, atol=2e-4)


def test_tts_end_to_end(synths):
    _, psynth = synths
    wav, info = psynth.tts("Hello world, 42 dogs.")
    assert info["phoneme_len"] > 5 and info["mel_len"] > 0
    assert wav.shape == (info["mel_len"] * psynth.hifigan_cfg.total_upsample,)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


@pytest.mark.parametrize("fmt", ["int16", "mulaw", "f32"])
def test_wire_codecs_bit_equal_to_jax(fmt):
    rng = np.random.default_rng(9)
    wav = np.concatenate([
        rng.uniform(-1.2, 1.2, 4096),
        [-1.0, 1.0, 0.0, -0.0, 0.5, -0.5, 32767 / 32768, 1 / 32768],
    ]).astype(np.float32)
    want = np.asarray(jax_encode_device(jnp.asarray(wav), fmt))
    got = encode_device(torch.from_numpy(wav), fmt).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    back = decode_host(got, fmt)
    assert back.dtype == np.float32 and back.shape == wav.shape


def test_kernel_route_matches_plain_route(synths, monkeypatch):
    """With the kernel threshold lowered, synthesize_ids routes the
    vocoder through the kernel wrappers (their plain versions on the CPU,
    launching nothing) and gives the plain route's waveform."""
    from efficientspeech_tpu_torch import infer
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul, mrf_block

    _, psynth = synths
    seq = np.random.default_rng(6).integers(70, 146, size=14).astype(np.int32)
    want, mel_len, _ = psynth.synthesize_ids(seq)
    monkeypatch.setattr(infer, "KERNEL_MIN_FRAMES", 0)
    monkeypatch.setattr(psynth, "vocoder_mode", "folded_kernel")
    before = (dict(folded_matmul.launches), dict(mrf_block.launches))
    got, mel_len_k, _ = psynth.synthesize_ids(seq)
    assert (folded_matmul.launches, mrf_block.launches) == before
    assert mel_len_k == mel_len
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_kernel_route_hands_kernels_serving_dtype_weights(monkeypatch,
                                                          dtype):
    """The synthesizer's kernel route hands folded_matmul and mrf_fused
    weights in the serving dtype (the kernels' variant on the card), never
    a cast to another dtype; activations stay float32."""
    from efficientspeech_tpu_torch import infer
    from efficientspeech_tpu_torch.models import hifigan_folded

    seen = {"folded_matmul": [], "mrf_fused": []}
    # the weight's place among each wrapper's arguments
    w_arg = {"folded_matmul": 1, "mrf_fused": 2}

    def record(name, fn):
        def wrapper(*args, **kwargs):
            seen[name].append((args[0].dtype, args[w_arg[name]].dtype))
            return fn(*args, **kwargs)
        return wrapper

    for name in seen:
        monkeypatch.setattr(hifigan_folded, name,
                            record(name, getattr(hifigan_folded, name)))
    monkeypatch.setattr(infer, "KERNEL_MIN_FRAMES", 0)
    synth = _small_setup(build_synthesizer(
        preset="tiny", hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN),
        dtype=dtype, bench_duration_bias=4.0, transfer="f32",
        vocoder_mode="folded_kernel", device="cpu"))
    seq = np.random.default_rng(7).integers(70, 146, size=12).astype(
        np.int32)
    wav, mel_len, _ = synth.synthesize_ids(seq)
    assert mel_len > 0 and np.isfinite(wav).all()
    for name, calls in seen.items():
        assert calls, f"{name} was not called"
        assert set(calls) == {(torch.float32, dtype)}, (name, set(calls))


def test_bf16_synthesizer_keeps_norms_f32_and_matches_jax(synths):
    """Serving in bf16 casts the acoustic model's Linear and conv weights
    and keeps its LayerNorm and embedding parameters float32, as the JAX
    modules do.  With LayerNorm scales and biases drawn from a seed (a
    cast of init's 1 and 0 to bf16 is exact, so they would hide a cast),
    the synthesizer's bf16 mel is held to the JAX model's bf16 mel at the
    bar of test_phoneme2mel_bf16_matches_jax: 0.06 max-abs, mel_len
    equal."""
    jsynth, _ = synths
    bucket, frames = 16, 128
    rng = np.random.default_rng(11)
    phoneme = np.zeros((2, bucket), np.int32)
    phoneme[0, :14] = rng.integers(1, 140, 14)
    phoneme[1, :9] = rng.integers(1, 140, 9)
    pad = phoneme == 0
    jmodel = JaxP2M(JaxModelConfig.preset("tiny", max_phoneme_len=bucket,
                                          max_mel_len=frames),
                    dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(phoneme), jnp.asarray(pad),
        train=False)["params"])

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("embedding", "speaker_embedding"):
            return rng.standard_normal(s.shape).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    p2m = jax.tree_util.tree_map_with_path(leaf, shapes)
    p2m["encoder"]["duration_decoder"]["linear"]["bias"] = np.array(
        [3.3], np.float32)
    want = jmodel.apply({"params": p2m}, jnp.asarray(phoneme),
                        jnp.asarray(pad), train=False)

    psynth = build_synthesizer(
        preset="tiny", params={"phoneme2mel": p2m,
                               "hifigan": jsynth.params["hifigan"]},
        hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN), dtype=torch.bfloat16,
        transfer="f32", vocoder_mode="folded", device="cpu")
    kept = 0
    for module in psynth.acoustic.modules():
        f32 = getattr(module, "takes_f32_params", False)
        kept += isinstance(module, (LayerNorm, Embedding))
        for name, p in module.named_parameters(recurse=False):
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), \
                (type(module).__name__, name, p.dtype)
    assert kept > 10
    assert psynth.acoustic.decoder.proj_norm.weight.dtype == torch.float32
    with torch.no_grad():
        got = psynth.acoustic(torch.from_numpy(phoneme),
                              torch.from_numpy(pad), max_mel_len=frames)
    assert got["mel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["mel_len"].numpy(),
                                  np.asarray(want["mel_len"]))
    assert int(got["mel_len"].min()) > 0
    err = np.abs(got["mel"].float().numpy()
                 - np.asarray(want["mel"], np.float32)).max()
    assert err <= 0.06, err



def _duration_bias(synth) -> float:
    return float(synth.acoustic.encoder.duration_decoder.linear.bias
                 .reshape(()))


def test_loaded_params_keep_their_duration_bias(synths):
    """``bench_duration_bias`` sets the duration head of a random init
    only, as in the JAX package's build_synthesizer: parameters from the
    JAX init with their own duration bias (2.5) keep it when built with
    ``bench_duration_bias=4.0``; a seeded build still gets 4.0."""
    jsynth, _ = synths
    p2m = jax.tree_util.tree_map(np.asarray, jsynth.params["phoneme2mel"])
    assert float(p2m["encoder"]["duration_decoder"]["linear"]["bias"][0]) \
        == 4.0
    p2m["encoder"]["duration_decoder"]["linear"]["bias"] = np.array(
        [2.5], np.float32)
    loaded = build_synthesizer(
        preset="tiny", params=dict(jsynth.params, phoneme2mel=p2m),
        hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN), dtype=torch.float32,
        bench_duration_bias=4.0, transfer="f32", vocoder_mode="folded",
        device="cpu")
    assert _duration_bias(loaded) == 2.5
    seeded = build_synthesizer(
        preset="tiny", hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN),
        dtype=torch.float32, bench_duration_bias=4.0, transfer="f32",
        vocoder_mode="folded", device="cpu")
    assert _duration_bias(seeded) == 4.0
