"""The port's export against the JAX package's: ``EfficientSpeech.predict``
against JAX's ``predict`` on carried-across weights, the ``torch.export``
program against JAX's exported StableHLO, TorchScript and ONNX written
and read back, the convert CLI, the demo's ``.onnx`` input and
``--play``, and the bench's ``--checkpoint``, ``--verbose`` and
``--profile``.

Tolerances: float32 on the CPU in both packages; the mel length and the
rounded durations (the frames the length regulator expands by) are held
equal, the wav at 1e-4 absolute, the raw durations at 1e-5.  In bf16 the
two packages round at other places, so the wav is held by SNR."""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.convert import export as jax_export
from efficientspeech_tpu.models.efficientspeech import (
    EfficientSpeech as JaxEfficientSpeech)
from efficientspeech_tpu_torch import bench, demo, infer
from efficientspeech_tpu_torch.config import (
    HifiGanConfig, ModelConfig, PreprocessConfig)
from efficientspeech_tpu_torch.convert import __main__ as convert_cli
from efficientspeech_tpu_torch.convert import export, onnx_export
from efficientspeech_tpu_torch.convert.to_torch import (
    save_hifigan_checkpoint, save_reference_checkpoint)
from efficientspeech_tpu_torch.models.efficientspeech import EfficientSpeech
from efficientspeech_tpu_torch.ops.length_regulator import length_regulate
from efficientspeech_tpu_torch.weights import (
    init_params, set_duration_bias, to_jax_params)

torch.set_num_threads(2)

# ResBlock1 layout at small channels (tests/test_onnx_export.py:21)
SMALL_HIFIGAN = dict(upsample_rates=(8, 8),
                     upsample_kernel_sizes=(16, 16),
                     upsample_initial_channel=32,
                     resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
INSIZE, MEL_EXPANSION = 16, 4
WAV_ATOL = 1e-4
DURATION_ATOL = 1e-5
BF16_SNR_DB = 20.0


@pytest.fixture(autouse=True)
def _keep_tf32_flags(monkeypatch):
    """The CLIs' float32 runs switch TF32 off process-wide; restore it."""
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)


def _model(bias=3.0):
    cfg = ModelConfig.preset("tiny")
    model = EfficientSpeech(cfg, HifiGanConfig(**SMALL_HIFIGAN))
    return set_duration_bias(init_params(model, 0), bias).eval()


def _jax_predict(tree, dtype, phoneme, pad):
    cfg = dataclasses.replace(JaxModelConfig.preset("tiny"),
                              max_phoneme_len=INSIZE,
                              max_mel_len=INSIZE * MEL_EXPANSION)
    model = JaxEfficientSpeech(cfg=cfg,
                               hifigan_cfg=JaxHifiGanConfig(**SMALL_HIFIGAN),
                               dtype=dtype)
    out = model.apply({"params": tree}, jnp.asarray(phoneme),
                      jnp.asarray(pad), method=model.predict)
    return [np.asarray(o.astype(jnp.float32) if o.dtype == jnp.bfloat16
                       else o) for o in out]


def _phonemes():
    rng = np.random.default_rng(5)
    phoneme = rng.integers(70, 146, size=(2, INSIZE)).astype(np.int32)
    phoneme[1, 11:] = 0
    return phoneme, phoneme == 0


def _snr_db(ref, got):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - got) ** 2),
                                                1e-30))


@pytest.mark.parametrize("bias", [3.0, 6.0], ids=["fits", "clipped"])
def test_predict_matches_jax(bias):
    """Float32: at bias 6.0 the mel length passes max_mel_len (64), so
    the vocoder's clip and the unclipped mel_len are both held."""
    model = _model(bias)
    phoneme, pad = _phonemes()
    fixed = export.fixed_size_model(model.cfg, model.hifigan_cfg, model,
                                    INSIZE, MEL_EXPANSION, torch.float32)
    with torch.no_grad():
        wav, wav_len, mel_len, dur = [
            t.numpy() for t in fixed.predict(torch.from_numpy(phoneme),
                                             torch.from_numpy(pad))]
    jw, jwl, jml, jd = _jax_predict(to_jax_params(model), jnp.float32,
                                    phoneme, pad)
    np.testing.assert_array_equal(mel_len, jml)
    np.testing.assert_array_equal(wav_len, jwl)
    assert (mel_len > INSIZE * MEL_EXPANSION).any() == (bias == 6.0)
    np.testing.assert_array_equal(np.round(dur), np.round(jd))
    np.testing.assert_allclose(dur, jd, atol=DURATION_ATOL, rtol=0)
    assert wav.shape == jw.shape == (2, INSIZE * MEL_EXPANSION * 64)
    np.testing.assert_allclose(wav, jw, atol=WAV_ATOL, rtol=0)
    assert np.abs(wav).max() > 0


def test_predict_bf16_by_snr():
    model = _model()
    phoneme, pad = _phonemes()
    fixed = export.fixed_size_model(model.cfg, model.hifigan_cfg, model,
                                    INSIZE, MEL_EXPANSION, torch.bfloat16)
    with torch.no_grad():
        wav, _, mel_len, _ = fixed.predict(torch.from_numpy(phoneme),
                                           torch.from_numpy(pad))
    assert wav.dtype == torch.bfloat16
    jw, _, jml, _ = _jax_predict(to_jax_params(model), jnp.bfloat16,
                                 phoneme, pad)
    np.testing.assert_array_equal(mel_len.numpy(), jml)
    assert _snr_db(jw, wav.float().numpy()) >= BF16_SNR_DB


def test_torch_export_round_trip_against_jax_export(tmp_path):
    """The .pt2 loaded back equals eager predict, and holds the JAX
    package's exported program (load_exported) on the same phonemes."""
    model = _model()
    program = export.export_text_to_wav(model.cfg, model.hifigan_cfg, model,
                                        INSIZE, MEL_EXPANSION, torch.float32)
    path = str(tmp_path / "tiny.pt2")
    assert export.save_exported(path, program) > 10_000
    run = export.load_exported(path, "cpu")
    phoneme, pad = _phonemes()
    phoneme, pad = phoneme[1:], pad[1:]
    got = [t.numpy() for t in run(torch.from_numpy(phoneme),
                                  torch.from_numpy(pad))]
    fixed = export.fixed_size_model(model.cfg, model.hifigan_cfg, model,
                                    INSIZE, MEL_EXPANSION, torch.float32)
    with torch.no_grad():
        eager = [t.numpy() for t in fixed.predict(torch.from_numpy(phoneme),
                                                  torch.from_numpy(pad))]
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g, e)

    jcfg = JaxModelConfig.preset("tiny")
    blob = jax_export.export_text_to_wav(
        jcfg, JaxHifiGanConfig(**SMALL_HIFIGAN), to_jax_params(model),
        insize=INSIZE, mel_expansion=MEL_EXPANSION, dtype=jnp.float32)
    jpath = str(tmp_path / "tiny.stablehlo")
    jax_export.save_exported(jpath, blob)
    want = [np.asarray(o) for o in jax_export.load_exported(jpath)(
        jnp.asarray(phoneme), jnp.asarray(pad))]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], atol=DURATION_ATOL, rtol=0)
    np.testing.assert_allclose(got[0], want[0], atol=WAV_ATOL, rtol=0)


def test_torchscript_reproduces_eager(tmp_path):
    model = _model()
    path = str(tmp_path / "tiny.ts")
    size = onnx_export.export_torchscript(model.cfg, model.hifigan_cfg,
                                          model, path, insize=INSIZE,
                                          mel_expansion=MEL_EXPANSION)
    assert size > 10_000
    loaded = torch.jit.load(path)
    graph = onnx_export.export_model(model.cfg, model.hifigan_cfg, model,
                                     INSIZE, MEL_EXPANSION)
    phoneme, _ = _phonemes()
    for row in phoneme:  # unpadded, then padded (the mask is in the graph)
        x = torch.from_numpy(row[None])
        with torch.no_grad():
            got, want = loaded(x), graph(x)
        assert len(got) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_onnx_export_writes_valid_proto(tmp_path):
    """Structural, as tests/test_onnx_export.py checks the JAX package's
    file (no onnx package here): ModelProto's ir_version tag, producer
    "pytorch", the contract's input and output names."""
    model = _model()
    path = str(tmp_path / "tiny.onnx")
    size = onnx_export.export_onnx(model.cfg, model.hifigan_cfg, model,
                                   path, insize=INSIZE,
                                   mel_expansion=MEL_EXPANSION)
    assert os.path.isfile(path) and size > 10_000
    data = open(path, "rb").read()
    assert data[0] == 0x08, "ModelProto must start with ir_version tag"
    assert b"pytorch" in data[:64]
    for name in (b"inputs", b"wav", b"lengths", b"duration"):
        assert name in data
    # the regulator's count form and bucketize: no searchsorted node
    assert b"searchsorted" not in data.lower()


def test_onnx_shim_raises_on_an_unknown_exporter_layout(monkeypatch):
    monkeypatch.setitem(sys.modules, "onnx", None)
    monkeypatch.setattr(onnx_export, "_PROTO_UTILS", ("no.such.module",))
    with pytest.raises(RuntimeError, match="no known place"):
        onnx_export._shim_missing_onnx_package()


def test_regulator_count_form_equals_searchsorted(monkeypatch):
    """The form the ONNX export takes gives the serving route's frames
    bit for bit."""
    rng = np.random.default_rng(0)
    features = torch.from_numpy(rng.normal(size=(3, 12, 8)).astype(
        np.float32))
    durations = torch.from_numpy(rng.integers(0, 5, size=(3, 12)))
    durations[2, 7:] = 0
    want = length_regulate(features, durations, 40)
    monkeypatch.setattr(torch.onnx, "is_in_onnx_export", lambda: True)
    got = length_regulate(features, durations, 40)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def reference_files(tmp_path_factory):
    """A seeded tiny model's reference .ckpt and its small generator file
    (config.json beside it), written by the port's writers."""
    root = tmp_path_factory.mktemp("convert")
    model = _model()
    tree = to_jax_params(model)
    cfg = model.cfg
    ckpt = str(root / "tiny.ckpt")
    save_reference_checkpoint(ckpt, {"phoneme2mel": tree["phoneme2mel"]},
                              depth=cfg.depth, n_blocks=cfg.n_blocks,
                              block_depth=cfg.block_depth,
                              pitch_stats=cfg.pitch_stats,
                              energy_stats=cfg.energy_stats)
    (root / "gen").mkdir()
    gen = str(root / "gen" / "generator_v2")
    save_hifigan_checkpoint(gen, tree["hifigan"],
                            HifiGanConfig(**SMALL_HIFIGAN))
    return {"root": root, "ckpt": ckpt, "gen": gen}


def test_convert_cli_from_reference_files(reference_files, tmp_path,
                                          capsys):
    """--output loads back into build_synthesizer for the same waveform;
    --export, --onnx and --torchscript write programs of the same
    predict."""
    f = reference_files
    out = {k: str(tmp_path / name) for k, name in (
        ("output", "tiny.pt"), ("export", "tiny.pt2"),
        ("onnx", "tiny.onnx"), ("torchscript", "tiny.ts"))}
    written = convert_cli.main([
        "--device", "cpu", "--checkpoint", f["ckpt"],
        "--hifigan-checkpoint", f["gen"], "--precision", "f32",
        "--insize", str(INSIZE), "--output", out["output"], "--export",
        out["export"], "--onnx", out["onnx"], "--torchscript",
        out["torchscript"]])
    assert written == out
    printed = capsys.readouterr().out
    for line in ("wrote native params", "wrote torch.export program",
                 "wrote ONNX model", "wrote TorchScript module"):
        assert line in printed

    h_cfg = HifiGanConfig(**SMALL_HIFIGAN)
    text = "hello world"
    want, want_info = infer.build_synthesizer(
        preset="tiny", checkpoint=f["ckpt"], hifigan_checkpoint=f["gen"],
        dtype=torch.float32, device="cpu").tts(text)
    got, got_info = infer.build_synthesizer(
        preset="tiny", checkpoint=out["output"], hifigan_cfg=h_cfg,
        dtype=torch.float32, device="cpu").tts(text)
    assert got_info["mel_len"] == want_info["mel_len"] > 0
    np.testing.assert_array_equal(got, want)

    model = infer.build_model(preset="tiny", checkpoint=out["output"],
                              hifigan_cfg=h_cfg)
    fixed = export.fixed_size_model(model.cfg, h_cfg, model, INSIZE, 16,
                                    torch.float32)
    phoneme, pad = export.example_inputs(INSIZE, "cpu")
    with torch.no_grad():
        eager = fixed.predict(phoneme, pad)
        traced = torch.jit.load(out["torchscript"])(phoneme)
    program = export.load_exported(out["export"])(phoneme, pad)
    for g, w in zip(program, eager):
        assert torch.equal(g, w)
    for g, w in zip(traced, (eager[0], eager[2], eager[3])):
        assert torch.equal(g, w)


def _onnx_args(tmp_path, **kw):
    ns = demo.get_args(["--checkpoint", str(tmp_path / "tiny.onnx"),
                        "--onnx-insize", "32", "--text", "hello world",
                        "--iter", "2", "--wav-path", str(tmp_path),
                        "--wav-filename", "out.wav"])
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_demo_onnx_missing_runtime_is_graceful(tmp_path, monkeypatch):
    import builtins

    monkeypatch.delitem(sys.modules, "onnxruntime", raising=False)
    real_import = builtins.__import__

    def no_ort(name, *a, **k):
        if name == "onnxruntime":
            raise ImportError("No module named 'onnxruntime'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_ort)
    with pytest.raises(SystemExit, match="onnxruntime is not installed"):
        demo.main(["--checkpoint", str(tmp_path / "x.onnx"), "--text",
                   "hi"])


def test_demo_onnx_consumption_with_fake_session(tmp_path, monkeypatch):
    """tokenize → pad to insize → run → trim by the rounded durations ×
    hop → wav file, against a stub InferenceSession honouring the
    exporter's (wav, lengths, duration) contract."""
    from efficientspeech_tpu_torch.text.g2p import (
        get_lexicon_and_g2p, text2phoneme)

    cfg = PreprocessConfig()
    hop = cfg.audio.hop_length
    seen = {}

    class FakeSession:
        def __init__(self, path):
            seen["path"] = path

        def get_inputs(self):
            return [types.SimpleNamespace(name="inputs")]

        def run(self, _outputs, inputs):
            phoneme = np.asarray(inputs["inputs"])
            assert phoneme.shape == (1, 32) and phoneme.dtype == np.int32
            insize = phoneme.shape[1]
            duration = np.full((1, insize, 1), 2.0, np.float32)
            wav = np.ones((1, insize * 2 * hop), np.float32) * 0.1
            return wav, np.array([insize * 2]), duration

    fake = types.ModuleType("onnxruntime")
    fake.InferenceSession = FakeSession
    monkeypatch.setitem(sys.modules, "onnxruntime", fake)
    demo.run_onnx(_onnx_args(tmp_path))

    lexicon, g2p = get_lexicon_and_g2p(cfg)
    n_real = min(len(text2phoneme(lexicon, g2p, "hello world", cfg)), 32)
    from scipy.io import wavfile

    sr, wav = wavfile.read(str(tmp_path / "out.wav"))
    assert sr == cfg.audio.sampling_rate
    assert len(wav) == n_real * 2 * hop  # duration-trimmed, not insize-long
    assert seen["path"].endswith("tiny.onnx")


def _small_build(monkeypatch, seen):
    """build_synthesizer with the small vocoder, its arguments recorded."""
    real = infer.build_synthesizer

    def build(**kw):
        seen.append(dict(kw))
        synth = real(**dict(kw, hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN)))
        synth.phoneme_buckets, synth.mel_expansion = (32,), 8
        synth.spec_min_frames = 128
        return synth

    monkeypatch.setattr(infer, "build_synthesizer", build)


def test_demo_play_without_sounddevice_saves(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    seen = []
    _small_build(monkeypatch, seen)
    wav, _ = demo.main(["--device", "cpu", "--precision", "f32", "--text",
                        "hi there", "--warmup", "0", "--play",
                        "--wav-path", str(tmp_path)])
    out = capsys.readouterr().out
    assert "sounddevice not installed; saving to file instead" in out
    assert os.path.isfile(tmp_path / "efficient_speech.wav") and len(wav)


def test_bench_checkpoint_verbose_and_profile(reference_files, tmp_path,
                                              monkeypatch, capsys):
    seen = []
    _small_build(monkeypatch, seen)
    prof = tmp_path / "prof"
    bench.main(["--device", "cpu", "--metric", "rtf", "--iter", "1",
                "--warmup", "1", "--text", "hello there",
                "--checkpoint", reference_files["ckpt"], "--verbose",
                "--profile", str(prof)])
    assert seen[0]["checkpoint"] == reference_files["ckpt"]
    assert seen[0]["bench_duration_bias"] is None
    captured = capsys.readouterr()
    lines = [json.loads(x) for x in captured.out.splitlines()
             if x.startswith("{")]
    assert lines[-1]["metric"] == "text_to_wav_rtf"
    summary = lines[-2]
    assert summary["profile"] == str(prof / "bench_trace.json")
    assert summary["wall_ms"] > 0
    assert summary["device_busy_ms"] == summary["idle_share"] == \
        "not measured"
    assert os.path.getsize(summary["profile"]) > 0
    assert "RTF:" in captured.out  # the per-request line of --verbose
    extras = json.loads(captured.err.strip().splitlines()[-1])
    assert extras["precision"] == "bf16" and extras["device"] == "cpu"
    assert extras["model_rtf_mean"] > 0
