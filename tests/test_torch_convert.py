"""Reference checkpoints in the port: its copies of the JAX package's
``.ckpt`` / generator-file loaders and writers against the JAX ones,
``weights.to_jax_params``, ``build_synthesizer`` on reference files
against the JAX ``build_synthesizer`` on the same files, and the demo's
and the server's checkpoint flags.

The files are written from seeded parameters by the JAX package's own
writers, so nothing is downloaded.  Tolerances: the loaders and writers
move float32 arrays (the weight-norm fold in float64, as in JAX) and are
held bit-equal; the synthesizers are float32 on the CPU in both packages,
mel and waveform held as test_torch_synth.py holds them (waveform rtol
1e-3, atol 2e-4; mel 1e-4), mel_len equal."""

import argparse
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.convert import from_torch as jax_from_torch
from efficientspeech_tpu.convert import to_torch as jax_to_torch
from efficientspeech_tpu.infer import build_synthesizer as jax_build
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu.models.phoneme2mel import Phoneme2Mel as JaxP2M
from efficientspeech_tpu_torch import demo
from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.convert import from_torch, to_torch
from efficientspeech_tpu_torch.infer import build_synthesizer
from efficientspeech_tpu_torch.models.efficientspeech import EfficientSpeech
from efficientspeech_tpu_torch.weights import (
    init_params, load_jax_params, to_jax_params)

torch.set_num_threads(2)

SMALL_HIFIGAN = dict(upsample_rates=(8, 8),
                     upsample_kernel_sizes=(16, 16),
                     upsample_initial_channel=32,
                     resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))
RESBLOCKS = {"1": dict(SMALL_HIFIGAN),
             "2": dict(SMALL_HIFIGAN, resblock="2",
                       resblock_dilation_sizes=((1, 3), (1, 3)))}
STATS = {"pitch": [-2.9, 11.4, 0.0, 1.0], "energy": [-1.4, 8.2, 0.0, 1.0]}
DURATION_BIAS = 4.0


def _seeded(shapes, seed):
    """A parameter tree of ``shapes`` drawn from a seed: kernels uniform
    ±1/√fan_in, biases and LayerNorm offsets small normals, scales around
    one, embeddings normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("embedding", "speaker_embedding"):
            return rng.standard_normal(s.shape).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _p2m_tree(n_speakers, seed=0):
    cfg = JaxModelConfig.preset("tiny", n_speakers=n_speakers,
                                pitch_stats=tuple(STATS["pitch"][:2]),
                                energy_stats=tuple(STATS["energy"][:2]))
    ph = jnp.zeros((1, 16), jnp.int32)
    shapes = jax.eval_shape(lambda: JaxP2M(cfg).init(
        jax.random.PRNGKey(0), ph, ph == 0, train=False)["params"])
    tree = _seeded(shapes, seed)
    tree["encoder"]["duration_decoder"]["linear"]["bias"] = np.array(
        [DURATION_BIAS], np.float32)
    return tree


def _hifigan_tree(resblock, seed=1):
    cfg = JaxHifiGanConfig(**RESBLOCKS[resblock])
    shapes = jax.eval_shape(lambda: JaxGen(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 80)))["params"])
    return _seeded(shapes, seed)


def _assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(w).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _save_generator(path, tree, resblock):
    """A reference generator file written by the JAX package's writer,
    with its config.json beside it."""
    num_kernels = len(RESBLOCKS[resblock]["resblock_kernel_sizes"])
    sd = jax_to_torch.hifigan_params_to_state_dict(tree, num_kernels)
    torch.save({"generator": {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}}, path)
    cfg = dict(RESBLOCKS[resblock], num_mels=80)
    cfg.setdefault("resblock", "1")
    with open(os.path.join(os.path.dirname(path), "config.json"), "w") as f:
        json.dump(cfg, f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference files of a seeded tiny model (single speaker) and a
    small ResBlock-1 generator, written by the JAX writers."""
    root = tmp_path_factory.mktemp("reference")
    p2m, hifigan = _p2m_tree(1), _hifigan_tree("1")
    # a reference file under the port's step-file name: told apart by
    # its contents
    ckpt = str(root / "step_00000004.pt")
    jax_to_torch.save_reference_checkpoint(
        ckpt, {"phoneme2mel": p2m}, pitch_stats=STATS["pitch"][:2],
        energy_stats=STATS["energy"][:2],
        hyper_parameters=argparse.Namespace(depth=2))
    (root / "gen").mkdir()
    gen = str(root / "gen" / "generator_v2")
    _save_generator(gen, hifigan, "1")
    return {"ckpt": ckpt, "gen": gen, "p2m": p2m, "hifigan": hifigan,
            "root": root}


@pytest.mark.parametrize("n_speakers", [1, 3], ids=["single", "multi"])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_loaders_bit_equal_to_jax(tmp_path, n_speakers, resblock):
    """A Lightning .ckpt with the vocoder inside it, and a generator file
    of its own, each loaded by both packages: the trees are bit-equal."""
    p2m, hifigan = _p2m_tree(n_speakers), _hifigan_tree(resblock)
    num_kernels = len(RESBLOCKS[resblock]["resblock_kernel_sizes"])
    sd = jax_to_torch.efficientspeech_params_to_state_dict(
        {"phoneme2mel": p2m}, pitch_stats=STATS["pitch"][:2],
        energy_stats=STATS["energy"][:2])
    sd.update({f"hifigan.{k}": v for k, v in
               jax_to_torch.hifigan_params_to_state_dict(
                   hifigan, num_kernels).items()})
    ckpt = str(tmp_path / "full.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()},
                "hyper_parameters": {"n_speakers": n_speakers}}, ckpt)
    want = jax_from_torch.load_efficientspeech_checkpoint(
        ckpt, num_kernels=num_kernels)
    got = from_torch.load_efficientspeech_checkpoint(
        ckpt, num_kernels=num_kernels)
    _assert_trees_equal(got, want)
    assert "hifigan" in got

    gen = str(tmp_path / "generator")
    _save_generator(gen, hifigan, resblock)
    want = jax_from_torch.load_hifigan_checkpoint(gen, num_kernels)
    got = from_torch.load_hifigan_checkpoint(gen, num_kernels)
    _assert_trees_equal(got, want)
    # the weight-norm fold only rounds: the generator comes back within an
    # ulp or two of the tree it was written from
    for k, block in hifigan.items():
        for name, w in (block.items() if "kernel" not in block
                        else [(None, block)]):
            g = got[k] if name is None else got[k][name]
            np.testing.assert_allclose(g["kernel"], w["kernel"], rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("n_speakers", [1, 3], ids=["single", "multi"])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_writers_bit_equal_to_jax(tmp_path, n_speakers, resblock):
    """The port's writers give the JAX writers' state dicts, and
    save_reference_checkpoint the same file contents."""
    p2m, hifigan = _p2m_tree(n_speakers), _hifigan_tree(resblock)
    num_kernels = len(RESBLOCKS[resblock]["resblock_kernel_sizes"])
    kw = dict(pitch_stats=STATS["pitch"][:2], energy_stats=STATS["energy"][:2])
    for fn, args in (
            ("efficientspeech_params_to_state_dict", ({"phoneme2mel": p2m},)),
            ("hifigan_params_to_state_dict", (hifigan, num_kernels))):
        want = getattr(jax_to_torch, fn)(*args, **(kw if "eff" in fn else {}))
        got = getattr(to_torch, fn)(*args, **(kw if "eff" in fn else {}))
        _assert_trees_equal(got, want)
    paths = [str(tmp_path / f"{n}.ckpt") for n in ("jax", "port")]
    for path, mod in zip(paths, (jax_to_torch, to_torch)):
        mod.save_reference_checkpoint(path, {"phoneme2mel": p2m},
                                      hyper_parameters={"seed": 7}, **kw)
    want, got = (torch.load(p, weights_only=False) for p in paths)
    assert got["hyper_parameters"] == want["hyper_parameters"]
    _assert_trees_equal({k: v.numpy() for k, v in got["state_dict"].items()},
                        {k: v.numpy() for k, v in want["state_dict"].items()})
    # save_hifigan_checkpoint writes what the JAX writer and torch.save do
    hcfg = HifiGanConfig(**RESBLOCKS[resblock])
    port_gen = tmp_path / "port" / "generator"
    port_gen.parent.mkdir()
    to_torch.save_hifigan_checkpoint(str(port_gen), hifigan, hcfg)
    assert HifiGanConfig.from_json(str(port_gen.parent / "config.json")) \
        == hcfg
    _save_generator(str(tmp_path / "generator"), hifigan, resblock)
    want, got = (torch.load(p, weights_only=True)["generator"]
                 for p in (tmp_path / "generator", port_gen))
    _assert_trees_equal({k: v.numpy() for k, v in got.items()},
                        {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("n_speakers", [1, 3], ids=["single", "multi"])
@pytest.mark.parametrize("resblock", ["1", "2"])
def test_to_jax_params_inverts_load(n_speakers, resblock):
    """to_jax_params(load_jax_params(m, t)) == t, bit for bit, and the
    native init's tree loads back into a model unchanged."""
    tree = {"phoneme2mel": _p2m_tree(n_speakers),
            "hifigan": _hifigan_tree(resblock)}
    cfg = ModelConfig.preset("tiny", n_speakers=n_speakers)
    hcfg = HifiGanConfig(**RESBLOCKS[resblock])
    model = load_jax_params(EfficientSpeech(cfg, hcfg), tree)
    _assert_trees_equal(to_jax_params(model), tree)
    seeded = init_params(EfficientSpeech(cfg, hcfg), seed=3)
    again = load_jax_params(EfficientSpeech(cfg, hcfg), to_jax_params(seeded))
    for (k, a), (_, b) in zip(seeded.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k


def _small(synth):
    synth.phoneme_buckets = (16,)
    synth.mel_expansion = 8
    synth.spec_min_frames = 128
    return synth


def test_build_synthesizer_from_reference_files_matches_jax(files):
    """Both packages build a synthesizer from the same .ckpt and generator
    file (float32, CPU): the same parameters, the same mel_len, mel and
    waveform within the stated tolerance."""
    jsynth = _small(jax_build(
        preset="tiny", checkpoint=files["ckpt"],
        hifigan_checkpoint=files["gen"], stats=STATS, dtype=jnp.float32,
        transfer="f32", vocoder_mode="folded"))
    psynth = _small(build_synthesizer(
        preset="tiny", checkpoint=files["ckpt"],
        hifigan_checkpoint=files["gen"], stats=STATS, dtype=torch.float32,
        transfer="f32", vocoder_mode="folded", device="cpu"))
    assert psynth.hifigan_cfg == HifiGanConfig(**SMALL_HIFIGAN)
    _assert_trees_equal(
        {"phoneme2mel": to_jax_params(psynth.acoustic),
         "hifigan": to_jax_params(psynth.generator)},
        jax.tree_util.tree_map(np.asarray, jsynth.params))
    bins = psynth.acoustic.encoder.pitch_embedding.bins.numpy()
    assert bins[0] == np.float32(STATS["pitch"][0])

    rng = np.random.default_rng(5)
    seq = rng.integers(70, 146, size=12).astype(np.int32)
    wav_j, mel_len_j, _ = jsynth.synthesize_ids(seq)
    wav_p, mel_len_p, _ = psynth.synthesize_ids(seq)
    assert mel_len_p == mel_len_j > 0
    np.testing.assert_allclose(wav_p, wav_j, rtol=1e-3, atol=2e-4)

    phoneme = np.zeros((1, 16), np.int32)
    phoneme[0, :12] = seq
    jcfg = JaxModelConfig.preset(
        "tiny", max_mel_len=128, pitch_stats=tuple(STATS["pitch"][:2]),
        energy_stats=tuple(STATS["energy"][:2]))
    want = JaxP2M(jcfg).apply(
        {"params": jsynth.params["phoneme2mel"]}, jnp.asarray(phoneme),
        jnp.asarray(phoneme == 0), train=False)
    with torch.no_grad():
        got = psynth.acoustic(torch.from_numpy(phoneme),
                              torch.from_numpy(phoneme == 0),
                              max_mel_len=128)
    assert int(got["mel_len"][0]) == int(want["mel_len"][0]) == mel_len_p
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               rtol=1e-4, atol=1e-4)


def test_build_synthesizer_tells_checkpoints_apart(files, tmp_path):
    """A reference file under a step-file name converts; a port trainer's
    payload under a .ckpt name loads as the port's; a file that is
    neither raises; a missing generator file leaves the vocoder random."""
    ref = build_synthesizer(preset="tiny", checkpoint=files["ckpt"],
                            stats=STATS, dtype=torch.float32,
                            device="cpu")
    _assert_trees_equal(to_jax_params(ref.acoustic), files["p2m"])
    port_file = str(tmp_path / "weights.ckpt")
    torch.save({"params": ref.acoustic.state_dict(), "step": 4}, port_file)
    again = build_synthesizer(preset="tiny", checkpoint=port_file,
                              stats=STATS, dtype=torch.float32, seed=9,
                              hifigan_checkpoint=str(tmp_path / "none"),
                              device="cpu")
    _assert_trees_equal(to_jax_params(again.acoustic), files["p2m"])
    random_vocoder = to_jax_params(init_params(EfficientSpeech(
        ModelConfig.preset("tiny"), HifiGanConfig()), seed=9).hifigan)
    _assert_trees_equal(to_jax_params(again.generator), random_vocoder)
    other = str(tmp_path / "other.pt")
    torch.save({"state_dict": {"encoder.w": torch.zeros(2)}}, other)
    with pytest.raises(ValueError, match="neither a reference"):
        build_synthesizer(preset="tiny", checkpoint=other, device="cpu")


def test_demo_random_init_duration_bias(monkeypatch):
    """The demo gives a random init the JAX demo's duration bias, 6.0
    (the port's demo had 4.0), and none to loaded weights."""
    from efficientspeech_tpu_torch import infer

    seen = []

    class Stop(Exception):
        pass

    def record(**kwargs):
        seen.append(kwargs)
        raise Stop

    monkeypatch.setattr(infer, "build_synthesizer", record)
    for extra in ([], ["--checkpoint", "x.ckpt"]):
        with pytest.raises(Stop):
            demo.main(["--text", "hi", "--device", "cpu", *extra])
    assert [k["bench_duration_bias"] for k in seen] == [6.0, None]
    assert seen[1]["checkpoint"] == "x.ckpt"


def test_demo_reference_files_on_cpu(files, tmp_path, capsys, monkeypatch):
    """python -m efficientspeech_tpu_torch.demo --device cpu --checkpoint
    X.ckpt --hifigan-checkpoint G --speaker 0 --preprocess-config Y:
    the weights are the files', and the wav is written; without the
    generator file the note and a random vocoder, as in the JAX demo."""
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    yaml = tmp_path / "p.yaml"
    yaml.write_text("preprocessing:\n  audio:\n    max_wav_value: 32768.0\n")
    wav, info = demo.main([
        "--device", "cpu", "--precision", "f32", "--checkpoint",
        files["ckpt"], "--hifigan-checkpoint", files["gen"], "--speaker",
        "0", "--preprocess-config", str(yaml), "--text", "hello world",
        "--warmup", "0", "--verbose", "--wav-path", str(tmp_path)])
    hop = np.prod(SMALL_HIFIGAN["upsample_rates"])
    assert info["mel_len"] > 0 and wav.shape == (info["mel_len"] * hop,)
    from scipy.io import wavfile

    sr, pcm = wavfile.read(str(tmp_path / "efficient_speech.wav"))
    assert sr == 22050 and pcm.dtype == np.int16 and len(pcm) == len(wav)
    out = capsys.readouterr().out
    assert "not found" not in out and "wrote" in out
    demo.main(["--device", "cpu", "--precision", "f32", "--checkpoint",
               files["ckpt"],
               "--hifigan-checkpoint", str(tmp_path / "absent"), "--text",
               "hi", "--warmup", "0", "--wav-path", str(tmp_path)])
    assert "using random vocoder weights" in capsys.readouterr().out


def test_demo_url_checkpoint(tmp_path, monkeypatch):
    """URL checkpoints are fetched to the working directory first; a
    failed fetch is a clear SystemExit (the fetch is monkeypatched)."""
    assert demo._maybe_download("local.ckpt") == "local.ckpt"
    assert demo._maybe_download(None) is None
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny_eng.ckpt").write_bytes(b"x")
    assert demo._maybe_download(
        "https://example.com/x/tiny_eng.ckpt") == "tiny_eng.ckpt"
    fetched = []

    def fetch(url, filename):
        fetched.append((url, filename))
        open(filename, "wb").close()

    monkeypatch.setattr(urllib.request, "urlretrieve", fetch)
    assert demo._maybe_download("https://example.com/a/b.ckpt") == "b.ckpt"
    assert fetched == [("https://example.com/a/b.ckpt", "b.ckpt")]

    def boom(url, filename):
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", boom)
    with pytest.raises(SystemExit, match="could not download"):
        demo._maybe_download("https://example.com/x/absent.ckpt")


def test_serve_hifigan_checkpoint(files, monkeypatch):
    """``serve.py --checkpoint X.ckpt --hifigan-checkpoint G`` serves the
    files' weights (in bf16), with no duration bias."""
    from efficientspeech_tpu_torch import infer, serve

    built = []

    class Stop(Exception):
        pass

    real = infer.build_synthesizer

    def record(**kwargs):
        built.append((kwargs, real(**kwargs)))
        return built[-1][1]

    def stop(host, port, handler):
        raise Stop

    monkeypatch.setattr(infer, "build_synthesizer", record)
    monkeypatch.setattr(serve, "make_server", stop)
    with pytest.raises(Stop):
        serve.main(["--device", "cpu", "--port", "0", "--checkpoint",
                    files["ckpt"], "--hifigan-checkpoint", files["gen"]])
    (kwargs, synth), = built
    assert kwargs["hifigan_checkpoint"] == files["gen"]
    assert kwargs["bench_duration_bias"] is None
    assert synth.hifigan_cfg == HifiGanConfig(**SMALL_HIFIGAN)
    got = synth.generator.conv_pre.weight.detach()
    assert got.dtype == torch.bfloat16
    # the fold's float32 kernel, cast to bf16 once
    np.testing.assert_array_equal(
        got.float().numpy().transpose(2, 1, 0),
        torch.from_numpy(from_torch.load_hifigan_checkpoint(
            files["gen"], 2)["conv_pre"]["kernel"]).bfloat16().float())


def test_f32_generator_from_written_files_holds_the_seed_build(tmp_path):
    """The float32 check of the weight-norm round trip: the LJ_V2-width
    generator from seed 0, written as a reference generator file by the
    port's writer (weight_g = ‖W‖ per output channel, weight_v = W) and
    rebuilt by the port's loader (the fold g · v / ‖v‖ in float64, as the
    JAX package's), moves each weight by at most two float32 ulps (g is
    the rounded norm: up to one ulp, and the fold's own rounding), and its
    float32 waveform holds the seed build's at >= 80 dB (the f32 route's
    end-to-end bar)."""
    from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator

    cfg = HifiGanConfig()
    seed = init_params(HifiGanGenerator(cfg), 0)
    path = str(tmp_path / "generator_v2")
    to_torch.save_hifigan_checkpoint(path, to_jax_params(seed), cfg)
    rebuilt = load_jax_params(HifiGanGenerator(cfg),
                              from_torch.load_hifigan_checkpoint(path))
    moved = total = 0
    want_sd = seed.state_dict()
    for name, got in rebuilt.state_dict().items():
        want = want_sd[name]
        ulp = torch.from_numpy(np.spacing(np.abs(want.numpy())))
        assert ((got - want).abs() <= 2 * ulp).all(), name
        moved += int((got != want).sum())
        total += want.numel()
    print(f"weights moved by the fold: {moved} of {total}")
    mel = torch.from_numpy(np.random.default_rng(3).normal(
        -4, 1.5, (1, 24, 80)).astype(np.float32))
    with torch.no_grad():
        want, got = seed(mel).double(), rebuilt(mel).double()
    snr = 10 * torch.log10(want.pow(2).mean()
                           / (got - want).pow(2).mean().clamp_min(1e-30))
    print(f"waveform SNR against the seed build: {float(snr):.1f} dB")
    assert float(snr) >= 80.0, float(snr)
