"""The port's data parallelism (``parallel/``) against the JAX package on
a virtual mesh: two gloo CPU ranks against ``make_mesh(2)`` of
tests/conftest.py's eight virtual CPU devices.

One spawned group runs every rank-side case of this file (a module
fixture): the collectives, the float32 acoustic step on a batch whose
halves differ widely in valid frames, the cached step on the replicated
device corpus, the Trainer's evaluation with its padded remainder (by
the loader and by the cache), the GAN step, and a SIGTERM that reaches
one rank.  The CLIs spawn their own ranks."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from conftest import mini_corpus, preprocessed_corpus  # noqa: F401
from efficientspeech_tpu.config import AudioConfig as JaxAudioConfig
from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.config import TrainConfig as JaxTrainConfig
from efficientspeech_tpu.data.dataset import LJSpeechDataset as JaxDataset
from efficientspeech_tpu.data.device_cache import (
    build_host_cache as jax_build_host_cache)
from efficientspeech_tpu.data.device_cache import (
    make_cached_eval_step as jax_cached_eval_step)
from efficientspeech_tpu.data.device_cache import (
    make_cached_train_step as jax_cached_step)
from efficientspeech_tpu.data.device_cache import (
    upload_cache as jax_upload_cache)
from efficientspeech_tpu.models.phoneme2mel import Phoneme2Mel as JaxP2M
from efficientspeech_tpu.parallel import make_mesh as jax_make_mesh
from efficientspeech_tpu.parallel import shard_batch as jax_shard_batch
from efficientspeech_tpu.training.state import (
    create_train_state as jax_create_state)
from efficientspeech_tpu.training.state import make_optimizer as jax_optimizer
from efficientspeech_tpu.training.step import make_train_step as jax_step
from efficientspeech_tpu.training.vocoder import (
    create_vocoder_trainer as jax_vocoder_trainer)
from efficientspeech_tpu_torch.config import (
    AudioConfig, HifiGanConfig, ModelConfig, PreprocessConfig)
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator, MultiScaleDiscriminator)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.parallel import launch, make_mesh
from efficientspeech_tpu_torch.parallel.mesh import (
    Mesh, pick_backend, shard_batch)
from efficientspeech_tpu_torch.training.step import forward_losses
from efficientspeech_tpu_torch.training.vocoder import create_vocoder_trainer
from efficientspeech_tpu_torch.weights import (
    from_jax_params, init_params, load_jax_params, to_jax_params)

torch.set_num_threads(2)

N_PAD, M_PAD = 32, 256      # the mini corpus's training shape
LR = 1e-3
# the width-32 generator of the JAX package's multichip dry run
GAN_CFG = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),))
GAN_BATCH, GAN_FRAMES = 4, 16


def _unequal_batch():
    """Four rows at the corpus's training shape; rank 0's two are long,
    rank 1's two short: the halves' valid frames differ about
    sevenfold."""
    rng = np.random.default_rng(3)
    lens = [30, 28, 4, 3]
    phoneme = np.zeros((4, N_PAD), np.int32)
    duration = np.zeros((4, N_PAD), np.int32)
    for i, length in enumerate(lens):
        phoneme[i, :length] = rng.integers(1, 140, length)
        duration[i, :length] = rng.integers(1, 8, length)
    pad = phoneme == 0
    mel_len = np.minimum(duration.sum(1), M_PAD)
    return {
        "phoneme": phoneme, "phoneme_mask": pad,
        "pitch": (rng.normal(size=(4, N_PAD)) * ~pad).astype(np.float32),
        "energy": (rng.normal(size=(4, N_PAD)) * ~pad).astype(np.float32),
        "duration": duration,
        "mel": rng.normal(size=(4, M_PAD, 80)).astype(np.float32),
        "mel_mask": np.arange(M_PAD)[None, :] >= mel_len[:, None]}


def _port_params(tree):
    return {k: v.numpy() for k, v in from_jax_params(
        jax.device_get(tree)).items()}


def _recording(tx):
    """``tx`` whose state also keeps the last gradients."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_state(params, mesh):
    """A replicated JAX train state at lr 1e-3 after no warmup, and its
    optimizer, which keeps each step's gradients."""
    train_cfg = JaxTrainConfig(lr=LR, warmup_epochs=0, max_epochs=10)
    tx = _recording(jax_optimizer(train_cfg, steps_per_epoch=4))
    state = jax_create_state({"phoneme2mel": params}, train_cfg, 4)
    state = state.replace(opt_state=tx.init(state.params))
    return jax.device_put(state, NamedSharding(mesh, P())), tx


def _stepped(state, metrics):
    """(metrics, stepped parameters, the step's gradients), port names."""
    return ({k: float(v) for k, v in jax.device_get(metrics).items()},
            _port_params(state.params["phoneme2mel"]),
            _port_params(state.opt_state[1]["phoneme2mel"]))


def _port_cfg(jax_cfg) -> PreprocessConfig:
    return PreprocessConfig(preprocessed_path=jax_cfg.preprocessed_path,
                            text_cleaners=tuple(jax_cfg.text_cleaners),
                            max_length=jax_cfg.max_length)


def _gan_inputs():
    rng = np.random.default_rng(7)
    mel = rng.normal(-3, 2, (GAN_BATCH, GAN_FRAMES, 80)).astype(np.float32)
    wav = rng.normal(0, 0.3, (GAN_BATCH, GAN_FRAMES * 64)).astype(
        np.float32)
    gen_tree = to_jax_params(init_params(HifiGanGenerator(HifiGanConfig(
        **GAN_CFG)), 0))
    disc_trees = {"mpd": to_jax_params(init_params(
        MultiPeriodDiscriminator(), 1)),
        "msd": to_jax_params(init_params(MultiScaleDiscriminator(), 2))}
    return mel, wav, gen_tree, disc_trees


@pytest.fixture(scope="module")
def runs(preprocessed_corpus, tmp_path_factory):
    """(JAX references, per-rank results, inputs) of every case of this
    file: one tiny float32 model at the mini corpus's training shape for
    the acoustic cases."""
    mesh = jax_make_mesh(data_parallel=2)
    pre_cfg = _port_cfg(preprocessed_corpus)
    stats = pre_cfg.load_stats()
    kw = dict(pitch_stats=tuple(stats["pitch"][:2]),
              energy_stats=tuple(stats["energy"][:2]),
              max_phoneme_len=N_PAD, max_mel_len=M_PAD)
    model_cfg = ModelConfig.preset("tiny", **kw)
    jmodel = JaxP2M(JaxModelConfig.preset("tiny", **kw), dtype=jnp.float32)
    batch = _unequal_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = jax.device_get(jax.jit(lambda r: jmodel.init(
        r, jb["phoneme"], jb["phoneme_mask"], pitch_target=jb["pitch"],
        energy_target=jb["energy"], duration_target=jb["duration"],
        train=True)["params"])(jax.random.PRNGKey(0)))
    ref = {}
    # the unequal halves on the mesh
    state, tx = _jax_state(tree, mesh)
    ref["step"] = _stepped(*jax_step(jmodel, tx, mesh=mesh, donate=False)(
        state, jax_shard_batch(batch, mesh)))
    # the replicated corpus: the cached step on the mesh ...
    ds = JaxDataset("train.txt", preprocessed_corpus)
    host = jax_build_host_cache(ds, N_PAD, M_PAD)
    idx = np.arange(4, dtype=np.int32) % len(ds)
    state, tx = _jax_state(tree, mesh)
    ref["cached"] = _stepped(*jax_cached_step(
        jmodel, tx, mesh=mesh, donate=False)(
        state, jax_upload_cache(host, mesh=mesh), idx))
    # ... and the JAX Trainer's evaluation of the validation set on the
    # mesh: its two utterances padded to batch 4 with row_valid False
    val = jax_build_host_cache(JaxDataset("val.txt", preprocessed_corpus),
                               N_PAD, M_PAD)
    assert len(val["mel_len"]) == 2
    ev = jax_cached_eval_step(jmodel, mesh=mesh)(
        {"phoneme2mel": tree}, jax_upload_cache(val, mesh=mesh),
        np.array([0, 1, 0, 0], np.int32), np.array([1, 1, 0, 0], bool))
    ref["eval"] = {k.replace("_loss", ""): float(v)
                   for k, v in jax.device_get(ev).items()}

    # the GAN step on the mesh
    mel, wav, gen_tree, disc_trees = _gan_inputs()
    _, ginit, gstep = jax_vocoder_trainer(
        JaxHifiGanConfig(**GAN_CFG), JaxAudioConfig(), mesh=mesh)
    gstate = ginit(jax.random.PRNGKey(0), gen_tree, segment=wav.shape[1])
    gstate = gstate.replace(mpd_params=disc_trees["mpd"],
                            msd_params=disc_trees["msd"])
    _, gm = gstep(gstate, jnp.asarray(mel), jnp.asarray(wav))
    ref["gan"] = {k: float(v) for k, v in jax.device_get(gm).items()}

    root = tmp_path_factory.mktemp("parallel")
    inputs = dict(batch=batch, tree=tree, model_cfg=model_cfg,
                  gan=(mel, wav, gen_tree, disc_trees),
                  sig=dict(model_cfg=model_cfg, pre_cfg=pre_cfg, after_s=2.0,
                           ckpt=str(root / "sig" / "ckpt"),
                           logs=str(root / "sig" / "logs")))
    cases = [
        ("comm", torch_ranks.comm_checks, None),
        ("acoustic", torch_ranks.dp_acoustic, dict(
            tree=tree, model_cfg=model_cfg, lr=LR, batch=batch,
            cache=dict(pre_cfg=pre_cfg, idx=idx, root=str(root / "port")))),
        ("gan", torch_ranks.dp_gan, dict(
            cfg=GAN_CFG, gen_tree=gen_tree, disc_trees=disc_trees, mel=mel,
            wav=wav)),
        ("sigterm", torch_ranks.dp_sigterm, inputs["sig"])]
    got = launch(torch_ranks.run_cases, 2, ["cpu", "cpu"], args=(cases,))
    return ref, got, inputs


def test_shard_batch_matches_data_sharding():
    """``shard_batch`` gives each rank the rows that ``P("data")`` puts on
    its device of the JAX mesh, for a batch's arrays and its text list."""
    batch = {"x": np.arange(24, dtype=np.float32).reshape(8, 3),
             "text": [f"u{i}" for i in range(8)]}
    for n in (2, 4):
        mesh = jax_make_mesh(data_parallel=n)
        sharded = jax.device_put(batch["x"], NamedSharding(mesh, P("data")))
        by_device = {s.device: np.asarray(s.data)
                     for s in sharded.addressable_shards}
        for r, dev in enumerate(mesh.devices[:, 0]):
            rows = shard_batch(batch, Mesh({"data": n, "model": 1}, rank=r,
                                           connected=False))
            np.testing.assert_array_equal(rows["x"], by_device[dev])
            assert rows["text"] == batch["text"][r * 8 // n:
                                                 (r + 1) * 8 // n]
    with pytest.raises(ValueError, match="do not split"):
        shard_batch({"x": np.zeros(3)}, Mesh({"data": 2}, rank=0,
                                             connected=False))


def test_mesh_and_backend_rules():
    """``make_mesh`` raises the JAX package's message past the devices;
    NCCL for a card a rank, gloo for CPU ranks, and ranks that share a
    card need gloo asked for (no silent switch)."""
    with pytest.raises(ValueError, match="mesh 3x1 exceeds 2 devices"):
        make_mesh(data_parallel=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mesh 2x2 exceeds 2 devices"):
        make_mesh(data_parallel=2, model_parallel=2, devices=["cpu"] * 2)
    plan = make_mesh(data_parallel=2, devices=["cpu", "cpu"])
    assert plan.shape == {"data": 2, "model": 1} and not plan.connected
    with pytest.raises(RuntimeError, match="parallel.launch"):
        plan.group("data")
    assert make_mesh(devices=["cpu"]).connected
    assert pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert pick_backend(["cpu", "cpu"]) == "gloo"
    assert pick_backend(["cuda", "cuda:0"], "gloo") == "gloo"
    for devices, backend in ((["cuda:0", "cuda:0"], None),
                             (["cuda", "cuda:0"], "nccl"),
                             (["cpu", "cpu"], "nccl"),
                             (["cpu", "cuda:0"], None)):
        with pytest.raises(ValueError, match="NCCL"):
            pick_backend(devices, backend)


def test_cli_mesh_past_the_cards_raises(monkeypatch, tmp_path):
    """On a card, ``--data-parallel`` above the number of cards raises the
    mesh message before any rank starts, in both CLIs."""
    from efficientspeech_tpu_torch import train, train_vocoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    yaml = str(tmp_path / "none.yaml")
    with pytest.raises(ValueError, match="mesh 2x1 exceeds 1 devices"):
        train.main(["--data-parallel", "2", "--preprocess-config", yaml])
    with pytest.raises(ValueError, match="mesh 2x1 exceeds 1 devices"):
        train_vocoder.main(["--data-parallel", "2", "--preprocess-config",
                            yaml])


def test_collectives(runs):
    """all_gather, the all-reduce and the halo exchange on rank-numbered
    inputs, and the differentiable forms' forward and backward."""
    got = [r["comm"] for r in runs[1]]
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
         for r in range(2)]
    glob = np.arange(12, dtype=np.float32).reshape(1, 6, 2)
    padded = np.pad(glob, ((0, 0), (2, 2), (0, 0)))
    c = np.arange(1.0, 7.0, dtype=np.float32)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["all_gather"],
                                      np.concatenate(x, axis=1))
        np.testing.assert_array_equal(g["all_reduce_sum"], x[0] + x[1])
        np.testing.assert_array_equal(g["halo"], padded[:, 3 * r:
                                                        3 * r + 7])
        np.testing.assert_array_equal(g["gather_last"], np.ones(6))
        np.testing.assert_array_equal(g["gather_last_grad"],
                                      c[3 * r: 3 * r + 3])
        np.testing.assert_array_equal(g["split_last"], np.ones(3))
        # each rank's slice gradient, gathered: c[:3] · 1 and c[:3] · 2
        np.testing.assert_array_equal(g["split_last_grad"],
                                      np.concatenate([c[:3], 2 * c[:3]]))
        np.testing.assert_array_equal(g["reduce_sum"], np.full(6, 3.0))
        np.testing.assert_array_equal(g["reduce_sum_grad"], c)
        np.testing.assert_array_equal(g["copy_in"], np.ones(6))
        np.testing.assert_array_equal(g["copy_in_grad"], c * 1 + c * 2)


def _assert_step(got, want):
    """test_train_step_matches_jax's float32 tolerances: losses at rtol
    1e-5, each gradient leaf at 1e-4 of its largest, the parameters after
    one AdamW step at 2e-5 except where the gradient is within that
    tolerance of zero (a first Adam step there may flip sign)."""
    want_metrics, want_params, want_grads = want
    for k, v in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert set(got["grads"]) == set(want_grads)
    for name, ref_g in want_grads.items():
        scale = np.abs(ref_g).max() + 1e-12
        np.testing.assert_allclose(got["grads"][name] / scale,
                                   ref_g / scale, atol=1e-4, err_msg=name)
        g = np.abs(ref_g)
        keep = ~((g > 0) & (g < 1e-4 * g.max()))
        np.testing.assert_allclose(got["params"][name][keep],
                                   want_params[name][keep], atol=2e-5,
                                   err_msg=name)


def test_unequal_halves_step_matches_jax_mesh(runs):
    """The two-rank float32 step on halves of unequal valid frames equals
    JAX's ``make_train_step(mesh=make_mesh(2))``: every rank reports the
    global losses, holds the full batch's gradients (at
    test_train_step_matches_jax's tolerances) and takes the same update.
    A mean of the two ranks' own means would miss the loss by a hundred
    times its tolerance."""
    ref, got, inp = runs
    for r in got:
        _assert_step(r["acoustic"]["step"], ref["step"])
    a, b = (r["acoustic"]["step"] for r in got)
    assert a["metrics"] == b["metrics"]
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])
    # the mean of per-rank means, on the same parameters
    model = load_jax_params(Phoneme2Mel(inp["model_cfg"]), inp["tree"])
    halves = [forward_losses(model, {k: torch.from_numpy(v[sl]) for k, v
                                     in inp["batch"].items()},
                             torch.float32)["loss"].item()
              for sl in (slice(0, 2), slice(2, 4))]
    # misses the loss by a hundred times the tolerance (5e-3 relative)
    want = ref["step"][0]["loss"]
    assert abs(np.mean(halves) - want) > 100 * 1e-5 * want, (halves, want)


def test_cached_step_matches_jax_mesh(runs):
    """The cached step on the replicated corpus, each rank gathering its
    slice of the global indices, equals JAX's cached step on its mesh
    (tests/test_device_cache.py::test_cached_step_mesh_matches_single_device)."""
    ref, got, _ = runs
    for r in got:
        _assert_step(r["acoustic"]["cached"], ref["cached"])


def test_sharded_eval_includes_remainder(runs):
    """A mesh Trainer's evaluation, by the loader and by the cache, with
    the whole validation set a remainder padded to batch 4, equals the
    JAX mesh Trainer's (tests/test_device_cache.py::
    test_sharded_eval_includes_remainder)."""
    ref, got, _ = runs
    assert ref["eval"]
    for r in got:
        for device_data, val in r["acoustic"]["eval"].items():
            assert set(val) == set(ref["eval"]), device_data
            for k, v in ref["eval"].items():
                np.testing.assert_allclose(val[k], v, rtol=1e-5, atol=1e-6,
                                           err_msg=(k, device_data))


def test_gan_step_matches_jax_mesh(runs):
    """The two-rank GAN step's metrics equal JAX's
    ``create_vocoder_trainer(mesh=make_mesh(2))`` at the dry run's 2e-5;
    its averaged gradients equal the one-process step's on the whole
    batch (the generator's within 5e-4 of its norm, the discriminators'
    1e-4: test_torch_vocoder_training's bars)."""
    ref, got, inp = runs
    for r in got:
        for k, v in ref["gan"].items():
            np.testing.assert_allclose(r["gan"]["metrics"][k], v, rtol=2e-5,
                                       atol=2e-5, err_msg=k)
    mel, wav, gen_tree, disc_trees = inp["gan"]
    _, init, step = create_vocoder_trainer(
        HifiGanConfig(**GAN_CFG), AudioConfig(), device="cpu")
    state = init(gen_params=gen_tree, disc_params=disc_trees)
    state, _ = step(state, torch.from_numpy(mel), torch.from_numpy(wav))
    for part, bar in (("gen", 5e-4), ("mpd", 1e-4), ("msd", 1e-4)):
        want = np.concatenate([p.grad.numpy().ravel() for p in getattr(
            state, part).parameters()])
        for r in got:
            g = np.concatenate([v.ravel() for k, v in r["gan"][
                "grads"].items() if k.startswith(part + ".")])
            assert np.linalg.norm(g - want) <= bar * np.linalg.norm(want), \
                part


def test_sigterm_on_one_rank_stops_both(runs):
    """SIGTERM to rank 1 alone: both ranks stop after the same step, and
    rank 0 writes the one checkpoint (of that step) and every log line."""
    _, got, inp = runs
    steps = [r["sigterm"] for r in got]
    assert steps[0] == steps[1] >= 1
    ckpts = sorted(os.listdir(inp["sig"]["ckpt"]))
    assert ckpts == [f"step_{steps[0]:08d}.pt"]
    epochs = [line["step"] for line in _logged(inp["sig"]["logs"])
              if "loss" in line]
    assert epochs == sorted(set(epochs)) and epochs[-1] == steps[0]


def _yaml(corpus, tmp_path):
    path = os.path.join(tmp_path, "c.yaml")
    with open(path, "w") as f:
        f.write(f"""
dataset: "LJSpeech"
path:
  corpus_path: "{corpus.corpus_path}"
  raw_path: "{corpus.raw_path}"
  preprocessed_path: "{corpus.preprocessed_path}"
preprocessing:
  audio:
    sampling_rate: 22050
""")
    return path


def _logged(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_data_parallel_resumes_on_one(preprocessed_corpus,
                                                tmp_path):
    """``train --data-parallel 2 --device cpu`` writes finite metrics and
    an unsharded checkpoint; ``--data-parallel 1`` resumes from it."""
    from efficientspeech_tpu_torch import train

    common = ["--device", "cpu", "--precision", "f32", "--preprocess-config",
              _yaml(preprocessed_corpus, tmp_path), "--batch-size", "2",
              "--max-phoneme-len", str(N_PAD), "--max-mel-len", str(M_PAD),
              "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir",
              str(tmp_path / "logs")]
    assert train.main(common + ["--data-parallel", "2", "--max-steps",
                                "3"]) == 3
    assert os.listdir(tmp_path / "ckpt") == ["step_00000003.pt"]
    lines = _logged(tmp_path / "logs")
    assert [line["step"] for line in lines] == [2, 3]
    assert all(np.isfinite(line[k]) for line in lines
               for k in ("loss", "mel", "duration"))
    assert train.main(common + ["--data-parallel", "1", "--max-steps",
                                "4"]) == 4
    assert _logged(tmp_path / "logs")[-1]["step"] == 4


def test_train_vocoder_cli_data_parallel_resumes_on_one(preprocessed_corpus,
                                                        tmp_path):
    """``train_vocoder --data-parallel 2 --device cpu`` writes finite
    metrics and a checkpoint that ``--data-parallel 1 --resume`` goes on
    from."""
    from efficientspeech_tpu_torch import train_vocoder

    common = ["--batch-size", "2", "--segment", "2048",
              "--initial-channels", "16", "--device", "cpu",
              "--preprocess-config", _yaml(preprocessed_corpus, tmp_path),
              "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir",
              str(tmp_path / "logs"), "--log-every", "1"]
    out = train_vocoder.main(common + ["--data-parallel", "2", "--steps",
                                       "2"])
    assert out["step"] == 2 and out["checkpoint"].endswith(
        "step_00000002.pt")
    lines = _logged(tmp_path / "logs")
    assert [line["step"] for line in lines] == [1, 2]
    assert all(np.isfinite(line["gen_loss"]) and np.isfinite(
        line["disc_loss"]) for line in lines)
    out = train_vocoder.main(common + ["--data-parallel", "1", "--steps",
                                       "3", "--resume"])
    assert out["step"] == 3
    assert [line["step"] for line in _logged(tmp_path / "logs")] == [1, 2, 3]
