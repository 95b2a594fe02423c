"""The port's acoustic training slice against the JAX package's: losses,
schedule, AdamW, one whole train step (fused decoder routes; the JAX side
runs its Pallas kernels in interpret mode, the port its kernels' plain
versions on the CPU), the batch loader, and ``Trainer.fit`` with resume."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.config import TrainConfig as JaxTrainConfig
from efficientspeech_tpu.data.dataset import BucketedLoader as JaxLoader
from efficientspeech_tpu.data.dataset import LJSpeechDataset as JaxDataset
from efficientspeech_tpu.models.phoneme2mel import Phoneme2Mel as JaxP2M
from efficientspeech_tpu.training.losses import (
    compute_losses as jax_compute_losses)
from efficientspeech_tpu.training.schedule import (
    warmup_cosine_schedule as jax_schedule)
from efficientspeech_tpu.training.state import (
    create_train_state as jax_create_state)
from efficientspeech_tpu.training.state import make_optimizer as jax_optimizer
from efficientspeech_tpu.training.step import make_train_step as jax_step
from efficientspeech_tpu_torch.config import (
    ModelConfig, PreprocessConfig, TrainConfig)
from efficientspeech_tpu_torch.data.dataset import (
    BucketedLoader, LJSpeechDataset)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.training.losses import compute_losses
from efficientspeech_tpu_torch.training.schedule import (
    warmup_cosine_schedule)
from efficientspeech_tpu_torch.training.state import (
    apply_gradients, create_train_state)
from efficientspeech_tpu_torch.training.step import make_train_step
from efficientspeech_tpu_torch.weights import from_jax_params, load_jax_params

torch.set_num_threads(2)

N, M = 24, 96


def _batch(rng, b=3, n=N, m=M):
    lens = [n, n - 7, 9][:b]
    phoneme = np.zeros((b, n), np.int32)
    duration = np.zeros((b, n), np.int32)
    for i, length in enumerate(lens):
        phoneme[i, :length] = rng.integers(1, 140, length)
        duration[i, :length] = rng.integers(1, m // n + 2, length)
    pad = phoneme == 0
    mel_len = np.minimum(duration.sum(1), m)
    return {
        "phoneme": phoneme, "phoneme_mask": pad,
        "pitch": (rng.normal(size=(b, n)) * ~pad).astype(np.float32),
        "energy": (rng.normal(size=(b, n)) * ~pad).astype(np.float32),
        "duration": duration,
        "mel": rng.normal(size=(b, m, 80)).astype(np.float32),
        "mel_mask": np.arange(m)[None, :] >= mel_len[:, None],
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    batch = _batch(rng)
    pred = {"mel": rng.normal(size=(3, M, 80)).astype(np.float32),
            "pitch": rng.normal(size=(3, N, 1)).astype(np.float32),
            "energy": rng.normal(size=(3, N, 1)).astype(np.float32),
            "duration": rng.uniform(0, 6, (3, N, 1)).astype(np.float32)}
    want = jax_compute_losses({k: jnp.asarray(v) for k, v in pred.items()},
                              {k: jnp.asarray(v) for k, v in batch.items()})
    got = compute_losses({k: torch.from_numpy(v) for k, v in pred.items()},
                         _torch_batch(batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("warmup", [0, 3])
def test_schedule_matches_jax(warmup):
    want = jax_schedule(1e-3, warmup, 20, 7)
    got = warmup_cosine_schedule(1e-3, warmup, 20, 7)
    assert got(0) == (0.0 if warmup else 1e-3)
    for step in (0, 1, 6, 7, 20, 21, 22, 70, 139, 140, 200):
        # the JAX schedule computes in float32, and 1 + cos cancels near
        # the end of the decay: 1e-7 of the base rate absolute
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-10, err_msg=str(step))


@pytest.mark.parametrize("case", ["acoustic", "vocoder"])
def test_adamw_matches_optax(case):
    """Three AdamW steps on the same numpy gradients, decay on every
    parameter.  acoustic: the train state's AdamW, lr from the schedule
    at the pre-increment step; vocoder: the vocoder trainer's optimizers,
    a constant rate with betas (0.8, 0.99) and decay 0.01."""
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    cfg = TrainConfig(lr=1e-2, weight_decay=0.1, warmup_epochs=1,
                      max_epochs=4)
    if case == "acoustic":
        tx = optax.adamw(jax_schedule(cfg.lr, 1, 4, 2),
                         weight_decay=cfg.weight_decay)
    else:
        tx = optax.adamw(1e-2, b1=0.8, b2=0.99, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    model = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    if case == "acoustic":
        state = create_train_state(model, cfg, warmup_cosine_schedule(
            cfg.lr, 1, 4, 2))
        step = lambda: apply_gradients(state)  # noqa: E731
    else:
        from efficientspeech_tpu_torch.config import (
            AudioConfig, HifiGanConfig)
        from efficientspeech_tpu_torch.training.vocoder import (
            create_vocoder_trainer)

        _, init, _ = create_vocoder_trainer(
            HifiGanConfig(upsample_initial_channel=16), AudioConfig(),
            lr=1e-2, device="cpu")
        opt = init().gen_opt
        assert opt.defaults["betas"] == (0.8, 0.99)
        assert opt.defaults["weight_decay"] == 0.01
        assert opt.defaults["eps"] == 1e-8
        opt = torch.optim.AdamW(model.values(), **{
            k: opt.defaults[k] for k in ("lr", "betas", "eps",
                                         "weight_decay")})
        step = opt.step
    for g in grads:
        for k, p in model.items():
            p.grad = torch.from_numpy(g[k])
        step()
    if case == "acoustic":
        assert state.step == 3
    for k in params:
        np.testing.assert_allclose(model[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


# the small preset's case keeps its mel-decoder width (256) and cuts its
# blocks (3 → 1) and lengths for speed
CASES = {"tiny": (dict(), N, M), "small": (dict(n_blocks=1), 16, 64)}
# at most this many updated parameter elements differ from JAX's, all
# where the float32 gradient is within the gradients' tolerance of zero
LEFT_OUT = {"tiny": 0, "small": 2}


def _step_case(preset):
    """A batch, JAX-layout parameters, and the JAX package's results for
    them in each dtype: its train step (fused decoder routes, Pallas
    kernels in interpret mode) and the gradients of the same loss."""
    overrides, n, m = CASES[preset]
    rng = np.random.default_rng(5)
    batch = _batch(rng, n=n, m=m)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = JaxModelConfig.preset(preset, max_phoneme_len=n, max_mel_len=m,
                                 **overrides)
    models = {name: JaxP2M(jcfg, dtype=jdt, fused_decoder_norm=True,
                           fused_decoder_block=True,
                           fused_norm_interpret=True)
              for name, (jdt, _) in DTYPES.items()}
    params = jax.jit(lambda r: models["f32"].init(
        r, jb["phoneme"], jb["phoneme_mask"], pitch_target=jb["pitch"],
        energy_target=jb["energy"], duration_target=jb["duration"],
        train=True)["params"])(jax.random.PRNGKey(0))
    # realistic LayerNorm scales (flax initialises them to 1)
    lnr = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + 0.1 * lnr.standard_normal(v.shape)
                         ).astype(np.float32) if path[-1].key == "scale"
        else np.asarray(v), params)
    train_cfg = JaxTrainConfig(lr=1e-3, warmup_epochs=0, max_epochs=10)
    ref = {}
    for name, model in models.items():
        tx = jax_optimizer(train_cfg, steps_per_epoch=4)
        state = jax_create_state({"phoneme2mel": params}, train_cfg, 4)
        state, metrics = jax_step(model, tx, donate=False)(state, jb)

        def loss_fn(p, model=model):
            pred = model.apply(
                {"params": p}, jb["phoneme"], jb["phoneme_mask"],
                pitch_target=jb["pitch"], energy_target=jb["energy"],
                duration_target=jb["duration"], train=True)
            return jax_compute_losses(pred, jb)["loss"]

        grads = jax.jit(jax.grad(loss_fn))(params)
        ref[name] = dict(
            loss=float(metrics["loss"]),
            grads={k: v.numpy() for k, v in from_jax_params(grads).items()},
            params={k: v.numpy() for k, v in from_jax_params(
                state.params["phoneme2mel"]).items()})
    return batch, params, ref


@pytest.fixture(scope="module")
def step_case():
    return _step_case("tiny")


@pytest.fixture(scope="module")
def step_case_small():
    return _step_case("small")


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("preset,dtype", [
    pytest.param(preset, dtype,
                 id=dtype if preset == "tiny" else f"{preset}-{dtype}")
    for preset in CASES for dtype in sorted(DTYPES)])
def test_train_step_matches_jax(request, preset, dtype):
    """One train step of the whole slice, fused decoder routes: the loss,
    every gradient leaf and the updated parameters."""
    batch, params, ref = request.getfixturevalue(
        "step_case" if preset == "tiny" else f"step_case_{preset}")
    overrides, n, m = CASES[preset]
    model = Phoneme2Mel(ModelConfig.preset(preset, max_phoneme_len=n,
                                           max_mel_len=m, **overrides),
                        fused_decoder_norm=True, fused_decoder_block=True)
    assert model.decoder.proj_norm.weight.shape[0] == \
        {"tiny": 128, "small": 256}[preset]
    load_jax_params(model, params)
    cfg = TrainConfig(lr=1e-3, warmup_epochs=0, max_epochs=10)
    state = create_train_state(model, cfg, warmup_cosine_schedule(
        cfg.lr, 0, 10, 4))
    state, metrics = make_train_step(DTYPES[dtype][1])(state,
                                                       _torch_batch(batch))
    assert state.step == 1
    want = ref[dtype]
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    if dtype == "f32":
        # the same float32 arithmetic in another summation order
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                                   rtol=1e-5)
        for name, got in grads.items():
            scale = np.abs(want["grads"][name]).max() + 1e-12
            np.testing.assert_allclose(got / scale,
                                       want["grads"][name] / scale,
                                       atol=1e-4, err_msg=name)
        # one AdamW step at lr 1e-3 moves each weight by about 1e-3.  A
        # first Adam step moves a weight by lr · g / (|g| + eps): where g is
        # within the gradients' tolerance of zero but not zero (0 < |g| <
        # 1e-4 of its leaf's largest) the two frameworks' steps may differ
        # in sign.
        # Every other element must agree; of those, the ones that do not
        # are counted
        left_out = 0
        for name, p in model.state_dict().items():
            got, ref_p = p.numpy(), want["params"][name]
            g = np.abs(want["grads"][name])
            noise = (g > 0) & (g < 1e-4 * g.max())
            np.testing.assert_allclose(got[~noise], ref_p[~noise], atol=2e-5,
                                       err_msg=name)
            left_out += int((~np.isclose(got[noise], ref_p[noise], rtol=1e-7,
                                         atol=2e-5)).sum())
        assert left_out <= LEFT_OUT[preset], left_out
        return
    # bf16 rounds activations at other places in the two frameworks, so
    # the bf16 gradients of the two differ by as much as each differs from
    # float32.  Each of the port's bf16 gradient leaves must be no farther
    # (relative L2) from JAX's float32 gradient than three times JAX's own
    # bf16 gradient is, and its loss within 1e-3 of JAX's bf16 loss
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=1e-3)
    # the parameters JAX keeps in float32 (LayerNorm, the embedding tables,
    # the K4 route's convs) take float32 gradients, summed in float32: a
    # gradient through a bf16 copy of the parameter would be bf16 values
    for name in ("encoder.encoder.embed.weight",
                 "encoder.pitch_embedding.weight",
                 "encoder.encoder.stage0.norm1.weight",
                 "decoder.proj_norm.weight", "decoder.block0_norm0.bias",
                 f"decoder.block{model.cfg.n_blocks - 1}_conv1_dw.weight",
                 "decoder.block0_conv0_pw.weight"):
        g = torch.from_numpy(grads[name])
        assert not torch.equal(g, g.bfloat16().float()), name
    f32 = ref["f32"]["grads"]
    for name, got in grads.items():
        if not np.abs(f32[name]).any():  # norm2 of pitch/energy: unused
            assert not got.any(), name
            continue
        assert _rel(got, f32[name]) <= 3 * _rel(want["grads"][name],
                                                f32[name]), name


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_compute_params_f32_keeps_every_parameter_f32(preset):
    """A float32 train step runs on the float32 masters themselves:
    compute_params at float32 returns every parameter as it is (no cast,
    no copy), on the fused decoder routes as on the plain ones."""
    from efficientspeech_tpu_torch.models.modules import compute_params

    for fused in (False, True):
        model = Phoneme2Mel(ModelConfig.preset(preset, max_phoneme_len=16,
                                               max_mel_len=64),
                            fused_decoder_norm=fused,
                            fused_decoder_block=fused)
        params = compute_params(model, torch.float32)
        named = dict(model.named_parameters())
        assert set(params) == set(named)
        for name, p in params.items():
            assert p.dtype == torch.float32, name
            assert p is named[name], name


def _port_cfg(jax_cfg) -> PreprocessConfig:
    """The port's preprocessing config for the JAX fixture's corpus."""
    return PreprocessConfig(preprocessed_path=jax_cfg.preprocessed_path,
                            text_cleaners=tuple(jax_cfg.text_cleaners),
                            max_length=jax_cfg.max_length)


def test_loader_yields_jax_batches(preprocessed_corpus):
    cfg = _port_cfg(preprocessed_corpus)
    for shuffle, fixed in ((True, True), (False, False)):
        kw = dict(shuffle=shuffle, seed=3, max_phoneme_len=32,
                  max_mel_len=256, fixed_shape=fixed, drop_last=False)
        want = list(JaxLoader(JaxDataset("train.txt", preprocessed_corpus),
                              2, **kw))
        got = list(BucketedLoader(LJSpeechDataset("train.txt", cfg), 2,
                                  **kw))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]),
                                              np.asarray(w[k]), err_msg=k)


def test_trainer_fit_and_resume(preprocessed_corpus, tmp_path):
    from efficientspeech_tpu_torch.training.loop import Trainer

    cfg = _port_cfg(preprocessed_corpus)
    stats = cfg.load_stats()
    model_cfg = ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]), max_phoneme_len=32,
        max_mel_len=256)
    train_cfg = TrainConfig(batch_size=2, max_epochs=5, warmup_epochs=1,
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            log_dir=str(tmp_path / "logs"))
    trainer = Trainer(model_cfg, train_cfg, cfg, dtype=torch.float32,
                      device="cpu")
    assert trainer.model.decoder.fused_norm is False
    assert trainer.steps_per_epoch == 2
    assert trainer.fit(max_steps=2) == 2
    lines = [json.loads(line) for line in open(
        os.path.join(train_cfg.log_dir, "metrics.jsonl"))]
    assert lines[-1]["step"] == 2 and "mel" in lines[-1] \
        and "lr" in lines[-1]
    assert np.isfinite([lines[-1][k] for k in ("loss", "mel", "pitch",
                                               "energy", "duration")]).all()
    assert os.path.isfile(tmp_path / "ckpt" / "step_00000002.pt")
    val = trainer.evaluate()
    assert val["mel"] > 0

    # a new trainer resumes from step 2 with the saved weights, and goes on
    trainer2 = Trainer(model_cfg, train_cfg, cfg, dtype=torch.float32,
                       device="cpu")
    assert trainer2.fit(max_steps=3) == 3
    lines = [json.loads(line) for line in open(
        os.path.join(train_cfg.log_dir, "metrics.jsonl"))]
    assert [line["step"] for line in lines if "loss" in line][-2:] == [2, 3]
    assert lines[-1]["epoch"] == 1


def test_sigterm_checkpoints_and_returns(preprocessed_corpus, tmp_path):
    """SIGTERM during fit finishes the step, saves a checkpoint and
    returns instead of dying."""
    import signal
    import threading

    from efficientspeech_tpu_torch.training.checkpoint import (
        latest_checkpoint)
    from efficientspeech_tpu_torch.training.loop import Trainer

    cfg = _port_cfg(preprocessed_corpus)
    stats = cfg.load_stats()
    model_cfg = ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]), max_phoneme_len=32,
        max_mel_len=256)
    train_cfg = TrainConfig(batch_size=2, max_epochs=10_000,
                            warmup_epochs=1,
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            log_dir=str(tmp_path / "logs"))
    trainer = Trainer(model_cfg, train_cfg, cfg, dtype=torch.float32,
                      device="cpu")
    timer = threading.Timer(3.0, lambda: os.kill(os.getpid(),
                                                 signal.SIGTERM))
    timer.start()
    try:
        final_step = trainer.fit()  # 10,000 epochs without the signal
    finally:
        timer.cancel()
    assert 1 <= final_step < 10_000 * trainer.steps_per_epoch
    assert latest_checkpoint(train_cfg.checkpoint_dir).endswith(
        f"step_{final_step:08d}.pt")
    # the handlers are restored
    assert signal.getsignal(signal.SIGTERM) is not None


def test_synthesizer_serves_a_trainer_checkpoint(preprocessed_corpus,
                                                 tmp_path):
    """A checkpoint that ``save_checkpoint`` writes from a Trainer's state
    loads into ``build_synthesizer(checkpoint=...)``, named by its file or
    by its directory: the synthesizer's acoustic model gives the trained
    Phoneme2Mel's mel and durations."""
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.infer import build_synthesizer
    from efficientspeech_tpu_torch.training.checkpoint import save_checkpoint
    from efficientspeech_tpu_torch.training.loop import Trainer

    cfg = _port_cfg(preprocessed_corpus)
    stats = cfg.load_stats()
    sizes = dict(max_phoneme_len=32, max_mel_len=256)
    model_cfg = ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]), **sizes)
    train_cfg = TrainConfig(batch_size=2, max_epochs=5, warmup_epochs=1,
                            checkpoint_dir=str(tmp_path / "ckpt"),
                            log_dir=str(tmp_path / "logs"))
    trainer = Trainer(model_cfg, train_cfg, cfg, dtype=torch.float32,
                      device="cpu")
    trainer.fit(max_steps=1)
    trainer.state.step = 7
    path = save_checkpoint(str(tmp_path / "served"), trainer.state)
    assert path.endswith("step_00000007.pt")

    rng = np.random.default_rng(11)
    ph = torch.from_numpy(rng.integers(70, 146, (2, 20)).astype(np.int64))
    ph[1, 14:] = 0
    mask = ph == 0
    model = trainer.model.eval()
    with torch.no_grad():
        want = model(ph, mask, max_mel_len=128)
    small = HifiGanConfig(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                          upsample_initial_channel=16)

    def build(checkpoint):
        return build_synthesizer(
            preset="tiny", checkpoint=checkpoint, stats=stats,
            model_overrides=sizes, hifigan_cfg=small, dtype=torch.float32,
            bench_duration_bias=6.0, device="cpu")

    for checkpoint in (path, str(tmp_path / "served")):
        synth = build(checkpoint)
        with torch.no_grad():
            got = synth.acoustic(ph, mask, max_mel_len=128)
        assert torch.equal(got["duration"], want["duration"])
        assert torch.equal(got["mel_len"], want["mel_len"])
        torch.testing.assert_close(got["mel"], want["mel"], rtol=1e-5,
                                   atol=1e-6)
    with torch.no_grad():
        fresh = build(None).acoustic(ph, mask, max_mel_len=128)
    assert not torch.allclose(fresh["mel"], want["mel"])
    with pytest.raises(FileNotFoundError):
        build(str(tmp_path / "logs"))


# a small vocoder for the validation audio (ResBlock 1, 64x upsampling)
SMALL_VOCODER = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                     upsample_initial_channel=16,
                     resblock_kernel_sizes=(3, 5),
                     resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)))


def _vocoder_tree(seed=4):
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
    from efficientspeech_tpu_torch.weights import init_params, to_jax_params

    return to_jax_params(init_params(
        HifiGanGenerator(HifiGanConfig(**SMALL_VOCODER)), seed))


def test_validate_audio_matches_jax(preprocessed_corpus, tmp_path):
    """``Trainer.validate_audio`` of the port and of the JAX package on the
    same acoustic parameters (duration bias 2.0, so the mels are not
    empty), vocoder and validation batch, float32 on the CPU: the same
    ``val_*`` keys; the mel and duration metrics within 1e-4 relative
    (the models agree to ~1e-6, and DTW takes the same path); the F0
    metrics, from DIO on two vocoders' float32 waveforms, within 0.02 of
    voicing share and 1 Hz.  Both write the same wav files and
    prediction.txt; each PCM within 8 LSB of the JAX one."""
    from scipy.io import wavfile

    from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
    from efficientspeech_tpu.training.loop import Trainer as JaxTrainer
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.training.loop import Trainer

    cfg = _port_cfg(preprocessed_corpus)
    stats = cfg.load_stats()
    sizes = dict(pitch_stats=tuple(stats["pitch"][:2]),
                 energy_stats=tuple(stats["energy"][:2]), max_phoneme_len=32,
                 max_mel_len=256)
    vocoder = _vocoder_tree()
    runs = {}
    for name in ("jax", "port"):
        kw = dict(batch_size=2, max_epochs=5, warmup_epochs=1,
                  checkpoint_dir=str(tmp_path / name / "ckpt"),
                  log_dir=str(tmp_path / name / "logs"),
                  wav_path=str(tmp_path / name / "wavs"))
        if name == "jax":
            jt = JaxTrainer(JaxModelConfig.preset("tiny", **sizes),
                            JaxTrainConfig(**kw), preprocessed_corpus,
                            hifigan_cfg=JaxHifiGanConfig(**SMALL_VOCODER),
                            hifigan_params=vocoder, dtype=jnp.float32)
            params = jax.tree_util.tree_map(np.asarray, jt.state.params)
            params["phoneme2mel"]["encoder"]["duration_decoder"]["linear"][
                "bias"] = np.array([2.0], np.float32)
            jt.state = jt.state.replace(params=params)
            runs[name] = jt.validate_audio(epoch=9)
        else:
            pt = Trainer(ModelConfig.preset("tiny", **sizes),
                         TrainConfig(**kw), cfg,
                         hifigan_cfg=HifiGanConfig(**SMALL_VOCODER),
                         hifigan_params=vocoder, dtype=torch.float32,
                         device="cpu")
            load_jax_params(pt.model, params["phoneme2mel"])
            runs[name] = pt.validate_audio(epoch=9)
    want, got = runs["jax"], runs["port"]
    assert sorted(got) == sorted(want)
    assert {"mcd_db", "mcd_floor_db", "duration_mae_frames", "f0_rmse_hz",
            "voicing_f1"} <= set(got)
    for k, w in want.items():
        if k.startswith(("mcd", "duration")):
            np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
        elif k.startswith("voicing"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=0.02,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1.0,
                                       err_msg=k)
    names = sorted(os.listdir(tmp_path / "jax" / "wavs"))
    assert names == sorted(os.listdir(tmp_path / "port" / "wavs")) == [
        "prediction-0.wav", "prediction-1.wav", "prediction.txt",
        "reconstruction-0.wav", "reconstruction-1.wav"]
    assert (tmp_path / "jax" / "wavs" / "prediction.txt").read_bytes() == \
        (tmp_path / "port" / "wavs" / "prediction.txt").read_bytes()
    for n in names[:2] + names[3:]:
        (sr_w, w), (sr_g, g) = (wavfile.read(str(tmp_path / d / "wavs" / n))
                                for d in ("jax", "port"))
        assert sr_w == sr_g and w.shape == g.shape and len(w) > 0, n
        assert np.abs(g.astype(np.int32) - w).max() <= 8, n


def test_train_cli_writes_validation_audio(preprocessed_corpus, tmp_path,
                                          monkeypatch, capsys):
    """``python -m efficientspeech_tpu_torch.train --device cpu
    --hifigan-checkpoint G --wav-path W --resume`` writes the validation
    audio during ``fit`` (its tenth epoch) and logs the quality metrics;
    a failing dump is printed, and training goes on."""
    from efficientspeech_tpu_torch import train
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.convert.to_torch import (
        save_hifigan_checkpoint)
    from efficientspeech_tpu_torch.training import loop

    gen = tmp_path / "vocoder" / "generator"
    gen.parent.mkdir()
    save_hifigan_checkpoint(str(gen), _vocoder_tree(),
                            HifiGanConfig(**SMALL_VOCODER))
    yaml = tmp_path / "p.yaml"
    yaml.write_text(f"path:\n  preprocessed_path: "
                    f"{preprocessed_corpus.preprocessed_path}\n")
    wavs, logs = tmp_path / "wavs", tmp_path / "logs"
    argv = ["--device", "cpu", "--precision", "f32", "--preprocess-config",
            str(yaml), "--batch-size", "2", "--max-phoneme-len", "32",
            "--max-mel-len", "256", "--max-epochs", "10", "--warmup-epochs",
            "1", "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir",
            str(logs), "--hifigan-checkpoint", str(gen), "--wav-path",
            str(wavs), "--resume"]
    assert train.main(argv) == 20
    assert sorted(os.listdir(wavs)) == [
        "prediction-0.wav", "prediction-1.wav", "prediction.txt",
        "reconstruction-0.wav", "reconstruction-1.wav"]
    lines = [json.loads(line) for line in open(logs / "metrics.jsonl")]
    quality = [r for r in lines if "val_duration_mae_frames" in r]
    assert len(quality) == 1 and quality[0]["step"] == 20
    assert np.isfinite(quality[0]["val_duration_mae_frames"])

    def broken(self, epoch, quality_n=16):
        raise RuntimeError("disk full")

    monkeypatch.setattr(loop.Trainer, "validate_audio", broken)
    argv[argv.index("--max-epochs") + 1] = "20"
    capsys.readouterr()
    assert train.main(argv) == 40  # resumed at step 20
    assert "validation audio dump failed: disk full" in \
        capsys.readouterr().out
