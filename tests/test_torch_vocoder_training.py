"""The port's vocoder training slice against the JAX package's: the
period and scale discriminators, the GAN losses, the mel and
multi-resolution STFT losses, one whole GAN step (metrics, every
gradient, the stepped parameters) and a second step's metrics, and the
rank-4 kernels of the weight bridge.

The parameters are the port's native init, carried to the JAX side by
``weights.to_jax_params``.  One JAX train step is compiled per file (it
takes about a minute on the CPU): a module fixture runs it twice, with
optax's adamw wrapped to keep each step's gradients in the optimizer
state."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import efficientspeech_tpu.training.vocoder as jax_vocoder
from efficientspeech_tpu.config import AudioConfig as JaxAudioConfig
from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.models.hifigan_disc import (
    MultiPeriodDiscriminator as JaxMPD)
from efficientspeech_tpu.models.hifigan_disc import (
    MultiScaleDiscriminator as JaxMSD)
from efficientspeech_tpu.models.hifigan_disc import (
    discriminator_loss as jax_discriminator_loss)
from efficientspeech_tpu.models.hifigan_disc import (
    feature_loss as jax_feature_loss)
from efficientspeech_tpu.models.hifigan_disc import (
    generator_loss as jax_generator_loss)
from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator, MultiScaleDiscriminator, discriminator_loss,
    feature_loss, generator_loss)
from efficientspeech_tpu_torch.models.modules import Conv2d
from efficientspeech_tpu_torch.training.vocoder import (
    create_vocoder_trainer, make_mel_fn, multi_resolution_stft_loss)
from efficientspeech_tpu_torch.weights import (
    _WEIGHT_LEAF, from_jax_params, init_params, to_jax_params)

torch.set_num_threads(4)

WIDTH, SEGMENT, BATCH = 16, 2048, 2
LR, MR_STFT_WEIGHT = 2e-4, 2.5
DISCS = {"mpd": (MultiPeriodDiscriminator, JaxMPD),
         "msd": (MultiScaleDiscriminator, JaxMSD)}


def _inputs():
    """mel (B, frames, 80) and wav (B, SEGMENT); the second row's tail is
    silent, so its STFT frames there are exactly zero."""
    mel = np.random.default_rng(0).normal(
        -3, 2, (BATCH, SEGMENT // 256, 80)).astype(np.float32)
    wav = np.random.default_rng(1).normal(
        0, 0.3, (BATCH, SEGMENT)).astype(np.float32)
    wav[1, SEGMENT // 2:] = 0.0
    return mel, wav


def _trees():
    """JAX-layout trees of the port's native init: generator (seed 0),
    MPD (1), MSD (2)."""
    gen = init_params(HifiGanGenerator(HifiGanConfig(
        upsample_initial_channel=WIDTH)), 0)
    return (to_jax_params(gen),
            {name: to_jax_params(init_params(cls(), i + 1))
             for i, (name, (cls, _)) in enumerate(DISCS.items())})


def _recording_adamw(adamw):
    """optax's adamw whose state also keeps the last gradients."""
    def make(*args, **kwargs):
        inner = adamw(*args, **kwargs)

        def init(params):
            return inner.init(params), jax.tree.map(jnp.zeros_like, params)

        def update(grads, state, params=None):
            updates, inner_state = inner.update(grads, state[0], params)
            return updates, (inner_state, grads)

        return optax.GradientTransformation(init, update)

    return make


def _numpy_state(trees):
    """{part: {port parameter name: numpy array}} of JAX-layout trees."""
    return {k: {n: t.numpy() for n, t in from_jax_params(v).items()}
            for k, v in trees.items()}


@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX train steps from the trees, with mr_stft_weight 2.5:
    (inputs, trees, [metrics of each step], the first step's gradients,
    its stepped parameters)."""
    mel, wav = _inputs()
    gen_tree, disc_trees = _trees()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vocoder.optax, "adamw",
                   _recording_adamw(optax.adamw))
        _, init, step = jax_vocoder.create_vocoder_trainer(
            JaxHifiGanConfig(upsample_initial_channel=WIDTH),
            JaxAudioConfig(), lr=LR, mr_stft_weight=MR_STFT_WEIGHT)
        state = init(jax.random.PRNGKey(0), gen_tree, segment=SEGMENT)
    state = state.replace(mpd_params=disc_trees["mpd"],
                          msd_params=disc_trees["msd"])
    metrics = []
    for i in range(2):
        state, m = step(state, jnp.asarray(mel), jnp.asarray(wav))
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
        if i == 0:
            first = jax.device_get(state)
            grads = _numpy_state({"gen": first.gen_opt[1],
                                  **first.disc_opt[1]})
            params = _numpy_state({"gen": first.gen_params,
                                   "mpd": first.mpd_params,
                                   "msd": first.msd_params})
            del first
    return (mel, wav), (gen_tree, disc_trees), metrics, grads, params


@pytest.fixture(scope="module")
def port_steps(jax_steps):
    """The port's two steps from the same trees, on the CPU: ([metrics of
    each step], the first step's gradients, its stepped parameters)."""
    (mel, wav), (gen_tree, disc_trees) = jax_steps[:2]
    _, init, step = create_vocoder_trainer(
        HifiGanConfig(upsample_initial_channel=WIDTH), AudioConfig(),
        lr=LR, mr_stft_weight=MR_STFT_WEIGHT, device="cpu")
    state = init(gen_params=gen_tree, disc_params=disc_trees)
    metrics = []
    for i in range(2):
        state, m = step(state, torch.from_numpy(mel), torch.from_numpy(wav))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mods = {"gen": state.gen, "mpd": state.mpd, "msd": state.msd}
            grads = {k: {n: p.grad.numpy().copy()
                         for n, p in mod.named_parameters()}
                     for k, mod in mods.items()}
            params = {k: {n: p.detach().numpy().copy()
                          for n, p in mod.named_parameters()}
                      for k, mod in mods.items()}
    assert state.step == 2
    return metrics, grads, params


def _nhwc(t: torch.Tensor) -> np.ndarray:
    """A port feature map in the JAX package's channels-last layout."""
    a = t.numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else (
        a.transpose(0, 2, 1) if a.ndim == 3 else a)


@pytest.mark.parametrize("which", sorted(DISCS))
def test_discriminator_matches_jax(which):
    """Logits and feature maps of the multi-period / multi-scale
    discriminator on the same weights, at a length no period divides
    (the reflect pad), within 1e-5 of each tensor's largest entry; the
    real batch run on its own (``real_grad=False``) gives the same."""
    cls, jax_cls = DISCS[which]
    model = init_params(cls(), 3)
    rng = np.random.default_rng(4)
    y, y_hat = (rng.normal(0, 0.3, (2, 2001)).astype(np.float32)
                for _ in range(2))
    want = jax.jit(jax_cls().apply)({"params": to_jax_params(model)},
                                    jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = model(torch.from_numpy(y), torch.from_numpy(y_hat))
        alone = model(torch.from_numpy(y), torch.from_numpy(y_hat),
                      real_grad=False)
    flat = lambda outs: [t for part in outs for d in part  # noqa: E731
                         for t in (d if isinstance(d, list) else [d])]
    got, alone, want = flat(got), flat(alone), flat(want)
    assert len(got) == len(want) == len(alone)
    for i, (g, a, w) in enumerate(zip(got, alone, want)):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(_nhwc(g) / scale, w / scale, atol=1e-5,
                                   err_msg=str(i))
        np.testing.assert_allclose(a.numpy() / scale, g.numpy() / scale,
                                   atol=1e-6, err_msg=str(i))


def test_gan_losses_match_jax():
    rng = np.random.default_rng(5)
    outs = [[rng.normal(size=(2, n)).astype(np.float32) for n in (7, 13)]
            for _ in range(2)]
    fmaps = [[[rng.normal(size=(2, c, 9)).astype(np.float32)
               for c in (4, 8)] for _ in range(3)] for _ in range(2)]
    tt = lambda tree: jax.tree.map(torch.from_numpy, tree)  # noqa: E731
    jj = lambda tree: jax.tree.map(jnp.asarray, tree)       # noqa: E731
    got = [discriminator_loss(*tt(outs))[0], generator_loss(tt(outs[1]))[0],
           feature_loss(*tt(fmaps))]
    want = [jax_discriminator_loss(*jj(outs))[0],
            jax_generator_loss(jj(outs[1]))[0],
            jax_feature_loss(*jj(fmaps))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    parts = discriminator_loss(*tt(outs))
    want_parts = jax_discriminator_loss(*jj(outs))
    for g, w in zip(parts[1] + parts[2], want_parts[1] + want_parts[2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_mel_fn_and_mr_stft_loss_match_jax():
    """The training-scale log-mel and the multi-resolution STFT loss with
    its parts, within 1e-5 (a silent tail clamps to log 1e-5 in both);
    the gradient of the STFT magnitude at a silent frame is 0, not NaN."""
    _, wav = _inputs()
    y_hat = np.random.default_rng(6).normal(0, 0.3, wav.shape).astype(
        np.float32)
    want = jax_vocoder.make_mel_fn(JaxAudioConfig())(jnp.asarray(wav))
    got = make_mel_fn(AudioConfig(), "cpu")(torch.from_numpy(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    loss, parts = multi_resolution_stft_loss(torch.from_numpy(y_hat),
                                             torch.from_numpy(wav))
    w_loss, w_parts = jax_vocoder.multi_resolution_stft_loss(
        jnp.asarray(y_hat), jnp.asarray(wav))
    np.testing.assert_allclose(float(loss), float(w_loss), rtol=1e-5)
    for k in w_parts:
        np.testing.assert_allclose(float(parts[k]), float(w_parts[k]),
                                   rtol=1e-5, err_msg=k)
    x = torch.from_numpy(wav.copy()).requires_grad_(True)
    mel = make_mel_fn(AudioConfig(), "cpu")(x)
    mel.sum().backward()
    assert torch.isfinite(x.grad).all()
    assert not x.grad[1, SEGMENT // 2 + 1024:].any()


def test_gan_step_matches_jax(jax_steps, port_steps):
    """One GAN step: every metric within 1e-4 relative; the
    discriminators' gradient leaves within 1e-4 of each leaf's largest
    entry (and untouched by the generator's step, which would add to
    them); the stepped parameters within 1e-6 where the gradient is above
    1e-4 of its leaf's largest.

    The generator's gradients are float32 sums of cancelling terms (the
    45 · mel L1 through log(clamp(m, 1e-5)) on a random generator's quiet
    output).  Against a float64 evaluation of this step both frameworks
    are off by up to 1.7e-3 (JAX) and 3.2e-3 (the port) of a leaf's
    largest entry, 2.3e-4 and 1.8e-4 of the whole gradient's norm
    (measured), so their leaves are held at 1e-2 of the largest entry and
    the whole generator gradient at 5e-4 of its norm.

    Adam's first step is about lr · sign(g), so where g is rounding noise
    the two steps may differ by up to 2 · lr: those entries are held at
    2 · lr, and the number that moved apart is reported and bounded."""
    (want_m, _), want_g, want_p = jax_steps[2:]
    (got_m, _), got_g, got_p = port_steps
    assert set(got_m) == set(want_m) == {
        "disc_loss", "gen_loss", "mel_l1", "adv", "fm", "mr_stft"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4,
                                   err_msg=k)
    leaf_tol = {"gen": 1e-2, "mpd": 1e-4, "msd": 1e-4}
    moved = total = 0
    for part in ("gen", "mpd", "msd"):
        assert set(got_g[part]) == set(want_g[part])
        names = sorted(want_g[part])
        for name in names:
            wg, gg = want_g[part][name], got_g[part][name]
            scale = np.abs(wg).max() + 1e-30
            np.testing.assert_allclose(gg / scale, wg / scale,
                                       atol=leaf_tol[part],
                                       err_msg=f"{part}.{name}")
            noise = np.abs(wg) <= 1e-4 * scale
            gp, wp = got_p[part][name], want_p[part][name]
            np.testing.assert_allclose(gp[~noise], wp[~noise], atol=1e-6,
                                       rtol=0, err_msg=f"{part}.{name}")
            np.testing.assert_allclose(gp[noise], wp[noise],
                                       atol=2 * LR * (1 + 1e-3), rtol=0,
                                       err_msg=f"{part}.{name} (noise)")
            moved += int((np.abs(gp[noise] - wp[noise]) > 1e-6).sum())
            total += wg.size
        if part == "gen":
            flat_w = np.concatenate([want_g[part][n].ravel() for n in names])
            flat_g = np.concatenate([got_g[part][n].ravel() for n in names])
            assert np.linalg.norm(flat_g - flat_w) <= \
                5e-4 * np.linalg.norm(flat_w)
    print(f"stepped entries at rounding-noise gradients that moved apart: "
          f"{moved} of {total}")
    assert moved <= 1e-5 * total, (moved, total)


def test_second_gan_step_metrics_match_jax(jax_steps, port_steps):
    """The second step, from each framework's own first step, keeps every
    metric within 1e-4 relative."""
    want_m = jax_steps[2][1]
    got_m = port_steps[0][1]
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("which", sorted(DISCS))
def test_rank4_bridge_round_trips(which):
    """``to_jax_params(from_jax_params(t)) == t``, bit for bit, for a tree
    with the period discriminators' (kh, kw, in, out) kernels; a Conv2d
    weight is (out, in, kh, kw)."""
    cls, jax_cls = DISCS[which]
    tree = jax.tree.map(
        np.asarray, jax.jit(jax_cls().init)(
            jax.random.PRNGKey(7), jnp.zeros((1, 256)),
            jnp.zeros((1, 256)))["params"])
    model = cls()
    model.load_state_dict(from_jax_params(tree), strict=True)
    back = to_jax_params(model)
    flat = dict(jax.tree_util.tree_leaves_with_path(tree))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert flat.keys() == flat_back.keys()
    for path, leaf in flat.items():
        assert flat_back[path].shape == leaf.shape, path
        assert np.array_equal(flat_back[path], leaf), path
    assert _WEIGHT_LEAF[Conv2d] == "kernel"
    if which == "mpd":
        conv = model.disc0.conv1
        assert tuple(conv.weight.shape) == (128, 32, 5, 1)
        np.testing.assert_array_equal(
            conv.weight.detach().numpy(),
            tree["disc0"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
