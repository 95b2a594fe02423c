"""The port's folded vocoder on its kernel path (plain versions on the
CPU) against the JAX package's folded vocoder with its Pallas kernels in
interpret mode, and against the JAX conv generator: LJ_V2's layout, V1's
at every published width, and LJ_V3's."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu.models.hifigan_folded import (
    fold_hifigan_device, folded_plan_apply as jax_folded_plan_apply)
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, folded_plan_apply, kernel_op_shapes, make_grid_plan,
    prepare_for_kernels)
from efficientspeech_tpu_torch.ops.kernels import folded_matmul, mrf_block
from efficientspeech_tpu_torch.utils import spans
from efficientspeech_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vocoder():
    cfg = JaxHifiGanConfig()
    shapes = jax.eval_shape(lambda: JaxGen(cfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 80)))["params"])
    rng = np.random.default_rng(21)

    def leaf(path, s):
        if path[-1].key == "bias":
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    gen = HifiGanGenerator(HifiGanConfig())
    load_jax_params(gen, params)
    mel = rng.normal(-3, 2, size=(1, 16, 80)).astype(np.float32)
    return cfg, params, gen, mel


@pytest.fixture(scope="module")
def jax_kernel_path(vocoder):
    """The JAX folded vocoder with its Pallas kernels (interpret mode) and
    the JAX conv generator, at valid = 13 of 16 frames."""
    cfg, params, _, mel = vocoder
    valid = jnp.asarray([13])
    j_arrays, j_meta = fold_hifigan_device(params, cfg, dtype=jnp.float32)
    want = jax_folded_plan_apply(j_arrays, j_meta, cfg, jnp.asarray(mel),
                                 valid, dtype=jnp.float32, use_pallas=True,
                                 interpret=True, fuse_mrf=True)
    ref = JaxGen(cfg).apply({"params": params}, jnp.asarray(mel),
                            valid_len=valid)
    return np.asarray(want), np.asarray(ref)


def test_grid_plan():
    _, _, g, rpf = make_grid_plan(HifiGanConfig())
    assert g == [2, 4, 8, 16] and rpf == [4, 16, 16, 16]
    ops, mrf = kernel_op_shapes(HifiGanConfig(), 2048)
    assert [op[:4] for op in ops] == [
        ("up0", 2048, 128, 512), ("up1", 8192, 128, 512),
        ("up2", 32768, 128, 128), ("up3", 32768, 128, 128),
        ("post", 32768, 128, 16)]
    assert mrf == [(0, 8192), (1, 32768), (2, 32768), (3, 32768)]


@pytest.mark.parametrize("prepared", [False, True])
def test_kernel_path_matches_jax(vocoder, jax_kernel_path, prepared):
    _, _, gen, mel = vocoder
    want, ref = jax_kernel_path
    valid = 13
    arrays, meta = fold_hifigan(gen, torch.float32)
    mrf = None
    if prepared:
        arrays, mrf = prepare_for_kernels(arrays, meta, gen.cfg)
    before = (dict(folded_matmul.launches), dict(mrf_block.launches))
    with torch.no_grad():
        got = folded_plan_apply(arrays, meta, gen.cfg, torch.from_numpy(mel),
                                torch.tensor([valid]), dtype=torch.float32,
                                use_kernel=True, fuse_mrf=True, mrf=mrf)
    assert (folded_matmul.launches, mrf_block.launches) == before
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_plain_path_matches_conv_generator(vocoder):
    cfg, params, gen, mel = vocoder
    valid = 11
    ref = JaxGen(cfg).apply({"params": params}, jnp.asarray(mel),
                            valid_len=jnp.asarray([valid]))
    arrays, meta = fold_hifigan(gen, torch.float32)
    with torch.no_grad():
        got = folded_plan_apply(arrays, meta, gen.cfg, torch.from_numpy(mel),
                                torch.tensor([valid]), dtype=torch.float32)
        conv = gen(torch.from_numpy(mel), torch.tensor([valid]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(conv.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


# the LJ_V3 layout (resblock "2": one residual conv per dilation, three
# upsample stages x8 x8 x4) at a quarter of its 256 initial channels
V3_SMALL = dict(resblock="2", upsample_rates=(8, 8, 4),
                upsample_kernel_sizes=(16, 16, 8),
                upsample_initial_channel=64, resblock_kernel_sizes=(3, 5, 7),
                resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


@pytest.fixture(scope="module")
def vocoder_v3():
    """A ResBlock "2" generator from seeded parameters, the JAX conv
    generator's and folded (XLA) path's waveforms at valid = 9 of 12
    frames."""
    cfg = JaxHifiGanConfig(**V3_SMALL)
    shapes = jax.eval_shape(lambda: JaxGen(cfg).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 4, 80)))["params"])
    rng = np.random.default_rng(23)

    def leaf(path, s):
        if path[-1].key == "bias":
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    gen = HifiGanGenerator(HifiGanConfig(**V3_SMALL))
    load_jax_params(gen, params)
    t, valid = 12, 9
    mel = rng.normal(-3, 2, size=(1, t, 80)).astype(np.float32)
    mel[0, valid:] = 0
    vl = jnp.asarray([valid])
    ref = JaxGen(cfg).apply({"params": params}, jnp.asarray(mel),
                            valid_len=vl)
    j_arrays, j_meta = fold_hifigan_device(params, cfg, dtype=jnp.float32)
    folded = jax_folded_plan_apply(j_arrays, j_meta, cfg, jnp.asarray(mel),
                                   vl, dtype=jnp.float32)
    return gen, mel, valid, np.asarray(ref), np.asarray(folded)


@pytest.mark.parametrize("path", ["conv", "folded", "folded_kernel"])
def test_resblock2_matches_jax(vocoder_v3, path):
    """The LJ_V3-layout vocoder against JAX's on the same parameters: the
    port's conv generator against the JAX conv generator, its folded plain
    path and its kernel path (plain versions on the CPU; fuse_mrf inert
    for resblock "2", so K1 runs every conv) against the JAX folded path
    and the JAX conv generator, at the folded tests' tolerance (rtol and
    atol 2e-4: float32 sums in another order and over folded weights)."""
    gen, mel, valid, ref, folded = vocoder_v3
    before = (dict(folded_matmul.launches), dict(mrf_block.launches))
    with torch.no_grad():
        if path == "conv":
            got = gen(torch.from_numpy(mel), torch.tensor([valid]))
        else:
            arrays, meta = fold_hifigan(gen, torch.float32)
            got = folded_plan_apply(
                arrays, meta, gen.cfg, torch.from_numpy(mel),
                torch.tensor([valid]), dtype=torch.float32,
                use_kernel=path == "folded_kernel", fuse_mrf=True)
    assert (folded_matmul.launches, mrf_block.launches) == before
    assert got.shape == ref.shape
    want = ref if path == "conv" else folded
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


V1_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "hifigan_v1.json")


@pytest.fixture(scope="module")
def vocoder_v1():
    """HiFi-GAN V1 (config_v1.json: 512 initial channels, stage 0 folded
    256 wide) from seeded parameters, and the JAX folded path's waveform
    (its Pallas kernels in interpret mode, fuse_mrf: K2 at width 256) and
    the JAX conv generator's, at valid = 5 of 8 frames."""
    cfg = JaxHifiGanConfig.from_json(V1_CONFIG)
    shapes = jax.eval_shape(lambda: JaxGen(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4, 80)))["params"])
    rng = np.random.default_rng(25)

    def leaf(path, s):
        if path[-1].key == "bias":
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    gen = HifiGanGenerator(HifiGanConfig.from_json(V1_CONFIG))
    load_jax_params(gen, params)
    t, valid = 8, 5
    mel = rng.normal(-3, 2, size=(1, t, 80)).astype(np.float32)
    vl = jnp.asarray([valid])
    j_arrays, j_meta = fold_hifigan_device(params, cfg, dtype=jnp.float32)
    want = jax_folded_plan_apply(j_arrays, j_meta, cfg, jnp.asarray(mel), vl,
                                 dtype=jnp.float32, use_pallas=True,
                                 interpret=True, fuse_mrf=True)
    ref = JaxGen(cfg).apply({"params": params}, jnp.asarray(mel),
                            valid_len=vl)
    return gen, mel, valid, np.asarray(want), np.asarray(ref)


@pytest.mark.parametrize("prepared", [False, True])
def test_v1_kernel_path_matches_jax(vocoder_v1, prepared):
    """V1 on the port's kernel path (plain versions on the CPU: stage 0
    through mrf_fused at width 256, counted under
    ``synth.vocoder.wide_rows``; from prepare_for_kernels, the post conv
    from its arrays padded to 16 columns) against JAX's folded path and
    conv generator.  Tolerance: rtol and atol 2e-5 (float32 sums in
    another order and over folded weights lie ~5e-8 apart); a tenth of
    the other folded tests' 2e-4, since V1's waveform from these weights
    peaks at ~0.09, and a stage 0 with a leaky slope of 0.2 in place of
    0.1 moves it by less than 2e-4 but fails this bar."""
    gen, mel, valid, want, ref = vocoder_v1
    arrays, meta = fold_hifigan(gen, torch.float32)
    mrf = None
    if prepared:
        arrays, mrf = prepare_for_kernels(arrays, meta, gen.cfg)
        assert arrays["post"][0].shape[1] == 16
    before = (dict(folded_matmul.launches), dict(mrf_block.launches))
    wide = spans.counters().get("synth.vocoder.wide_rows", 0)
    with torch.no_grad():
        got = folded_plan_apply(arrays, meta, gen.cfg, torch.from_numpy(mel),
                                torch.tensor([valid]), dtype=torch.float32,
                                use_kernel=True, fuse_mrf=True, mrf=mrf)
    assert (folded_matmul.launches, mrf_block.launches) == before
    assert spans.counters()["synth.vocoder.wide_rows"] == wide + 1
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
