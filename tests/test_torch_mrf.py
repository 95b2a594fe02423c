"""The port's mrf_fused (plain version, which CPU tensors take) against
the JAX package's Pallas MRF kernel in interpret mode, on each stage of
the default HiFi-GAN config."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu.models.hifigan_folded import fold_hifigan_device
from efficientspeech_tpu.ops.pallas.mrf_block import (
    build_mrf_spec as jax_build_mrf_spec, mrf_fused as jax_mrf_fused)
from efficientspeech_tpu_torch.ops.kernels import mrf_block

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def folded():
    cfg = JaxHifiGanConfig()
    params = JaxGen(cfg).init(jax.random.PRNGKey(3),
                              jnp.zeros((1, 4, 80)))["params"]
    # random biases too: host-style init leaves them zero, which would not
    # exercise the masking of bias-revived rows
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                      if p[-1].key == "bias" else np.asarray(v)), params)
    arrays, meta = fold_hifigan_device(params, cfg, dtype=jnp.float32)
    return cfg, arrays, meta


@pytest.mark.parametrize("stage,t,valid", [(0, 80, 61), (1, 72, 50),
                                           (2, 64, 41), (3, 64, 64)])
def test_mrf_plain_matches_pallas(folded, stage, t, valid):
    cfg, arrays, meta = folded
    chains, W_all, b_all, H = jax_build_mrf_spec(
        arrays, meta["widths"], stage, cfg.resblock_dilation_sizes)
    rng = np.random.default_rng(stage)
    x = rng.standard_normal((t, 128)).astype(np.float32)
    want = jax_mrf_fused(jnp.asarray(x), chains, W_all, b_all, H,
                         jnp.int32(valid), len(cfg.resblock_kernel_sizes),
                         tm=32, interpret=True)

    t_arrays = {k: (torch.from_numpy(np.array(W)),
                    torch.from_numpy(np.array(b)))
                for k, (W, b) in arrays.items()}
    p_chains, p_W, p_b, p_H = mrf_block.build_mrf_spec(
        t_arrays, meta["widths"], stage, cfg.resblock_dilation_sizes)
    assert p_chains == chains and p_H == H
    np.testing.assert_array_equal(p_W.numpy(), np.asarray(W_all))
    before = dict(mrf_block.launches)
    got = mrf_block.mrf_fused(torch.from_numpy(x), p_chains, p_W, p_b, p_H,
                              torch.tensor([valid], dtype=torch.int32),
                              len(cfg.resblock_kernel_sizes))
    assert mrf_block.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert not got[valid:].any()
