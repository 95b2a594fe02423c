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


STAGE_WIDTHS = {  # the default config's chains, by stage
    0: ((1, 1, 2, 1, 3, 1), (2, 2, 5, 2, 8, 2), (3, 3, 8, 3, 13, 3)),
    1: ((1, 1, 1, 1, 2, 1), (1, 1, 3, 1, 4, 1), (2, 2, 4, 2, 7, 2)),
    2: ((1, 1, 1, 1, 1, 1), (1, 1, 2, 1, 2, 1), (1, 1, 2, 1, 4, 1)),
    3: ((1, 1, 1, 1, 1, 1), (1, 1, 1, 1, 1, 1), (1, 1, 1, 1, 2, 1))}


def test_stage_widths_are_the_default_configs(folded):
    cfg, arrays, meta = folded
    for stage, widths in STAGE_WIDTHS.items():
        chains, _, _, _ = jax_build_mrf_spec(
            arrays, meta["widths"], stage, cfg.resblock_dilation_sizes)
        assert mrf_block.chain_widths(chains) == widths


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("t,tm", [(8192, None), (32768, None),
                                  (1000, None), (1000, 16), (1000, 32)])
def test_f32_plan_fits_every_conv(stage, t, tm):
    """The float32 kernel's plan at every stage: shared memory (the split
    activation buffer and float32 v) inside a block's 227 KB, regions in
    order and 16-byte aligned; every conv's output, rounded up to the
    kernel's 16-row chunks, at most two 64-row and three 16-row chunks;
    every row any conv's taps read (past its extent by up to 15 rows)
    inside the buffer; rows of a chunk = 1 mod 8; and the tiles cover
    every row once."""
    widths = STAGE_WIDTHS[stage]
    H = max(sum(c) for c in widths)
    p = mrf_block.f32_plan(widths, t, tm)
    if tm is not None:
        assert p.tm == tm
    assert p.tm % 16 == 0 and p.tm > 0
    assert p.smem <= 227 * 1024
    assert p.lo_off == 32 * p.r_alloc * 16 and p.v_off == 2 * p.lo_off
    assert p.v_off % 16 == 0
    assert p.smem == p.v_off + (p.tm + 2 * H) * mrf_block.F32_LDV * 4
    assert p.r_alloc % 8 == 1
    for chain in widths:
        a, b = H - sum(chain), H + p.tm + sum(chain)
        assert a >= 0
        for w in chain:
            npad = -(-(b - a - 2 * w) // 16) * 16
            n64 = min(npad // 64, 2)
            assert (npad - 64 * n64) // 16 <= 3
            assert a + 2 * w + npad <= p.r_alloc   # the last tap's rows
            a, b = a + w, b - w
        assert (a, b) == (H, H + p.tm)
    tiles = -(-t // p.tm)
    assert sorted(r for i in range(tiles) for r in range(
        i * p.tm, min(i * p.tm + p.tm, t))) == list(range(t))


def test_f32_plan_refuses_a_tile_that_does_not_fit():
    with pytest.raises(ValueError, match="no float32 tile"):
        mrf_block.f32_plan(STAGE_WIDTHS[0], 8192, tm=128)
    with pytest.raises(ValueError, match="no float32 tile"):
        mrf_block.f32_plan(((60, 60),), 8192)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("t,tm", [(8192, None), (32768, None),
                                  (1000, None), (1000, 16), (1000, 64)])
def test_bf16_plan_fits_every_conv(stage, t, tm):
    """The bf16 kernel's plan at every stage: shared memory (the weight
    ring, the bf16 activation buffer, float32 v and the slots' two barriers)
    inside a block's 227 KB, regions in order, the ring's slots 1,024
    bytes apart from the aligned base and the rest 16-byte aligned; at
    least two slots; every conv's N a multiple of 8 (of 16 here), at most
    the kernel's largest, covering its output rows; every row any tap
    reads (past the conv's extent by up to 15 rows) inside the buffer;
    rows of a chunk = 1 mod 8; and the tiles cover every row once."""
    widths = STAGE_WIDTHS[stage]
    H = max(sum(c) for c in widths)
    p = mrf_block.bf16_plan(widths, t, tm)
    if tm is not None:
        assert p.tm == tm
    assert p.tm % 16 == 0 and 0 < p.tm <= mrf_block.BF16_MAX_TM
    assert 2 <= p.slots <= mrf_block.MAX_SLOTS
    assert p.smem <= 227 * 1024
    assert mrf_block.SLICE_BYTES % 1024 == 0
    assert p.buf_off == p.slots * mrf_block.SLICE_BYTES
    assert p.v_off == p.buf_off + 16 * p.r_alloc * 16
    assert p.bar_off == p.v_off + (p.tm + 2 * H) * 128 * 4
    assert p.buf_off % 16 == p.v_off % 16 == p.bar_off % 16 == 0
    assert p.smem == p.bar_off + 16 * p.slots + mrf_block.ALIGN_SLACK
    assert p.r_alloc % 8 == 1
    assert len(p.chunks) == len(widths)
    for chain, ns in zip(widths, p.chunks):
        a, b = H - sum(chain), H + p.tm + sum(chain)
        assert a >= 0 and len(ns) == len(chain)
        for w, n in zip(chain, ns):
            assert n % 8 == 0 and 0 < n <= mrf_block.BF16_MAX_N <= 256
            assert b - a - 2 * w <= n < b - a - 2 * w + 16
            assert a + 2 * w + n <= p.r_alloc   # the last tap's rows
            a, b = a + w, b - w
        assert (a, b) == (H, H + p.tm)
    tiles = -(-t // p.tm)
    assert sorted(r for i in range(tiles) for r in range(
        i * p.tm, min(i * p.tm + p.tm, t))) == list(range(t))


@pytest.mark.parametrize("stage,t,want", [(0, 8192, 64), (1, 32768, 128),
                                          (2, 32768, 128), (3, 32768, 128)])
def test_bf16_plan_takes_the_shortest_tile_of_the_fewest_waves(stage, t,
                                                               want):
    """One block a SM: a wave of tiles that is partly filled costs a whole
    one, and within as many waves a shorter tile does less work (less
    halo and padding).  At the main path's stage lengths for 2,048
    frames that is 64 rows at stage 0 and 128 at stages 1-3."""
    widths = STAGE_WIDTHS[stage]
    fits = []
    for tm in range(16, 257, 16):
        try:
            mrf_block.bf16_plan(widths, t, tm)
        except ValueError:
            continue
        fits.append((-(-(-(-t // tm)) // 132), tm))
    assert mrf_block.bf16_plan(widths, t).tm == min(fits)[1] == want


def test_bf16_plan_refuses_a_tile_that_does_not_fit():
    with pytest.raises(ValueError, match="no bf16 tile"):
        mrf_block.bf16_plan(STAGE_WIDTHS[0], 8192, tm=160)
    with pytest.raises(ValueError, match="no bf16 tile"):
        mrf_block.bf16_plan(STAGE_WIDTHS[1], 8192, tm=24)
    with pytest.raises(ValueError, match="no bf16 tile"):
        mrf_block.bf16_plan(((60, 60),), 8192)
