"""The port's folded_matmul (plain version, which CPU tensors take)
against the JAX package's Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficientspeech_tpu.ops.pallas.folded_matmul import (
    folded_matmul as jax_folded_matmul)
from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm

torch.set_num_threads(2)


@pytest.mark.parametrize("t,d_in,d_out,w,valid,res,acc,scale,slope", [
    (64, 128, 256, 1, 50, False, False, None, None),
    (64, 128, 128, 1, 64, True, False, None, 0.1),
    (100, 128, 128, 3, 77, True, True, 1.0 / 3, 0.1),
    (70, 128, 16, 1, 61, False, False, None, 0.01),
    (48, 128, 128, 0, 40, False, True, 0.5, 0.1),
])
def test_folded_matmul_plain_matches_pallas(t, d_in, d_out, w, valid, res,
                                            acc, scale, slope):
    rng = np.random.default_rng(t + w)
    x = rng.standard_normal((t, d_in)).astype(np.float32)
    W = (rng.standard_normal(((2 * w + 1) * d_in, d_out)) * 0.05
         ).astype(np.float32)
    b = rng.standard_normal((d_out,)).astype(np.float32)
    residual = rng.standard_normal((t, d_out)).astype(np.float32)
    accum = rng.standard_normal((t, d_out)).astype(np.float32)
    kw = dict(out_scale=scale, pre_lrelu=slope is not None,
              lrelu_slope=slope if slope is not None else 0.1)

    want = jax_folded_matmul(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), w, jnp.int32(valid),
        residual=jnp.asarray(residual) if res else None,
        accum=jnp.asarray(accum) if acc else None,
        tm=32, tn=128, interpret=True, **kw)
    before = dict(fm.launches)
    got = fm.folded_matmul(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b), w,
        torch.tensor([valid], dtype=torch.int32),
        residual=torch.from_numpy(residual) if res else None,
        accum=torch.from_numpy(accum) if acc else None, **kw)
    assert fm.launches == before  # the CPU tensor took the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert not got[valid:].any()


def _plan_cases():
    """(id, t, d_in, d_out, w, resident, warpgroups): every op of the
    serving path at 2,048 and 4,096 frames, the int8 probe's w = 2 route
    and the w = 13 resblock op."""
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        kernel_op_shapes)
    cases = []
    for frames in (2048, 4096):
        ops, _ = kernel_op_shapes(HifiGanConfig(), frames)
        cases += [pytest.param(t, d_in, d_out, w, True, 2,
                               id=f"{key}-{frames}")
                  for key, t, d_in, d_out, w in ops]
    return cases + [
        pytest.param(49152, 128, 128, 2, True, 1, id="probe-w2"),
        pytest.param(8192, 128, 128, 13, False, 2, id="w13")]


@pytest.mark.parametrize("t,d_in,d_out,w,resident,n_wg", _plan_cases())
def test_bf16_plan_fits_and_covers_every_tile(t, d_in, d_out, w, resident,
                                              n_wg):
    """The bf16 kernel's tile plan: W resident (loaded once per block) or
    streamed, and one or two warpgroups, as intended; every shared-memory
    region inside a block's 227 KB without overlap; every (row tile,
    column panel) owned by exactly one block of a grid of at most one
    block an SM."""
    p = fm.plan(t, d_in, d_out, w)
    assert (p.resident, p.n_wg) == (resident, n_wg)
    assert p.smem <= 227 * 1024
    w_bytes = ((2 * w + 1) * d_in * p.tn * 2 if resident
               else p.n_wg * p.w_slot)
    assert p.w_slot >= d_in * p.tn * 2 and p.w_slot % 1024 == 0
    assert p.x_off >= w_bytes and p.x_off % 1024 == 0
    assert p.x_bytes >= (p.tm + 2 * w) * d_in * 4
    assert p.a_off == p.x_off + p.n_wg * p.x_bytes
    assert p.a_bytes >= (p.tm + 2 * w) * (d_in + fm.APAD) * 2
    assert p.bar_off == p.a_off + p.n_wg * p.a_bytes
    assert p.x_bytes % 128 == p.a_off % 128 == p.a_bytes % 128 == 0
    assert p.smem >= p.bar_off + 8 * (p.n_wg + 1) + fm.ALIGN_SLACK
    assert p.tn * p.n_panels == d_out and p.tm in (64, 128)
    assert p.grid == p.bpp * p.n_panels <= fm.SMS_H100
    n_tiles = -(-t // p.tm)
    owned = sorted((b % p.n_panels, tile) for b in range(p.grid)
                   for tile in range(b // p.n_panels, n_tiles, p.bpp))
    assert owned == [(c, r) for c in range(p.n_panels)
                     for r in range(n_tiles)]


@pytest.mark.parametrize("d_in,d_out,w,match", [
    (96, 128, 1, "multiple of 64"), (128, 24, 1, "multiple of 16"),
    (128, 128, 400, "shared memory"), (1024, 128, 1, "shared memory")])
def test_bf16_plan_refuses(d_in, d_out, w, match):
    """A shape the bf16 kernel does not take raises in the plan, which the
    wrapper makes before it launches anything: even with x read from
    device memory, the A tile of a 801-tap window, or W's slot and the A
    tile at D_in 1024, exceed a block's shared memory."""
    with pytest.raises(ValueError, match=match):
        fm.plan(4096, d_in, d_out, w)


@pytest.mark.parametrize("t,d_in,d_out,w", [
    (4096, 128, 128, 120), (4096, 512, 2048, 1), (16, 512, 2048, 1)])
def test_bf16_plan_without_an_x_stage(t, d_in, d_out, w):
    """Where no x stage fits beside W's slot and the A tile (a 241-tap
    window; HiFi-GAN V1's first upsampler, D_in 512), the plan takes one
    warpgroup streaming W with no stage, the converter reading x from
    device memory."""
    p = fm.plan(t, d_in, d_out, w)
    assert (p.x_bytes, p.resident, p.n_wg) == (0, False, 1)
    assert p.a_off == p.x_off == p.w_slot and p.smem <= fm.SMEM_LIMIT


@pytest.mark.parametrize("t,d_in,d_out,w,tn,nc", [
    pytest.param(2048, 128, 512, 1, 128, 1, id="up0-2048"),
    pytest.param(8192, 128, 512, 1, 128, 2, id="up1-2048"),
    pytest.param(32768, 128, 128, 1, 128, 2, id="up2-2048"),
    pytest.param(32768, 128, 16, 1, 16, 1, id="post-2048"),
    # two chunks of both warpgroups' rows would need 263 KB
    pytest.param(65536, 128, 16, 1, 16, 1, id="post-4096"),
    pytest.param(8192, 128, 128, 13, 128, 1, id="w13"),
    pytest.param(500, 128, 64, 1, 64, 1, id="d_out-64"),
    pytest.param(500, 128, 32, 3, 32, 1, id="d_out-32"),
    pytest.param(777, 128, 16, 1, 16, 1, id="post-ragged")])
def test_f32_plan_fits_and_covers_every_row(t, d_in, d_out, w, tn, nc):
    """The float32 kernel's tile plan: the panel width and 64-row chunks
    a warpgroup as intended (two only where they fit and the grid still
    gives every SM a block); the split x tile, hi and
    lo, and then the output tile inside a block's 227 KB, with every row a
    warpgroup's taps read;
    chunks of an odd row count; every (row, column) owned by exactly one
    (block, warpgroup)."""
    p = fm.f32_plan(t, d_in, d_out, w)
    assert (p.tn, p.nc) == (tn, nc)
    assert p.smem <= 227 * 1024
    assert p.smem == max(2 * p.lo_off, p.tile_rows * (p.tn + 4) * 4)
    assert p.lo_off % 128 == 0 and p.lo_off >= d_in // 4 * p.r_alloc * 16
    assert p.r_alloc % 2 == 1 and p.r_alloc >= p.tile_rows + 2 * w
    split = p.tn < 128
    assert p.tile_rows == 64 * p.nc * (2 if split else 1)
    assert p.n_panels * p.tn == d_out
    assert p.grid == -(-t // p.tile_rows) * p.n_panels
    if p.nc == 2:
        assert p.grid >= fm.SMS_H100
    owned = []
    for blk in range(p.grid):
        col0 = blk % p.n_panels * p.tn
        row0 = blk // p.n_panels * p.tile_rows
        for wg in range(2):
            rg = 64 * p.nc * wg if split else 0
            cols = range(p.tn) if split else range(64 * wg, 64 * wg + 64)
            # the taps of this warpgroup read tile rows rg .. rg + N - 1
            # + 2w, all inside the staged tile
            assert rg + 64 * p.nc - 1 + 2 * w < p.tile_rows + 2 * w
            owned += [(row0 + rg + r, col0 + c) for r in range(64 * p.nc)
                      if row0 + rg + r < t for c in cols if c < p.tn]
    assert len(owned) == len(set(owned)) == t * d_out


@pytest.mark.parametrize("d_in,d_out,w,match", [
    (80, 128, 1, "multiple of 32"), (128, 24, 1, "multiple of 16"),
    (128, 128, -1, "w -1"), (128, 128, 120, "shared memory")])
def test_f32_plan_refuses(d_in, d_out, w, match):
    """A shape the float32 kernel does not take raises in the plan, which
    the wrapper makes before it launches anything."""
    with pytest.raises(ValueError, match=match):
        fm.f32_plan(4096, d_in, d_out, w)
