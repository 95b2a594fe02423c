"""Kernel K4's plain version (the function the CUDA kernel computes)
against the JAX package's Pallas ``decoder_block_fused`` in interpret
mode: the forward and all seven gradients, on the same numpy inputs and a
random keep mask."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.ops.pallas.decoder_block import (
    decoder_block_fused as jax_decoder_block_fused)
from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.mel_decoder import MelDecoder
from efficientspeech_tpu_torch.models.modules import compute_params
from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
from efficientspeech_tpu_torch.weights import init_params

# batch 3 is not a multiple of the JAX kernel's batch group tg = 2
B, M, C, K = 3, 40, 128, 5
# the mel decoder's widths: 128 (tiny), 256 (small, base)
WIDTHS = (128, 256)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GRAD_NAMES = ("dx", "dw_w", "dw_b", "pw_w", "pw_b", "ln_s", "ln_b")


def _inputs(seed, c=C):
    """JAX-layout weights: dw (K, 1, C), pw (1, C_in, C_out); the
    pointwise weight's scale falls as 1/sqrt(C), as its init's does."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        x=f(B, M, c), keep=(rng.random((B, M)) > 0.2).astype(np.float32),
        dw_w=f(K, 1, c) * 0.4, dw_b=f(c) * 0.1,
        pw_w=f(1, c, c) * np.float32(0.09 * np.sqrt(C / c)),
        pw_b=f(c) * 0.1, ln_s=1 + 0.2 * f(c), ln_b=0.1 * f(c),
        cot=f(B, M, c))


def _torch_weights(a):
    """The same weights in the port's layouts (the depthwise and
    pointwise Conv1d and the LayerNorm parameters)."""
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))
    return [t(a["dw_w"].transpose(2, 1, 0)), t(a["dw_b"]),
            t(a["pw_w"].transpose(2, 1, 0)), t(a["pw_b"]), t(a["ln_s"]),
            t(a["ln_b"])]


def _jax_grads(a, jdt):
    def loss(x, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b):
        y = jax_decoder_block_fused(x, jnp.asarray(a["keep"]), dw_w, dw_b,
                                    pw_w, pw_b, ln_s, ln_b, K, 1e-5, 2, 2,
                                    True)
        return jnp.sum(y.astype(jnp.float32) * a["cot"]), y

    args = [jnp.asarray(a["x"], jdt)] + [jnp.asarray(a[k]) for k in (
        "dw_w", "dw_b", "pw_w", "pw_b", "ln_s", "ln_b")]
    (_, y), grads = jax.value_and_grad(loss, argnums=tuple(range(7)),
                                       has_aux=True)(*args)
    dx, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b = [
        np.asarray(g, np.float32) for g in grads]
    # JAX layouts → the port's
    return np.asarray(y, np.float32), [
        dx, dw_w.transpose(2, 1, 0), dw_b, pw_w.transpose(2, 1, 0), pw_b,
        ln_s, ln_b]


def _torch_grads(a, tdt):
    x = torch.from_numpy(a["x"]).to(tdt).requires_grad_()
    weights = [w.requires_grad_() for w in _torch_weights(a)]
    y = k4.decoder_block_fused(x, torch.from_numpy(a["keep"]), *weights)
    (y.float() * torch.from_numpy(a["cot"])).sum().backward()
    assert x.grad.dtype == tdt
    assert all(w.grad.dtype == torch.float32 for w in weights)
    return y.detach().float().numpy(), [
        g.detach().float().numpy() for g in [x.grad] + [w.grad
                                                        for w in weights]]


@pytest.mark.parametrize("dtype,c", [
    pytest.param(dtype, c, id=dtype if c == C else f"{dtype}-C{c}")
    for c in WIDTHS for dtype in sorted(DTYPES)])
def test_matches_jax_kernel(dtype, c):
    jdt, tdt = DTYPES[dtype]
    a = _inputs(0, c)
    y_want, g_want = _jax_grads(a, jdt)
    y_got, g_got = _torch_grads(a, tdt)
    if dtype == "f32":
        # the same float32 arithmetic in another summation order: 1e-5 of
        # each leaf's largest magnitude, as the JAX package's own test
        np.testing.assert_allclose(y_got, y_want, rtol=1e-5, atol=1e-5)
        for name, got, want in zip(GRAD_NAMES, g_got, g_want):
            scale = np.abs(want).max() + 1e-12
            np.testing.assert_allclose(got / scale, want / scale, atol=1e-5,
                                       err_msg=name)
    else:
        # bf16: tanh and float32 sums round to other bf16 neighbours in the
        # two frameworks (one bf16 ulp is 2^-8 relative).  The JAX package
        # holds its own fused-vs-plain bf16 forward to atol 0.06; the
        # gradients are held to 2% of each leaf's largest magnitude
        np.testing.assert_allclose(y_got, y_want, atol=0.06)
        for name, got, want in zip(GRAD_NAMES, g_got, g_want):
            scale = np.abs(want).max() + 1e-12
            np.testing.assert_allclose(got / scale, want / scale, atol=2e-2,
                                       err_msg=name)


def test_fwd_writes_out_on_cpu():
    """``out`` receives y on the CPU too, and is what comes back."""
    a = _inputs(1)
    x, keep = torch.from_numpy(a["x"]), torch.from_numpy(a["keep"])
    w = _torch_weights(a)
    out = torch.full_like(x, float("nan"))
    assert k4.decoder_block_fwd(x, keep, *w, out=out) is out
    assert torch.equal(out, k4.decoder_block_fwd(x, keep, *w))


def test_padding_is_masked_and_keep_has_no_grad():
    a = _inputs(1)
    x = torch.from_numpy(a["x"]).requires_grad_()
    keep = torch.from_numpy(a["keep"])
    y = k4.decoder_block_fused(x, keep, *_torch_weights(a))
    (y * torch.from_numpy(a["cot"])).sum().backward()
    # the masked input ignores padded frames: dx is zero there
    assert not x.grad[keep == 0].any()
    assert x.grad[keep == 1].abs().sum() > 0
    # changing a padded frame's input does not change the output
    x2 = x.detach().clone()
    x2[keep == 0] += 3.0
    assert torch.equal(k4.decoder_block_fused(x2, keep, *_torch_weights(a)),
                       y.detach())


def test_mel_decoder_kernel_routes_match_plain_route():
    """The mel decoder through K3 and K4 (their plain versions here) and
    through its plain modules: the same parameter names, and in float32
    the same output and gradients; under compute_params the K4 route's
    convs stay float32."""
    cfg = ModelConfig.preset("tiny", max_phoneme_len=16, max_mel_len=40)
    plain = init_params(MelDecoder(cfg), 0)
    fused = MelDecoder(cfg, fused_norm=True, fused_block=True)
    fused.load_state_dict(plain.state_dict())
    assert list(plain.state_dict()) == list(fused.state_dict())
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(3, 40, 128)).astype(np.float32))
    mask = torch.from_numpy(rng.random((3, 40)) < 0.2)
    outs = []
    for model in (plain, fused):
        y = model(feats, mask)
        (y ** 2).sum().backward()
        outs.append((y.detach(), {n: p.grad for n, p in
                                  model.named_parameters()}))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    for name, g in outs[0][1].items():
        scale = float(g.abs().max()) + 1e-12
        torch.testing.assert_close(outs[1][1][name] / scale, g / scale,
                                   rtol=0, atol=1e-5, msg=name)
    bf16 = compute_params(fused, torch.bfloat16)
    assert bf16["block0_conv0_dw.weight"].dtype == torch.float32
    assert bf16["block0_norm0.weight"].dtype == torch.float32
    assert bf16["proj_linear.weight"].dtype == torch.bfloat16
    assert compute_params(plain, torch.bfloat16)[
        "block0_conv0_dw.weight"].dtype == torch.bfloat16


def test_check_supported_names_the_kernel_widths():
    """The kernel covers every preset's decoder (width 128 or 256) in bf16
    and in float32, and refuses float16 and other widths with a message
    that says so; the check needs no build."""
    for c in WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            k4.check_supported(c, dtype)
    for c, dtype in ((128, torch.float16), (256, torch.float16),
                     (384, torch.bfloat16), (64, torch.bfloat16),
                     (384, torch.float32), (64, torch.float32)):
        with pytest.raises(NotImplementedError,
                           match="cannot run on the card"):
            k4.check_supported(c, dtype)
    widths = {p: MelDecoder(ModelConfig.preset(p)).proj_norm.weight.shape[0]
              for p in ("tiny", "small", "base")}
    assert widths == {"tiny": 128, "small": 256, "base": 256}


@pytest.mark.parametrize("c", WIDTHS)
def test_bf16_fwd_plan_fits_and_buffers_do_not_overlap(c):
    """The bf16 forward's shared memory at each width: every buffer lies
    inside the plan's bytes, which with the 1,024 bytes that align the
    base fit a block's 227 KB, its blocks an SM (each with 1 KB more
    reserved) fit the SM's 228 KB, and no two buffers that are live in the
    same phase overlap.  A tile is one wgmma M (64 rows), a warpgroup per
    64 columns; W's and u's operand tiles sit on 8 KB boundaries, the x
    rows' TMA boxes (68 rows of 64 channels) on 128-byte ones."""
    pl = k4.bf16_fwd_plan(c)
    assert pl.smem + 1024 <= k4.SMEM_LIMIT
    assert pl.blocks_per_sm >= 1
    assert pl.blocks_per_sm * (pl.smem + 2048) <= k4.SM_SMEM
    assert (pl.blocks_per_sm + 1) * (pl.smem + 2048) > k4.SM_SMEM
    assert pl.tile_rows == 64 and pl.warpgroups == c // 64
    assert pl.u_off == (c // 64) ** 2 * k4.BF16_TILE
    assert pl.x_off == pl.u_off + c // 64 * k4.BF16_TILE
    assert pl.x_box == (pl.tile_rows + K - 1) * 128
    assert pl.x_off % 128 == 0 and pl.x_box % 128 == 0
    for off in (pl.st_off, pl.kp_off, pl.par_off):
        assert off % 16 == 0
    assert pl.bar_off % 8 == 0
    bufs = k4.bf16_fwd_buffers(c)
    for name, (off, size, phases) in bufs.items():
        assert 0 <= off and off + size <= pl.smem, name
        assert phases <= set(k4.BF16_FWD_PHASES), name
    assert {p for _, _, ph in bufs.values() for p in ph} == set(
        k4.BF16_FWD_PHASES)
    names = sorted(bufs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (oa, sa, pa), (ob, sb, pb) = bufs[a], bufs[b]
            if pa & pb:
                assert oa + sa <= ob or ob + sb <= oa, (a, b)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", [1, 5, 63, 64, 65, 127, 128, 129, 1000,
                               1024])
def test_bf16_fwd_tiles_cover_every_frame_once(c, m):
    """The bf16 forward's tiles, which own all their rows, cover a
    sequence of any length exactly once: below one tile, at a multiple of
    the tile and one row past it, and at the training length."""
    pl = k4.bf16_fwd_plan(c)
    tiles = k4.owned_tiles(m, pl.tile_rows)
    assert len(tiles) == -(-m // pl.tile_rows)
    covered = np.zeros(m, int)
    for m0, rows in tiles:
        assert 0 < rows <= pl.tile_rows
        covered[m0:m0 + rows] += 1
    assert (covered == 1).all()


def test_bf16_fwd_plan_refuses_other_widths():
    for c in (64, 192, 384):
        with pytest.raises(ValueError, match="no bf16 forward plan"):
            k4.bf16_fwd_plan(c)


@pytest.mark.parametrize("c", WIDTHS)
def test_f32_fwd_plan_fits_and_buffers_do_not_overlap(c):
    """The float32 forward's shared memory at each width: every buffer lies
    inside the plan's bytes, its blocks an SM (with the 1 KB each reserves)
    fit the SM's 228 KB, and no two buffers that are live in the same
    phase overlap.  The tile is one wgmma N, a chunk of the split buffer
    is 16 bytes past a multiple of 128 (the depthwise's stores, a lane a
    chunk, meet 32 banks), v's rows fit over the split buffer, and the x
    rows sit on 16-byte boundaries for cp.async."""
    pl = k4.f32_fwd_plan(c)
    assert pl.smem <= k4.SMEM_LIMIT
    assert pl.blocks_per_sm >= 1
    assert pl.blocks_per_sm * (pl.smem + 1024) <= k4.SM_SMEM
    assert (pl.blocks_per_sm + 1) * (pl.smem + 1024) > k4.SM_SMEM
    assert pl.tile_rows in (64, 128) and pl.warpgroups == 2
    assert pl.r_alloc >= pl.tile_rows and (pl.r_alloc * 16) % 128 == 16
    assert pl.lo_off == c // 4 * pl.r_alloc * 16 and pl.x_off == 2 * pl.lo_off
    assert pl.tile_rows * pl.ld_v * 4 <= pl.x_off
    assert pl.ld_x % 32 == 4 and pl.ld_v % 32 == 4
    for off in (pl.x_off, pl.kp_off, pl.par_off):
        assert off % 16 == 0
    bufs = k4.f32_fwd_buffers(c)
    for name, (off, size, phases) in bufs.items():
        assert 0 <= off and off + size <= pl.smem, name
        assert phases <= set(k4.F32_FWD_PHASES), name
    assert {p for _, _, ph in bufs.values() for p in ph} == set(
        k4.F32_FWD_PHASES)
    names = sorted(bufs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (oa, sa, pa), (ob, sb, pb) = bufs[a], bufs[b]
            if pa & pb:
                assert oa + sa <= ob or ob + sb <= oa, (a, b)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", [1, 5, 63, 64, 65, 127, 128, 129, 1000,
                               1024])
def test_f32_fwd_tiles_cover_every_frame_once(c, m):
    """The float32 forward's tiles, which own all their rows, cover a
    sequence of any length exactly once: below one tile, at a multiple of
    the tile and one row past it, and at the training length."""
    pl = k4.f32_fwd_plan(c)
    tiles = k4.owned_tiles(m, pl.tile_rows)
    assert len(tiles) == -(-m // pl.tile_rows)
    covered = np.zeros(m, int)
    for m0, rows in tiles:
        assert 0 < rows <= pl.tile_rows
        covered[m0:m0 + rows] += 1
    assert (covered == 1).all()


def test_f32_fwd_plan_refuses_other_widths():
    for c in (64, 192, 384):
        with pytest.raises(ValueError, match="no float32 forward plan"):
            k4.f32_fwd_plan(c)


@pytest.mark.parametrize("c", WIDTHS)
def test_f32_bwd_plan_fits_and_buffers_do_not_overlap(c):
    """The float32 backward's shared memory at each width: every buffer
    lies inside the plan's bytes, which fit a block's 227 KB, and no two
    buffers that are live in the same phase overlap.  The tile is one
    wgmma N (64 or 128 rows), and a chunk of the split buffer is 64 bytes
    past a multiple of 128, so the weight gradient's fragment loads meet
    32 banks."""
    pl = k4.f32_bwd_plan(c)
    assert pl.smem <= k4.SMEM_LIMIT
    assert pl.tile_rows in (64, 128) and pl.r_alloc >= pl.tile_rows
    assert pl.owned_rows == pl.tile_rows - (K - 1)
    assert (pl.r_alloc * 16) % 128 == 64 and pl.lo_off % 16 == 0
    assert pl.ld_v % 32 == 8 and pl.ld_x % 4 == 0
    bufs = k4.f32_bwd_buffers(c)
    for name, (off, size, phases) in bufs.items():
        assert 0 <= off and off + size <= pl.smem, name
        assert phases <= set(k4.F32_BWD_PHASES), name
    assert {p for _, _, ph in bufs.values() for p in ph} == set(
        k4.F32_BWD_PHASES)
    names = sorted(bufs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (oa, sa, pa), (ob, sb, pb) = bufs[a], bufs[b]
            if pa & pb:
                assert oa + sa <= ob or ob + sb <= oa, (a, b)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", [1, 5, 59, 60, 61, 123, 124, 125, 249, 1000,
                               1024])
def test_f32_bwd_tiles_cover_every_frame_once(c, m):
    """The owned rows of the float32 backward's tiles cover a sequence of
    any length exactly once: below one tile, at a multiple of the owned
    rows and one row past it."""
    pl = k4.f32_bwd_plan(c)
    tiles = k4.owned_tiles(m, pl.owned_rows)
    assert len(tiles) == -(-m // pl.owned_rows)
    covered = np.zeros(m, int)
    for m0, rows in tiles:
        assert 0 < rows <= pl.owned_rows
        covered[m0:m0 + rows] += 1
    assert (covered == 1).all()


def test_f32_bwd_plan_refuses_other_widths():
    for c in (64, 192, 384):
        with pytest.raises(ValueError, match="no float32 backward plan"):
            k4.f32_bwd_plan(c)


@pytest.mark.parametrize("c", WIDTHS)
def test_f32_bwd_layouts_map_every_element_once(c):
    """The float32 backward's two reordered operands, checked element by
    element: W in wgmma's A-fragment order (a lane's four values of a
    k-step side by side) and the weight-gradient partial in the mma
    accumulators' order, which the wrapper maps back to (C_in, C_out)."""
    w = torch.arange(c * c, dtype=torch.float32).view(c, c)
    frag = k4.a_fragments(w).reshape(c // 64, 4, c // 8, 8, 4, 4)
    rng = np.random.default_rng(c)
    for m, q, s, g, t in zip(*(rng.integers(0, n, 50) for n in
                               (c // 64, 4, c // 8, 8, 4))):
        col = 64 * m + 16 * q + 2 * g
        want = [w[8 * s + t, col], w[8 * s + t, col + 1],
                w[8 * s + t + 4, col], w[8 * s + t + 4, col + 1]]
        assert frag[m, q, s, g, t].tolist() == [float(v) for v in want]
    assert torch.equal(frag.reshape(-1).sort().values, w.reshape(-1))
    idx = k4.f32_bwd_partial_index(c)
    assert torch.equal(idx.sort().values, torch.arange(c * c))
    # block q, tile (mt, nt), lane (g, t), value e: row i, column o
    blocks = idx.view(-1, 4, 4, 32, 4)
    for q, mt, nt, lane, e in zip(*(rng.integers(0, n, 50) for n in
                                    (c * c // 2048, 4, 4, 32, 4))):
        i = 64 * (q // (c // 32)) + 16 * mt + lane // 4 + 8 * (e // 2)
        o = 32 * (q % (c // 32)) + 8 * nt + 2 * (lane % 4) + e % 2
        assert int(blocks[q, mt, nt, lane, e]) == i * c + o


@pytest.mark.parametrize("c", WIDTHS)
def test_bf16_bwd_plan_fits_and_buffers_do_not_overlap(c):
    """The bf16 backward's shared memory at each width: every buffer lies
    inside the plan's bytes, which with the 1,024 bytes that align the
    base fit a block's 227 KB, and no two buffers that are live in the
    same phase overlap.  A tile is one wgmma M (64 rows) over a cluster
    of one block per 128 columns; the operand tiles sit on 8 KB
    boundaries and the slots (and so dy's TMA boxes) on 1 KB ones (the
    128-byte swizzle needs 1 KB); a slot holds a tile's x rows (two
    boxes of 64 channels), its dy rows (two swizzled tiles) or t (rows
    4 banks apart); du fits over u and dv."""
    pl = k4.bf16_bwd_plan(c)
    assert pl.smem + 1024 <= k4.SMEM_LIMIT
    assert pl.tile_rows == 64 and pl.owned_rows == 64 - (K - 1)
    assert pl.cluster == c // 128 and pl.warpgroups == 2
    assert pl.w_tiles == 4 * (c // 64) - 4 <= (c // 64) ** 2
    for off in (pl.u_off, pl.dv_off):
        assert off % k4.BF16_TILE == 0
    assert pl.x_box == (pl.tile_rows + K - 1) * 128 and pl.ld_t // 2 % 32 == 4
    assert pl.slot >= max(2 * pl.x_box, 2 * k4.BF16_TILE,
                          pl.tile_rows * pl.ld_t * 2)
    assert pl.slot_off % 1024 == 0 and pl.slot % 1024 == 0
    assert pl.tile_rows * pl.ld_du * 4 <= pl.slot_off - pl.u_off
    for off in (pl.st_off, pl.cs_off, pl.kp_off, pl.par_off):
        assert off % 16 == 0
    assert pl.bar_off % 8 == 0
    bufs = k4.bf16_bwd_buffers(c)
    for name, (off, size, phases) in bufs.items():
        assert 0 <= off and off + size <= pl.smem, name
        assert phases <= set(k4.BF16_BWD_PHASES), name
    assert {p for _, _, ph in bufs.values() for p in ph} == set(
        k4.BF16_BWD_PHASES)
    names = sorted(bufs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (oa, sa, pa), (ob, sb, pb) = bufs[a], bufs[b]
            if pa & pb:
                assert oa + sa <= ob or ob + sb <= oa, (a, b)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("m", [1, 5, 59, 60, 61, 119, 120, 121, 1000,
                               1024])
def test_bf16_bwd_tiles_cover_every_frame_once(c, m):
    """The owned rows of the bf16 backward's tiles cover a sequence of any
    length exactly once: below one tile, at a multiple of the owned rows
    and one row past it, and at the training length."""
    pl = k4.bf16_bwd_plan(c)
    tiles = k4.owned_tiles(m, pl.owned_rows)
    assert len(tiles) == -(-m // pl.owned_rows)
    covered = np.zeros(m, int)
    for m0, rows in tiles:
        assert 0 < rows <= pl.owned_rows
        covered[m0:m0 + rows] += 1
    assert (covered == 1).all()


def test_bf16_bwd_plan_refuses_other_widths():
    for c in (64, 192, 384):
        with pytest.raises(ValueError, match="no bf16 backward plan"):
            k4.bf16_bwd_plan(c)
