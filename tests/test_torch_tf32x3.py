"""The numerics of the float32 kernels' 3xTF32 split products, shown on
the CPU before the card runs them.

The float32 variants of folded_matmul (K1) and mrf_fused (K2), and the
float32 forward and backward of decoder_block_fused (K4), multiply on the
tensor cores by splitting each operand into TF32 hi and lo parts
(csrc/tf32x3.cuh) and summing lo·hi′ + hi·lo′ + hi·hi′ in float32.  This
file emulates that arithmetic in numpy (float32 bit masking, hi rounded
to nearest with ties away from zero, as cvt.rna.tf32.f32 does, then lo
= x − hi rounded the same way) and holds the emulated K1, K2 and K4
forward and backward against the JAX package's Pallas kernels in
interpret mode, as the existing
parity tests run them: at ≥ 90 dB, the bar the card tests hold the
kernels to.  TF32 products alone (hi·hi′) land below that bar, so it
does tell the two apart.  The emulation is test-only: nothing on the
port's path uses it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.models.hifigan import HifiGanGenerator as JaxGen
from efficientspeech_tpu.models.hifigan_folded import fold_hifigan_device
from efficientspeech_tpu.ops.pallas.decoder_block import (
    decoder_block_fused as jax_decoder_block_fused)
from efficientspeech_tpu.ops.pallas.folded_matmul import (
    folded_matmul as jax_folded_matmul)
from efficientspeech_tpu.ops.pallas.mrf_block import (
    build_mrf_spec as jax_build_mrf_spec, mrf_fused as jax_mrf_fused)

BAR_DB = 90.0


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero), low 13 bits zero."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(a: np.ndarray):
    hi = tf32(a)
    return hi, tf32(a - hi)


def matmul3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b by 3xTF32: each product of two TF32 values is exact in
    float32; the three partial products summed in float32, small first."""
    ahi, alo = split(a)
    bhi, blo = split(b)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def matmul1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b with TF32 operands (one product)."""
    return tf32(a) @ tf32(b)


def leaky(x, slope):
    return np.where(x >= 0, x, x * slope).astype(np.float32)


def window(x: np.ndarray, w: int) -> np.ndarray:
    t = x.shape[0]
    xp = np.pad(x, ((w, w), (0, 0)))
    return np.concatenate([xp[j: j + t] for j in range(2 * w + 1)], axis=1)


def mask(y: np.ndarray, valid: int) -> np.ndarray:
    y = y.copy()
    y[valid:] = 0
    return y


def snr_db(ref, got) -> float:
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(10 * np.log10((ref ** 2).mean()
                               / max(((got - ref) ** 2).mean(), 1e-30)))


def emulated_folded_matmul(x, W, b, w, valid, residual=None, accum=None,
                           out_scale=None, slope=None, mm=matmul3):
    """K1's function with its products made as the float32 kernel makes
    them (x activated before the split)."""
    src = leaky(x, slope) if slope is not None else x
    y = mm(window(src, w), W) + b
    if residual is not None:
        y = y + residual
    if accum is not None:
        y = y + accum
    if out_scale is not None:
        y = y * np.float32(out_scale)
    return mask(y.astype(np.float32), valid)


def emulated_mrf(x, chains, W_all, b_all, valid, num_kernels, slope=0.1,
                 mm=matmul3):
    """K2's function with its products made as the float32 kernel makes
    them; v and the resblock sum stay float32."""
    def conv(src, op):
        w, n_win, off, bi = op
        return mm(window(leaky(src, slope), w),
                  W_all[off: off + n_win * src.shape[1]]) + b_all[bi]

    x = mask(x, valid)
    xs = None
    for chain in chains:
        v = x
        for m in range(0, len(chain), 2):
            t = mask(conv(v, chain[m]), valid)
            v = mask(conv(t, chain[m + 1]) + v, valid)
        xs = v if xs is None else xs + v
    return mask((xs * np.float32(1.0 / num_kernels)).astype(np.float32),
                valid)


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """hi has its low 13 bits zero, hi + lo recovers x to 2^-22 of it,
    and the rounding is to nearest with ties away from zero."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(10000) * 10.0 ** rng.uniform(-6, 6, 10000)
         ).astype(np.float32)
    hi, lo = split(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(x - (hi + lo)) <= np.abs(x) * 2.0 ** -21)
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)   # half of TF32's ulp at 1
    assert tf32(np.array([one + half_ulp]))[0] == one + 2 * half_ulp
    assert tf32(np.array([-(one + half_ulp)]))[0] == -(one + 2 * half_ulp)
    assert tf32(np.array([one + half_ulp * 0.99]))[0] == one


@pytest.mark.parametrize("t,d_out,w,valid,res,acc,scale,slope", [
    (64, 128, 1, 50, False, False, None, 0.1),
    (100, 128, 3, 77, True, True, 1.0 / 3, 0.1),
    (70, 16, 1, 61, False, False, None, 0.01),
    (96, 64, 1, 96, True, False, None, 0.1),
])
def test_folded_matmul_3xtf32_matches_pallas(t, d_out, w, valid, res, acc,
                                             scale, slope):
    """K1's 3xTF32 arithmetic against the JAX kernel (float32 products,
    interpret mode) at ≥ 90 dB over the valid rows; one TF32 product
    falls below the bar."""
    rng = np.random.default_rng(t + w)
    d_in = 128
    x = rng.standard_normal((t, d_in)).astype(np.float32)
    W = (rng.standard_normal(((2 * w + 1) * d_in, d_out)) * 0.05
         ).astype(np.float32)
    b = rng.standard_normal((d_out,)).astype(np.float32)
    residual = rng.standard_normal((t, d_out)).astype(np.float32)
    accum = rng.standard_normal((t, d_out)).astype(np.float32)
    kw = dict(residual=residual if res else None,
              accum=accum if acc else None, out_scale=scale, slope=slope)
    want = np.asarray(jax_folded_matmul(
        jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), w, jnp.int32(valid),
        residual=jnp.asarray(residual) if res else None,
        accum=jnp.asarray(accum) if acc else None, out_scale=scale,
        pre_lrelu=True, lrelu_slope=slope, tm=32, tn=128, interpret=True))
    got = emulated_folded_matmul(x, W, b, w, valid, **kw)
    one = emulated_folded_matmul(x, W, b, w, valid, mm=matmul1, **kw)
    assert not got[valid:].any()
    assert snr_db(want[:valid], got[:valid]) >= BAR_DB
    assert snr_db(want[:valid], one[:valid]) < BAR_DB


@pytest.fixture(scope="module")
def folded():
    cfg = JaxHifiGanConfig()
    params = JaxGen(cfg).init(jax.random.PRNGKey(5),
                              jnp.zeros((1, 4, 80)))["params"]
    rng = np.random.default_rng(17)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                      if p[-1].key == "bias" else np.asarray(v)), params)
    arrays, meta = fold_hifigan_device(params, cfg, dtype=jnp.float32)
    return cfg, arrays, meta


@pytest.mark.parametrize("stage,t,valid", [(0, 80, 61), (1, 72, 50),
                                           (2, 64, 41), (3, 64, 64)])
def test_mrf_3xtf32_matches_pallas(folded, stage, t, valid):
    """K2's 3xTF32 arithmetic through a whole stage (18 convs, their
    residuals and the resblock sum) against the JAX kernel (float32
    products, interpret mode) at ≥ 90 dB over the valid rows; one TF32
    product per conv falls below the bar."""
    cfg, arrays, meta = folded
    chains, W_all, b_all, H = jax_build_mrf_spec(
        arrays, meta["widths"], stage, cfg.resblock_dilation_sizes)
    nk = len(cfg.resblock_kernel_sizes)
    x = np.random.default_rng(stage + 40).standard_normal(
        (t, 128)).astype(np.float32)
    want = np.asarray(jax_mrf_fused(jnp.asarray(x), chains, W_all, b_all, H,
                                    jnp.int32(valid), nk, tm=32,
                                    interpret=True))
    W_np, b_np = np.asarray(W_all, np.float32), np.asarray(b_all, np.float32)
    got = emulated_mrf(x, chains, W_np, b_np, valid, nk)
    one = emulated_mrf(x, chains, W_np, b_np, valid, nk, mm=matmul1)
    assert not got[valid:].any()
    assert snr_db(want[:valid], got[:valid]) >= BAR_DB
    assert snr_db(want[:valid], one[:valid]) < BAR_DB


def emulated_decoder_block_fwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, ln_b,
                               eps=1e-5, mm=matmul3):
    """K4's float32 forward (the JAX ``_fwd_kernel``) with its product v =
    u W made as the float32 kernel makes it; everything else float32.
    JAX layouts: dw_w (k, 1, C), pw_w (1, C_in, C_out)."""
    b, m, c = x.shape
    k = dw_w.shape[0]
    pad = k // 2
    xp = np.pad(x * keep[..., None], ((0, 0), (pad, pad), (0, 0)))
    u = xp[:, 0:m] * dw_w[0, 0]
    for tap in range(1, k):
        u = u + xp[:, tap:tap + m] * dw_w[tap, 0]
    u = (u + dw_b).reshape(-1, c)
    t = np.tanh(mm(u, pw_w[0]) + pw_b)
    cen = t - t.mean(-1, keepdims=True)
    rstd = np.float32(1) / np.sqrt((cen * cen).mean(-1, keepdims=True)
                                   + np.float32(eps))
    return (cen * rstd * ln_s + ln_b).reshape(b, m, c).astype(np.float32)


@pytest.mark.parametrize("c", [128, 256])
def test_decoder_block_fwd_3xtf32_matches_pallas(c):
    """K4's float32 forward with its 3xTF32 product against the JAX
    kernel (float32, Precision.HIGHEST, interpret mode) at ≥ 90 dB, on
    sequences with padded tails; with one TF32 product y falls below the
    bar."""
    rng = np.random.default_rng(c + 1)
    b, m, k = 2, 37, 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, m, c)
    keep = np.ones((b, m), np.float32)
    keep[0, 30:] = 0
    keep[1, 19:] = 0
    weights = [f(k, 1, c) * np.float32(0.4), f(c) * np.float32(0.1),
               f(1, c, c) * np.float32(0.09 * np.sqrt(128 / c)),
               f(c) * np.float32(0.1), 1 + np.float32(0.2) * f(c),
               np.float32(0.1) * f(c)]
    want = np.asarray(jax_decoder_block_fused(
        jnp.asarray(x), jnp.asarray(keep), *map(jnp.asarray, weights), k,
        1e-5, 2, 2, True))
    got = emulated_decoder_block_fwd(x, keep, *weights)
    one = emulated_decoder_block_fwd(x, keep, *weights, mm=matmul1)
    assert got.shape == want.shape
    assert snr_db(want, got) >= BAR_DB
    assert snr_db(want, one) < BAR_DB


def emulated_decoder_block_bwd(x, keep, dw_w, dw_b, pw_w, pw_b, ln_s, dy,
                               eps=1e-5, mm=matmul3):
    """K4's float32 backward (the JAX ``_bwd_kernel``) with its three
    products made as the float32 kernel makes them, in its order: v = u W,
    the weight gradient u^T dv, then du = dv W^T; everything else float32.
    JAX layouts: dw_w (k, 1, C), pw_w (1, C_in, C_out).  Returns dx and
    the six weight gradients in those layouts."""
    b, m, c = x.shape
    k = dw_w.shape[0]
    pad = k // 2
    W = pw_w[0]
    xp = np.pad(x * keep[..., None], ((0, 0), (pad, pad), (0, 0)))
    u = xp[:, 0:m] * dw_w[0, 0]
    for tap in range(1, k):
        u = u + xp[:, tap:tap + m] * dw_w[tap, 0]
    u = (u + dw_b).reshape(-1, c)
    t = np.tanh(mm(u, W) + pw_b)
    mean = t.mean(-1, keepdims=True)
    cen = t - mean
    rstd = np.float32(1) / np.sqrt((cen * cen).mean(-1, keepdims=True)
                                   + np.float32(eps))
    that = cen * rstd
    d = dy.reshape(-1, c)
    g = d * ln_s
    dv = rstd * (g - g.mean(-1, keepdims=True)
                 - that * (g * that).mean(-1, keepdims=True)) * (1 - t * t)
    d_pw = mm(u.T, dv)
    du = mm(dv, W.T).reshape(b, m, c)
    d_dw = np.stack([(xp[:, tap:tap + m] * du).sum((0, 1))
                     for tap in range(k)])[:, None, :]
    dup = np.pad(du, ((0, 0), (pad, pad), (0, 0)))
    acc = dup[:, 0:m] * dw_w[k - 1, 0]
    for sh in range(1, k):
        acc = acc + dup[:, sh:sh + m] * dw_w[k - 1 - sh, 0]
    dx = acc * keep[..., None]
    return [a.astype(np.float32) for a in (
        dx, d_dw, du.sum((0, 1)), d_pw[None], dv.sum(0), (d * that).sum(0),
        d.sum(0))]


K4_GRADS = ("dx", "dw_w", "dw_b", "pw_w", "pw_b", "ln_s", "ln_b")


@pytest.mark.parametrize("c", [128, 256])
def test_decoder_block_bwd_3xtf32_matches_pallas(c):
    """K4's float32 backward with 3xTF32 products against the JAX kernel's
    VJP (float32, Precision.HIGHEST, interpret mode) at ≥ 90 dB for dx and
    each weight gradient, on sequences with padded tails; with one TF32
    product each, dx and the pointwise weight's gradient fall below the
    bar."""
    rng = np.random.default_rng(c)
    b, m, k = 2, 37, 5
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, dy = f(b, m, c), f(b, m, c)
    keep = np.ones((b, m), np.float32)
    keep[0, 30:] = 0
    keep[1, 19:] = 0
    weights = [f(k, 1, c) * np.float32(0.4), f(c) * np.float32(0.1),
               f(1, c, c) * np.float32(0.09 * np.sqrt(128 / c)),
               f(c) * np.float32(0.1), 1 + np.float32(0.2) * f(c),
               np.float32(0.1) * f(c)]

    def loss(x, *w):
        y = jax_decoder_block_fused(x, jnp.asarray(keep), *w, k, 1e-5, 2, 2,
                                    True)
        return jnp.sum(y * dy)

    want = [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(
        jnp.asarray(x), *map(jnp.asarray, weights))]
    got = emulated_decoder_block_bwd(x, keep, *weights[:5], dy)
    one = emulated_decoder_block_bwd(x, keep, *weights[:5], dy, mm=matmul1)
    assert not got[0][keep == 0].any()
    for name, w, g, o in zip(K4_GRADS, want, got, one):
        assert g.shape == w.shape, name
        assert snr_db(w, g) >= BAR_DB, name
    assert snr_db(want[0], one[0]) < BAR_DB
    assert snr_db(want[3], one[3]) < BAR_DB
