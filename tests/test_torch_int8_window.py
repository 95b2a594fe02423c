"""Kernel K5's plain version (the function the CUDA kernel computes)
against the JAX package's int8 probe kernel, run in interpret mode by
``benchmarks/int8_pallas_probe.run`` on inputs the test rebuilds with
numpy from the probe's seed.  The quantisation and the int32 sums leave
no rounding but the final float32 multiply, so both variants must agree
bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from benchmarks.int8_pallas_probe import run as jax_probe_run
from efficientspeech_tpu_torch.ops.kernels import int8_window as k5


def _probe_inputs(t, d_in, d_out, n_win, tm, quantize):
    """``run``'s inputs: ``default_rng(0)``, first xs, then W."""
    rng = np.random.default_rng(0)
    _, rows = k5.layout(t, tm, n_win)
    xs = rng.normal(size=(rows, d_in))
    w = rng.integers(-127, 127, size=(n_win * d_in, d_out))
    x = (torch.from_numpy(xs.astype(np.float32)).to(torch.bfloat16)
         if quantize
         else torch.from_numpy(np.clip(xs * 40, -127, 127).astype(np.int8)))
    return x, torch.from_numpy(w.astype(np.int8))


@pytest.mark.parametrize("quantize", [True, False], ids=["bf16", "int8"])
@pytest.mark.parametrize("t,tm,n_win,d", [
    (256, 64, 5, 128),   # the probe's window and width, four tiles
    (200, 64, 5, 128),   # t not a multiple of tm: the last tile is padded
    (96, 32, 3, 64)])
def test_plain_bit_equal_to_jax_probe(quantize, t, tm, n_win, d):
    want = np.asarray(jax_probe_run(
        t, d, d, n_win, tm, quantize,
        jnp.bfloat16 if quantize else jnp.int8, 0, 0, interpret=True))
    x, w = _probe_inputs(t, d, d, n_win, tm, quantize)
    got = k5.int8_window_matmul(x, w, n_win, tm)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (k5.layout(t, tm, n_win)[0], d)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0


def test_layout_and_tile_scale():
    """slice_rows rounds the window up to 8 rows; each tile's scale comes
    from its whole slice, the rows past its window included."""
    assert k5.slice_rows(512, 5) == 520 and k5.slice_rows(64, 3) == 72
    assert k5.layout(49152, 512, 5) == (49152, 49672)
    assert k5.layout(200, 64, 5) == (256, 328)
    x = torch.zeros(k5.layout(64, 32, 3)[1], 32, dtype=torch.bfloat16)
    # row 36: past tile 0's window (rows 0-33) but in its slice (0-39)
    x[36, 0] = 4.0
    xq, scale = k5.quantized_slices(x, 3, 32)
    assert float(scale[0]) == float(scale[1]) == \
        float(np.float32(4.0) * np.float32(k5.INV_127))
    assert xq.shape == (2, 40, 32) and float(xq.abs().max()) == 127
    # an all-zero slice takes the 1e-6 floor
    xq, scale = k5.quantized_slices(torch.zeros_like(x), 3, 32)
    assert float(scale[0]) == float(np.float32(1e-6) *
                                    np.float32(k5.INV_127))


def test_cpu_tensor_launches_nothing():
    x, w = _probe_inputs(64, 32, 64, 3, 32, True)
    before = (k5.launches_quant, k5.launches_int8)
    k5.int8_window_matmul(x, w, 3, 32)
    k5.int8_window_matmul(x.to(torch.int8), w, 3, 32)
    assert (k5.launches_quant, k5.launches_int8) == before


@pytest.mark.parametrize("tm,n_win,d,d_out", [
    (512, 5, 128, 128), (256, 5, 128, 128), (256, 3, 128, 128),
    (160, 5, 128, 128), (96, 3, 64, 64), (1024, 5, 128, 128),
    (4672, 3, 32, 64)])
def test_plan_partitions_rows(tm, n_win, d, d_out):
    """The cluster plan: every output row of a tile belongs to exactly one
    block, every slice row to exactly one block's share (the maximum), a
    block's quantised rows (its output rows and the window's halo) lie in
    the slice and in its int8 tile, and shared memory leaves room for two
    blocks an SM at the probe's shape."""
    p = k5.plan(tm, n_win, d, d_out)
    sr = k5.slice_rows(tm, n_win)
    assert 1 <= p.cs <= 8 and p.rb % 32 == 0
    out = [r for lo, hi in p.out_rows(tm) for r in range(lo, hi)]
    assert out == list(range(tm))
    shares = [r for lo, hi in p.shares(tm, n_win) for r in range(lo, hi)]
    assert shares == list(range(sr))
    for (lo, hi), (s_lo, _) in zip(p.out_rows(tm), p.shares(tm, n_win)):
        assert lo == s_lo and hi > lo
        assert hi + n_win - 1 <= sr and hi - lo <= p.rb
    assert p.wt_bytes >= n_win * d * d_out and p.wt_bytes % 1024 == 0
    assert p.xq_off == p.wt_bytes
    assert p.pmax_off - p.xq_off >= (p.rb + n_win - 1) * (d + k5.PADB)
    assert p.bar_off >= p.pmax_off + 4 * 9 and p.bar_off % 8 == 0
    assert p.smem <= 227 * 1024 and p.smem >= p.bar_off + 8 + 1024
    if (tm, n_win, d) == (512, 5, 128):
        assert (p.cs, p.rb) == (4, 128) and 2 * (p.smem + 1024) <= 228 * 1024


def _emulate(x, w, n_win, tm):
    """The kernel's data flow on the CPU: per block of each tile's
    cluster, the share's maximum, the cluster's scale, the block's rows
    and halo quantised, its products."""
    p = k5.plan(tm, n_win, x.shape[1], w.shape[1], x.element_size())
    sr = k5.slice_rows(tm, n_win)
    outs = []
    for base in range(0, x.shape[0] - sr, tm):
        sl = x[base: base + sr].float()
        if x.dtype == torch.int8:
            scale = torch.tensor(1.0)
        else:
            part = [sl[lo:hi].abs().amax() for lo, hi in p.shares(tm, n_win)]
            scale = (torch.clamp_min(torch.stack(part).amax(), 1e-6)
                     * k5.INV_127)
        for lo, hi in p.out_rows(tm):
            rows = sl[lo: hi + n_win - 1]
            xq = (rows if x.dtype == torch.int8 else
                  torch.clamp(rows / scale, -127, 127).trunc())
            win = torch.cat([xq[j: j + hi - lo] for j in range(n_win)], 1)
            outs.append((win.double() @ w.double()).float() * scale)
    return torch.cat(outs)


@pytest.mark.parametrize("quantize", [True, False], ids=["bf16", "int8"])
@pytest.mark.parametrize("t,tm,n_win", [(1000, 256, 3), (700, 160, 5)])
def test_cluster_split_is_bit_equal(quantize, t, tm, n_win):
    """Split as the plan splits it, a tile gives the plain version's
    outputs bit for bit: the maximum is exact in any order."""
    x, w = _probe_inputs(t, 64, 64, n_win, tm, quantize)
    want = k5.int8_window_matmul_plain(x, w, n_win, tm)
    assert torch.equal(_emulate(x, w, n_win, tm), want)


@pytest.mark.parametrize("tm,d_in,d_out", [(48, 128, 128), (512, 80, 128),
                                           (512, 128, 96), (8192, 128, 128)])
def test_plan_refuses(tm, d_in, d_out):
    """What the kernel does not take raises in the plan, which the wrapper
    makes before it launches anything."""
    with pytest.raises(ValueError, match="int8_window"):
        k5.plan(tm, 5, d_in, d_out)
