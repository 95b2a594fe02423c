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
