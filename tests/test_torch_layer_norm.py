"""Kernel K3's plain version (the function the CUDA kernel computes)
against the JAX package's Pallas ``layer_norm_fused`` in interpret mode,
forward and backward, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.ops.pallas.layer_norm import (
    layer_norm_fused as jax_layer_norm_fused)
from efficientspeech_tpu_torch.models.modules import LayerNorm
from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3

# 5 · 21 = 105 rows: not a multiple of the JAX kernel's 16-row tile, nor of
# the CUDA kernel's 8 rows per block
SHAPE = (5, 21, 128)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    s = (rng.normal(size=shape[-1:]) * 0.5 + 1).astype(np.float32)
    b = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    return x, s, b


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    x, s, b = _inputs(0)
    want = jax_layer_norm_fused(jnp.asarray(x, jdt), jnp.asarray(s),
                                jnp.asarray(b), 1e-5, 16, True)
    got = k3.layer_norm_fused(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == tdt and got.shape == x.shape
    got, want = _as_f32(got), _as_f32(want)
    if dtype == "f32":
        # the two frameworks sum a row in another order
        np.testing.assert_allclose(got, want, atol=1e-6)
        return
    # bf16: both round float32 values that differ only in summation order,
    # so the bits agree except where those values straddle a rounding
    # boundary; there they differ by one bf16 ulp (2^-7 of the binade)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() < 1e-3


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_matches_jax_grad(dtype):
    """dx, dscale and dbias of a nonlinear loss, sum(sin(y))."""
    jdt, tdt = DTYPES[dtype]
    x, s, b = _inputs(1)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_layer_norm_fused(
        *a, 1e-5, 16, True).astype(jnp.float32))), argnums=(0, 1, 2))(
        jnp.asarray(x, jdt), jnp.asarray(s), jnp.asarray(b))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    torch.sin(k3.layer_norm_fused(xt, st, bt).float()).sum().backward()
    assert xt.grad.dtype == tdt
    assert st.grad.dtype == bt.grad.dtype == torch.float32
    # float32: summation order only.  bf16: dx is rounded to bf16 (one ulp
    # is 2^-8 relative) from float32 values that differ in summation order,
    # and the weight grads sum 105 rows of such terms
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "f32"
           else dict(rtol=1e-2, atol=1e-2))
    for name, g, w in zip(("dx", "dscale", "dbias"), (xt.grad, st.grad,
                                                       bt.grad), want):
        np.testing.assert_allclose(_as_f32(g), _as_f32(w), err_msg=name,
                                   **tol)


def test_kernel_route_equals_layer_norm_module():
    """The plain version is the port's LayerNorm module's function."""
    x, s, b = _inputs(2, (7, 256))
    norm = LayerNorm(256)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(s))
        norm.bias.copy_(torch.from_numpy(b))
        for tdt in (torch.float32, torch.bfloat16):
            xt = torch.from_numpy(x).to(tdt)
            assert torch.equal(
                k3.layer_norm_fused(xt, norm.weight, norm.bias), norm(xt))


def test_cpu_takes_plain_version_without_launch():
    x, s, b = _inputs(3, (4, 128))
    before = (dict(k3.launches_fwd), dict(k3.launches_bwd))
    xt = torch.from_numpy(x).requires_grad_()
    k3.layer_norm_fused(xt, torch.from_numpy(s), torch.from_numpy(b)
                        ).sum().backward()
    assert (k3.launches_fwd, k3.launches_bwd) == before
