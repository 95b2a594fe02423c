"""The port's tensor parallelism (``parallel/sharding.py``) against the
JAX package's: the rules pick the same kernels, and one float32 step on a
(data 2, model 2) mesh of four gloo CPU ranks (a module fixture) equals
JAX's tensor-parallel step on its virtual mesh
(tests/test_tensor_parallel.py::test_tp_step_matches_replicated): the
loss, the gradients and the stepped parameters, gathered by
``gather_params`` into the unsharded tree that ``weights.to_jax_params``
writes."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks
from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.config import TrainConfig as JaxTrainConfig
from efficientspeech_tpu.models.phoneme2mel import Phoneme2Mel as JaxP2M
from efficientspeech_tpu.parallel import make_mesh as jax_make_mesh
from efficientspeech_tpu.parallel import shard_batch as jax_shard_batch
from efficientspeech_tpu.parallel.sharding import (
    state_shardings, tp_param_shardings as jax_tp_shardings)
from efficientspeech_tpu.training.state import (
    create_train_state as jax_create_state)
from efficientspeech_tpu.training.state import make_optimizer as jax_optimizer
from efficientspeech_tpu.training.step import make_train_step as jax_step
from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.parallel import launch
from efficientspeech_tpu_torch.parallel.mesh import Mesh
from efficientspeech_tpu_torch.parallel.sharding import tp_param_shardings
from efficientspeech_tpu_torch.weights import (
    from_jax_params, load_jax_params, to_jax_params)
from test_training import _toy_batch

LR = 1e-3


def _cfgs():
    kw = dict(max_phoneme_len=32, max_mel_len=128)
    return JaxModelConfig.preset("tiny", **kw), ModelConfig.preset("tiny",
                                                                   **kw)


def _jax_params(model, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.device_get(jax.jit(lambda r: model.init(
        r, jb["phoneme"], jb["phoneme_mask"], pitch_target=jb["pitch"],
        energy_target=jb["energy"], duration_target=jb["duration"],
        train=True)["params"])(jax.random.PRNGKey(0)))


def _port_name(path) -> str:
    """A JAX kernel's path → the port's parameter name."""
    keys = [p.key for p in path if hasattr(p, "key")][1:]  # no phoneme2mel
    return ".".join(keys[:-1] + ["weight"])


@pytest.mark.parametrize("model_parallel", [2, 3])
def test_tp_rules_match_jax(model_parallel):
    """The port's rules shard the parameters JAX's do, each along the
    matching dim of its torch weight (a column split is dim 0, a row split
    dim 1), and replicate a kernel whose dim does not divide by the model
    size; at model size 2 they take qkv and mlp1."""
    jcfg, cfg = _cfgs()
    batch = _toy_batch(np.random.default_rng(0), b=4)
    params = _jax_params(JaxP2M(jcfg), batch)
    jmesh = jax_make_mesh(data_parallel=1, model_parallel=model_parallel)
    want = {}
    for path, sh in jax.tree_util.tree_leaves_with_path(
            jax_tp_shardings({"phoneme2mel": params}, jmesh)):
        if sh.spec != jax.sharding.PartitionSpec():
            want[_port_name(path)] = (0 if sh.spec[0] is None else 1,
                                      model_parallel)
    model = load_jax_params(Phoneme2Mel(cfg), params)
    got = tp_param_shardings(model, Mesh({"data": 1, "model": model_parallel},
                                         connected=False))
    assert {k: v for k, v in got.items() if v is not None} == want
    assert want
    if model_parallel == 2:
        assert any("qkv" in k for k in want) and any("mlp1" in k
                                                     for k in want)
    else:  # 32-wide projections stay whole at model size 3
        assert "encoder.encoder.stage0.attn.proj.weight" not in want


def _recording(tx):
    """``tx`` whose state also keeps the last gradients."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def runs():
    """(JAX's tensor-parallel step, the four ranks' results, inputs)."""
    jcfg, cfg = _cfgs()
    batch = _toy_batch(np.random.default_rng(2), b=4)
    model = JaxP2M(jcfg)
    params = _jax_params(model, batch)
    train_cfg = JaxTrainConfig(batch_size=4, lr=LR, warmup_epochs=0,
                               max_epochs=10)
    tx = _recording(jax_optimizer(train_cfg, 4))
    mesh = jax_make_mesh(data_parallel=2, model_parallel=2)
    state = jax_create_state({"phoneme2mel": params}, train_cfg, 4)
    state = state.replace(opt_state=tx.init(state.params))
    st_sh = state_shardings(state, mesh)
    state = jax.device_put(state, st_sh)
    state, metrics = jax_step(model, tx, mesh=mesh, donate=False,
                              state_sharding=st_sh)(
        state, jax_shard_batch(batch, mesh))
    state = jax.device_get(state)
    want = dict(
        metrics={k: float(v) for k, v in jax.device_get(metrics).items()},
        params={k: v.numpy() for k, v in from_jax_params(
            state.params["phoneme2mel"]).items()},
        grads={k: v.numpy() for k, v in from_jax_params(
            state.opt_state[1]["phoneme2mel"]).items()})
    got = launch(torch_ranks.tp_step, 4, ["cpu"] * 4, args=(dict(
        data=2, model=2, model_cfg=cfg, tree=params, lr=LR,
        batch=batch),))
    return want, got, cfg


def test_tp_step_matches_jax(runs):
    """Every rank's gathered gradients and stepped parameters equal JAX's
    tensor-parallel step (loss at rtol 1e-5, gradients at 1e-4 of each
    leaf's largest, parameters at JAX's rtol 3e-4 / atol 3e-5 away from
    gradients within that tolerance of zero), and the four agree."""
    want, got, _ = runs
    for r in got:
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        assert set(r["params"]) == set(want["params"])
        for name, ref_g in want["grads"].items():
            scale = np.abs(ref_g).max() + 1e-12
            np.testing.assert_allclose(r["grads"][name] / scale,
                                       ref_g / scale, atol=1e-4,
                                       err_msg=name)
            g = np.abs(ref_g)
            keep = ~((g > 0) & (g < 1e-4 * g.max()))
            np.testing.assert_allclose(r["params"][name][keep],
                                       want["params"][name][keep],
                                       rtol=3e-4, atol=3e-5, err_msg=name)
    for r in got[1:]:
        for name, p in r["params"].items():
            np.testing.assert_array_equal(p, got[0]["params"][name])


def test_tp_ranks_hold_their_shards(runs):
    """Each rank holds half of each sharded weight, and the gathered
    parameters load into an unsharded model whose JAX tree has the
    reference's shapes."""
    want, got, cfg = runs
    for r in got:
        for name, split in r["shardings"].items():
            full = want["params"][name].shape
            if split is None:
                assert r["local"][name] == full, name
            else:
                dim, n = split
                assert r["local"][name][dim] * n == full[dim], name
    model = Phoneme2Mel(cfg)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got[0]["params"].items()})
    tree = to_jax_params(model)
    back = {k: v.numpy() for k, v in from_jax_params(tree).items()}
    for name, v in back.items():
        np.testing.assert_array_equal(v, got[0]["params"][name])
