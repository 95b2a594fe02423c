"""The port's sequence-parallel folded vocoder (``parallel/seq_vocoder.py``)
against the JAX package's ``seq_parallel_vocode`` on a virtual mesh, and
against the port's own single-device folded route: four gloo CPU ranks
in one spawned group (a module fixture) run every case, on meshes
("sp",) of 4 and ("data", "sp") of 2 x 2.

The cases mirror tests/test_seq_parallel_vocoder.py: (4 shards, 16
frames, valid 13), (2, 16, 5), whose valid length ends in shard 0 (a
mask on local row indices passes only when it ends in the last shard),
no valid length, and a batch split over "data" composed with the frame
split."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_ranks
from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.models.hifigan import (
    HifiGanGenerator as JaxGenerator)
from efficientspeech_tpu.models.hifigan_folded import fold_hifigan_device
from efficientspeech_tpu.parallel.seq_vocoder import (
    seq_parallel_vocode as jax_seq_vocode)
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, folded_plan_apply)
from efficientspeech_tpu_torch.parallel import launch
from efficientspeech_tpu_torch.parallel.mesh import Mesh
from efficientspeech_tpu_torch.parallel.seq_vocoder import (
    seq_parallel_vocode)
from efficientspeech_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)

CFG = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),))
UP = 64

# name: (generator key, mesh, batch axis, mel rows, frames, valid lengths)
CASES = {
    "4x16_valid13": (1, {"sp": 4}, None, 1, 16, [13]),
    "2x16_valid5": (1, {"data": 2, "sp": 2}, None, 1, 16, [5]),
    "no_valid_len": (2, {"sp": 4}, None, 1, 16, None),
    "data2_sp2": (3, {"data": 2, "sp": 2}, "data", 4, 16, [13, 16, 5, 9]),
}


def _params(key):
    gen = JaxGenerator(JaxHifiGanConfig(**CFG), dtype=jnp.float32)
    return jax.device_get(gen.init(jax.random.PRNGKey(key),
                                   jnp.zeros((1, 4, 80), jnp.float32))
                          ["params"])


def _mel(rows, t, valid, seed):
    mel = np.random.default_rng(seed).normal(-3, 2, (rows, t, 80)).astype(
        np.float32)
    for i, v in enumerate(valid or []):
        mel[i, v:] = 0
    return mel


def _jax_run(params, mel, valid, shape, batch_axis):
    """JAX's seq_parallel_vocode on a mesh of the same shape."""
    cfg = JaxHifiGanConfig(**CFG)
    arrays, meta = fold_hifigan_device(params, cfg, dtype=jnp.float32)
    n = int(np.prod(list(shape.values())))
    mesh = JaxMesh(np.array(jax.devices()[:n]).reshape(
        tuple(shape.values())), tuple(shape))
    mel_sh = jax.device_put(mel, NamedSharding(mesh, P(batch_axis, "sp",
                                                       None)))
    vl = None if valid is None else jax.device_put(
        np.asarray(valid, np.int32), NamedSharding(mesh, P(batch_axis)))
    out = jax.jit(lambda a, m, v: jax_seq_vocode(
        a, meta, cfg, m, mesh, valid_len=v, batch_axis=batch_axis,
        dtype=jnp.float32))(arrays, mel_sh, vl)
    return np.asarray(jax.device_get(out))


def _assemble(blocks, shape, batch_axis, rows, t):
    """The waveform from the ranks' blocks (by their coordinates)."""
    wav = np.full((rows, t * UP), np.nan, np.float32)
    n_sp = shape["sp"]
    n_rows = rows // (shape[batch_axis] if batch_axis else 1)
    for blk in blocks:
        c = blk["coords"]
        r0 = c[batch_axis] * n_rows if batch_axis else 0
        s0 = c["sp"] * (t // n_sp) * UP
        wav[r0: r0 + n_rows, s0: s0 + blk["wav"].shape[1]] = blk["wav"]
    return wav


@pytest.fixture(scope="module")
def runs():
    """{case: (JAX's waveform, the port's assembled waveform, inputs)}."""
    cases, inputs = [], {}
    for i, (name, (key, shape, axis, rows, t, valid)) in enumerate(
            CASES.items()):
        tree = _params(key)
        mel = _mel(rows, t, valid, seed=i)
        inputs[name] = (tree, mel, valid)
        cases.append(dict(tree=tree, mesh=shape, batch_axis=axis, mel=mel,
                          valid=None if valid is None
                          else np.asarray(valid, np.int32)))
    got = launch(torch_ranks.seq_vocode, 4, ["cpu"] * 4,
                 args=(dict(cfg=CFG, cases=cases),))
    out = {}
    for i, (name, (key, shape, axis, rows, t, valid)) in enumerate(
            CASES.items()):
        tree, mel, _ = inputs[name]
        want = _jax_run(tree, mel, valid, shape, axis)
        port = _assemble([g[i] for g in got], shape, axis, rows, t)
        out[name] = (want, port, inputs[name], [g[i] for g in got])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_seq_parallel_matches_jax(runs, case):
    """Every case equals JAX's sequence-parallel vocoder at its test's
    tolerance, and the port's single-device folded route."""
    want, port, (tree, mel, valid), _ = runs[case]
    assert not np.isnan(port).any()
    np.testing.assert_allclose(port, want, rtol=1e-5, atol=1e-5)
    gen = load_jax_params(HifiGanGenerator(HifiGanConfig(**CFG)), tree)
    arrays, meta = fold_hifigan(gen, dtype=torch.float32)
    vl = torch.full((mel.shape[0],), mel.shape[1]) if valid is None \
        else torch.tensor(valid)
    single = folded_plan_apply(arrays, meta, HifiGanConfig(**CFG),
                               torch.from_numpy(mel), vl,
                               dtype=torch.float32).numpy()
    np.testing.assert_allclose(port, single, rtol=1e-5, atol=1e-5)


def test_valid_length_in_an_earlier_shard_masks_there(runs):
    """With the valid length ending in shard 0 of 2, the samples past it
    are exactly zero on both shards, and the data ranks of the 2 x 2 mesh
    that split no batch give the same blocks."""
    _, port, (_, _, valid), blocks = runs["2x16_valid5"]
    assert not port[0, valid[0] * UP:].any()
    assert port[0, :valid[0] * UP].any()
    by_sp = {}
    for blk in blocks:
        by_sp.setdefault(blk["coords"]["sp"], []).append(blk["wav"])
    for same in by_sp.values():
        np.testing.assert_array_equal(same[0], same[1])


def test_seq_vocode_checks_its_split():
    """The frame axis must split over the ranks, each shard at least the
    widest window; the one-rank mesh is the single-device route."""
    gen = load_jax_params(HifiGanGenerator(HifiGanConfig(**CFG)),
                          _params(1))
    arrays, meta = fold_hifigan(gen, dtype=torch.float32)
    cfg = HifiGanConfig(**CFG)
    mel = torch.from_numpy(_mel(1, 16, [11], seed=9))
    one = Mesh.create({"sp": 1})
    np.testing.assert_allclose(
        seq_parallel_vocode(arrays, meta, cfg, mel, one,
                            valid_len=torch.tensor([11]),
                            dtype=torch.float32).numpy(),
        folded_plan_apply(arrays, meta, cfg, mel, torch.tensor([11]),
                          dtype=torch.float32).numpy(), rtol=1e-5, atol=1e-5)
    plan = Mesh({"sp": 3}, connected=False)
    with pytest.raises(ValueError, match="do not split"):
        seq_parallel_vocode(arrays, meta, cfg, mel, plan)
    plan = Mesh({"sp": 16}, connected=False)
    with pytest.raises(ValueError, match="max window"):
        seq_parallel_vocode(arrays, meta, cfg, mel, plan)
