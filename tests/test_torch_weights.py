"""The weight bridge: every leaf of a JAX parameter tree lands in the
port's modules, and the port's vocoder fold equals the JAX fold."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.config import HifiGanConfig as JaxHifiGanConfig
from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.models import EfficientSpeech as JaxEfficientSpeech
from efficientspeech_tpu.models.hifigan_folded import fold_hifigan_device
from efficientspeech_tpu.utils.host_init import host_init
from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.models.efficientspeech import EfficientSpeech
from efficientspeech_tpu_torch.models.hifigan_folded import fold_hifigan
from efficientspeech_tpu_torch.weights import (
    from_jax_params, init_params, load_jax_params)

torch.set_num_threads(2)


def _jax_tree(preset, seed=0):
    model = JaxEfficientSpeech(cfg=JaxModelConfig.preset(preset),
                               hifigan_cfg=JaxHifiGanConfig())
    return host_init(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 32), jnp.int32),
        jnp.ones((1, 32), bool), method=model.predict)["params"], seed=seed)


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_every_leaf_maps(preset):
    tree = _jax_tree(preset)
    n_leaves = len(jax.tree_util.tree_leaves(tree))
    state = from_jax_params(tree)
    assert len(state) == n_leaves
    model = EfficientSpeech(ModelConfig.preset(preset), HifiGanConfig())
    assert set(state) == set(model.state_dict())
    load_jax_params(model, tree)
    got = model.phoneme2mel.encoder.encoder.stage0.attn.qkv.weight
    want = tree["phoneme2mel"]["encoder"]["encoder"]["stage0"]["attn"][
        "qkv"]["kernel"]
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want).T)
    # a missing or extra leaf raises
    tree["hifigan"]["extra"] = {"bias": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        load_jax_params(model, tree)
    del tree["hifigan"]["extra"]
    del tree["hifigan"]["conv_post"]
    with pytest.raises(KeyError):
        load_jax_params(model, tree)


def test_native_init_is_seeded():
    cfg, hcfg = ModelConfig.preset("tiny"), HifiGanConfig()
    a = init_params(EfficientSpeech(cfg, hcfg), seed=3).state_dict()
    b = init_params(EfficientSpeech(cfg, hcfg), seed=3).state_dict()
    c = init_params(EfficientSpeech(cfg, hcfg), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["hifigan.conv_pre.weight"],
                           c["hifigan.conv_pre.weight"])


def test_fold_matches_jax_fold():
    tree = _jax_tree("tiny", seed=1)
    rng = np.random.default_rng(0)
    hifigan = {k: {n: (rng.standard_normal(v.shape).astype(np.float32)
                       if n == "bias" else v) for n, v in sub.items()}
               if "kernel" in sub else sub
               for k, sub in tree["hifigan"].items()}
    tree["hifigan"] = jax.tree.map(np.asarray, hifigan)
    model = EfficientSpeech(ModelConfig.preset("tiny"), HifiGanConfig())
    load_jax_params(model, tree)
    arrays, meta = fold_hifigan(model.hifigan, torch.float32)
    j_arrays, j_meta = fold_hifigan_device(tree["hifigan"],
                                           JaxHifiGanConfig(),
                                           dtype=jnp.float32)
    assert meta == j_meta
    assert set(arrays) == set(j_arrays)
    for key, (W, b) in arrays.items():
        np.testing.assert_array_equal(W.numpy(), np.asarray(j_arrays[key][0]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(j_arrays[key][1]))
