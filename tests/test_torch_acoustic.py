"""The port's acoustic model (Phoneme2Mel) against the JAX package's, at
float32 on the same parameters and a padded batch of two."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientspeech_tpu.config import ModelConfig as JaxModelConfig
from efficientspeech_tpu.models.phoneme2mel import Phoneme2Mel as JaxP2M
from efficientspeech_tpu_torch.config import ModelConfig
from efficientspeech_tpu_torch.models.acoustic import ScalarEmbedding
from efficientspeech_tpu_torch.models.modules import cast_params_
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.weights import load_jax_params

torch.set_num_threads(2)

BUCKET, FRAMES = 16, 128


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("embedding", "speaker_embedding"):
            return rng.standard_normal(s.shape).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_phoneme2mel_matches_jax(preset):
    jcfg = dataclasses.replace(JaxModelConfig.preset(preset),
                               max_phoneme_len=BUCKET, max_mel_len=FRAMES)
    jmodel = JaxP2M(jcfg)
    rng = np.random.default_rng(7)
    phoneme = np.zeros((2, BUCKET), np.int32)
    phoneme[0, :14] = rng.integers(1, 140, 14)
    phoneme[1, :9] = rng.integers(1, 140, 9)
    pad = phoneme == 0
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(phoneme), jnp.asarray(pad),
        train=False)["params"])
    params = _random_tree(shapes, seed=3 if preset == "tiny" else 4)
    # a duration bias that gives a few frames per phoneme
    params["encoder"]["duration_decoder"]["linear"]["bias"] = np.array(
        [3.3], np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(phoneme),
                        jnp.asarray(pad), train=False)

    model = Phoneme2Mel(ModelConfig.preset(preset))
    load_jax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(phoneme), torch.from_numpy(pad),
                    max_mel_len=FRAMES)
    np.testing.assert_array_equal(got["mel_len"].numpy(),
                                  np.asarray(want["mel_len"]))
    assert int(got["mel_len"].min()) > 0
    dur = lambda d: np.maximum(np.round(np.asarray(d)[..., 0]), 0) * ~pad
    np.testing.assert_array_equal(dur(got["duration"].numpy()),
                                  dur(want["duration"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               rtol=1e-3, atol=2e-4)


def test_scalar_bins_bit_equal_to_jax():
    for lo, hi in (ModelConfig().pitch_stats, ModelConfig().energy_stats,
                   (-1.0, 1.0), (0.1, 7.3)):
        emb = ScalarEmbedding(128, (lo, hi))
        want = np.asarray(jnp.linspace(lo, hi, 127))
        np.testing.assert_array_equal(emb.bins.numpy().view(np.int32),
                                      want.view(np.int32))
        # the bits survive a cast of the module to bf16
        assert torch.equal(emb.to(torch.bfloat16).bins,
                           torch.from_numpy(want))


def test_phoneme2mel_bf16_matches_jax():
    """The serving acoustic model in bf16: the port casts its Linear and
    conv weights to bf16 and keeps LayerNorm and embedding parameters
    float32 (``cast_params_``), as the JAX modules do.  Both round
    activations to bf16 at other places; JAX's own bf16-vs-float32 mel gap
    at these inputs is about 0.03, so the two bf16 mels are held to 0.06
    max-abs, and the rounded durations, hence mel_len, must agree."""
    jcfg = dataclasses.replace(JaxModelConfig.preset("tiny"),
                               max_phoneme_len=BUCKET, max_mel_len=FRAMES)
    rng = np.random.default_rng(7)
    phoneme = np.zeros((2, BUCKET), np.int32)
    phoneme[0, :14] = rng.integers(1, 140, 14)
    phoneme[1, :9] = rng.integers(1, 140, 9)
    pad = phoneme == 0
    jmodel = JaxP2M(jcfg, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(phoneme), jnp.asarray(pad),
        train=False)["params"])
    params = _random_tree(shapes, seed=3)
    params["encoder"]["duration_decoder"]["linear"]["bias"] = np.array(
        [3.3], np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(phoneme),
                        jnp.asarray(pad), train=False)

    model = Phoneme2Mel(ModelConfig.preset("tiny"))
    load_jax_params(model, params)
    cast_params_(model, torch.bfloat16)
    assert model.decoder.proj_norm.weight.dtype == torch.float32
    with torch.no_grad():
        got = model(torch.from_numpy(phoneme), torch.from_numpy(pad),
                    max_mel_len=FRAMES)
    assert got["mel"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["mel_len"].numpy(),
                                  np.asarray(want["mel_len"]))
    err = np.abs(got["mel"].float().numpy()
                 - np.asarray(want["mel"], np.float32)).max()
    assert err <= 0.06, err


@pytest.mark.parametrize("with_ids", [False, True], ids=["no-ids", "ids"])
def test_phoneme2mel_multispeaker_matches_jax(with_ids):
    """A three-speaker acoustic model (the speaker table added to the fused
    encoder features), with speaker ids per row and without (every row
    then speaks as speaker 0), against the JAX model on the same
    parameters: mel_len and rounded durations equal, the mel at the
    single-speaker test's tolerance (rtol 1e-3, atol 2e-4; float32 in
    both, sums in another order)."""
    jcfg = dataclasses.replace(JaxModelConfig.preset("tiny"),
                               max_phoneme_len=BUCKET, max_mel_len=FRAMES,
                               n_speakers=3)
    jmodel = JaxP2M(jcfg)
    rng = np.random.default_rng(13)
    phoneme = np.zeros((2, BUCKET), np.int32)
    phoneme[0, :13] = rng.integers(1, 140, 13)
    phoneme[1, :10] = rng.integers(1, 140, 10)
    pad = phoneme == 0
    speaker = np.array([2, 1], np.int32) if with_ids else None
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(phoneme), jnp.asarray(pad),
        train=False)["params"])
    params = _random_tree(shapes, seed=5)
    params["encoder"]["duration_decoder"]["linear"]["bias"] = np.array(
        [3.3], np.float32)
    want = jmodel.apply({"params": params}, jnp.asarray(phoneme),
                        jnp.asarray(pad),
                        speaker=None if speaker is None
                        else jnp.asarray(speaker), train=False)

    model = Phoneme2Mel(dataclasses.replace(ModelConfig.preset("tiny"),
                                            n_speakers=3))
    load_jax_params(model, params)
    assert model.encoder.speaker_embedding.shape[0] == 3
    with torch.no_grad():
        got = model(torch.from_numpy(phoneme), torch.from_numpy(pad),
                    max_mel_len=FRAMES,
                    speaker=None if speaker is None
                    else torch.from_numpy(speaker).long())
    np.testing.assert_array_equal(got["mel_len"].numpy(),
                                  np.asarray(want["mel_len"]))
    assert int(got["mel_len"].min()) > 0
    dur = lambda d: np.maximum(np.round(np.asarray(d)[..., 0]), 0) * ~pad
    np.testing.assert_array_equal(dur(got["duration"].numpy()),
                                  dur(want["duration"]))
    np.testing.assert_allclose(got["mel"].numpy(), np.asarray(want["mel"]),
                               rtol=1e-3, atol=2e-4)
