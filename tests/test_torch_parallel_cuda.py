"""Data parallelism and the sequence-parallel vocoder on the card: two
ranks that share cuda:0 over gloo (NCCL refuses two ranks on one
device), each held against the one-process run on the same card.  These
tests need a CUDA device and nvcc, and skip without them; on a machine
with a card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch

import torch_ranks
from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, folded_plan_apply)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.parallel import launch
from efficientspeech_tpu_torch.weights import init_params, to_jax_params

pytestmark = pytest.mark.cuda

SHARED = ["cuda:0", "cuda:0"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(b=4, n=32, m=256):
    """Rows of very unequal length, as the ranks would hold them."""
    rng = np.random.default_rng(0)
    phoneme = np.zeros((b, n), np.int32)
    duration = np.zeros((b, n), np.int32)
    for i, length in enumerate([30, 28, 5, 3][:b]):
        phoneme[i, :length] = rng.integers(1, 140, length)
        duration[i, :length] = rng.integers(1, 8, length)
    pad = phoneme == 0
    mel_len = np.minimum(duration.sum(1), m)
    return {"phoneme": phoneme, "phoneme_mask": pad,
            "pitch": (rng.normal(size=(b, n)) * ~pad).astype(np.float32),
            "energy": (rng.normal(size=(b, n)) * ~pad).astype(np.float32),
            "duration": duration,
            "mel": rng.normal(size=(b, m, 80)).astype(np.float32),
            "mel_mask": np.arange(m)[None, :] >= mel_len[:, None]}


def test_data_parallel_step_on_the_card(card):
    """A float32 tiny step on the kernel routes (K3, K4 on every rank) by
    two ranks on cuda:0 equals the one-process step on the whole batch:
    the global losses at rtol 1e-5, the summed gradients at 1e-4 of each
    leaf's largest."""
    cfg = ModelConfig.preset("tiny", max_phoneme_len=32, max_mel_len=256)
    tree = to_jax_params(init_params(Phoneme2Mel(cfg), 0))
    batch = _batch()
    case = dict(tree=tree, model_cfg=cfg, lr=1e-3, batch=batch, fused=True)
    # the one-process step first: it builds the kernels the ranks load
    state = torch_ranks.acoustic_state(tree, cfg, 1e-3, card, fused=True)
    state, m = torch_ranks.step_once(state, batch, torch.float32, card, None)
    want = torch_ranks._stepped(state, m)
    got = launch(torch_ranks.dp_acoustic, 2, SHARED, backend="gloo",
                 args=(case,))
    for r in got:
        # tiny: K3 3 + 3 and K4 4 + 4 float32 launches a step, on each rank
        assert r["launches"] == {"k3": (3, 3), "k4": (4, 4)}
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(r["step"]["metrics"][k], v,
                                       rtol=1e-5, err_msg=k)
        for name, g in want["grads"].items():
            scale = np.abs(g).max() + 1e-12
            np.testing.assert_allclose(r["step"]["grads"][name] / scale,
                                       g / scale, atol=1e-4, err_msg=name)


def test_seq_parallel_vocode_on_the_card(card):
    """The frame axis split over two ranks on cuda:0, its valid length
    ending in shard 0, equals the one-process folded route at float32's
    rtol 1e-5."""
    cfg = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
               upsample_initial_channel=32, resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3),))
    gen = init_params(HifiGanGenerator(HifiGanConfig(**cfg)), 1)
    tree = to_jax_params(gen)
    t, valid = 64, 21
    mel = np.random.default_rng(1).normal(-3, 2, (1, t, 80)).astype(
        np.float32)
    mel[0, valid:] = 0
    got = launch(torch_ranks.seq_vocode, 2, SHARED, backend="gloo",
                 args=(dict(cfg=cfg, cases=[dict(
                     tree=tree, mesh={"sp": 2}, mel=mel,
                     valid=np.array([valid], np.int32))]),))
    blocks = sorted((r[0]["coords"]["sp"], r[0]["wav"]) for r in got)
    wav = np.concatenate([b for _, b in blocks], axis=1)
    arrays, meta = fold_hifigan(gen.to(card), dtype=torch.float32)
    want = folded_plan_apply(
        arrays, meta, HifiGanConfig(**cfg), torch.from_numpy(mel).to(card),
        torch.tensor([valid], device=card), dtype=torch.float32).cpu()
    np.testing.assert_allclose(wav, want.numpy(), rtol=1e-5, atol=1e-5)
    assert not wav[0, valid * 64:].any()
