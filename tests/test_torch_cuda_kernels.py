"""The CUDA kernels against their plain versions, on the card.  These
tests need a CUDA device and nvcc, and skip without them; on a machine
with a card run them with

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, prepare_for_kernels)
from efficientspeech_tpu_torch.models.modules import reset_parameters
from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
from efficientspeech_tpu_torch.ops.kernels import mrf_block

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    err = (got.double() - ref.double()).pow(2).mean()
    return 10 * float(torch.log10(ref.double().pow(2).mean()
                                  / err.clamp_min(1e-30)))


@pytest.mark.parametrize("t,d_out,w,extras", [
    (1000, 512, 1, False), (777, 16, 1, False), (300, 128, 13, True)])
def test_folded_matmul_kernel(card, t, d_out, w, extras):
    g = torch.Generator(device="cpu").manual_seed(t)
    x = torch.randn(t, 128, generator=g).to(card)
    W = (torch.randn((2 * w + 1) * 128, d_out, generator=g) * 0.05
         ).to(card, torch.bfloat16)
    b = torch.randn(d_out, generator=g).to(card)
    res = torch.randn(t, d_out, generator=g).to(card) if extras else None
    valid = torch.tensor([t - 137], dtype=torch.int32, device=card)
    kw = dict(residual=res, accum=res, out_scale=1 / 3 if extras else None,
              pre_lrelu=True, lrelu_slope=0.01 if d_out == 16 else 0.1)
    got = fm.folded_matmul(x, W, b, w, valid, **kw)
    want = fm.folded_matmul_plain(x, W, b, w, valid, **kw)
    torch.cuda.synchronize()
    assert snr_db(want, got) >= 35.0
    assert not got[t - 137:].any()


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mrf_kernel(card, stage):
    cfg = HifiGanConfig()
    gen = HifiGanGenerator(cfg)
    reset_parameters(gen, 0)
    arrays, meta = fold_hifigan(gen.to(card), torch.bfloat16)
    arrays, mrf = prepare_for_kernels(arrays, meta, cfg)
    chains, W_all, b_all, H = mrf[stage]
    t = 1000
    x = torch.randn(t, 128, generator=torch.Generator().manual_seed(stage)
                    ).to(card)
    valid = torch.tensor([t - 229], dtype=torch.int32, device=card)
    got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, 3)
    want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid, 3)
    torch.cuda.synchronize()
    assert snr_db(want, got) >= 35.0
    assert not got[t - 229:].any()
    assert np.isfinite(got.cpu().numpy()).all()
