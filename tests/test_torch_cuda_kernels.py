"""The CUDA kernels against their plain versions, on the card.  These
tests need a CUDA device and nvcc, and skip without them; on a machine
with a card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from efficientspeech_tpu_torch.config import HifiGanConfig, ModelConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, kernel_op_shapes, prepare_for_kernels)
from efficientspeech_tpu_torch.models.modules import reset_parameters
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.ops.kernels import adpcm
from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
from efficientspeech_tpu_torch.ops.kernels import int8_window as k5
from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3
from efficientspeech_tpu_torch.ops.kernels import mrf_block
from efficientspeech_tpu_torch.training.step import forward_losses

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


# bf16 kernels against float32 plain versions: bf16 operand rounding;
# float32 kernels: float32 accuracy (3xTF32 split products in K1, K2
# and K4, the CUDA cores in K3), sums in another order; one TF32
# product would land near the bf16 figures, so this bar shows none did
SNR_BAR = {torch.bfloat16: 35.0, torch.float32: 90.0}
# regression floors of K4's bf16 backward beside that bar, by width and
# output: about 6 dB under the least the card gives it over this file's
# cases (NVIDIA H100 80GB HBM3; each test records its readings, see
# --junitxml), C = 128 / 256: dx 76.0 / 70.5, dw_w
# 84.2 / 80.7, dw_b 93.3 / 85.9, pw_w 84.9 / 81.7, pw_b 94.5 / 95.2,
# ln_s 88.4 / 87.4, ln_b 151.2 / 148.7; dx no lower than 74 / 70.  A
# build whose compiler contracted the depthwise's bf16 multiply and add
# gave 46-58 dB
BF16_BWD_FLOOR_DB = {
    128: {"dx": 74.0, "dw_w": 78.0, "dw_b": 87.0, "pw_w": 78.0,
          "pw_b": 88.0, "ln_s": 82.0, "ln_b": 145.0},
    256: {"dx": 70.0, "dw_w": 74.0, "dw_b": 79.0, "pw_w": 75.0,
          "pw_b": 89.0, "ln_s": 81.0, "ln_b": 142.0}}


# regression floors of the other bf16 kernels, about 6 dB under the least
# the card gives them over this file's cases (NVIDIA H100 80GB HBM3, 700
# W; the tests record their readings): K4's forward (y) by width, C = 128
# / 256: 88.8 / 88.0; K1 at each main-path op shape, up0-3 60.5 / 60.1 /
# 60.1 / 60.1, post 59.4; K3 by width and output, C = 128 / 256: y 94.0 /
# 100.3, dx 147.2 / 100.3, dscale 134.6 / 136.1, dbias 160.6 / 165.6
BF16_FWD_FLOOR_DB = {128: 82.0, 256: 82.0}
K1_BF16_FLOOR_DB = {"up0": 54.0, "up1": 54.0, "up2": 54.0, "up3": 54.0,
                    "post": 53.0}
K3_BF16_FLOOR_DB = {
    128: {"y": 88.0, "dx": 141.0, "dscale": 128.0, "dbias": 154.0},
    256: {"y": 94.0, "dx": 94.0, "dscale": 130.0, "dbias": 159.0}}


@pytest.fixture(scope="module")
def folded_f32(card):
    """The LJ_V2-width vocoder folded in float32 (the serving dtype of
    --precision f32), with its per-stage MRF specs."""
    cfg = HifiGanConfig()
    gen = HifiGanGenerator(cfg)
    reset_parameters(gen, 0)
    arrays, meta = fold_hifigan(gen.to(card), torch.float32)
    return prepare_for_kernels(arrays, meta, cfg)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("t,d_out,w,extras,key", [
    (1000, 512, 1, False, "up0"), (777, 16, 1, False, "post"),
    (300, 128, 13, True, "rb0_2_c1_2")])
def test_folded_matmul_kernel(card, request, dtype, t, d_out, w, extras,
                              key):
    """K1 against its plain version: bf16 on random weights, float32 on
    the float32-folded vocoder's op ``key``."""
    g = torch.Generator(device="cpu").manual_seed(t)
    x = torch.randn(t, 128, generator=g).to(card)
    if dtype == torch.float32:
        W, b = request.getfixturevalue("folded_f32")[0][key]
        assert W.dtype == dtype and W.shape == ((2 * w + 1) * 128, d_out)
    else:
        W = (torch.randn((2 * w + 1) * 128, d_out, generator=g) * 0.05
             ).to(card, torch.bfloat16)
        b = torch.randn(d_out, generator=g).to(card)
    res = torch.randn(t, d_out, generator=g).to(card) if extras else None
    valid = torch.tensor([t - 137], dtype=torch.int32, device=card)
    kw = dict(residual=res, accum=res, out_scale=1 / 3 if extras else None,
              pre_lrelu=True, lrelu_slope=0.01 if d_out == 16 else 0.1)
    before = dict(fm.launches)
    got = fm.folded_matmul(x, W, b, w, valid, **kw)
    want = fm.folded_matmul_plain(x, W, b, w, valid, **kw)
    torch.cuda.synchronize()
    assert fm.launches[dtype] == before[dtype] + 1
    assert snr_db(want, got) >= SNR_BAR[dtype]
    assert not got[t - 137:].any()


def _k1_case(card, dtype, t, d_out, w, valid_rows, extras=False, seed=0,
             floor=0.0):
    """K1 with W in ``dtype`` on random inputs against its plain version:
    one launch of that variant, SNR >= 35 dB (bf16) or 90 dB (float32,
    3xTF32) and >= ``floor`` over the valid rows, rows at or beyond valid
    exactly zero.  Returns the SNR (None without a valid row)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(t, 128, generator=g).to(card)
    W = (torch.randn((2 * w + 1) * 128, d_out, generator=g) * 0.05
         ).to(card, dtype)
    b = torch.randn(d_out, generator=g).to(card)
    res = torch.randn(t, d_out, generator=g).to(card) if extras else None
    acc = torch.randn(t, d_out, generator=g).to(card) if extras else None
    valid = torch.tensor([valid_rows], dtype=torch.int32, device=card)
    kw = dict(residual=res, accum=acc, out_scale=1 / 3 if extras else None,
              pre_lrelu=True, lrelu_slope=0.01 if d_out == 16 else 0.1)
    before = fm.launches[dtype]
    got = fm.folded_matmul(x, W, b, w, valid, **kw)
    want = fm.folded_matmul_plain(x, W, b, w, valid, **kw)
    torch.cuda.synchronize()
    assert fm.launches[dtype] == before + 1
    assert torch.isfinite(got).all()
    assert not got[valid_rows:].any()
    if valid_rows > 0:
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        assert snr >= SNR_BAR[dtype], snr
        assert snr >= floor, snr
        return snr
    return None


@pytest.mark.parametrize("key", ["up0", "up1", "up2", "up3", "post"])
def test_folded_matmul_bf16_main_path_shapes(card, key, record_property):
    """K1 bf16 at each op shape of the serving path for 2,048 frames, also
    at its regression floor."""
    ops, _ = kernel_op_shapes(HifiGanConfig(), 2048)
    (t, d_in, d_out, w), = [op[1:] for op in ops if op[0] == key]
    assert d_in == 128
    snr = _k1_case(card, torch.bfloat16, t, d_out, w, t - t // 16,
                   floor=K1_BF16_FLOOR_DB[key])
    record_property("snr_db", round(snr, 1))


@pytest.mark.parametrize("t,d_out,w,valid_rows,extras", [
    pytest.param(1000, 128, 1, 1000 - 137, False, id="T-not-tile-multiple"),
    pytest.param(777, 16, 1, 777 - 5, False, id="T-not-tile-multiple-post"),
    pytest.param(4096, 512, 1, 0, False, id="valid-0"),
    pytest.param(3000, 128, 1, 3000, False, id="valid-T"),
    pytest.param(4096, 128, 2, 4096 - 300, False, id="w2-probe-route"),
    pytest.param(1000, 128, 13, 1000 - 137, True, id="w13-res-acc-scale"),
    pytest.param(500, 64, 1, 431, False, id="d_out-64"),
    pytest.param(500, 32, 3, 431, True, id="d_out-32")])
def test_folded_matmul_bf16_edges(card, t, d_out, w, valid_rows, extras):
    """K1 bf16 at the edges of its tile plan: a ragged last tile, every
    row or no row valid, the probe's resident w = 2 panel, the streamed
    w = 13 panel with every epilogue operand, and narrower panels."""
    _k1_case(card, torch.bfloat16, t, d_out, w, valid_rows, extras,
             seed=t + w)


def test_folded_matmul_bf16_refuses(card):
    """What the bf16 kernel does not take raises before any launch."""
    x = torch.zeros(64, 96, device=card)
    W = torch.zeros(3 * 96, 128, dtype=torch.bfloat16, device=card)
    b = torch.zeros(128, device=card)
    valid = torch.tensor([64], dtype=torch.int32, device=card)
    before = dict(fm.launches)
    with pytest.raises(ValueError, match="multiple of 64"):
        fm.folded_matmul(x, W, b, 1, valid)
    assert fm.launches == before


@pytest.mark.parametrize("key", ["up0", "up1", "up2", "up3", "post"])
def test_folded_matmul_f32_main_path_shapes(card, key):
    """K1 float32 at each op shape of the serving path for 2,048 frames:
    one 64-row chunk a warpgroup (up0), two (up1-up3), and the post conv's
    16-column panel split over the rows."""
    ops, _ = kernel_op_shapes(HifiGanConfig(), 2048)
    (t, d_in, d_out, w), = [op[1:] for op in ops if op[0] == key]
    assert d_in == 128
    _k1_case(card, torch.float32, t, d_out, w, t - t // 16)


@pytest.mark.parametrize("t,d_out,w,valid_rows,extras", [
    pytest.param(1000, 128, 1, 1000 - 137, False, id="T-not-tile-multiple"),
    pytest.param(777, 16, 1, 777 - 5, False, id="T-not-tile-multiple-post"),
    pytest.param(4096, 512, 1, 0, False, id="valid-0"),
    pytest.param(3000, 128, 1, 3000, False, id="valid-T"),
    pytest.param(4096, 128, 2, 4096 - 300, False, id="w2"),
    pytest.param(1000, 128, 13, 1000 - 137, True, id="w13-res-acc-scale"),
    pytest.param(500, 64, 1, 431, False, id="d_out-64"),
    pytest.param(500, 32, 3, 431, True, id="d_out-32")])
def test_folded_matmul_f32_edges(card, t, d_out, w, valid_rows, extras):
    """K1 float32 at the edges of its tile plan: a ragged last tile, every
    row or no row valid, wider windows with every epilogue operand, and
    the 64- and 32-column panels split over the rows."""
    _k1_case(card, torch.float32, t, d_out, w, valid_rows, extras,
             seed=t + w)


@pytest.mark.parametrize("stage,t,valid_rows,tm", [
    pytest.param(0, 8192, 8192 - 512, None, id="stage0-2048-frames"),
    pytest.param(1, 32768, 32768 - 2048, None, id="stage1-2048-frames"),
    pytest.param(2, 32768, 32768 - 2048, None, id="stage2-2048-frames"),
    pytest.param(3, 32768, 32768 - 2048, None, id="stage3-2048-frames"),
    pytest.param(1, 3000, 0, None, id="valid-0"),
    pytest.param(2, 3000, 3000, None, id="valid-T"),
    pytest.param(0, 1000, 1000 - 229, 32, id="stage0-tm32"),
    pytest.param(3, 1000, 1000 - 229, 112, id="stage3-tm112")])
def test_mrf_f32_kernel_plans(card, folded_f32, stage, t, valid_rows, tm):
    """K2 float32 (3xTF32) at the main path's stage lengths and at other
    tile heights of its plan: SNR >= 90 dB over the valid rows, rows at
    or beyond valid exactly zero."""
    chains, W_all, b_all, H = folded_f32[1][stage]
    x = torch.randn(t, 128, generator=torch.Generator().manual_seed(t)
                    ).to(card)
    valid = torch.tensor([valid_rows], dtype=torch.int32, device=card)
    before = mrf_block.launches[torch.float32]
    got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, 3, tm=tm)
    want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid, 3)
    torch.cuda.synchronize()
    assert mrf_block.launches[torch.float32] == before + 1
    assert torch.isfinite(got).all()
    assert not got[valid_rows:].any()
    if valid_rows > 0:
        assert snr_db(want[:valid_rows], got[:valid_rows]) >= 90.0


@pytest.fixture(scope="module")
def folded_bf16(card):
    """The LJ_V2-width vocoder folded in bf16 (the serving dtype of bf16
    requests), with its per-stage MRF specs."""
    cfg = HifiGanConfig()
    gen = HifiGanGenerator(cfg)
    reset_parameters(gen, 0)
    arrays, meta = fold_hifigan(gen.to(card), torch.bfloat16)
    return prepare_for_kernels(arrays, meta, cfg)


@pytest.mark.parametrize("stage,t,valid_rows,tm", [
    pytest.param(0, 8192, 8192 - 512, None, id="stage0-2048-frames"),
    pytest.param(1, 32768, 32768 - 2048, None, id="stage1-2048-frames"),
    pytest.param(2, 32768, 32768 - 2048, None, id="stage2-2048-frames"),
    pytest.param(3, 32768, 32768 - 2048, None, id="stage3-2048-frames"),
    pytest.param(1, 3000, 0, None, id="valid-0"),
    pytest.param(2, 3000, 3000, None, id="valid-T"),
    pytest.param(0, 1000, 1000 - 229, 128, id="stage0-tm128"),
    pytest.param(3, 1000, 1000 - 229, 32, id="stage3-tm32")])
def test_mrf_bf16_kernel_plans(card, folded_bf16, stage, t, valid_rows, tm):
    """K2 bf16 (wgmma with the weight ring) at the main path's stage
    lengths and at other tile heights of its plan: SNR >= 35 dB over the
    valid rows, rows at or beyond valid exactly zero, every output
    finite, one launch counted."""
    chains, W_all, b_all, H = folded_bf16[1][stage]
    assert W_all.dtype == torch.bfloat16
    x = torch.randn(t, 128, generator=torch.Generator().manual_seed(t)
                    ).to(card)
    valid = torch.tensor([valid_rows], dtype=torch.int32, device=card)
    before = mrf_block.launches[torch.bfloat16]
    got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, 3, tm=tm)
    want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid, 3)
    torch.cuda.synchronize()
    assert mrf_block.launches[torch.bfloat16] == before + 1
    assert torch.isfinite(got).all()
    assert not got[valid_rows:].any()
    if valid_rows > 0:
        assert snr_db(want[:valid_rows], got[:valid_rows]) >= 35.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mrf_kernel(card, request, stage, dtype):
    if dtype == torch.float32:
        _, mrf = request.getfixturevalue("folded_f32")
    else:
        cfg = HifiGanConfig()
        gen = HifiGanGenerator(cfg)
        reset_parameters(gen, 0)
        arrays, meta = fold_hifigan(gen.to(card), torch.bfloat16)
        arrays, mrf = prepare_for_kernels(arrays, meta, cfg)
    chains, W_all, b_all, H = mrf[stage]
    assert W_all.dtype == dtype
    t = 1000
    x = torch.randn(t, 128, generator=torch.Generator().manual_seed(stage)
                    ).to(card)
    valid = torch.tensor([t - 229], dtype=torch.int32, device=card)
    before = dict(mrf_block.launches)
    got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, 3)
    want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid, 3)
    torch.cuda.synchronize()
    assert mrf_block.launches[dtype] == before[dtype] + 1
    assert snr_db(want, got) >= SNR_BAR[dtype]
    assert not got[t - 229:].any()
    assert np.isfinite(got.cpu().numpy()).all()


@pytest.mark.parametrize("rows,frames", [(32, 1024), (1, 512)])
def test_serving_shapes_take_the_kernel_route(card, rows, frames,
                                              record_property):
    """At the short-sentence server's batches (32 rows at 1,024 frames,
    bf16, the int16 wire) and a single row at 512 frames, the folded
    vocoder takes the kernel route: K1 5 and K2 4 launches a row, every
    row counted under ``synth.vocoder.kernel_rows``; its wire matches the
    plain route's at the bf16 kernels' bar over the valid samples and is
    zero beyond them."""
    from efficientspeech_tpu_torch.audio.transfer import encode_device
    from efficientspeech_tpu_torch.infer import build_synthesizer
    from efficientspeech_tpu_torch.utils import spans

    synth = build_synthesizer(preset="tiny", dtype=torch.bfloat16,
                              bench_duration_bias=6.0, transfer="int16",
                              device=card)
    g = torch.Generator().manual_seed(rows)
    mel = (torch.randn(rows, frames, synth.cfg.n_mel_channels, generator=g)
           * 2.0 - 5.0).to(card)
    mel_len = (frames - torch.randint(0, frames // 4, (rows,),
                                      generator=g)).to(card)

    def wire(mode):
        synth.vocoder_mode = mode
        with torch.no_grad():
            return encode_device(synth._vocode_folded(mel, mel_len),
                                 "int16").float() / 32768.0

    before = (dict(fm.launches), dict(mrf_block.launches),
              spans.counters(synth.span_id))
    got = wire("folded_kernel")
    torch.cuda.synchronize()
    after = spans.counters(synth.span_id)
    assert (fm.launches[torch.bfloat16] - before[0][torch.bfloat16],
            mrf_block.launches[torch.bfloat16] - before[1][torch.bfloat16]
            ) == (5 * rows, 4 * rows)
    assert after.get("synth.vocoder.kernel_rows", 0) - before[2].get(
        "synth.vocoder.kernel_rows", 0) == rows
    assert after.get("synth.vocoder.plain_rows", 0) == before[2].get(
        "synth.vocoder.plain_rows", 0)
    want = wire("folded")
    up = synth.hifigan_cfg.total_upsample
    worst = float("inf")
    for i, n in enumerate(mel_len.tolist()):
        assert not got[i, n * up:].any() and not want[i, n * up:].any()
        worst = min(worst, snr_db(want[i, :n * up], got[i, :n * up]))
    record_property("snr_db", worst)
    assert worst >= SNR_BAR[torch.bfloat16], worst


@pytest.mark.parametrize("rows,c,dtype", [
    (1001, 128, torch.bfloat16), (517, 256, torch.bfloat16),
    (300, 128, torch.float32)])
def test_layer_norm_kernel(card, rows, c, dtype, record_property):
    """K3 forward and backward against the plain version: y, dx, dscale
    and dbias each at SNR >= 35 dB, the bf16 ones also at their
    regression floors."""
    g = torch.Generator(device="cpu").manual_seed(rows)
    x = (torch.randn(rows, c, generator=g) * 2 + 0.5).to(card, dtype)
    s = (torch.randn(c, generator=g) * 0.5 + 1).to(card)
    b = (torch.randn(c, generator=g) * 0.1).to(card)
    dy = torch.randn(rows, c, generator=g).to(card, dtype)
    got = [k3.layer_norm_fwd(x, s, b), *k3.layer_norm_bwd(x, s, dy)]
    want = [k3.layer_norm_fwd_plain(x, s, b),
            *k3.layer_norm_bwd_plain(x, s, dy)]
    torch.cuda.synchronize()
    floors = K3_BF16_FLOOR_DB[c] if dtype == torch.bfloat16 else {}
    for name, a, w in zip(("y", "dx", "dscale", "dbias"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        snr = snr_db(w, a)
        record_property(f"snr_db {name}", round(snr, 1))
        assert snr >= 35.0, name
        assert snr >= floors.get(name, 0.0), (name, snr)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,m,c", [
    pytest.param(3, 200, 128, id="3-200"),
    pytest.param(2, 1024, 128, id="2-1024"),
    pytest.param(3, 200, 256, id="3-200-C256"),
    pytest.param(2, 1024, 256, id="2-1024-C256")])
def test_decoder_block_kernel(card, b, m, c, dtype, record_property):
    """K4 forward and backward against the plain version on a keep mask
    with padded tails: y, dx and the six weight gradients each at
    SNR >= 35 dB (bf16) or 90 dB (float32), the bf16 gradients also at
    their regression floor, dx exactly zero on padded frames."""
    k = 5
    g = torch.Generator(device="cpu").manual_seed(m)
    f = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(card)
    x = f(b, m, c).to(dtype)
    keep = torch.ones(b, m, device=card)
    keep[0, m - m // 6:] = 0
    keep[-1, m // 2:] = 0
    weights = [f(c, 1, k, s=0.4), f(c, s=0.1), f(c, c, 1, s=0.09),
               f(c, s=0.1), 1 + f(c, s=0.2), f(c, s=0.1)]
    dy = f(b, m, c).to(dtype)
    before = (dict(k4.launches_fwd), dict(k4.launches_bwd))
    y = k4.decoder_block_fwd(x, keep, *weights)
    y_plain = k4.decoder_block_fwd_plain(x, keep, *weights)
    grads = k4.decoder_block_bwd(x, keep, *weights[:5], dy)
    grads_plain = k4.decoder_block_bwd_plain(x, keep, *weights[:5], dy)
    torch.cuda.synchronize()
    for counts, was in zip((k4.launches_fwd, k4.launches_bwd), before):
        assert counts[c, dtype] == was[c, dtype] + 1
    assert y.dtype == dtype and snr_db(y_plain, y) >= SNR_BAR[dtype]
    record_property("snr_db y", round(snr_db(y_plain, y), 1))
    if dtype == torch.bfloat16:
        assert snr_db(y_plain, y) >= BF16_FWD_FLOOR_DB[c], snr_db(y_plain, y)
    names = ("dx", "dw_w", "dw_b", "pw_w", "pw_b", "ln_s", "ln_b")
    floors = BF16_BWD_FLOOR_DB[c] if dtype == torch.bfloat16 else {}
    for name, a, w in zip(names, grads, grads_plain):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        record_property(f"snr_db {name}", round(snr_db(w, a), 1))
        assert snr_db(w, a) >= SNR_BAR[dtype], name
        assert snr_db(w, a) >= floors.get(name, 0.0), (name, snr_db(w, a))
    assert not grads[0][keep == 0].any()


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("case", ["below-one-tile", "one-tile",
                                  "one-past-tile", "masked-sequence",
                                  "small-grid"])
def test_decoder_block_f32_fwd_edges(card, c, case):
    """The float32 forward (3xTF32 on the tensor cores) at its edges: a
    sequence shorter than one tile, exactly one tile, one row past a
    tile, a fully masked sequence, and a grid smaller than the tile count;
    a few frames keep half their input.  y at SNR >= 90 dB against the
    plain version, and two launches bit-equal."""
    k, rows = 5, k4.f32_fwd_plan(c).tile_rows
    b, m, grid = {"below-one-tile": (3, rows // 2, None),
                  "one-tile": (3, rows, None),
                  "one-past-tile": (2, rows + 1, None),
                  "masked-sequence": (3, 2 * rows, None),
                  "small-grid": (4, 5 * rows + 7, 3)}[case]
    g = torch.Generator(device="cpu").manual_seed(c + m)
    f = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(card)
    x = f(b, m, c)
    keep = torch.ones(b, m, device=card)
    keep[0, m - m // 5:] = 0
    keep[-1, 1::7] = 0.5
    if case == "masked-sequence":
        keep[1] = 0
    weights = [f(c, 1, k, s=0.4), f(c, s=0.1),
               f(c, c, 1, s=0.09 * (128 / c) ** 0.5), f(c, s=0.1),
               1 + f(c, s=0.2), f(c, s=0.1)]
    assert grid is None or grid < b * -(-m // rows)
    y = k4.decoder_block_fwd(x, keep, *weights, grid=grid)
    again = k4.decoder_block_fwd(x, keep, *weights, grid=grid)
    plain = k4.decoder_block_fwd_plain(x, keep, *weights)
    torch.cuda.synchronize()
    assert y.dtype == plain.dtype and y.shape == plain.shape
    assert snr_db(plain, y) >= SNR_BAR[torch.float32], snr_db(plain, y)
    assert torch.equal(y, again)


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("case", ["below-one-tile", "one-past-owned",
                                  "masked-sequence", "small-grid"])
def test_decoder_block_f32_bwd_edges(card, c, case):
    """The float32 backward (3xTF32 on the tensor cores) at its edges: a
    sequence shorter than one tile, one row past a multiple of the owned
    rows, a fully masked sequence, and a grid smaller than the tile
    count.  Each output at SNR >= 90 dB against the plain version, dx
    exactly zero on masked frames, and two launches bit-equal."""
    k, own = 5, k4.f32_bwd_plan(c).owned_rows
    b, m, grid = {"below-one-tile": (3, own // 2, None),
                  "one-past-owned": (2, 3 * own + 1, None),
                  "masked-sequence": (3, 2 * own, None),
                  "small-grid": (4, 5 * own + 7, 3)}[case]
    g = torch.Generator(device="cpu").manual_seed(c + m)
    f = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(card)
    x = f(b, m, c)
    keep = torch.ones(b, m, device=card)
    keep[0, m - m // 5:] = 0
    if case == "masked-sequence":
        keep[1] = 0
    weights = [f(c, 1, k, s=0.4), f(c, s=0.1),
               f(c, c, 1, s=0.09 * (128 / c) ** 0.5), f(c, s=0.1),
               1 + f(c, s=0.2)]
    dy = f(b, m, c)
    assert grid is None or grid < b * -(-m // own)
    grads = k4.decoder_block_bwd(x, keep, *weights, dy, grid=grid)
    again = k4.decoder_block_bwd(x, keep, *weights, dy, grid=grid)
    plain = k4.decoder_block_bwd_plain(x, keep, *weights, dy)
    torch.cuda.synchronize()
    names = ("dx", "dw_w", "dw_b", "pw_w", "pw_b", "ln_s", "ln_b")
    for name, a, a2, w in zip(names, grads, again, plain):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert snr_db(w, a) >= SNR_BAR[torch.float32], name
        assert torch.equal(a, a2), name
    assert not grads[0][keep == 0].any()


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("case", ["one-frame", "below-one-tile",
                                  "one-past-owned", "masked-sequence",
                                  "large-grid", "one-sequence"])
def test_decoder_block_bf16_bwd_edges(card, c, case, record_property):
    """The bf16 backward (wgmma; a tile over a cluster of C / 128 blocks)
    at its edges: M = 1, a sequence shorter than one tile, one row past a
    multiple of the owned rows, a fully masked sequence, a grid of more
    clusters than tiles, and B = 1 at the training length.  Each output
    at SNR >= 35 dB against the plain version, dx exactly zero on masked
    frames, and two launches bit-equal; each output also at the bf16
    backward's regression floor."""
    k = 5
    plan = k4.bf16_bwd_plan(c)
    own = plan.owned_rows
    b, m, clusters = {"one-frame": (3, 1, None),
                      "below-one-tile": (3, own // 2, None),
                      "one-past-owned": (2, 3 * own + 1, None),
                      "masked-sequence": (3, 2 * own, None),
                      "large-grid": (2, own + 7, 9),
                      "one-sequence": (1, 1024, None)}[case]
    grid = None if clusters is None else clusters * plan.cluster
    g = torch.Generator(device="cpu").manual_seed(c + m)
    f = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(card)
    x = f(b, m, c).to(torch.bfloat16)
    keep = torch.ones(b, m, device=card)
    keep[0, m - m // 5:] = 0
    if case == "masked-sequence":
        keep[1] = 0
    weights = [f(c, 1, k, s=0.4), f(c, s=0.1),
               f(c, c, 1, s=0.09 * (128 / c) ** 0.5), f(c, s=0.1),
               1 + f(c, s=0.2)]
    dy = f(b, m, c).to(torch.bfloat16)
    assert clusters is None or clusters > b * -(-m // own)
    grads = k4.decoder_block_bwd(x, keep, *weights, dy, grid=grid)
    again = k4.decoder_block_bwd(x, keep, *weights, dy, grid=grid)
    plain = k4.decoder_block_bwd_plain(x, keep, *weights, dy)
    torch.cuda.synchronize()
    names = ("dx", "dw_w", "dw_b", "pw_w", "pw_b", "ln_s", "ln_b")
    for name, a, a2, w in zip(names, grads, again, plain):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        record_property(f"snr_db {name}", round(snr_db(w, a), 1))
        assert snr_db(w, a) >= SNR_BAR[torch.bfloat16], name
        assert snr_db(w, a) >= BF16_BWD_FLOOR_DB[c][name], (name,
                                                            snr_db(w, a))
        assert torch.equal(a, a2), name
    assert not grads[0][keep == 0].any()


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("case", ["one-frame", "below-one-tile", "one-tile",
                                  "one-past-tile", "m-1000",
                                  "masked-sequence", "small-grid"])
def test_decoder_block_bf16_fwd_edges(card, c, case, record_property):
    """The bf16 forward (wgmma; x by TMA) at its edges: M = 1, a sequence
    shorter than one tile, exactly one tile, one row past it, M = 1000, a
    fully masked sequence, and a grid smaller than the tile count; a few
    frames keep half their input.  y is written into a tensor with NaN
    rows on either side: at SNR >= 35 dB against the plain version and
    at the bf16 forward's regression floor, every element written, none
    of the NaN rows around it, and two launches bit-equal."""
    k, rows = 5, k4.bf16_fwd_plan(c).tile_rows
    b, m, grid = {"one-frame": (3, 1, None),
                  "below-one-tile": (3, rows // 2, None),
                  "one-tile": (3, rows, None),
                  "one-past-tile": (2, rows + 1, None),
                  "m-1000": (2, 1000, None),
                  "masked-sequence": (3, 2 * rows, None),
                  "small-grid": (4, 5 * rows + 7, 3)}[case]
    g = torch.Generator(device="cpu").manual_seed(c + m)
    f = lambda *shape, s=1.0: (torch.randn(*shape, generator=g) * s).to(card)
    x = f(b, m, c).to(torch.bfloat16)
    keep = torch.ones(b, m, device=card)
    keep[0, m - m // 5:] = 0
    keep[-1, 1::7] = 0.5
    if case == "masked-sequence":
        keep[1] = 0
    weights = [f(c, 1, k, s=0.4), f(c, s=0.1),
               f(c, c, 1, s=0.09 * (128 / c) ** 0.5), f(c, s=0.1),
               1 + f(c, s=0.2), f(c, s=0.1)]
    assert grid is None or grid < b * -(-m // rows)
    # y between `rows` NaN rows on either side
    pad = rows * c
    buf = torch.full((b * m * c + 2 * pad,), float("nan"),
                     dtype=torch.bfloat16, device=card)
    y = buf[pad:pad + b * m * c].view(b, m, c)
    before = k4.launches_fwd[c, torch.bfloat16]
    k4.decoder_block_fwd(x, keep, *weights, grid=grid, out=y)
    again = k4.decoder_block_fwd(x, keep, *weights, grid=grid)
    plain = k4.decoder_block_fwd_plain(x, keep, *weights)
    torch.cuda.synchronize()
    assert k4.launches_fwd[c, torch.bfloat16] == before + 2
    assert torch.isnan(buf[:pad]).all() and torch.isnan(buf[-pad:]).all()
    assert torch.isfinite(y).all()
    assert y.dtype == plain.dtype and y.shape == plain.shape
    snr = snr_db(plain, y)
    record_property("snr_db y", round(snr, 1))
    assert snr >= SNR_BAR[torch.bfloat16], snr
    assert snr >= BF16_FWD_FLOOR_DB[c], snr
    assert torch.equal(y, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_decoder_block_fwd_refuses_out_over_x(card, dtype):
    """The forward's ``out`` may not overlap x on the card: the kernel
    reads x's rows while it writes y's.  A separate tensor is taken."""
    c, k = 128, 5
    g = torch.Generator(device="cpu").manual_seed(9)
    f = lambda *shape: torch.randn(*shape, generator=g).to(card)
    buf = f(2 * 3 * 64 * c).to(dtype)
    x = buf[:3 * 64 * c].view(3, 64, c)
    keep = torch.ones(3, 64, device=card)
    weights = [f(c, 1, k), f(c), f(c, c, 1) * 0.09, f(c), f(c), f(c)]
    before = k4.launches_fwd[c, dtype]
    for out in (x, buf[32 * c:32 * c + 3 * 64 * c].view(3, 64, c)):
        with pytest.raises(ValueError, match="must not overlap x"):
            k4.decoder_block_fwd(x, keep, *weights, out=out)
    assert k4.launches_fwd[c, dtype] == before
    y = buf[3 * 64 * c:].view(3, 64, c)
    assert k4.decoder_block_fwd(x, keep, *weights, out=y) is y
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()


def test_decoder_block_bf16_fwd_plan_matches_kernel(card):
    """The library's bf16 forward geometry is bf16_fwd_plan's."""
    lib = k4._lib()
    for c in (128, 256):
        k4.check_bf16_fwd_plan(lib, c)
        fields = len(k4.bf16_fwd_plan(c))
        assert lib.decoder_block_bf16_fwd_plan(c, fields) == -1
    assert lib.decoder_block_bf16_fwd_plan(384, 0) == -1


def test_decoder_block_bf16_bwd_plan_matches_kernel(card):
    """The library's bf16 backward geometry is bf16_bwd_plan's, and at
    least one of its clusters fits the card."""
    lib = k4._lib()
    for c in (128, 256):
        k4.check_bf16_bwd_plan(lib, c)
        fields = len(k4.bf16_bwd_plan(c))
        assert lib.decoder_block_bf16_bwd_plan(c, fields) == -1
        assert lib.decoder_block_bwd_clusters(c) >= 1
    assert lib.decoder_block_bf16_bwd_plan(384, 0) == -1
    assert lib.decoder_block_bwd_clusters(384) == 0


def test_decoder_block_f32_fwd_plan_matches_kernel(card):
    """The library's float32 forward geometry is f32_fwd_plan's."""
    lib = k4._lib()
    for c in (128, 256):
        k4.check_f32_fwd_plan(lib, c)
        fields = len(k4.f32_fwd_plan(c))
        assert lib.decoder_block_f32_fwd_plan(c, fields) == -1
    assert lib.decoder_block_f32_fwd_plan(384, 0) == -1


def test_decoder_block_f32_bwd_plan_matches_kernel(card):
    """The library's float32 backward geometry is f32_bwd_plan's."""
    lib = k4._lib()
    for c in (128, 256):
        k4.check_f32_bwd_plan(lib, c)
        fields = len(k4.f32_bwd_plan(c))
        assert lib.decoder_block_f32_bwd_plan(c, fields) == -1
    assert lib.decoder_block_f32_bwd_plan(384, 0) == -1


@pytest.mark.parametrize("c,dtype", [(384, torch.bfloat16),
                                     (128, torch.float16),
                                     (256, torch.float16),
                                     (384, torch.float32)])
def test_decoder_block_kernel_refuses(card, c, dtype):
    """A decoder the kernel is not built for (a width other than 128 and
    256, or a dtype other than bf16 and float32) raises on the card
    instead of taking the plain version."""
    with pytest.raises(NotImplementedError, match="cannot run on the card"):
        k4.check_supported(c, dtype)
    # the library is built for exactly the variants check_supported names:
    # each plan query answers for those and returns -1 for another width
    lib = k4._lib()
    plans = {0: (lib.decoder_block_bf16_fwd_plan,
                 lib.decoder_block_bf16_bwd_plan),
             1: (lib.decoder_block_f32_fwd_plan,
                 lib.decoder_block_f32_bwd_plan)}
    assert [(w, f32) for w in (128, 256, 384) for f32 in (0, 1)
            if all(q(w, 0) > 0 for q in plans[f32])] == [
                (c_, int(dt == torch.float32)) for c_, dt in k4.VARIANTS]
    x = torch.zeros(1, 16, c, dtype=dtype, device=card)
    keep = torch.ones(1, 16, device=card)
    weights = [torch.zeros(shape, device=card) for shape in
               ((c, 1, 5), (c,), (c, c, 1), (c,), (c,), (c,))]
    with pytest.raises(NotImplementedError, match="cannot run on the card"):
        k4.decoder_block_fused(x, keep, *weights)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("preset,width,k3_per_dir,k4_per_dir", [
    ("tiny", 128, 3, 4), ("small", 256, 4, 6), ("base", 256, 4, 9)])
def test_fused_decoder_launches_per_preset(card, preset, width, k3_per_dir,
                                           k4_per_dir, dtype):
    """Every preset's train-mode forward and backward, in bf16 and in
    float32, goes through K3 (proj_norm and each block's skip norm) and K4
    (every block body), at the preset's decoder width and in the compute
    dtype, with finite losses."""
    cfg = ModelConfig.preset(preset, max_phoneme_len=32, max_mel_len=256)
    model = Phoneme2Mel(cfg, fused_decoder_norm=True,
                        fused_decoder_block=True)
    reset_parameters(model, 0)
    model.to(card)
    k4.check_supported(model.decoder.proj_norm.weight.shape[0], dtype)
    g = np.random.default_rng(0)
    n, m, b = 32, 256, 2
    duration = g.integers(1, 8, (b, n))
    mel_len = np.minimum(duration.sum(1), m)
    batch = {
        "phoneme": g.integers(1, 140, (b, n)), "phoneme_mask":
        np.zeros((b, n), bool), "pitch": g.normal(size=(b, n)),
        "energy": g.normal(size=(b, n)), "duration": duration,
        "mel": g.normal(size=(b, m, 80)),
        "mel_mask": np.arange(m)[None, :] >= mel_len[:, None]}
    batch = {k: torch.from_numpy(v).to(card) for k, v in batch.items()}
    for key in ("pitch", "energy", "mel"):
        batch[key] = batch[key].float()
    for d in (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
              k4.launches_bwd):
        d.update(dict.fromkeys(d, 0))
    loss = forward_losses(model, batch, dtype)["loss"]
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert k3.launches_fwd == {v: k3_per_dir if v == (width, dtype) else 0
                               for v in k3.VARIANTS}
    assert k3.launches_bwd == k3.launches_fwd
    assert k4.launches_fwd == {v: k4_per_dir if v == (width, dtype) else 0
                               for v in k4.VARIANTS}
    assert k4.launches_bwd == k4.launches_fwd


@pytest.mark.parametrize("quantize", [True, False], ids=["bf16", "int8"])
@pytest.mark.parametrize("t,tm,n_win", [
    (4096, 512, 5), (4096, 256, 5), (1000, 256, 3),
    (1000, 160, 5),   # 96 + 64 rows a cluster: not a multiple of its rows
    (300, 96, 3)])    # a cluster of one block
def test_int8_window_kernel(card, quantize, t, tm, n_win):
    """K5 against its plain version: the int32 sums are exact in both and
    the one float32 multiply by the scale rounds alike, so the outputs are
    bit-equal."""
    d_in = d_out = 128
    _, rows = k5.layout(t, tm, n_win)
    g = torch.Generator(device="cpu").manual_seed(t + tm)
    xs = torch.randn(rows, d_in, generator=g)
    x = (xs.to(torch.bfloat16) if quantize
         else torch.clamp(xs * 40, -127, 127).to(torch.int8)).to(card)
    w = torch.randint(-127, 127, (n_win * d_in, d_out), generator=g,
                      dtype=torch.int8).to(card)
    before = (k5.launches_quant, k5.launches_int8)
    got = k5.int8_window_matmul(x, w, n_win, tm)
    want = k5.int8_window_matmul_plain(x, w, n_win, tm)
    torch.cuda.synchronize()
    assert (k5.launches_quant - before[0], k5.launches_int8 - before[1]) \
        == ((1, 0) if quantize else (0, 1))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), float((got - want).abs().max())
    assert float(want.abs().max()) > 0


@pytest.mark.parametrize("bits", [4, 3, 2])
@pytest.mark.parametrize("rows,blocks", [(1, 4096), (3, 33), (5, 1)])
def test_adpcm_encode_kernel(card, bits, rows, blocks):
    """The ADPCM encoder against its plain version, bit for bit (integer
    arithmetic and float32 values that are exact), on random, constant,
    full-scale and clipped blocks, with a last CUDA block of lanes that
    is partly filled (3 x 33 lanes)."""
    g = torch.Generator(device="cpu").manual_seed(rows * 100 + bits)
    x = torch.rand(rows, blocks * 256, generator=g) * 2.4 - 1.2
    flat = x.view(-1, 256)
    flat[0::4] = 0.3                       # constant blocks
    flat[1::4] = torch.where(flat[1::4] > 0, 1.0, -1.0)   # full scale
    flat[2::4] *= 3.0                      # clipped
    x = x.to(card)
    before = dict(adpcm.launches)
    got = adpcm.adpcm_encode(x, bits)
    want = adpcm.adpcm_encode_plain(x, bits)
    torch.cuda.synchronize()
    assert adpcm.launches[bits] == before[bits] + 1
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())


def test_mel_extractor_on_card_ignores_tf32(card, monkeypatch):
    """The mel extractor on the card against the CPU's, with TF32 turned
    on globally first: its mel product runs in float64, so the card's
    log-mel stays within 1e-4 of the CPU's and the energy within 1e-5
    relative (a TF32 product would round the mel to about 1e-3)."""
    from efficientspeech_tpu_torch.audio.stft import MelSpectrogram

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(0)
    t = np.arange(3 * 22050) / 22050
    y = np.stack([0.4 * np.sin(2 * np.pi * (150 + 30 * b) * t)
                  + 0.02 * rng.standard_normal(len(t)) for b in range(2)]
                 ).astype(np.float32)
    want = MelSpectrogram(device="cpu").extract_bucketed(y)
    got = MelSpectrogram(device=card).extract_bucketed(y)
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


@pytest.mark.parametrize("mr_stft_weight", [0.0, 2.5])
def test_gan_step_on_card_matches_cpu(card, mr_stft_weight):
    """One vocoder GAN step (generator width 32, the full MPD and MSD, TF32
    off) on the card against the same step on the CPU from the same
    seeded weights and inputs, in float64 and in float32.

    Float64 shows the card computes the CPU's step: every metric within
    1e-9 relative, every gradient within 1e-9 of its norm (1e-12
    measured).  Float32: every metric within 1e-4 relative, the
    discriminators' gradients within 1e-4 of their norms, and the
    generator's within 5e-4 of the CPU's without the STFT term.  With it
    the generator's float32 gradient carries the rounding of quiet bins'
    log-magnitudes (4.50e-4 of the norm from float64 on the CPU, 4.93e-4
    on the card, 9.23e-4 between them, NVIDIA H100 80GB HBM3, 700 W), so
    it is held to the float64 step instead: the card's distance from it
    at most 1.5 times the CPU's."""
    from efficientspeech_tpu_torch.config import AudioConfig
    from efficientspeech_tpu_torch.training.vocoder import (
        create_vocoder_trainer)

    cfg = HifiGanConfig(upsample_initial_channel=32)
    g = torch.Generator(device="cpu").manual_seed(7)
    mel = torch.randn(2, 16, 80, generator=g) * 2 - 3
    wav = torch.randn(2, 16 * 256, generator=g) * 0.3
    results = {}
    for device, dtype in (("cpu", torch.float64), (card, torch.float64),
                          ("cpu", torch.float32), (card, torch.float32)):
        _, init, step = create_vocoder_trainer(
            cfg, AudioConfig(), mr_stft_weight=mr_stft_weight,
            device=device)
        state = init(seed=3)
        for module in (state.gen, state.mpd, state.msd):
            module.to(dtype)
        state, metrics = step(state, mel.to(device, dtype),
                              wav.to(device, dtype))
        grads = {name: torch.cat([p.grad.flatten().double().cpu()
                                  for p in getattr(state, name).parameters()])
                 for name in ("gen", "mpd", "msd")}
        results[str(device), dtype] = (
            {k: float(v) for k, v in metrics.items()}, grads)

    def rel(a, b, name):
        return float((a[1][name] - b[1][name]).norm() / b[1][name].norm())

    for dtype, m_tol, g_tol in ((torch.float64, 1e-9, 1e-9),
                                (torch.float32, 1e-4, 1e-4)):
        want, got = results["cpu", dtype], results[str(card), dtype]
        assert set(got[0]) == set(want[0])
        for k in want[0]:
            np.testing.assert_allclose(got[0][k], want[0][k], rtol=m_tol,
                                       err_msg=(k, dtype))
        for name in ("gen", "mpd", "msd") if dtype == torch.float64 \
                else ("mpd", "msd"):
            assert rel(got, want, name) <= g_tol, (name, dtype)
    exact = results["cpu", torch.float64]
    cpu32, card32 = results["cpu", torch.float32], results[
        str(card), torch.float32]
    if mr_stft_weight == 0:
        assert rel(card32, cpu32, "gen") <= 5e-4
    assert rel(card32, exact, "gen") <= 1.5 * rel(cpu32, exact, "gen"), (
        rel(card32, exact, "gen"), rel(cpu32, exact, "gen"))


def test_gather_batch_on_card(card):
    """The device-resident corpus's gather on the card equals the CPU's,
    a bf16 mel cast back to float32."""
    from efficientspeech_tpu_torch.data.device_cache import (
        gather_batch, upload_cache)

    rng = np.random.default_rng(0)
    host = {"phoneme": rng.integers(1, 80, (6, 32)).astype(np.int32),
            "speaker": np.zeros(6, np.int32),
            "pitch": rng.normal(size=(6, 32)).astype(np.float32),
            "energy": rng.normal(size=(6, 32)).astype(np.float32),
            "duration": rng.integers(0, 5, (6, 32)).astype(np.int32),
            "mel": rng.normal(size=(6, 128, 80)).astype(np.float32),
            "phoneme_len": rng.integers(1, 33, 6).astype(np.int32),
            "mel_len": rng.integers(1, 129, 6).astype(np.int32)}
    idx = torch.tensor([4, 0, 4, 2])
    for dtype in (torch.float32, torch.bfloat16):
        want = gather_batch(upload_cache(host, "cpu", dtype), idx)
        got = gather_batch(upload_cache(host, card, dtype), idx.to(card))
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k].cpu(), v), k


# HiFi-GAN V1 (config_v1.json): its 256-wide stage 0 on K2's wide kernel,
# its first upsampler (D_in 512) and its post conv (4 samples a row,
# padded to 16) on K1; regression floors about 6 dB under the least the
# card gave over these cases (NVIDIA H100 80GB HBM3, 700 W)
V1 = HifiGanConfig.from_json(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "hifigan_v1.json"))
K2_WIDE_FLOOR_DB = 62.0
K1_V1_FLOOR_DB = {"up0": 49.0, "post": 48.0}


@pytest.fixture(scope="module")
def folded_v1(card):
    """The V1 vocoder folded in bf16, with its per-stage MRF specs."""
    gen = HifiGanGenerator(V1)
    reset_parameters(gen, 0)
    arrays, meta = fold_hifigan(gen.to(card), torch.bfloat16)
    return prepare_for_kernels(arrays, meta, V1)


@pytest.mark.parametrize("t,valid_rows,tm", [
    pytest.param(32768, 32768 - 4096, None, id="4096-frames"),
    pytest.param(1000, 771, None, id="ragged"),
    pytest.param(3000, 0, None, id="valid-0"),
    pytest.param(3000, 3000, None, id="valid-T"),
    pytest.param(1000, 771, 16, id="tm16"),
    pytest.param(1000, 771, 64, id="tm64")])
def test_mrf_wide_kernel(card, folded_v1, t, valid_rows, tm,
                         record_property):
    """K2's wide kernel (stage 0 of V1: 256 wide, halo 60) against the
    plain version: one launch counted (and one ``k2.wide_launches``),
    SNR >= 35 dB and >= K2_WIDE_FLOOR_DB over the valid rows, rows at or
    beyond valid exactly zero, every output finite."""
    from efficientspeech_tpu_torch.utils import spans

    chains, W_all, b_all, H = folded_v1[1][0]
    assert W_all.shape[1] == 256 and H == 60
    x = torch.randn(t, 256, generator=torch.Generator().manual_seed(t)
                    ).to(card)
    valid = torch.tensor([valid_rows], dtype=torch.int32, device=card)
    before = (mrf_block.launches[torch.bfloat16],
              spans.counters().get("k2.wide_launches", 0))
    got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, 3, tm=tm)
    want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid, 3)
    torch.cuda.synchronize()
    assert (mrf_block.launches[torch.bfloat16],
            spans.counters()["k2.wide_launches"]) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.isfinite(got).all()
    assert not got[valid_rows:].any()
    if valid_rows > 0:
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        record_property("snr_db", snr)
        assert snr >= max(SNR_BAR[torch.bfloat16], K2_WIDE_FLOOR_DB), snr


@pytest.mark.parametrize("key", ["up0", "post"])
def test_folded_matmul_v1_ops(card, folded_v1, key, record_property):
    """K1 at V1's first upsampler (4,096 frames, D_in 512: a plan with no
    x stage) and post conv (its 16 padded columns) against the plain
    version on the folded weights."""
    ops, _ = kernel_op_shapes(V1, 4096)
    _, t, d_in, _, w = next(op for op in ops if op[0] == key)
    W, b = folded_v1[0][key]
    assert W.shape[1] % 16 == 0
    assert (fm.plan(t, d_in, W.shape[1], w).x_bytes == 0) == (key == "up0")
    g = torch.Generator().manual_seed(len(key))
    x = torch.randn(t, d_in, generator=g).to(card)
    valid_rows = t - t // 8
    valid = torch.tensor([valid_rows], dtype=torch.int32, device=card)
    slope = 0.01 if key == "post" else 0.1
    before = fm.launches[torch.bfloat16]
    got = fm.folded_matmul(x, W, b, w, valid, pre_lrelu=True,
                           lrelu_slope=slope)
    want = fm.folded_matmul_plain(x, W, b, w, valid, pre_lrelu=True,
                                  lrelu_slope=slope)
    torch.cuda.synchronize()
    assert fm.launches[torch.bfloat16] == before + 1
    assert not got[valid_rows:].any()
    snr = snr_db(want[:valid_rows], got[:valid_rows])
    record_property("snr_db", snr)
    assert snr >= max(SNR_BAR[torch.bfloat16], K1_V1_FLOOR_DB[key]), snr


def test_v1_tts_batch_takes_the_kernel_route(card, record_property):
    """EfficientSpeech base with V1 in bf16: a tts_batch on the kernel
    route runs K1 5 and K2 4 launches a row (one of them wide), counts
    every row under ``synth.vocoder.wide_rows``, and matches the plain
    route's waveform at the bf16 kernels' bar."""
    from efficientspeech_tpu_torch.infer import build_synthesizer
    from efficientspeech_tpu_torch.utils import spans

    synth = build_synthesizer(preset="base", hifigan_cfg=V1,
                              dtype=torch.bfloat16, bench_duration_bias=6.0,
                              transfer="int16", device=card)
    texts = ["The quick brown fox jumps over the lazy dog.",
             "A second sentence, somewhat shorter.",
             "And a third one, to make the batch uneven in its lengths."]
    before = (dict(fm.launches), dict(mrf_block.launches),
              spans.counters(synth.span_id),
              spans.counters().get("k2.wide_launches", 0))
    got = synth.tts_batch(texts)
    torch.cuda.synchronize()
    c = spans.counters(synth.span_id)
    rows = c["synth.vocoder.kernel_rows"] - before[2].get(
        "synth.vocoder.kernel_rows", 0)
    assert rows >= len(texts)
    assert c["synth.vocoder.wide_rows"] - before[2].get(
        "synth.vocoder.wide_rows", 0) == rows
    assert spans.counters()["k2.wide_launches"] - before[3] == rows
    assert (fm.launches[torch.bfloat16] - before[0][torch.bfloat16],
            mrf_block.launches[torch.bfloat16] - before[1][torch.bfloat16]
            ) == (5 * rows, 4 * rows)
    synth.vocoder_mode = "folded"
    want = synth.tts_batch(texts)
    worst = min(snr_db(torch.from_numpy(w), torch.from_numpy(g))
                for (w, _), (g, _) in zip(want, got))
    record_property("snr_db", worst)
    assert worst >= SNR_BAR[torch.bfloat16], worst
