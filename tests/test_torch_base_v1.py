"""EfficientSpeech base with HiFi-GAN V1 on the port's CPU route: the
acoustic model and the folded generator (K2's plain version at width 256,
the padded post conv) against the benchmark's plain float32 reference at
every published width; the kernels' plans at V1's shapes, and LJ_V2's
plans as they were before the wide kernel; the padded post conv bit for
bit; K2's refusal of a width no variant is built for."""

import json
import os

import numpy as np
import pytest
import torch

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models import hifigan_folded
from efficientspeech_tpu_torch.models.hifigan_folded import (
    fold_hifigan, fold_specs, folded_plan_apply, kernel_op_shapes,
    prepare_for_kernels)
from efficientspeech_tpu_torch.ops.kernels import folded_matmul, mrf_block
from efficientspeech_tpu_torch.utils import spans
from perfbench.reference import model as ref
from perfbench.reference.precision import Precision
from perfbench.yardstick.weights import make_weights

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1 = HifiGanConfig.from_json(os.path.join(REPO, "configs", "hifigan_v1.json"))


def stage_widths(cfg: HifiGanConfig, stage: int):
    _, meta = fold_specs(cfg)
    return tuple(tuple(meta["widths"][f"rb{stage}_{j}_{c}_{m}"]
                       for m in range(len(rd)) for c in ("c1", "c2"))
                 for j, rd in enumerate(cfg.resblock_dilation_sizes))


@pytest.fixture(scope="module")
def base_v1():
    """The benchmark's es-base-ljv1 configuration built by the port, on
    the benchmark's seeded random weights (biases included)."""
    from perfbench.drivers.synthesis import hifigan_config, port_overrides
    from efficientspeech_tpu_torch.infer import build_model

    with open(os.path.join(REPO, "perfbench", "configs",
                           "es-base-ljv1.json")) as fh:
        cfg = json.load(fh)
    model = build_model(cfg["preset"], model_overrides=port_overrides(cfg),
                        hifigan_cfg=hifigan_config(cfg))
    assert model.hifigan_cfg == V1
    P = make_weights({k: tuple(v.shape) for k, v in
                      model.state_dict().items()}, 2405, "cpu", 6.0)
    model.load_state_dict(P)
    return cfg, model.eval(), P


def test_base_v1_matches_the_plain_reference(base_v1, monkeypatch):
    """Two texts, the second padded, at most 32 frames: the acoustic
    model's predictions and mel, and the folded generator on the kernel
    route's CPU versions (stage 0 through mrf_fused at width 256, the post
    conv through folded_matmul from its padded arrays, whose plain version
    takes the 4 real columns) against the reference's conv generator on
    each row's valid frames.

    Tolerances: the acoustic outputs at 2e-5 (float32 in another order
    of sums, as the tiny model's test); the waveform at 1e-4 (float32
    products through the folded matrices, ~1e-6 measured); the same
    reference with bf16 operands lies ~1e-2 away, and the test checks
    that it fails the bar."""
    cfg, model, P = base_v1
    ids = torch.tensor([[70, 81, 92, 103, 114], [75, 86, 97, 0, 0]])
    with torch.no_grad():
        want = model.phoneme2mel(ids, ids == 0, max_mel_len=32)
        got = ref.acoustic(Precision(), P, cfg["model"], ids, ids == 0, 32)
        for k in ("pitch", "energy", "duration"):
            np.testing.assert_allclose(got[k], want[k][..., 0], atol=2e-5)
        assert (got["mel_len"] == want["mel_len"]).all()
        assert int(want["mel_len"].min()) > 8
        np.testing.assert_allclose(got["mel"], want["mel"], atol=2e-5)

        seen = {"mrf_fused": [], "folded_matmul": []}
        for name in seen:
            def record(*a, _fn=getattr(hifigan_folded, name), _n=name, **k):
                seen[_n].append((a[0].shape,
                                 a[2 if _n == "mrf_fused" else 1].shape))
                return _fn(*a, **k)
            monkeypatch.setattr(hifigan_folded, name, record)
        arrays, meta = fold_hifigan(model.hifigan, torch.float32)
        karrays, mrf = prepare_for_kernels(arrays, meta, V1)
        mel, mel_len = want["mel"], want["mel_len"]
        wide0 = spans.counters().get("synth.vocoder.wide_rows", 0)
        wav = folded_plan_apply(karrays, meta, V1, mel, mel_len,
                                dtype=torch.float32, use_kernel=True,
                                fuse_mrf=True, mrf=mrf)
        assert spans.counters()["synth.vocoder.wide_rows"] == wide0 + 2
        # per row: stage 0 at 256 wide, then 128 wide at stages 1-3
        assert [s[0][1] for s in seen["mrf_fused"]] == [256, 128, 128,
                                                         128] * 2
        assert karrays["post"][0].shape == (384, 16)
        assert seen["folded_matmul"][-1][1] == (384, 4)
        for row in range(2):
            n = int(mel_len[row])
            conv = ref.generator(Precision(), P, cfg["hifigan"],
                                 mel[row:row + 1, :n])[0]
            np.testing.assert_allclose(wav[row, :n * 256], conv, atol=1e-4)
            assert not wav[row, n * 256:].any()
            bf16 = ref.generator(Precision("bf16"), P, cfg["hifigan"],
                                 mel[row:row + 1, :n])[0]
            assert (bf16 - conv).abs().max() > 1e-4


def test_padded_post_conv_is_bit_for_bit(base_v1):
    """prepare_for_kernels pads V1's post conv (4 samples a row) with
    zero columns to 16, the kernel's multiple; the padding is zeros, and
    the CPU route's waveform from the padded arrays is the one the
    unpadded arrays give, bit for bit."""
    _, model, _ = base_v1
    arrays, meta = fold_hifigan(model.hifigan, torch.float32)
    karrays, mrf = prepare_for_kernels(arrays, meta, V1)
    W, b = karrays["post"]
    assert W.shape == (384, 16) and b.shape == (16,)
    assert torch.equal(W[:, :4], arrays["post"][0])
    assert not W[:, 4:].any() and not b[4:].any()
    unpadded = dict(karrays, post=(arrays["post"][0],
                                   arrays["post"][1].float()))
    mel = torch.randn(1, 9, 80, generator=torch.Generator().manual_seed(3))
    valid = torch.tensor([7])
    with torch.no_grad():
        runs = [folded_plan_apply(a, meta, V1, mel, valid,
                                  dtype=torch.float32, use_kernel=True,
                                  fuse_mrf=True, mrf=mrf)
                for a in (karrays, unpadded)]
    assert runs[0].shape == (1, 9 * 256)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("rows", [8, 64, 512, 4096, 8192, 32768])
def test_wide_plan_fits_stage0(rows):
    """K2's plan at d = 256 takes V1's stage 0 (halo 60) from 1 to 4,096
    frames (8 rows a frame): one wgmma a conv within the wide kernel's N,
    two ring slots or more, shared memory within the block's, v in device
    memory."""
    widths = stage_widths(V1, 0)
    assert max(sum(c) for c in widths) == 60
    pl = mrf_block.bf16_plan(widths, rows, d=256)
    assert 0 < pl.tm <= mrf_block.WIDE_MAX_TM and pl.tm % 16 == 0
    assert max(max(c) for c in pl.chunks) <= mrf_block.WIDE_MAX_N
    assert 2 <= pl.slots <= mrf_block.MAX_SLOTS
    assert pl.v_off == pl.bar_off and pl.smem <= mrf_block.SMEM_LIMIT
    assert pl.buf_off == pl.slots * mrf_block.SLICE_BYTES
    assert pl.bar_off - pl.buf_off == 256 // 8 * pl.r_alloc * 16


@pytest.mark.parametrize("frames", [16, 512, 4096])
def test_k1_plans_fit_every_v1_op(frames):
    """K1's bf16 plan takes all five of V1's ops: up0 (D_in 512) with x
    read from device memory, the post conv at its padded 16 columns."""
    ops, mrf = kernel_op_shapes(V1, frames)
    assert [op[0] for op in ops] == ["up0", "up1", "up2", "up3", "post"]
    assert [s for s, _ in mrf] == [0, 1, 2, 3]
    for key, t, d_in, d_out, w in ops:
        d_out += -d_out % hifigan_folded.KERNEL_COLS
        pl = folded_matmul.plan(t, d_in, d_out, w)
        assert pl.smem <= folded_matmul.SMEM_LIMIT
        assert (pl.x_bytes == 0) == (key == "up0"), (key, pl)
    for stage, rows in mrf:
        pl = mrf_block.bf16_plan(stage_widths(V1, stage), rows,
                                 d=256 if stage == 0 else 128)
        assert pl.smem <= mrf_block.SMEM_LIMIT


def test_mrf_fused_refuses_unbuilt_widths():
    """A stage 256 wide in float32, or a width no variant is built for,
    raises a ValueError naming the width and the dtype before any launch
    (meta tensors: no card needed)."""
    widths = stage_widths(V1, 0)
    chains = [[(w, 2 * w + 1, 0, 0) for w in c] for c in widths]
    for d, dtype in ((256, torch.float32), (192, torch.bfloat16),
                     (64, torch.float32)):
        x = torch.empty((64, d), device="meta")
        W = torch.empty((3 * d, d), dtype=dtype, device="meta")
        b = torch.empty((18, d), device="meta")
        before = dict(mrf_block.launches)
        with pytest.raises(ValueError, match=rf"{d} wide with {dtype}"):
            mrf_block.mrf_fused(x, chains, W, b, 60,
                                torch.tensor([64], dtype=torch.int32), 3)
        assert mrf_block.launches == before
    assert mrf_block.supports(256, torch.bfloat16)
    assert not mrf_block.supports(256, torch.float32)


TINY_PLANS = {  # (kernel, op or stage, frames): (bf16 plan, f32 plan)
    ('K1', 'up0', 32): ((64, 64, 2, True, 1, 8, 8, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 4, 67, 34304, 68608)),
    ('K1', 'up1', 32): ((64, 64, 2, True, 2, 8, 16, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 8, 67, 34304, 68608)),
    ('K1', 'up2', 32): ((64, 64, 2, True, 8, 2, 16, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 1, 8, 67, 34304, 68608)),
    ('K1', 'up3', 32): ((64, 64, 2, True, 8, 2, 16, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 1, 8, 67, 34304, 68608)),
    ('K1', 'post', 32): ((128, 16, 2, True, 4, 1, 4, 4096, 12288, 66560, 145408, 35456, 216320, 217368),
        (16, 1, 128, 1, 4, 131, 67072, 134144)),
    ('K2', 0, 32): ((16, 4, 97, 131072, 155904, 197888, 198976), (16, 97, 49664, 99328, 142624)),
    ('K2', 1, 32): ((16, 4, 73, 131072, 149760, 177408, 178496), (16, 73, 37376, 74752, 103264)),
    ('K2', 2, 32): ((16, 4, 57, 131072, 145664, 164096, 165184), (16, 57, 29184, 58368, 77376)),
    ('K2', 3, 32): ((16, 4, 49, 131072, 143616, 158976, 160064), (16, 49, 25088, 50176, 66016)),
    ('K1', 'up0', 512): ((64, 64, 2, True, 8, 8, 64, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 32, 67, 34304, 68608)),
    ('K1', 'up1', 512): ((64, 64, 2, True, 16, 8, 128, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 128, 67, 34304, 68608)),
    ('K1', 'up2', 512): ((64, 64, 2, True, 66, 2, 132, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 1, 128, 67, 34304, 68608)),
    ('K1', 'up3', 512): ((64, 64, 2, True, 66, 2, 132, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 1, 128, 67, 34304, 68608)),
    ('K1', 'post', 512): ((128, 16, 2, True, 64, 1, 64, 4096, 12288, 66560, 145408, 35456, 216320, 217368),
        (16, 1, 128, 1, 64, 131, 67072, 134144)),
    ('K2', 0, 512): ((16, 4, 97, 131072, 155904, 197888, 198976), (16, 97, 49664, 99328, 142624)),
    ('K2', 1, 512): ((64, 4, 121, 131072, 162048, 214272, 215360), (64, 121, 61952, 123904, 177760)),
    ('K2', 2, 512): ((64, 4, 105, 131072, 157952, 200960, 202048), (64, 105, 53760, 107520, 151872)),
    ('K2', 3, 512): ((64, 4, 97, 131072, 155904, 195840, 196928), (64, 97, 49664, 99328, 140512)),
    ('K1', 'up0', 1024): ((64, 64, 2, True, 16, 8, 128, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 64, 67, 34304, 68608)),
    ('K1', 'up1', 1024): ((64, 64, 2, True, 16, 8, 128, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 256, 67, 34304, 68608)),
    ('K1', 'up2', 1024): ((64, 64, 2, True, 66, 2, 132, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 1, 256, 67, 34304, 68608)),
    ('K1', 'up3', 1024): ((64, 64, 2, True, 66, 2, 132, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 1, 256, 67, 34304, 68608)),
    ('K1', 'post', 1024): ((128, 16, 2, True, 128, 1, 128, 4096, 12288, 66560, 145408, 35456, 216320, 217368),
        (16, 1, 128, 1, 128, 131, 67072, 134144)),
    ('K2', 0, 1024): ((32, 4, 113, 131072, 160000, 210176, 211264), (32, 113, 57856, 115712, 167456)),
    ('K2', 1, 1024): ((128, 3, 185, 98304, 145664, 230656, 231728), (96, 153, 78336, 156672, 227424)),
    ('K2', 2, 1024): ((128, 3, 169, 98304, 141568, 217344, 218416), (112, 153, 78336, 156672, 226368)),
    ('K2', 3, 1024): ((128, 3, 161, 98304, 139520, 212224, 213296), (112, 145, 74240, 148480, 215008)),
    ('K1', 'up0', 4096): ((64, 64, 2, True, 16, 8, 128, 16384, 49152, 33792, 116736, 18048, 152832, 153880),
        (128, 1, 64, 4, 256, 67, 34304, 68608)),
    ('K1', 'up1', 4096): ((64, 128, 2, True, 33, 4, 132, 32768, 98304, 33792, 165888, 18048, 201984, 203032),
        (128, 2, 128, 4, 512, 131, 67072, 134144)),
    ('K1', 'up2', 4096): ((64, 128, 2, True, 132, 1, 132, 32768, 98304, 33792, 165888, 18048, 201984, 203032),
        (128, 2, 128, 1, 512, 131, 67072, 134144)),
    ('K1', 'up3', 4096): ((64, 128, 2, True, 132, 1, 132, 32768, 98304, 33792, 165888, 18048, 201984, 203032),
        (128, 2, 128, 1, 512, 131, 67072, 134144)),
    ('K1', 'post', 4096): ((128, 16, 2, True, 132, 1, 132, 4096, 12288, 66560, 145408, 35456, 216320, 217368),
        (16, 1, 128, 1, 512, 131, 67072, 134144)),
    ('K2', 0, 4096): ((128, 2, 209, 65536, 119040, 218368, 219424), (64, 145, 74240, 148480, 217120)),
    ('K2', 1, 4096): ((128, 3, 185, 98304, 145664, 230656, 231728), (96, 153, 78336, 156672, 227424)),
    ('K2', 2, 4096): ((128, 3, 169, 98304, 141568, 217344, 218416), (112, 153, 78336, 156672, 226368)),
    ('K2', 3, 4096): ((128, 3, 161, 98304, 139520, 212224, 213296), (112, 145, 74240, 148480, 215008)),
}


@pytest.mark.parametrize("key", sorted(TINY_PLANS, key=str),
                         ids=lambda k: "-".join(map(str, k)))
def test_ljv2_plans_are_unchanged(key):
    """Every K1 and K2 plan of es-tiny-ljv2's shapes (LJ_V2 at 32-4,096
    frames), bf16 and float32, is the one it was before the wide kernel
    and K1's plans without an x stage."""
    kernel, op, frames = key
    cfg = HifiGanConfig()
    ops, mrf = kernel_op_shapes(cfg, frames)
    if kernel == "K1":
        _, t, d_in, d_out, w = next(o for o in ops if o[0] == op)
        got = (tuple(folded_matmul.plan(t, d_in, d_out, w)),
               tuple(folded_matmul.f32_plan(t, d_in, d_out, w)))
    else:
        t = dict(mrf)[op]
        widths = stage_widths(cfg, op)
        got = (tuple(mrf_block.bf16_plan(widths, t)[:7]),
               tuple(mrf_block.f32_plan(widths, t)[:5]))
    assert got == TINY_PLANS[key]
