"""Operation and byte counts against counts made by hand or by PyTorch's
FLOP counter on the plain reference at small shapes."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import model as ref
from perfbench.reference.precision import Precision
from perfbench.tests.conftest import REPO
from perfbench.yardstick import work


def config(name):
    with open(os.path.join(REPO, "perfbench", "configs",
                           name + ".json")) as fh:
        return json.load(fh)


def weights_for(cfg, small_vocoder=True):
    from perfbench.drivers.synthesis import hifigan_config, port_overrides
    from perfbench.yardstick.weights import make_weights
    from efficientspeech_tpu_torch.infer import build_model

    model = build_model(cfg["preset"], model_overrides=port_overrides(cfg),
                        hifigan_cfg=hifigan_config(cfg))
    return make_weights({k: tuple(v.shape)
                         for k, v in model.state_dict().items()}, 3, "cpu",
                        6.0)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_mrf_flops_per_sample_is_252_c2():
    st = work.mrf_stages(config("es-tiny-ljv2")["hifigan"])
    assert [s["channels"] for s in st] == [64, 32, 16, 8]
    assert [s["samples_per_frame"] for s in st] == [8, 64, 128, 256]
    assert all(s["flops_per_sample"] == 252 * s["channels"] ** 2
               for s in st)


def test_generator_flops_match_the_counter():
    cfg = config("es-tiny-ljv2")
    P = weights_for(cfg)
    mel = torch.randn(1, 7, 80)
    got = counted(lambda: ref.generator(Precision(), P, cfg["hifigan"],
                                        mel))
    assert got == pytest.approx(7 * work.generator_frame_flops(
        cfg["hifigan"]), rel=1e-12)


@pytest.mark.parametrize("name", ["es-tiny-ljv2"])
@pytest.mark.parametrize("n", [9, 16])
def test_acoustic_flops_match_the_counter(name, n):
    cfg = config(name)
    P = weights_for(cfg)
    ids = torch.randint(67, 150, (1, n))
    # one frame a phoneme: the decoder runs on exactly n valid frames
    judged = {"pitch": torch.zeros(1, n), "energy": torch.zeros(1, n),
              "duration": torch.ones(1, n)}
    got = counted(lambda: ref.acoustic(Precision(), P, cfg["model"], ids,
                                       ids == 0, n, judged=judged))
    want = (work.acoustic_phoneme_flops(cfg["model"], n)
            + n * work.acoustic_frame_flops(cfg["model"]))
    assert got == pytest.approx(want, rel=1e-12)


def test_mrf_bound_by_hand():
    h = config("es-tiny-ljv2")["hifigan"]
    want = 0.0
    for c, spf in ((64, 8), (32, 64), (16, 128), (8, 256)):
        s = spf * 100
        ops = 252 * c * c * s / 989e12
        nbytes = (2 * c * s * 4 + 126 * c * c * 2 + 18 * c * 4) / 3.35e12
        want += max(ops, nbytes)
    assert work.mrf_bound_s(h, 100) == pytest.approx(want)
