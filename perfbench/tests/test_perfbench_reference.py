"""The plain reference against the port's plain modules in float32 on
the CPU, on the same weights: the acoustic model and the generator."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench.reference import model as ref
from perfbench.reference.precision import Precision
from perfbench.tests.conftest import REPO
from perfbench.yardstick.weights import make_weights


def load(name):
    with open(os.path.join(REPO, "perfbench", "configs",
                           name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["hifigan"]["upsample_initial_channel"] = 32
    return cfg


def port_model(cfg):
    from perfbench.drivers.synthesis import hifigan_config, port_overrides
    from efficientspeech_tpu_torch.infer import build_model

    model = build_model(cfg["preset"], model_overrides=port_overrides(cfg),
                        hifigan_cfg=hifigan_config(cfg))
    P = make_weights({k: tuple(v.shape) for k, v in
                      model.state_dict().items()}, 11, "cpu", 6.0)
    model.load_state_dict(P)
    return model.eval(), P


@pytest.mark.parametrize("name", ["es-tiny-ljv2"])
def test_acoustic_and_generator_match_the_port(name):
    cfg = load(name)
    model, P = port_model(cfg)
    ids = torch.randint(67, 150, (2, 40))
    ids[1, 29:] = 0
    with torch.no_grad():
        want = model.phoneme2mel(ids, ids == 0, max_mel_len=320)
        got = ref.acoustic(Precision(), P, cfg["model"], ids, ids == 0, 320)
        for k in ("pitch", "energy", "duration"):
            np.testing.assert_allclose(got[k], want[k][..., 0], atol=2e-5)
        assert (got["mel_len"] == want["mel_len"]).all()
        np.testing.assert_allclose(got["mel"], want["mel"], atol=2e-5)
        n = int(want["mel_len"][1])
        wav = model.hifigan(want["mel"][1:, :n])
        np.testing.assert_allclose(
            ref.generator(Precision(), P, cfg["hifigan"],
                          want["mel"][1:, :n]), wav, atol=2e-6)


def test_control_precision_rounds_operands():
    x = torch.linspace(-3, 3, 101)
    assert torch.equal(Precision().q(x), x)
    fp8 = Precision("fp8").q(x)
    assert 0 < (fp8 - x).abs().max() <= 3 * 2 ** -4
    g = torch.ones(101, requires_grad=True)
    Precision("fp8").q(g * 1.3).sum().backward()
    assert torch.allclose(g.grad, torch.full((101,), 1.3))
