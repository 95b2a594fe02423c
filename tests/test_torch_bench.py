"""The port's bench entry point: its metric runners on a small CPU
synthesizer (one iteration each; the host's clock, so no number here is
a device's), its print order, and its refusal to start without a card
unless asked for the CPU."""

import argparse
import json

import numpy as np
import pytest
import torch

from efficientspeech_tpu_torch import bench
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.infer import build_synthesizer

from test_torch_synth import SMALL_HIFIGAN, _small_setup

torch.set_num_threads(2)

KEYS = {"metric", "value", "unit", "vs_baseline"}
TEXT = "hello there, my friend"


@pytest.fixture(scope="module")
def small():
    def make(transfer):
        return _small_setup(build_synthesizer(
            preset="tiny", hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN),
            dtype=torch.float32, bench_duration_bias=4.0, transfer=transfer,
            vocoder_mode="folded_kernel", device="cpu"))
    return make("adpcm4"), make("adpcm3")


@pytest.mark.parametrize("metric", ["mel_rtf", "device_rtf", "batch_rtf",
                                    "rtf"])
def test_metric_runner(small, metric):
    synth, batch_synth = small
    args = bench.get_args(["--device", "cpu", "--text", TEXT, "--iter", "1",
                           "--batch", "3", "--metric", metric])
    (result,) = bench.run_metrics(synth, batch_synth, args)
    assert KEYS <= set(result)
    assert result["unit"] == "x_realtime"
    assert np.isfinite(result["value"]) and result["value"] > 0
    json.dumps(result)
    names = {"rtf": "text_to_wav_rtf", "batch_rtf": "batch_text_to_wav_rtf"}
    assert result["metric"] == names.get(metric, metric)
    if metric == "batch_rtf":
        assert (result["batch"], result["transfer"]) == (3, "adpcm3")
    if metric == "device_rtf":
        assert result["note"] == bench.DEVICE_RTF_NOTE


def test_all_prints_text_to_wav_rtf_last(small, monkeypatch):
    synth, batch_synth = small
    for name in ("run_mel_rtf", "run_device_rtf", "run_batch_rtf",
                 "run_rtf"):
        # each runner once for real above; here only the order counts
        monkeypatch.setattr(bench, name, lambda *a, name=name: {
            "metric": name})
    args = argparse.Namespace(metric="all", text=TEXT, iter=1, batch=2)
    got = [r["metric"] for r in bench.run_metrics(synth, batch_synth, args)]
    assert got == ["run_mel_rtf", "run_device_rtf", "run_batch_rtf",
                   "run_rtf"]


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--iter", "1", "--warmup", "1"])
