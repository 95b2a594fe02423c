"""The port's preprocessing pipeline against the JAX package's: the
TextGrid reader, ``Preprocessor`` on ``conftest.py``'s synthetic mini
corpus (``device="cpu"``; sequential and with a worker pool),
``prepare_align`` on a tiny LJSpeech-layout corpus, and both CLIs.

Tolerances: the text files, the durations and the pitch are host numpy
in both packages and must be byte- or bit-equal (stats.json's pitch
entries too); the mel and energy come from two FFT libraries and two
float orders, so the log-mel is held to 1e-4 absolute and the energy to
1e-5 relative.  stats.json's energy mean is held to 1e-6 relative.  Its
std and its min and max (z-scores) come from the energy's deviations
from that mean, which on a near-constant synthetic tone are a thousandth
of it: an energy error of 1e-5 relative becomes 1e-5 · mean / std there,
and that is their bound (std relative, min and max absolute)."""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from efficientspeech_tpu.config import PreprocessConfig as JaxPreprocessConfig
from efficientspeech_tpu.data import ljspeech as jax_ljspeech
from efficientspeech_tpu.data.preprocessor import (
    Preprocessor as JaxPreprocessor)
from efficientspeech_tpu.data.preprocessor import (
    RunningScaler as JaxRunningScaler)
from efficientspeech_tpu.data.textgrid import read_textgrid as jax_read_tg
from efficientspeech_tpu_torch import prepare_align as prepare_align_cli
from efficientspeech_tpu_torch import preprocess as preprocess_cli
from efficientspeech_tpu_torch.config import PreprocessConfig
from efficientspeech_tpu_torch.data import ljspeech
from efficientspeech_tpu_torch.data.preprocessor import (
    Preprocessor, RunningScaler)
from efficientspeech_tpu_torch.data.textgrid import read_textgrid

torch.set_num_threads(2)

LOG_MEL_ATOL = 1e-4
ENERGY_RTOL = 1e-5
STATS_RTOL = 1e-6
TEXT_FILES = ("train.txt", "val.txt", "speakers.json")


def _copy_corpus(mini_corpus, root):
    """The mini corpus's raw wavs and TextGrids under ``root``, with an
    output directory of its own; returns (jax config, port config)."""
    shutil.copytree(mini_corpus.raw_path, root / "raw")
    shutil.copytree(os.path.join(mini_corpus.preprocessed_path, "TextGrid"),
                    root / "out" / "TextGrid")
    kw = dict(dataset="LJSpeech", corpus_path=str(root),
              lexicon_path="/nonexistent", raw_path=str(root / "raw"),
              preprocessed_path=str(root / "out"), val_size=2)
    return JaxPreprocessConfig(**kw), PreprocessConfig(**kw)


def _build(pp, num_workers=0, seed=0):
    random.seed(seed)  # the train/val shuffle uses the global generator
    return pp.build_from_path(verbose=False, num_workers=num_workers)


def _features(out_dir):
    return {kind: {f: np.load(os.path.join(out_dir, kind, f))
                   for f in sorted(os.listdir(os.path.join(out_dir, kind)))}
            for kind in ("mel", "pitch", "energy", "duration")}


def _assert_same_corpus(want_dir, got_dir, bit_equal_all=False):
    for name in TEXT_FILES:
        with open(os.path.join(want_dir, name), "rb") as a, \
                open(os.path.join(got_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    want, got = _features(want_dir), _features(got_dir)
    for kind in want:
        assert sorted(want[kind]) == sorted(got[kind]), kind
        for f, w in want[kind].items():
            g = got[kind][f]
            assert g.dtype == w.dtype and g.shape == w.shape, (kind, f)
            if bit_equal_all or kind in ("duration", "pitch"):
                np.testing.assert_array_equal(g, w, err_msg=f)
            elif kind == "mel":
                np.testing.assert_allclose(g, w, rtol=0, atol=LOG_MEL_ATOL,
                                           err_msg=f)
    with open(os.path.join(want_dir, "stats.json")) as a, \
            open(os.path.join(got_dir, "stats.json")) as b:
        sw, sg = json.load(a), json.load(b)
    assert sw["pitch_extractor"] == sg["pitch_extractor"]
    assert sg["pitch"] == sw["pitch"]
    if bit_equal_all:
        assert sg["energy"] == sw["energy"]
        return
    (lo_w, hi_w, mean_w, std_w), (lo_g, hi_g, mean_g, std_g) = \
        sw["energy"], sg["energy"]
    np.testing.assert_allclose(mean_g, mean_w, rtol=STATS_RTOL)
    spread = ENERGY_RTOL * abs(mean_w) / std_w
    np.testing.assert_allclose(std_g, std_w, rtol=spread)
    np.testing.assert_allclose([lo_g, hi_g], [lo_w, hi_w], rtol=0,
                               atol=spread)


def test_textgrid_reader_matches_jax(mini_corpus):
    tg_dir = os.path.join(mini_corpus.preprocessed_path, "TextGrid",
                          "LJSpeech")
    for name in sorted(os.listdir(tg_dir)):
        path = os.path.join(tg_dir, name)
        want, got = jax_read_tg(path), read_textgrid(path)
        assert list(want) == list(got)
        for tier in want:
            assert [(i.start_time, i.end_time, i.text) for i in want[tier]] \
                == [(i.start_time, i.end_time, i.text) for i in got[tier]]


def test_running_scaler_matches_jax():
    rng = np.random.default_rng(3)
    want, got = JaxRunningScaler(), RunningScaler()
    for _ in range(4):
        v = rng.normal(size=17)
        want.update(v)
        got.update(v)
    assert (got.n, got.mean, got.m2, got.std) == \
        (want.n, want.mean, want.m2, want.std)


def test_preprocessor_matches_jax(mini_corpus, tmp_path):
    """The whole corpus through both packages: text files byte-equal,
    durations and pitch bit-equal, mel within 1e-4, energy (normalised)
    and stats.json within their tolerances."""
    jcfg, _ = _copy_corpus(mini_corpus, tmp_path / "jax")
    _, pcfg = _copy_corpus(mini_corpus, tmp_path / "port")
    want = _build(JaxPreprocessor(jcfg))
    got = _build(Preprocessor(pcfg, device="cpu"))
    assert got == want and len(got) == 6
    _assert_same_corpus(jcfg.preprocessed_path, pcfg.preprocessed_path)
    # the energy files hold z-scores: each package's own stats undo them
    raw = []
    for cfg in (jcfg, pcfg):
        with open(os.path.join(cfg.preprocessed_path, "stats.json")) as f:
            mean, std = json.load(f)["energy"][2:]
        raw.append({k: v * std + mean for k, v in
                    _features(cfg.preprocessed_path)["energy"].items()})
    for name, w in raw[0].items():
        np.testing.assert_allclose(raw[1][name], w, rtol=ENERGY_RTOL,
                                   err_msg=name)


def test_process_utterance_matches_jax(mini_corpus, tmp_path):
    """One utterance before normalisation: the returned line, the
    outlier-filtered pitch (bit-equal) and energy, and the frame count."""
    jcfg, _ = _copy_corpus(mini_corpus, tmp_path / "jax")
    _, pcfg = _copy_corpus(mini_corpus, tmp_path / "port")
    jpp, pp = JaxPreprocessor(jcfg), Preprocessor(pcfg, device="cpu")
    for pre in (jpp, pp):
        for sub in ("mel", "pitch", "energy", "duration"):
            os.makedirs(os.path.join(pre.out_dir, sub), exist_ok=True)
    tasks, speakers = pp._utterance_list()
    assert (tasks, speakers) == jpp._utterance_list()
    for speaker, base in tasks[:3]:
        want = jpp.process_utterance(speaker, base)
        got = pp.process_utterance(speaker, base)
        assert got[0] == want[0] and got[3] == want[3]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=ENERGY_RTOL)


def test_worker_pool_equals_sequential(mini_corpus, tmp_path):
    """num_workers=2 (spawned workers doing the host part, the mel in this
    process) writes exactly what num_workers=0 writes."""
    _, seq = _copy_corpus(mini_corpus, tmp_path / "seq")
    _, pool = _copy_corpus(mini_corpus, tmp_path / "pool")
    a = _build(Preprocessor(seq, device="cpu"))
    b = _build(Preprocessor(pool, device="cpu"), num_workers=2)
    assert a == b
    _assert_same_corpus(seq.preprocessed_path, pool.preprocessed_path,
                        bit_equal_all=True)


def _lj_corpus(root, n=3, sr=22050, seed=0):
    """A tiny LJSpeech layout: metadata.csv and wavs/, one entry without
    its wav, one wav at another sampling rate."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i in range(n):
        base = f"LJ900-{i:04d}"
        lines.append(f"{base}|Dr. Smith paid $5 on Jan. {i + 1}.|"
                     f"Doctor Smith paid five dollars, #{i}!")
        rate = 16000 if i == 1 else sr
        wav = 0.3 * rng.standard_normal(int(0.4 * rate))
        wavfile.write(str(root / "wavs" / f"{base}.wav"), rate,
                      (wav * 20000).astype(np.int16))
    lines.append("LJ900-9999|missing|missing wav")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n",
                                       encoding="utf-8")


def test_prepare_align_matches_jax(tmp_path):
    corpus = tmp_path / "LJSpeech-1.1"
    _lj_corpus(corpus)
    outs = {}
    for name, cfg_cls, fn in (
            ("jax", JaxPreprocessConfig, jax_ljspeech.prepare_align),
            ("port", PreprocessConfig, ljspeech.prepare_align)):
        cfg = cfg_cls(dataset="LJSpeech", corpus_path=str(corpus),
                      raw_path=str(tmp_path / name))
        assert fn(cfg, verbose=False) == 3
        outs[name] = tmp_path / name / "LJSpeech"
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) == 6
    for name in names:
        assert (outs["jax"] / name).read_bytes() == \
            (outs["port"] / name).read_bytes(), name


def _yaml(tmp_path, cfg):
    path = tmp_path / "preprocess.yaml"
    path.write_text(
        "dataset: LJSpeech\n"
        f"path:\n  corpus_path: {cfg.corpus_path}\n"
        f"  lexicon_path: /nonexistent\n  raw_path: {cfg.raw_path}\n"
        f"  preprocessed_path: {cfg.preprocessed_path}\n"
        f"preprocessing:\n  val_size: {cfg.val_size}\n")
    return str(path)


def test_preprocess_cli(mini_corpus, tmp_path, monkeypatch):
    """``python -m efficientspeech_tpu_torch.preprocess`` raises without a
    card unless given ``--device cpu``, and then writes the corpus the
    library call writes."""
    _, cli_cfg = _copy_corpus(mini_corpus, tmp_path / "cli")
    _, lib_cfg = _copy_corpus(mini_corpus, tmp_path / "lib")
    yaml = _yaml(tmp_path, cli_cfg)
    assert PreprocessConfig.from_yaml(yaml).preprocessed_path == \
        cli_cfg.preprocessed_path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        preprocess_cli.main([yaml])
    assert not os.path.exists(os.path.join(cli_cfg.preprocessed_path,
                                           "stats.json"))
    random.seed(0)
    out = preprocess_cli.main([yaml, "--device", "cpu"])
    assert len(out) == 6
    _build(Preprocessor(lib_cfg, device="cpu"))
    _assert_same_corpus(lib_cfg.preprocessed_path,
                        cli_cfg.preprocessed_path, bit_equal_all=True)


def test_prepare_align_cli(tmp_path, monkeypatch):
    """``python -m efficientspeech_tpu_torch.prepare_align`` does host work
    only: it runs without a card and takes no --device."""
    corpus = tmp_path / "LJSpeech-1.1"
    _lj_corpus(corpus)
    yaml = tmp_path / "p.yaml"
    yaml.write_text(f"dataset: LJSpeech\npath:\n  corpus_path: {corpus}\n"
                    f"  raw_path: {tmp_path / 'raw'}\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prepare_align_cli.main([str(yaml)]) == 3
    assert len(os.listdir(tmp_path / "raw" / "LJSpeech")) == 6
    with pytest.raises(SystemExit):
        prepare_align_cli.main([str(yaml), "--device", "cpu"])
    yaml.write_text(yaml.read_text().replace("LJSpeech\n", "VCTK\n", 1))
    with pytest.raises(ValueError, match="unknown dataset"):
        prepare_align_cli.main([str(yaml)])
