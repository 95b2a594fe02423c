"""``python -m efficientspeech_tpu_torch.train_vocoder`` on the CPU over
the shared mini corpus: steps, checkpoints and resume, the metrics.jsonl
keys, ``--from-acoustic`` with a holdout (its pairs against the JAX
package's ``build_acoustic_pairs`` on the same acoustic weights), the
checkpoint round trip, and the flags the port refuses."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from conftest import mini_corpus, preprocessed_corpus  # noqa: F401
from efficientspeech_tpu_torch import train_vocoder
from efficientspeech_tpu_torch.config import (
    AudioConfig, HifiGanConfig, ModelConfig, PreprocessConfig)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.training.vocoder import (
    create_vocoder_trainer, restore_vocoder_checkpoint,
    save_vocoder_checkpoint)
from efficientspeech_tpu_torch.weights import init_params, to_jax_params

torch.set_num_threads(4)

COMMON = ["--batch-size", "2", "--segment", "2048", "--initial-channels",
          "16", "--device", "cpu"]
STEP_KEYS = {"disc_loss", "gen_loss", "mel_l1", "adv", "fm", "step",
             "wall_secs"}


def _write_yaml(corpus, tmp_path):
    cfg = os.path.join(tmp_path, "voc.yaml")
    with open(cfg, "w") as f:
        f.write(f"""
dataset: "LJSpeech"
path:
  corpus_path: "{corpus.corpus_path}"
  raw_path: "{corpus.raw_path}"
  preprocessed_path: "{corpus.preprocessed_path}"
preprocessing:
  audio:
    sampling_rate: 22050
""")
    return cfg


def _lines(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_steps_checkpoints_and_resumes(preprocessed_corpus, tmp_path):
    cfg = _write_yaml(preprocessed_corpus, tmp_path)
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    common = COMMON + ["--preprocess-config", cfg, "--checkpoint-dir", ckpt,
                       "--log-dir", logs, "--checkpoint-every", "2",
                       "--log-every", "1"]
    out = train_vocoder.main(common + ["--steps", "2"])
    assert out["step"] == 2 and out["before"] is None
    lines = _lines(logs)
    assert [line["step"] for line in lines] == [1, 2]
    assert all(set(line) == STEP_KEYS for line in lines)
    assert all(np.isfinite(line[k]) for line in lines
               for k in STEP_KEYS - {"step"})
    assert os.path.isfile(os.path.join(ckpt, "step_00000002.pt"))

    # --resume continues from step 2 to 3
    out = train_vocoder.main(common + ["--steps", "3", "--resume"])
    assert out["step"] == 3
    assert [line["step"] for line in _lines(logs)] == [1, 2, 3]
    assert sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ckpt, "step_*.pt"))) == ["step_00000002.pt",
                                              "step_00000003.pt"]
    payload = torch.load(os.path.join(ckpt, "step_00000003.pt"),
                         weights_only=True)
    assert set(payload) == {"step", "gen", "mpd", "msd", "gen_opt",
                            "disc_opt"} and payload["step"] == 3

    # --mr-stft-weight adds its term to the logged metrics
    logs2 = str(tmp_path / "logs2")
    train_vocoder.main(COMMON + [
        "--preprocess-config", cfg, "--checkpoint-dir",
        str(tmp_path / "ckpt2"), "--log-dir", logs2, "--steps", "1",
        "--mr-stft-weight", "2.5"])
    assert set(_lines(logs2)[-1]) == STEP_KEYS | {"mr_stft"}


def test_checkpoint_restores_the_state_exactly(tmp_path):
    """A step from a restored checkpoint equals the step from the state
    it was written from, bit for bit: generator, both discriminators and
    both optimizers' moments and counts."""
    cfg, audio = HifiGanConfig(upsample_initial_channel=16), AudioConfig()
    rng = np.random.default_rng(3)
    mel = torch.from_numpy(rng.normal(-3, 2, (1, 8, 80)).astype(np.float32))
    wav = torch.from_numpy(rng.normal(0, 0.3, (1, 2048)).astype(np.float32))
    _, init, step = create_vocoder_trainer(cfg, audio, device="cpu")
    state, _ = step(init(seed=5), mel, wav)
    path = save_vocoder_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000001.pt"
    _, init2, step2 = create_vocoder_trainer(cfg, audio, device="cpu")
    restored = restore_vocoder_checkpoint(path, init2(seed=9))
    assert restored.step == 1
    state, want = step(state, mel, wav)
    restored, got = step2(restored, mel, wav)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for name in ("gen", "mpd", "msd"):
        a = getattr(state, name).state_dict()
        b = getattr(restored, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name


def _acoustic_checkpoint(corpus_cfg, path):
    """A port trainer checkpoint (``step_*.pt``) of a seeded tiny model."""
    stats = corpus_cfg.load_stats()
    model = init_params(Phoneme2Mel(ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]))), 0)
    os.makedirs(path, exist_ok=True)
    torch.save({"step": 0, "params": model.state_dict(), "optimizer": {}},
               os.path.join(path, "step_00000000.pt"))
    return model


def test_from_acoustic_pairs_match_jax(preprocessed_corpus, tmp_path):
    """The teacher-forced pairs from a port checkpoint against the JAX
    package's build_acoustic_pairs on the same weights (an orbax copy):
    the same utterances in the same order, int16 audio equal, mels within
    one float16 step (and 1e-6, the float32 forward's rounding, where
    that step is smaller)."""
    import train_vocoder as jax_train_vocoder
    from efficientspeech_tpu.training.checkpoint import save_params

    cfg_yaml = _write_yaml(preprocessed_corpus, tmp_path)
    model = _acoustic_checkpoint(PreprocessConfig.from_yaml(cfg_yaml),
                                 str(tmp_path / "acoustic"))
    jax_ckpt = str(tmp_path / "acoustic_orbax")
    save_params(jax_ckpt, {"phoneme2mel": to_jax_params(model)})
    want, hop, n_mels = jax_train_vocoder.build_acoustic_pairs(
        jax_ckpt, "tiny", cfg_yaml, limit=4, seed=0, forward_batch=2)
    got, hop2, n_mels2 = train_vocoder.build_acoustic_pairs(
        str(tmp_path / "acoustic"), "tiny", cfg_yaml, limit=4, seed=0,
        forward_batch=2, device="cpu")
    assert (hop2, n_mels2) == (hop, n_mels) == (256, 80)
    assert len(got) == len(want) > 0
    for (gm, gw), (wm, ww) in zip(got, want):
        assert gm.dtype == np.float16 and gm.shape == wm.shape
        np.testing.assert_array_equal(gw, ww)
        ulp = np.spacing(np.abs(wm.astype(np.float16))).astype(np.float32)
        diff = np.abs(gm.astype(np.float32) - wm.astype(np.float32))
        assert (diff <= ulp + 1e-6).all(), diff.max()


def test_from_acoustic_holdout_writes_before_and_after(preprocessed_corpus,
                                                       tmp_path):
    cfg_yaml = _write_yaml(preprocessed_corpus, tmp_path)
    _acoustic_checkpoint(PreprocessConfig.from_yaml(cfg_yaml),
                         str(tmp_path / "acoustic"))
    logs = str(tmp_path / "logs")
    out = train_vocoder.main(COMMON + [
        "--preprocess-config", cfg_yaml, "--from-acoustic",
        str(tmp_path / "acoustic" / "step_00000000.pt"),
        "--max-utterances", "4", "--holdout-frac", "0.5", "--eval-batch",
        "2", "--steps", "2", "--log-every", "1", "--checkpoint-dir",
        str(tmp_path / "ckpt"), "--log-dir", logs])
    lines = _lines(logs)
    evals = [line for line in lines if "eval" in line]
    assert [e["phase"] for e in evals] == ["before", "after"]
    assert [e["step"] for e in evals] == [0, 2]
    for e in evals:
        assert e["eval"] == "holdout" and e["n_utterances"] == 2
        for k in ("mel_l1", "mr_stft", "sc_512", "sc_1024", "sc_2048",
                  "logmag_512", "logmag_1024", "logmag_2048"):
            assert np.isfinite(e[k]), (e["phase"], k)
    assert [line["step"] for line in lines if "eval" not in line] == [1, 2]
    assert out["before"]["mel_l1"] == evals[0]["mel_l1"]
    assert len(out["eval_secs"]) == 2


def test_init_generator_takes_both_formats(preprocessed_corpus, tmp_path):
    """``--init-generator`` takes a reference generator file (weight-norm
    pairs, written by the port's writer) or a checkpoint of this trainer;
    both start the generator from those weights."""
    from efficientspeech_tpu_torch.convert.to_torch import (
        save_hifigan_checkpoint)
    from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator

    cfg = HifiGanConfig(upsample_initial_channel=16)
    gen = init_params(HifiGanGenerator(cfg), 11)
    ref = str(tmp_path / "generator")
    save_hifigan_checkpoint(ref, to_jax_params(gen), cfg)
    state, tree = train_vocoder.init_generator_params(ref, 3)
    assert state is None
    _, init, _ = create_vocoder_trainer(cfg, AudioConfig(), device="cpu")
    loaded = init(gen_params=tree).gen
    for k, v in gen.state_dict().items():
        np.testing.assert_allclose(loaded.state_dict()[k].numpy(),
                                   v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    path = save_vocoder_checkpoint(str(tmp_path / "voc"),
                                   init(seed=4))
    for where in (path, str(tmp_path / "voc")):
        state, tree = train_vocoder.init_generator_params(where, 3)
        assert tree is None
        assert all(torch.equal(state[k], v) for k, v in
                   init(seed=4).gen.state_dict().items())


@pytest.mark.parametrize("flags,match", [
    # the JAX CLI's check: the ranks split the global batch evenly
    pytest.param(["--data-parallel", "2", "--batch-size", "3"],
                 "must be divisible by --data-parallel",
                 id="flags0-parallelism"),
])
def test_refused_flags(tmp_path, capsys, flags, match):
    with pytest.raises(SystemExit):
        train_vocoder.main(["--preprocess-config", "x.yaml",
                            "--device", "cpu"] + flags)
    assert match in capsys.readouterr().err
