"""The port's device-resident corpus (``data/device_cache.py``) against the
JAX package's and against the port's own loader path: the host cache
array for array, the epoch permutations, a cached step's losses and
parameters against the loader step's on the same rows,
``device_data_scan_steps`` running single steps, the cached evaluation
against the loader's, and ``Trainer`` / ``train.py --device-data`` on the
CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from conftest import mini_corpus, preprocessed_corpus  # noqa: F401
from efficientspeech_tpu.data.dataset import LJSpeechDataset as JaxDataset
from efficientspeech_tpu.data.device_cache import (
    DeviceDataCache as JaxDeviceDataCache)
from efficientspeech_tpu.data.device_cache import (
    build_host_cache as jax_build_host_cache)
from efficientspeech_tpu_torch.config import (
    ModelConfig, PreprocessConfig, TrainConfig)
from efficientspeech_tpu_torch.data.dataset import (
    BucketedLoader, LJSpeechDataset)
from efficientspeech_tpu_torch.data.device_cache import (
    DeviceDataCache, build_host_cache, gather_batch, make_cached_train_step,
    upload_cache)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.training.loop import batch_to_device
from efficientspeech_tpu_torch.training.schedule import (
    warmup_cosine_schedule)
from efficientspeech_tpu_torch.training.state import create_train_state
from efficientspeech_tpu_torch.training.step import make_train_step
from efficientspeech_tpu_torch.weights import init_params

torch.set_num_threads(4)

N_PAD, M_PAD = 32, 256


def _cfg(jax_cfg) -> PreprocessConfig:
    return PreprocessConfig(preprocessed_path=jax_cfg.preprocessed_path,
                            text_cleaners=tuple(jax_cfg.text_cleaners),
                            max_length=jax_cfg.max_length)


def _model_cfg(cfg):
    stats = cfg.load_stats()
    return ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]), max_phoneme_len=N_PAD,
        max_mel_len=M_PAD)


def _state(cfg, seed=0):
    model = init_params(Phoneme2Mel(_model_cfg(cfg)), seed)
    train_cfg = TrainConfig(lr=1e-3, warmup_epochs=0, max_epochs=10)
    return create_train_state(model, train_cfg, warmup_cosine_schedule(
        train_cfg.lr, 0, 10, 2))


def test_host_cache_equals_jax(preprocessed_corpus):
    """build_host_cache gives the JAX package's arrays, key for key and
    bit for bit (padding, duration clamping, lengths, speakers)."""
    want = jax_build_host_cache(JaxDataset("train.txt", preprocessed_corpus),
                                N_PAD, M_PAD)
    got = build_host_cache(LJSpeechDataset(
        "train.txt", _cfg(preprocessed_corpus)), N_PAD, M_PAD)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a duration clamp engages at a short mel buffer, as in JAX
    short = build_host_cache(LJSpeechDataset(
        "train.txt", _cfg(preprocessed_corpus)), N_PAD, 40)
    want_short = jax_build_host_cache(
        JaxDataset("train.txt", preprocessed_corpus), N_PAD, 40)
    assert (short["mel_len"] == 40).any()
    for k in want_short:
        np.testing.assert_array_equal(short[k], want_short[k], err_msg=k)


@pytest.mark.parametrize("batch,drop_last", [(2, True), (3, True),
                                             (3, False), (8, True)])
def test_epoch_batches_equal_jax(preprocessed_corpus, batch, drop_last):
    """The same (steps, batch) index matrices as the JAX cache for the
    same seed and epochs, a corpus smaller than a batch included."""
    jax_cache = JaxDeviceDataCache(
        JaxDataset("train.txt", preprocessed_corpus), N_PAD, M_PAD)
    cache = DeviceDataCache(LJSpeechDataset(
        "train.txt", _cfg(preprocessed_corpus)), N_PAD, M_PAD, device="cpu")
    for epoch in range(3):
        np.testing.assert_array_equal(
            cache.epoch_batches(batch, epoch, seed=5, drop_last=drop_last),
            jax_cache.epoch_batches(batch, epoch, seed=5,
                                    drop_last=drop_last))


def test_gather_batch_is_the_loaders_batch(preprocessed_corpus):
    """Each gathered row equals the loader's batch of that one utterance;
    a bf16 cache gives the float32 mel of its bf16 rounding."""
    cfg = _cfg(preprocessed_corpus)
    ds = LJSpeechDataset("train.txt", cfg)
    host = build_host_cache(ds, N_PAD, M_PAD)
    arrays = upload_cache(host, "cpu")
    bf16 = upload_cache(host, "cpu", torch.bfloat16)
    loader = BucketedLoader(ds, 1, shuffle=False, max_phoneme_len=N_PAD,
                            max_mel_len=M_PAD, fixed_shape=True, prefetch=0)
    for i in range(len(ds)):
        want = loader._assemble(np.array([i]))
        got = gather_batch(arrays, torch.tensor([i]))
        assert set(got) == set(want) - {"text"}
        for k, v in got.items():
            assert v.dtype == torch.from_numpy(want[k]).dtype, k
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        mel = gather_batch(bf16, torch.tensor([i]))["mel"]
        assert mel.dtype == torch.float32
        assert torch.equal(mel, torch.from_numpy(
            want["mel"]).bfloat16().float())


def test_cached_step_equals_loader_step(preprocessed_corpus):
    """One cached step and one loader step on the same rows (the loader
    sorts them by length inside the batch): losses within 1e-6 relative,
    gradients within 1e-5 of each leaf's largest entry, and every updated
    parameter within 1e-6 where its gradient is above 1e-4 of the leaf's
    largest (Adam's first step is about lr · sign(g): at rounding-noise
    gradients the two may differ by up to 2 · lr)."""
    cfg = _cfg(preprocessed_corpus)
    ds = LJSpeechDataset("train.txt", cfg)
    arrays = upload_cache(build_host_cache(ds, N_PAD, M_PAD), "cpu")
    loader = BucketedLoader(ds, 4, shuffle=False, max_phoneme_len=N_PAD,
                            max_mel_len=M_PAD, fixed_shape=True, prefetch=0)
    rows = np.array([2, 0, 3, 1])
    s1, m1 = make_cached_train_step(torch.float32)(
        _state(cfg), arrays, torch.from_numpy(rows))
    s2, m2 = make_train_step(torch.float32)(
        _state(cfg), batch_to_device(loader._assemble(rows), "cpu"))
    assert set(m1) == set(m2)
    for k in m1:
        np.testing.assert_allclose(float(m1[k]), float(m2[k]), rtol=1e-6,
                                   err_msg=k)
    p2 = dict(s2.model.named_parameters())
    for name, p in s1.model.named_parameters():
        g, g2 = p.grad.numpy(), p2[name].grad.numpy()
        scale = np.abs(g2).max() + 1e-30
        np.testing.assert_allclose(g / scale, g2 / scale, atol=1e-5,
                                   err_msg=name)
        noise = np.abs(g2) <= 1e-4 * scale
        got, want = p.detach().numpy(), p2[name].detach().numpy()
        np.testing.assert_allclose(got[~noise], want[~noise], atol=1e-6,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(got[noise], want[noise], atol=2e-3,
                                   rtol=0, err_msg=name)


def _trainer(cfg, tmp_path, tag, batch_size=2, **train_kw):
    from efficientspeech_tpu_torch.training.loop import Trainer

    train_cfg = TrainConfig(batch_size=batch_size, max_epochs=4,
                            warmup_epochs=1,
                            checkpoint_dir=str(tmp_path / tag / "ckpt"),
                            log_dir=str(tmp_path / tag / "logs"),
                            **train_kw)
    return Trainer(_model_cfg(cfg), train_cfg, cfg, dtype=torch.float32,
                   device="cpu")


def _logged(trainer):
    with open(os.path.join(trainer.train_cfg.log_dir,
                           "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_multi_step_equals_single_steps(preprocessed_corpus, tmp_path):
    """``device_data_scan_steps=3`` (the JAX package's steps per host
    call) runs single steps in the port: ``on_step`` after each of the
    three steps, with metrics and final parameters bit-equal to
    ``device_data_scan_steps=1``'s."""
    cfg = _cfg(preprocessed_corpus)
    runs = []
    for tag, k in (("k1", 1), ("k3", 3)):
        trainer = _trainer(cfg, tmp_path, tag, device_data=True,
                           device_data_scan_steps=k)
        seen = []
        assert trainer.fit(max_steps=3, on_step=lambda step, m: seen.append(
            (step, {n: v.clone() for n, v in m.items()}))) == 3
        runs.append((seen, dict(trainer.model.named_parameters())))
    (want, want_p), (got, got_p) = runs
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    for (_, m), (_, w) in zip(got, want):
        assert set(m) == set(w)
        for k in w:
            assert m[k].shape == () and torch.equal(m[k], w[k]), k
    for name, p in got_p.items():
        assert torch.equal(p, want_p[name]), name


def test_trainer_device_data_epochs_and_eval(preprocessed_corpus, tmp_path):
    """Trainer.fit on the device-resident corpus: each epoch's mean losses
    equal the loader path's over the same rows (the cache's permutation
    fed through the loader's assembly) within 1e-6, with
    device_data_scan_steps 3 too; the cached evaluation equals the
    loader's, in one batch and in batches of one."""
    cfg = _cfg(preprocessed_corpus)
    cached = _trainer(cfg, tmp_path, "cached", device_data=True)
    scanned = _trainer(cfg, tmp_path, "scan", device_data=True,
                       device_data_scan_steps=3)
    plain = _trainer(cfg, tmp_path, "plain")
    assert cached.steps_per_epoch == plain.steps_per_epoch == 2
    assert cached.fit(max_steps=4) == 4
    assert scanned.fit(max_steps=4) == 4
    want = []
    for epoch in range(2):
        sums = None
        for rows in cached.device_cache.epoch_batches(2, epoch, seed=0):
            plain.state, m = plain.train_step(plain.state, batch_to_device(
                plain.train_loader._assemble(rows), "cpu"))
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        want.append({k.replace("_loss", ""): float(v) / 2
                     for k, v in sums.items()})
    for got in (_logged(cached), _logged(scanned)):
        epochs = [line for line in got if "loss" in line]
        assert [line["step"] for line in epochs] == [2, 4]
        for line, w in zip(epochs, want):
            for k, v in w.items():
                np.testing.assert_allclose(line[k], v, rtol=1e-6,
                                           err_msg=k)
    # the cached validation against the loader's: the two validation
    # utterances in one batch, then in two batches of one
    for batch_size in (2, 1):
        loader_eval = _trainer(cfg, tmp_path, f"eval{batch_size}",
                               batch_size=batch_size)
        loader_eval.model.load_state_dict(cached.model.state_dict())
        want_val = loader_eval.evaluate()
        cached.train_cfg = dataclasses.replace(cached.train_cfg,
                                               batch_size=batch_size)
        got_val = cached.evaluate()
        assert set(got_val) == set(want_val)
        for k in want_val:
            np.testing.assert_allclose(got_val[k], want_val[k], rtol=1e-6,
                                       err_msg=(k, batch_size))


def test_train_cli_device_data(preprocessed_corpus, tmp_path):
    """``train.py --device-data --device-data-bf16-mel
    --device-data-scan-steps 2`` on the CPU: three steps, finite logged
    losses and a checkpoint."""
    from efficientspeech_tpu_torch import train

    yaml = tmp_path / "c.yaml"
    yaml.write_text(f"path:\n  preprocessed_path: "
                    f"{preprocessed_corpus.preprocessed_path}\n")
    step = train.main([
        "--device", "cpu", "--precision", "f32", "--preprocess-config",
        str(yaml), "--batch-size", "2", "--max-phoneme-len", str(N_PAD),
        "--max-mel-len", str(M_PAD), "--max-steps", "3", "--device-data",
        "--device-data-bf16-mel", "--device-data-scan-steps", "2",
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--log-dir",
        str(tmp_path / "logs")])
    assert step == 3
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["step"] for line in lines] == [2, 3]
    assert all(np.isfinite(line["loss"]) for line in lines)
    assert os.path.isfile(tmp_path / "ckpt" / "step_00000003.pt")
