"""The training loop: epochs over the bucketed loader, train steps on the
card, epoch-averaged metrics in ``metrics.jsonl``, checkpoints, resume, a
graceful stop on SIGTERM/SIGINT, and at each validation the teacher-forced
losses and the validation audio with its objective quality metrics
(counterpart of the JAX package's ``training/loop.py``).  With
``TrainConfig.device_data`` the train and validation sets live on the
card (``data/device_cache.py``) and each step uploads only its indices.

With a ``mesh`` (``parallel/mesh.py``) each rank runs the same seeded
loader or cache permutation and takes its rows of every global batch;
its step sums the gradients over the data group, so every rank takes
the update of the global batch.  Rank 0 alone writes metrics.jsonl,
checkpoints (the unsharded ``step_*.pt``, which a one-device run
resumes or serves) and the validation audio; every rank restores on
resume.  A stop signal on any rank stops them all after the same step.
"""

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from efficientspeech_tpu_torch.config import (
    HifiGanConfig, ModelConfig, PreprocessConfig, TrainConfig)
from efficientspeech_tpu_torch.data.dataset import (
    BucketedLoader, LJSpeechDataset)
from efficientspeech_tpu_torch.data.device_cache import (
    DeviceDataCache, make_cached_eval_step, make_cached_train_step)
from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.eval.quality import (
    batch_quality, duration_mae, utterance_quality)
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.models.modules import (
    cast_params_, compute_params)
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.ops.kernels import decoder_block
from efficientspeech_tpu_torch.parallel.mesh import (
    Mesh, any_rank, barrier, make_mesh, shard_batch)
from efficientspeech_tpu_torch.training.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint)
from efficientspeech_tpu_torch.training.schedule import (
    warmup_cosine_schedule)
from efficientspeech_tpu_torch.training.state import create_train_state
from efficientspeech_tpu_torch.training.step import (
    make_eval_step, make_train_step)
from efficientspeech_tpu_torch.utils.tools import write_batch_wavs
from efficientspeech_tpu_torch.weights import init_params, load_jax_params


def pad_rows(v: np.ndarray, rows: int) -> np.ndarray:
    """``v`` padded along its first axis to ``rows`` rows: zeros, or True
    for a boolean mask (True = pad)."""
    if len(v) >= rows:
        return v
    padding = np.zeros((rows - len(v),) + v.shape[1:], v.dtype)
    if v.dtype == bool:
        padding[:] = True
    return np.concatenate([v, padding], axis=0)


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, scalars: Dict[str, float]):
        self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self.jsonl.flush()


def batch_to_device(batch: Dict, device: torch.device) -> Dict:
    """The loader's numpy batch (minus ``text``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items() if k != "text"}


class Trainer:
    """``device`` defaults to the card and raises without one.  On the card
    the mel decoder's LayerNorms run through kernel K3 and its block bodies
    through K4 (widths 128 and 256, so every preset, in bf16 or float32),
    and a decoder width or dtype K4 does not cover raises here; on the CPU
    the decoder takes its plain route (same parameters).  A rank of a
    mesh runs the same single-device step with its kernels on.

    ``mesh``: the data-parallel mesh this rank belongs to (default one of
    ``train_cfg.num_data_axis`` ranks, which must then run under
    ``parallel.launch``); ``train_cfg.batch_size`` is the global batch.

    ``hifigan_params`` (a JAX-layout tree, e.g. from
    ``convert.from_torch.load_hifigan_checkpoint``) of a vocoder shaped by
    ``hifigan_cfg`` makes ``validate_audio`` write and score waveforms;
    without it only the mel and duration metrics are computed."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 preprocess_cfg: PreprocessConfig,
                 hifigan_cfg: Optional[HifiGanConfig] = None,
                 hifigan_params=None,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        if mesh is None and train_cfg.num_data_axis > 1:
            mesh = make_mesh(data_parallel=train_cfg.num_data_axis)
        self.mesh = mesh
        self.is_rank0 = mesh is None or mesh.rank == 0
        n_data = 1 if mesh is None else mesh.axis_size("data")
        if train_cfg.batch_size % n_data:
            raise ValueError(f"batch size {train_cfg.batch_size} does not "
                             f"split over {n_data} data-parallel ranks")
        self.train_cfg = train_cfg
        self.preprocess_cfg = preprocess_cfg
        self.hifigan_cfg = hifigan_cfg or HifiGanConfig()
        self.hifigan_params = hifigan_params
        self._vocoder = None
        self.dtype = dtype
        self.train_ds = LJSpeechDataset("train.txt", preprocess_cfg)
        self.val_ds = LJSpeechDataset("val.txt", preprocess_cfg)
        # a multi-speaker corpus gets a speaker embedding
        if self.train_ds.n_speakers > model_cfg.n_speakers:
            model_cfg = dataclasses.replace(
                model_cfg, n_speakers=self.train_ds.n_speakers)
        self.model_cfg = model_cfg

        fused = self.device.type == "cuda"
        self.model = Phoneme2Mel(model_cfg, fused_decoder_norm=fused,
                                 fused_decoder_block=fused)
        if fused:
            decoder_block.check_supported(
                self.model.decoder.proj_norm.weight.shape[0], dtype)
        init_params(self.model, train_cfg.seed)
        self.model.to(self.device)

        self.logger = (MetricLogger(train_cfg.log_dir) if self.is_rank0
                       else None)
        # every batch at the static (max_phoneme_len, max_mel_len) shape:
        # the train-mode model expands into a max_mel_len buffer
        self.train_loader = BucketedLoader(
            self.train_ds, train_cfg.batch_size, shuffle=True,
            seed=train_cfg.seed, max_phoneme_len=model_cfg.max_phoneme_len,
            max_mel_len=model_cfg.max_mel_len, drop_last=True,
            fixed_shape=True)
        self.val_loader = BucketedLoader(
            self.val_ds, train_cfg.batch_size, shuffle=False,
            max_phoneme_len=model_cfg.max_phoneme_len,
            max_mel_len=model_cfg.max_mel_len, fixed_shape=True,
            drop_last=False)
        self.steps_per_epoch = max(1, len(self.train_loader))
        self.lr_schedule = warmup_cosine_schedule(
            train_cfg.lr, train_cfg.warmup_epochs, train_cfg.max_epochs,
            self.steps_per_epoch)
        self.state = create_train_state(self.model, train_cfg,
                                        self.lr_schedule)
        self.train_step = make_train_step(dtype, mesh)
        self.eval_step = make_eval_step(dtype, mesh)

        # the device-resident corpus: the train and validation sets on the
        # card; a step uploads B indices instead of a batch
        self.device_cache = self.val_device_cache = None
        self._cached_step = self._cached_eval = None
        if train_cfg.device_data:
            mel_dtype = (torch.bfloat16 if train_cfg.device_cache_bf16_mel
                         else torch.float32)
            self.device_cache = DeviceDataCache(
                self.train_ds, model_cfg.max_phoneme_len,
                model_cfg.max_mel_len, mel_dtype=mel_dtype,
                device=self.device)
            self._cached_step = make_cached_train_step(dtype, mesh)
            # validation mel targets stay float32: the loader's eval losses
            self.val_device_cache = DeviceDataCache(
                self.val_ds, model_cfg.max_phoneme_len,
                model_cfg.max_mel_len, device=self.device)
            self._cached_eval = make_cached_eval_step(dtype, mesh)
            mb = (self.device_cache.nbytes
                  + self.val_device_cache.nbytes) / 2 ** 20
            self.print_rank0(
                f"device data cache: {self.device_cache.num_samples} train "
                f"+ {self.val_device_cache.num_samples} val samples, "
                f"{mb:.0f} MB")

    def print_rank0(self, *args):
        """print, on rank 0 of the mesh only."""
        if self.is_rank0:
            print(*args)

    def _indices(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows.astype(np.int64)).to(self.device)

    def _epoch_steps(self, epoch: int):
        """(step function, its arguments after the state) of each step of
        one epoch: the loader's batches, or on the device-resident corpus
        the cache's index rows (one step each, whatever
        ``device_data_scan_steps`` says).  On a mesh this rank's rows of
        the loader's batch; the cached step slices its own indices."""
        if self.device_cache is None:
            self.train_loader.epoch = epoch  # deterministic resume
            for batch in self.train_loader:
                yield self.train_step, (batch_to_device(
                    shard_batch(batch, self.mesh), self.device),)
            return
        arrays = self.device_cache.arrays
        for row in self.device_cache.epoch_batches(
                self.train_cfg.batch_size, epoch, seed=self.train_cfg.seed):
            yield self._cached_step, (arrays, self._indices(row))

    def maybe_resume(self) -> int:
        path = latest_checkpoint(self.train_cfg.checkpoint_dir)
        if path:
            self.state = restore_checkpoint(path, self.state)
            self.print_rank0(f"resumed from {path} at step "
                             f"{self.state.step}")
        return self.state.step

    def _eval_batches(self):
        """(metrics, utterances) of each validation batch: the loader's
        batches, or the device-resident corpus's rows in order.  The last
        batch is padded to the full batch, as the JAX package pads it, so
        that it splits over the mesh: the loader's with all-pad rows (every
        mask True), the cache's with ``row_valid`` False rows; either way
        the padding adds nothing to the losses."""
        bs = self.train_cfg.batch_size
        if self.val_device_cache is None:
            for batch in self.val_loader:
                real_b = len(batch["text"])
                host = {k: pad_rows(np.asarray(v), bs)
                        for k, v in batch.items() if k != "text"}
                yield self.eval_step(self.model, batch_to_device(
                    shard_batch(host, self.mesh), self.device)), real_b
            return
        s = self.val_device_cache.num_samples
        for lo in range(0, s, bs):
            real_b = min(bs, s - lo)
            rows = np.zeros(bs, np.int64)
            rows[:real_b] = np.arange(lo, lo + real_b)
            valid = torch.from_numpy(np.arange(bs) < real_b).to(self.device)
            yield self._cached_eval(self.model, self.val_device_cache.arrays,
                                    self._indices(rows), valid), real_b

    def evaluate(self) -> Dict[str, float]:
        """Teacher-forced losses over the validation set, weighted by the
        number of utterances in each batch; the sums stay on the card."""
        acc, count = None, 0
        self.model.eval()
        for metrics, real_b in self._eval_batches():
            metrics = {k: v * real_b for k, v in metrics.items()}
            acc = metrics if acc is None else {
                k: acc[k] + metrics[k] for k in acc}
            count += real_b
        self.model.train()
        sums = {k: float(v) for k, v in (acc or {}).items()}
        return {k.replace("_loss", ""): v / max(count, 1)
                for k, v in sums.items()}

    # --- validation audio dumps (reference: model.py:246-271) --------------
    def _get_vocoder(self) -> Optional[HifiGanGenerator]:
        """The conv HiFi-GAN generator on the card, its weights cast to the
        compute dtype, built at first use; None without vocoder
        parameters."""
        if self._vocoder is None and self.hifigan_params is not None:
            gen = HifiGanGenerator(self.hifigan_cfg)
            load_jax_params(gen, self.hifigan_params)
            self._vocoder = cast_params_(gen.to(self.device), self.dtype)
        return self._vocoder

    def _val_predict(self, phoneme: torch.Tensor, mask: torch.Tensor):
        """The free-running acoustic forward in the compute dtype: (mel,
        mel_len clamped to max_mel_len, the rounded and clamped
        per-phoneme durations the length regulator consumed; the quality
        pass scores these against the aligner's)."""
        pred = functional_call(self.model,
                               compute_params(self.model, self.dtype),
                               (phoneme, mask), dict(train=False))
        dur = torch.round(pred["duration"][..., 0].float()).clamp_min(0.0)
        dur = torch.where(mask, torch.zeros_like(dur), dur)
        return (pred["mel"], torch.clamp(pred["mel_len"],
                                         max=self.model_cfg.max_mel_len),
                dur)

    @torch.no_grad()
    def validate_audio(self, epoch: int, quality_n: int = 16
                       ) -> Optional[Dict[str, float]]:
        """Validation wav dumps (reference: model.py:246-271) and the
        objective quality pass over the first ``quality_n`` utterances of
        the first validation batch (eval/quality.py): MCD-DTW and duration
        MAE always; with vocoder parameters also ``prediction-i.wav``,
        ``reconstruction-i.wav`` (the ground-truth mel through the same
        vocoder) and ``prediction.txt`` under ``train_cfg.wav_path``, and
        F0 RMSE, voicing F1 and the reconstruction floor of the MCD.  The
        device work is the free-running forward and two calls of the conv
        generator (with ``valid_len``); its results reach the host in one
        read.  Returns the aggregated metrics."""
        vocoder = self._get_vocoder()
        batch = next(iter(self.val_loader))
        phoneme = torch.from_numpy(batch["phoneme"]).to(self.device)
        mask = torch.from_numpy(batch["phoneme_mask"]).to(self.device)
        self.model.eval()
        try:
            mel, mel_len, dur_pred = self._val_predict(phoneme, mask)
        finally:
            self.model.train()
        hop = self.preprocess_cfg.audio.hop_length
        sr = self.preprocess_cfg.audio.sampling_rate
        gt_len = (~batch["mel_mask"]).sum(axis=1).astype(np.int32)
        parts = [mel, mel_len, dur_pred]
        if vocoder is not None:
            parts.append(vocoder(mel, valid_len=mel_len))
            parts.append(vocoder(
                torch.from_numpy(batch["mel"]).to(self.device),
                valid_len=torch.from_numpy(gt_len).to(self.device)))
        # one host read for everything the dump and quality pass need
        flat = torch.cat([p.float().reshape(-1) for p in parts]).cpu()
        host = [t.reshape(p.shape).numpy() for t, p in zip(
            flat.split([p.numel() for p in parts]), parts)]
        mel, mel_len, dur_pred = host[0], host[1].astype(np.int64), host[2]
        wavs, rec = (host[3], host[4]) if vocoder is not None else (None,
                                                                     None)
        if wavs is not None:
            audio = self.preprocess_cfg.audio
            write_batch_wavs(wavs, mel_len * hop, self.train_cfg.wav_path,
                             "prediction", sr, audio.max_wav_value)
            write_batch_wavs(rec, gt_len * hop, self.train_cfg.wav_path,
                             "reconstruction", sr, audio.max_wav_value)
            with open(os.path.join(self.train_cfg.wav_path,
                                   "prediction.txt"), "w") as f:
                for t in batch["text"]:
                    f.write(t + "\n")

        per_utt = []
        for i in range(min(quality_n, len(batch["text"]))):
            p_len, g_len = int(mel_len[i]), int(gt_len[i])
            real = ~np.asarray(batch["phoneme_mask"][i])
            if p_len < 1 or g_len < 1:
                # an untrained duration predictor can emit an all-zero
                # expansion: duration MAE is still defined (and says why
                # the mel is empty)
                per_utt.append({"duration_mae_frames": duration_mae(
                    dur_pred[i], batch["duration"][i], real)})
                continue
            per_utt.append(utterance_quality(
                mel[i][:p_len], np.asarray(batch["mel"][i][:g_len],
                                           np.float32),
                dur_pred=dur_pred[i], dur_gt=batch["duration"][i],
                phoneme_real=real,
                wav_pred=None if wavs is None else wavs[i][:p_len * hop],
                wav_ref=None if rec is None else rec[i][:g_len * hop],
                sr=sr, hop=hop))
        return batch_quality(per_utt) if per_utt else None

    def fit(self, max_epochs: Optional[int] = None,
            checkpoint_every_epochs: int = 10,
            max_steps: Optional[int] = None,
            on_step: Optional[Callable[[int, Dict], None]] = None) -> int:
        """Train until ``max_epochs`` or ``max_steps``; returns the last
        step.  SIGTERM/SIGINT (caught when fit runs on the main thread)
        finish the current step, checkpoint and return; a later ``fit``
        resumes from the checkpoint.  On a mesh the ranks agree after
        every step whether any was signalled (a host all-reduce), so all
        stop after the same step and rank 0 checkpoints it.
        ``on_step(step, metrics)`` runs after every step."""
        max_epochs = max_epochs or self.train_cfg.max_epochs
        start_step = self.maybe_resume()
        t0 = time.time()
        step = start_step
        signalled = threading.Event()
        old_handlers = {}
        if threading.current_thread() is threading.main_thread():
            def request_stop(signum, _frame):
                signalled.set()
                print(f"signal {signum}: stopping after this step, "
                      "checkpointing...")

            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, request_stop)

        self.model.train()
        stop = False
        try:
            for epoch in range(start_step // self.steps_per_epoch,
                               max_epochs):
                # metric sums stay on the card; one fetch per epoch
                acc, count = None, 0
                for step_fn, step_args in self._epoch_steps(epoch):
                    self.state, metrics = step_fn(self.state, *step_args)
                    step = self.state.step
                    count += 1
                    acc = metrics if acc is None else {
                        k: acc[k] + metrics[k] for k in acc}
                    if on_step is not None:
                        on_step(step, metrics)
                    stop = any_rank(signalled.is_set(), self.mesh)
                    if (max_steps is not None and step >= max_steps) or stop:
                        break
                if self.is_rank0:
                    keys = sorted(acc or {})
                    values = (torch.stack([acc[k] for k in keys]).cpu()
                              .tolist() if keys else [])
                    scalars = {k.replace("_loss", ""): v / max(count, 1)
                               for k, v in zip(keys, values)}
                    scalars["lr"] = float(self.lr_schedule(step))
                    scalars["epoch"] = epoch
                    scalars["wall_secs"] = time.time() - t0
                    self.logger.log(step, scalars)

                done = (max_steps is not None and step >= max_steps) or stop
                if (epoch + 1) % checkpoint_every_epochs == 0 and not done \
                        and self.is_rank0:
                    save_checkpoint(self.train_cfg.checkpoint_dir,
                                    self.state)
                if epoch >= 1 and \
                        (epoch + 1) % self.train_cfg.val_every_n_epochs == 0:
                    val = self.evaluate()
                    if self.is_rank0:
                        self.logger.log(step, {f"val_{k}": v
                                               for k, v in val.items()})
                        try:
                            quality = self.validate_audio(epoch)
                            if quality:
                                self.logger.log(step, {
                                    f"val_{k}": v
                                    for k, v in quality.items()})
                        except Exception as e:  # must not kill training
                            print(f"validation audio dump failed: {e}")
                if done:
                    break
            if self.is_rank0:
                save_checkpoint(self.train_cfg.checkpoint_dir, self.state)
            # the checkpoint is on disk before any rank returns
            barrier(self.mesh)
        finally:
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)
        return step
