"""Device-resident training corpus: the whole preprocessed dataset lives
in the card's memory, and each training step uploads only its batch
indices (counterpart of the JAX package's ``data/device_cache.py``).

Every utterance is padded once to the train step's static
(max_phoneme_len, max_mel_len) shape, each array is moved to the card
once, and a step gathers its rows on the card from B int indices.  An
LJSpeech-size corpus (13,100 utterances, mel (S, 1,152, 80)) is about
4.8 GB in float32; ``mel_dtype=torch.bfloat16`` halves the mel's share,
and the gather casts it back to float32 before the loss.

On a data-parallel mesh every rank uploads the whole corpus to its own
device (the cache is replicated, as the JAX package replicates it over
its mesh), and each step takes the global index vector and gathers only
this rank's slice of it: no collective touches the corpus.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from efficientspeech_tpu_torch.device import resolve_device
from efficientspeech_tpu_torch.parallel.comm import reduce_metrics
from efficientspeech_tpu_torch.parallel.mesh import Mesh, shard_rows
from efficientspeech_tpu_torch.training.step import (
    data_group, forward_losses, make_train_step)


def build_host_cache(dataset, max_phoneme_len: int, max_mel_len: int
                     ) -> Dict[str, np.ndarray]:
    """Every utterance padded to the static training shape, by the
    loader's alignment rule (``BucketedLoader._assemble``): durations
    clamped so their cumulative sum never exceeds the mel buffer, and the
    mel's valid region the aligned frames."""
    s = len(dataset)
    n_pad, m_pad = max_phoneme_len, max_mel_len
    n_mels = dataset[0]["mel"].shape[1]
    cache = {
        "phoneme": np.zeros((s, n_pad), np.int32),
        "speaker": np.asarray(getattr(dataset, "speaker_id",
                                      np.zeros(s, np.int32))[:s], np.int32),
        "pitch": np.zeros((s, n_pad), np.float32),
        "energy": np.zeros((s, n_pad), np.float32),
        "duration": np.zeros((s, n_pad), np.int32),
        "mel": np.zeros((s, m_pad, n_mels), np.float32),
        "phoneme_len": np.zeros((s,), np.int32),
        "mel_len": np.zeros((s,), np.int32),
    }
    for i in range(s):
        item = dataset[i]
        n = min(len(item["phoneme"]), n_pad)
        cache["phoneme"][i, :n] = item["phoneme"][:n]
        cache["pitch"][i, :n] = item["pitch"][:n]
        cache["energy"][i, :n] = item["energy"][:n]
        d = item["duration"][:n].astype(np.int64)
        prev = np.cumsum(d) - d
        d = np.clip(np.minimum(d, m_pad - prev), 0, None)
        cache["duration"][i, :n] = d
        m = min(item["mel"].shape[0], m_pad, int(d.sum()))
        cache["mel"][i, :m] = item["mel"][:m]
        cache["phoneme_len"][i] = n
        cache["mel_len"][i] = m
    return cache


def upload_cache(host_cache: Dict[str, np.ndarray], device,
                 mel_dtype: torch.dtype = torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """The host cache on ``device``, each array moved once; the mel is
    cast to ``mel_dtype`` on the host first, so a bf16 mel moves half the
    bytes."""
    out = {}
    for k, v in host_cache.items():
        t = torch.from_numpy(v)
        if k == "mel":
            t = t.to(mel_dtype)
        out[k] = t.to(device)
    return out


def gather_batch(cache: Dict[str, torch.Tensor], idx: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """The batch of rows ``idx`` (B,) gathered on the device, its masks
    derived from the lengths: the loader's batch schema (without
    ``text``), so the step code is shared with the loader's path."""
    n_pad = cache["phoneme"].shape[1]
    m_pad = cache["mel"].shape[1]
    dev = cache["phoneme"].device
    plen = cache["phoneme_len"][idx]
    mlen = cache["mel_len"][idx]
    pos_n = torch.arange(n_pad, dtype=torch.int32, device=dev)
    pos_m = torch.arange(m_pad, dtype=torch.int32, device=dev)
    return {
        "phoneme": cache["phoneme"][idx],
        "phoneme_mask": pos_n[None, :] >= plen[:, None],
        "speaker": cache["speaker"][idx],
        "pitch": cache["pitch"][idx],
        "energy": cache["energy"][idx],
        "duration": cache["duration"][idx],
        "mel": cache["mel"][idx].float(),
        "mel_mask": pos_m[None, :] >= mlen[:, None],
    }


class DeviceDataCache:
    """The cache's build, upload and per-epoch index batches.  ``device``
    defaults to the card and raises without one."""

    def __init__(self, dataset, max_phoneme_len: int, max_mel_len: int,
                 mel_dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        host = build_host_cache(dataset, max_phoneme_len, max_mel_len)
        self.num_samples = len(dataset)
        self.arrays = upload_cache(host, self.device, mel_dtype)
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in self.arrays.values())

    def epoch_batches(self, batch_size: int, epoch: int, seed: int = 0,
                      drop_last: bool = True) -> np.ndarray:
        """(steps, batch) int32 index matrix of one shuffled epoch: the
        JAX package's permutation for the same seed and epoch."""
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(self.num_samples).astype(np.int32)
        n_full = len(order) // batch_size
        if n_full == 0:
            drop_last = False  # corpus smaller than one batch: resample
        if not drop_last and len(order) % batch_size:
            # pad the tail batch by resampling (training-only semantics);
            # tile when the corpus is smaller than even one batch
            pad = batch_size - len(order) % batch_size
            reps = -(-pad // len(order))
            order = np.concatenate([order] + [order] * reps)[
                : (n_full + 1) * batch_size]
            n_full = len(order) // batch_size
        return order[: n_full * batch_size].reshape(n_full, batch_size)


def make_cached_eval_step(dtype: torch.dtype = torch.bfloat16,
                          mesh: Optional[Mesh] = None):
    """eval_step(model, cache, idx, row_valid) → the teacher-forced losses
    over the device-resident rows ``idx``, no grad.  ``row_valid`` (B,)
    bool marks the real rows: a last batch padded to the full batch with
    ``row_valid`` False rows has them masked out of every loss, so its
    losses are those of its real rows (the JAX package's rule; the model
    still sees the padding rows' data, finite everywhere).  On a mesh
    ``idx`` and ``row_valid`` are the global vectors; each rank gathers
    its slice, and the losses are the global ones."""
    group = data_group(mesh)

    @torch.no_grad()
    def eval_step(model, cache, idx, row_valid) -> Dict[str, torch.Tensor]:
        rows = shard_rows(len(idx), mesh)
        batch = gather_batch(cache, idx[rows])
        pad = ~row_valid[rows][:, None]
        loss_batch = dict(batch, phoneme_mask=batch["phoneme_mask"] | pad,
                          mel_mask=batch["mel_mask"] | pad)
        return reduce_metrics(forward_losses(
            model, batch, dtype, group, loss_batch=loss_batch), group)

    return eval_step


def make_cached_train_step(dtype: torch.dtype = torch.bfloat16,
                           mesh: Optional[Mesh] = None) -> Callable:
    """train_step(state, cache, idx) → (state, metrics): the gather on the
    card, then the port's train step (forward, masked losses, backward,
    AdamW).  On a mesh ``idx`` is the global index vector and each rank
    gathers its slice."""
    step = make_train_step(dtype, mesh)

    def cached_step(state, cache, idx):
        return step(state, gather_batch(cache, idx[shard_rows(len(idx),
                                                             mesh)]))

    return cached_step
