"""Rank bodies for the parallel tests of the PyTorch port.

``parallel.launch`` imports a rank's function by name in each spawned
process, so these live in a module of their own that imports torch and
the port only (a test module imports JAX as well).  Each takes the
rank's device and numpy inputs, and returns numpy results that the
tests hold against the JAX package in the parent process."""

import os
import signal
import threading

import numpy as np
import torch
import torch.distributed as dist

from efficientspeech_tpu_torch.config import (
    AudioConfig, HifiGanConfig, ModelConfig, TrainConfig)
from efficientspeech_tpu_torch.device import set_full_f32
from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
from efficientspeech_tpu_torch.parallel import comm
from efficientspeech_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, shard_batch)
from efficientspeech_tpu_torch.training.schedule import (
    warmup_cosine_schedule)
from efficientspeech_tpu_torch.training.state import create_train_state
from efficientspeech_tpu_torch.training.step import make_train_step
from efficientspeech_tpu_torch.weights import load_jax_params


def _numpy(d):
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _stepped(state, metrics):
    """The metrics, the gradients and the parameters after a step."""
    return dict(metrics=_floats(metrics), grads=_numpy(
        {n: p.grad for n, p in state.model.named_parameters()}),
        params=_numpy(state.model.state_dict()))


def acoustic_state(tree, model_cfg: ModelConfig, lr: float, device,
                   mesh=None, tensor_parallel=False, fused=False):
    """A float32-master train state on ``device`` from a JAX-layout tree:
    lr constant after no warmup; tensor-parallel shards when asked; the
    mel decoder on its kernel routes (K3, K4) when ``fused``."""
    model = load_jax_params(Phoneme2Mel(
        model_cfg, fused_decoder_norm=fused, fused_decoder_block=fused),
        tree).to(device)
    if tensor_parallel:
        from efficientspeech_tpu_torch.parallel.sharding import (
            shard_tensor_parallel)

        shard_tensor_parallel(model, mesh)
    cfg = TrainConfig(lr=lr, warmup_epochs=0, max_epochs=10)
    return create_train_state(model, cfg, warmup_cosine_schedule(
        lr, 0, 10, 4))


def step_once(state, batch, dtype, device, mesh):
    """One train step on this rank's rows of the numpy ``batch``."""
    rows = {k: torch.from_numpy(v).to(device)
            for k, v in shard_batch(batch, mesh).items()}
    return make_train_step(dtype, mesh)(state, rows)


def comm_checks(device):
    """The collectives on rank-numbered inputs: (name → result) for the
    parent to check."""
    mesh = make_mesh()
    g = mesh.group("data")
    r = mesh.rank
    out = {}
    x = torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3) \
        + 10 * r
    out["all_gather"] = comm.all_gather(x, g, dim=1)
    out["all_reduce_sum"] = comm.all_reduce_sum(x, g)
    # halo of w = 2 on a (1, 3, 2) block: the global axis is 6 rows
    blk = torch.arange(6, dtype=torch.float32, device=device).reshape(
        1, 3, 2) + 6 * r
    out["halo"] = comm.halo_exchange(blk, 2, g)
    # forward and backward of the differentiable forms, against a weight
    # c that is the same on every rank (cr: this rank's own)
    c = torch.arange(1.0, 7.0, device=device)
    cr = c * (r + 1)
    for name, fn, inp, weight in (
            ("gather_last", comm.gather_last, torch.ones(3), c),
            ("split_last", comm.split_last, torch.ones(6), cr[:3]),
            ("reduce_sum", comm.reduce_sum, torch.ones(6) * (r + 1), c),
            ("copy_in", comm.copy_in, torch.ones(6), cr)):
        t = inp.to(device).requires_grad_(True)
        y = fn(t, g)
        (y * weight).sum().backward()
        out[name] = y.detach()
        out[name + "_grad"] = t.grad
    return {k: v.cpu().numpy() for k, v in out.items()}


def dp_acoustic(device, case):
    """The data-parallel step (float32 unless ``case["dtype"]``) on
    ``case["batch"]`` from ``case["tree"]``: metrics, the summed gradients
    and the stepped parameters; ``case["fused"]`` puts the decoder on its
    kernel routes; ``case["cache"]`` adds the cached step on the device
    corpus and the evaluation of a Trainer on the mesh, by the loader and
    by the cache."""
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3

    set_full_f32()  # TF32 is a per-process setting: off, as in the parent
    mesh = make_mesh()
    out = {}
    state = acoustic_state(case["tree"], case["model_cfg"], case["lr"],
                           device, fused=case.get("fused", False))
    counters = (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
                k4.launches_bwd)
    for d in counters:
        d.update(dict.fromkeys(d, 0))
    state, m = step_once(state, case["batch"],
                         case.get("dtype", torch.float32), device, mesh)
    out["step"] = _stepped(state, m)
    n = [sum(d.values()) for d in counters]
    out["launches"] = {"k3": (n[0], n[1]), "k4": (n[2], n[3])}
    if "cache" in case:
        out.update(_cache_cases(device, mesh, case))
    return out


def _cache_cases(device, mesh, case):
    from efficientspeech_tpu_torch.data.dataset import LJSpeechDataset
    from efficientspeech_tpu_torch.data.device_cache import (
        build_host_cache, make_cached_train_step, upload_cache)
    from efficientspeech_tpu_torch.training.loop import Trainer

    c = case["cache"]
    model_cfg = case["model_cfg"]
    host = build_host_cache(LJSpeechDataset("train.txt", c["pre_cfg"]),
                            model_cfg.max_phoneme_len, model_cfg.max_mel_len)
    state = acoustic_state(case["tree"], model_cfg, case["lr"], device)
    idx = torch.from_numpy(c["idx"].astype(np.int64)).to(device)
    state, m = make_cached_train_step(torch.float32, mesh)(
        state, upload_cache(host, device), idx)
    out = {"cached": _stepped(state, m)}
    evals = {}
    for device_data in (False, True):
        sub = os.path.join(c["root"], f"eval{int(device_data)}")
        cfg = TrainConfig(batch_size=4, max_epochs=1, warmup_epochs=1,
                          device_data=device_data,
                          checkpoint_dir=os.path.join(sub, "ckpt"),
                          log_dir=os.path.join(sub, "logs"))
        tr = Trainer(model_cfg, cfg, c["pre_cfg"], dtype=torch.float32,
                     device=device, mesh=mesh)
        load_jax_params(tr.model, case["tree"])
        evals[device_data] = tr.evaluate()
    out["eval"] = evals
    return out


def dp_gan(device, case):
    """One data-parallel GAN step from JAX-layout trees: metrics and the
    averaged gradients of the generator and the discriminators."""
    from efficientspeech_tpu_torch.training.vocoder import (
        create_vocoder_trainer)

    mesh = make_mesh()
    _, init, step = create_vocoder_trainer(
        HifiGanConfig(**case["cfg"]), AudioConfig(), device=device,
        mesh=mesh)
    state = init(gen_params=case["gen_tree"], disc_params=case["disc_trees"])
    rows = shard_batch({"mel": case["mel"], "wav": case["wav"]}, mesh)
    state, m = step(state, torch.from_numpy(rows["mel"]).to(device),
                    torch.from_numpy(rows["wav"]).to(device))
    grads = {f"{part}.{n}": p.grad for part in ("gen", "mpd", "msd")
             for n, p in getattr(state, part).named_parameters()}
    return {"metrics": _floats(m), "grads": _numpy(grads)}


def dp_sigterm(device, case):
    """``Trainer.fit`` of many epochs on the mesh; rank 1 alone receives
    SIGTERM after ``case["after_s"]``.  Returns the final step."""
    from efficientspeech_tpu_torch.training.loop import Trainer

    mesh = make_mesh()
    cfg = TrainConfig(batch_size=2, max_epochs=10_000, warmup_epochs=1,
                      checkpoint_dir=case["ckpt"], log_dir=case["logs"])
    tr = Trainer(case["model_cfg"], cfg, case["pre_cfg"],
                 dtype=torch.float32, device=device, mesh=mesh)
    timer = None
    if mesh.rank == 1:
        timer = threading.Timer(case["after_s"], lambda: os.kill(
            os.getpid(), signal.SIGTERM))
        timer.start()
    try:
        return tr.fit(checkpoint_every_epochs=10_000)
    finally:
        if timer is not None:
            timer.cancel()


def seq_vocode(device, case):
    """``seq_parallel_vocode`` of each case on its mesh: this rank's
    block of the waveform, with its coordinates."""
    from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
    from efficientspeech_tpu_torch.models.hifigan_folded import fold_hifigan
    from efficientspeech_tpu_torch.parallel.seq_vocoder import (
        seq_parallel_vocode)

    set_full_f32()  # TF32 is a per-process setting: off, as in the parent
    cfg = HifiGanConfig(**case["cfg"])
    out = []
    for c in case["cases"]:
        gen = load_jax_params(HifiGanGenerator(cfg), c["tree"]).to(device)
        arrays, meta = fold_hifigan(gen, dtype=c.get("dtype",
                                                     torch.float32))
        mesh = Mesh.create(c["mesh"])
        vl = (None if c["valid"] is None
              else torch.from_numpy(c["valid"]).to(device))
        wav = seq_parallel_vocode(
            arrays, meta, cfg, torch.from_numpy(c["mel"]).to(device), mesh,
            valid_len=vl, batch_axis=c.get("batch_axis"),
            dtype=c.get("dtype", torch.float32))
        out.append({"coords": mesh.coords(), "wav": wav.float().cpu()
                    .numpy()})
    return out


def tp_step(device, case):
    """One data × tensor parallel float32 step: the rules' choice, the
    metrics, and the gathered gradients and stepped parameters."""
    from efficientspeech_tpu_torch.parallel.sharding import (
        gather_params, tp_param_shardings)

    mesh = make_mesh(data_parallel=case["data"], model_parallel=case["model"])
    full = load_jax_params(Phoneme2Mel(case["model_cfg"]), case["tree"])
    shardings = tp_param_shardings(full, mesh)
    state = acoustic_state(case["tree"], case["model_cfg"], case["lr"],
                           device, mesh, tensor_parallel=True)
    local = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
    state, m = step_once(state, case["batch"], torch.float32, device, mesh)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    return {"metrics": _floats(m), "shardings": shardings, "local": local,
            "grads": _numpy(gather_params(state.model, grads)),
            "params": _numpy(gather_params(state.model)),
            "rank": dist.get_rank()}


def run_cases(device, cases):
    """Each (name, rank body, case) of ``cases`` in turn, in one process
    group: {name: result}."""
    return {name: fn(device, *([] if case is None else [case]))
            for name, fn, case in cases}
