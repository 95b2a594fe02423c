"""HiFi-GAN vocoder training CLI of the PyTorch port (the flags of the
JAX package's ``train_vocoder.py``): random wav segments from the
corpus, mel targets computed on the card from the same crops, the LSGAN +
feature-matching + 45·mel-L1 objective (``training/vocoder.py``),
checkpoints with resume, and metrics.jsonl.

    python -m efficientspeech_tpu_torch.train_vocoder \\
        --preprocess-config config.yaml --steps 1000 --batch-size 8 \\
        [--resume] [--init-generator PATH]

``--from-acoustic CKPT`` trains on the acoustic model's teacher-forced
predicted mels (aligned with the real audio by the ground-truth
durations) instead of the ground-truth mels: the fine-tuned-vocoder
recipe (LJ_FT_T2_V2) the reference bundles weights for.  CKPT is a
checkpoint of the port's trainer (``step_*.pt`` or its directory) or a
reference EfficientSpeech ``.ckpt``.  With ``--holdout-frac`` a slice of
those pairs is held out and scored before and after training
(``eval/vocoder_eval.py``).

Everything runs in float32 with TF32 off, as the JAX package trains its
vocoder.  It runs on the CUDA card, and raises without one unless given
``--device cpu``.

``--data-parallel N`` (which must divide ``--batch-size``) spawns one
rank a card over NCCL (CPU processes over gloo with ``--device cpu``;
N above the number of cards raises): every rank draws the same global
crops from the seeded sampler and trains on its rows, the gradients are
averaged over the ranks, and rank 0 alone writes the checkpoints, the
logs and the holdout eval.
"""

import argparse
import glob
import json
import os
import time

import numpy as np
import torch


def _load_acoustic(model, ckpt: str):
    """A checkpoint of the port's trainer (a ``step_*.pt`` file, or its
    directory's latest) or a reference EfficientSpeech checkpoint into
    ``model`` (a ``Phoneme2Mel``)."""
    from efficientspeech_tpu_torch.infer import _is_port_checkpoint
    from efficientspeech_tpu_torch.training.checkpoint import (
        latest_checkpoint)
    from efficientspeech_tpu_torch.weights import load_jax_params

    if _is_port_checkpoint(ckpt):
        path = latest_checkpoint(ckpt) if os.path.isdir(ckpt) else ckpt
        if path is None:
            raise FileNotFoundError(f"no step_*.pt checkpoint in {ckpt}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["params"], strict=True)
        return
    from efficientspeech_tpu_torch.convert.from_torch import (
        _torch_load_numpy, convert_efficientspeech_state_dict)

    cfg = model.cfg
    tree = convert_efficientspeech_state_dict(
        _torch_load_numpy(ckpt), depth=cfg.depth, n_blocks=cfg.n_blocks,
        block_depth=cfg.block_depth)
    load_jax_params(model, tree["phoneme2mel"])


def build_acoustic_pairs(ckpt: str, preset: str, pre_yaml: str,
                         limit: int, seed: int, arch_overrides=None,
                         forward_batch: int = 16, device=None,
                         fused=None, mel_dtype=np.float16):
    """(teacher-forced predicted mel, aligned ground-truth audio) pairs.

    Runs the trained acoustic model teacher-forced (ground-truth pitch,
    energy and duration, so the predicted frames stay aligned with the
    real audio) in float32 on ``device`` (the card unless ``"cpu"``), and
    pairs each predicted mel with the silence-trimmed wav span the
    preprocessor used (from the TextGrid).  On the card the mel decoder
    takes its kernel routes (K3, K4), as the port's trainer does;
    ``fused=False`` takes the plain route instead.

    Returns (pairs, hop, n_mels); pairs is a list of (mel ``mel_dtype``
    (T, n_mels), wav int16 (T·hop,))."""
    from efficientspeech_tpu_torch.config import (
        ModelConfig, PreprocessConfig)
    from efficientspeech_tpu_torch.data.dataset import LJSpeechDataset
    from efficientspeech_tpu_torch.data.preprocessor import (
        Preprocessor, load_wav)
    from efficientspeech_tpu_torch.data.textgrid import read_textgrid
    from efficientspeech_tpu_torch.device import resolve_device
    from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
    from efficientspeech_tpu_torch.ops.kernels import decoder_block

    device = resolve_device(device)
    if fused is None:
        fused = device.type == "cuda"
    pre_cfg = PreprocessConfig.from_yaml(pre_yaml)
    stats = pre_cfg.load_stats()
    ds = LJSpeechDataset("train.txt", pre_cfg, cache_in_memory=False)
    pre = Preprocessor(pre_cfg, device="cpu")  # its alignment rule only
    hop = pre_cfg.audio.hop_length
    n_mels = pre_cfg.audio.n_mel_channels
    sr = pre_cfg.audio.sampling_rate

    rng = np.random.default_rng(seed)
    sel = rng.permutation(len(ds))
    if limit:
        sel = sel[:limit]
    # one static forward shape for the whole sweep
    n_pad = max(16, int(-(-max(len(ds.phonemes[i]) for i in sel) // 16)
                        * 16))
    m_need = max(int(np.sum(ds[int(i)]["duration"])) for i in sel)
    m_pad = max(64, int(-(-m_need // 64) * 64))
    cfg = ModelConfig.preset(
        preset, pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]),
        max_phoneme_len=n_pad, max_mel_len=m_pad,
        n_speakers=ds.n_speakers, **(arch_overrides or {}))
    model = Phoneme2Mel(cfg, fused_decoder_norm=fused,
                        fused_decoder_block=fused)
    if fused:
        decoder_block.check_supported(
            model.decoder.proj_norm.weight.shape[0], torch.float32)
    _load_acoustic(model, ckpt)
    model.to(device).train()

    pairs = []
    for lo in range(0, len(sel), forward_batch):
        idxs = sel[lo: lo + forward_batch]
        b = forward_batch  # fixed batch dim: pad the tail with zero rows
        phoneme = np.zeros((b, n_pad), np.int32)
        mask = np.ones((b, n_pad), bool)
        pitch = np.zeros((b, n_pad), np.float32)
        energy = np.zeros((b, n_pad), np.float32)
        duration = np.zeros((b, n_pad), np.int32)
        speaker = np.zeros((b,), np.int32)
        wavs = []
        for r, i in enumerate(idxs):
            s = ds[int(i)]
            n = min(len(s["phoneme"]), n_pad)
            phoneme[r, :n] = s["phoneme"][:n]
            mask[r, :n] = False
            pitch[r, :n] = s["pitch"][:n]
            energy[r, :n] = s["energy"][:n]
            # durations clamped into the static mel buffer (the loader's
            # alignment rule)
            d = s["duration"][:n].astype(np.int64)
            prev = np.cumsum(d) - d
            duration[r, :n] = np.clip(np.minimum(d, m_pad - prev), 0, None)
            speaker[r] = s.get("speaker", 0)
            # the preprocessor's silence-trimmed wav span, from the TextGrid
            spk, base = ds.speaker[int(i)], ds.basename[int(i)]
            tiers = read_textgrid(os.path.join(
                pre.out_dir, "TextGrid", spk, f"{base}.TextGrid"))
            _, _, t0, t1 = pre.get_alignment(tiers["phones"])
            wav = load_wav(os.path.join(pre.in_dir, spk, f"{base}.wav"), sr)
            wavs.append(wav[int(sr * t0): int(sr * t1)])
        args = [torch.from_numpy(a).to(device) for a in (
            phoneme, mask, pitch, energy, duration, speaker)]
        with torch.no_grad():
            mel = model(args[0], args[1], speaker=args[5],
                        pitch_target=args[2], energy_target=args[3],
                        duration_target=args[4], train=True)["mel"]
        mel = mel.float().cpu().numpy()
        for r in range(len(idxs)):
            t = min(int(duration[r].sum()), len(wavs[r]) // hop)
            if t <= 0:
                continue
            pairs.append((mel[r, :t].astype(mel_dtype),
                          np.clip(wavs[r][: t * hop] * 32767.0,
                                  -32768, 32767).astype(np.int16)))
    if not pairs:
        raise SystemExit("--from-acoustic: no usable utterances "
                         "(empty train.txt or all alignments degenerate)")
    return pairs, hop, n_mels


def find_wavs(config: dict):
    raw = config["path"]["raw_path"]
    wavs = sorted(glob.glob(os.path.join(raw, "**", "*.wav"),
                            recursive=True))
    if not wavs:  # fall back to the un-prepared corpus layout
        wavs = sorted(glob.glob(os.path.join(
            config["path"]["corpus_path"], "**", "*.wav"), recursive=True))
    return wavs


def init_generator_params(path: str, num_kernels: int):
    """``--init-generator``: a checkpoint of this trainer (a ``step_*.pt``
    file or its directory) gives its generator's state dict; a reference
    HiFi-GAN generator file gives a JAX-layout tree.  Returns (state dict
    or None, tree or None)."""
    import pickle

    from efficientspeech_tpu_torch.training.checkpoint import (
        latest_checkpoint)

    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no step_*.pt checkpoint in {path}")
        path = found
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        payload = None
    if isinstance(payload, dict) and "gen" in payload and "mpd" in payload:
        return payload["gen"], None
    from efficientspeech_tpu_torch.convert.from_torch import (
        load_hifigan_checkpoint)

    return None, load_hifigan_checkpoint(path, num_kernels=num_kernels)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preprocess-config", required=True)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--segment", type=int, default=8192,
                        help="training crop in samples (HiFi-GAN default)")
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--mr-stft-weight", type=float, default=0.0,
                        help="weight of the multi-resolution STFT "
                             "auxiliary loss (sc + log-magnitude over "
                             "512/1024/2048 FFTs); 0 is the pure HiFi-GAN "
                             "objective")
    parser.add_argument("--data-parallel", type=int, default=1,
                        help="data-parallel ranks, one a card (must divide "
                             "batch-size)")
    parser.add_argument("--init-generator", default=None,
                        help="warm-start generator weights: a reference "
                             "HiFi-GAN generator file (e.g. LJ_V2's "
                             "generator_v2) or a checkpoint of this trainer")
    parser.add_argument("--from-acoustic", default=None, metavar="CKPT",
                        help="a trained acoustic model (the port trainer's "
                             "step_*.pt or its directory, or a reference "
                             ".ckpt): train on its teacher-forced predicted "
                             "mels paired with the aligned real audio")
    parser.add_argument("--acoustic-preset", default="tiny",
                        help="acoustic architecture preset of "
                             "--from-acoustic (tiny/small/base)")
    parser.add_argument("--max-utterances", type=int, default=2000,
                        help="utterance cap for the --from-acoustic "
                             "pair-building sweep (bounds host RAM)")
    parser.add_argument("--holdout-frac", type=float, default=0.0,
                        help="--from-acoustic only: hold this fraction of "
                             "the pairs out of training and score the "
                             "generator on them (mel L1 and the "
                             "multi-resolution STFT distance) before and "
                             "after training")
    parser.add_argument("--eval-batch", type=int, default=8,
                        help="static batch of the holdout eval sweep")
    parser.add_argument("--checkpoint-dir", default="vocoder_ckpt")
    parser.add_argument("--log-dir", default="vocoder_logs")
    parser.add_argument("--checkpoint-every", type=int, default=500)
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--initial-channels", type=int, default=None,
                        help="override upsample_initial_channel (smaller "
                             "generators for smoke tests)")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card")
    args = parser.parse_args(argv)
    if args.batch_size % args.data_parallel:
        parser.error(f"--batch-size ({args.batch_size}) must be divisible "
                     f"by --data-parallel ({args.data_parallel})")
    return args


def main(argv=None):
    """Train; returns ``{"step", "checkpoint", "before", "after",
    "eval_secs"}`` (the holdout summaries and the wall seconds of each
    holdout pass, None without a holdout; rank 0's with
    ``--data-parallel``)."""
    args = get_args(argv)
    from efficientspeech_tpu_torch.device import resolve_device
    from efficientspeech_tpu_torch.parallel.mesh import launch, make_mesh

    device = resolve_device(args.device)
    n = args.data_parallel
    if n == 1:
        return run(device, args)
    if device.type == "cuda":
        make_mesh(data_parallel=n)  # raises when n exceeds the cards
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [device] * n
    return launch(run, n, devices, args=(args,))[0]


def run(device, args):
    """Train on ``device``, as one rank of ``--data-parallel`` when there
    are more (the body of each spawned rank)."""
    import yaml

    from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
    from efficientspeech_tpu_torch.data.preprocessor import load_wav
    from efficientspeech_tpu_torch.device import set_full_f32
    from efficientspeech_tpu_torch.eval.vocoder_eval import (
        evaluate_pairs, make_holdout_eval)
    from efficientspeech_tpu_torch.parallel.mesh import (
        barrier, make_mesh, shard_batch)
    from efficientspeech_tpu_torch.training.checkpoint import (
        latest_checkpoint)
    from efficientspeech_tpu_torch.training.vocoder import (
        create_vocoder_trainer, make_mel_fn, restore_vocoder_checkpoint,
        save_vocoder_checkpoint)

    set_full_f32()
    mesh = (make_mesh(data_parallel=args.data_parallel)
            if args.data_parallel > 1 else None)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *a, **k: None)
    with open(args.preprocess_config) as f:
        config = yaml.safe_load(f)
    audio = AudioConfig(
        sampling_rate=config["preprocessing"]["audio"]["sampling_rate"])
    cfg = HifiGanConfig() if args.initial_channels is None else \
        HifiGanConfig(upsample_initial_channel=args.initial_channels)

    wav_paths = find_wavs(config)
    if not wav_paths and not args.from_acoustic:
        raise SystemExit(f"no .wav files under "
                         f"{config['path']['raw_path']}")
    say(f"{len(wav_paths)} wav files; batch {args.batch_size} x "
        f"{args.segment} samples on {device} x {args.data_parallel}")

    gen, init, train_step = create_vocoder_trainer(
        cfg, audio, lr=args.lr, mr_stft_weight=args.mr_stft_weight,
        device=device, mesh=mesh)
    mel_of = make_mel_fn(audio, device)

    gen_state = gen_tree = None
    if args.init_generator:
        gen_state, gen_tree = init_generator_params(
            args.init_generator, len(cfg.resblock_kernel_sizes))
    state = init(args.seed, gen_params=gen_tree)
    if gen_state is not None:
        state.gen.load_state_dict(gen_state, strict=True)
    if args.init_generator:
        say(f"generator warm-started from {args.init_generator}")

    start_step = 0
    if args.resume:
        path = latest_checkpoint(args.checkpoint_dir)
        if path:
            state = restore_vocoder_checkpoint(path, state)
            start_step = state.step
            say(f"resumed from {path} (step {start_step})")

    log_f = None
    if rank0:
        os.makedirs(args.log_dir, exist_ok=True)
        log_f = open(os.path.join(args.log_dir, "metrics.jsonl"), "a")

    # host-side sampler: random file, random crop (the HiFi-GAN recipe);
    # the mel targets are computed on the device from the same crop
    nrng = np.random.default_rng(args.seed + start_step)
    cache = {}
    hop = audio.hop_length
    seg_frames = args.segment // hop

    acoustic_pairs = holdout_pairs = None
    if args.from_acoustic:
        acoustic_pairs, hop, n_mels = build_acoustic_pairs(
            args.from_acoustic, args.acoustic_preset,
            args.preprocess_config, args.max_utterances, args.seed,
            device=device)
        seg_frames = args.segment // hop
        if args.holdout_frac > 0 and len(acoustic_pairs) >= 2:
            # the pairs come in a seeded random order, so a tail slice is
            # a random split
            k = max(1, int(round(len(acoustic_pairs) * args.holdout_frac)))
            k = min(k, len(acoustic_pairs) - 1)
            holdout_pairs = acoustic_pairs[-k:]
            acoustic_pairs = acoustic_pairs[:-k]
        say(f"fine-tuning on {len(acoustic_pairs)} teacher-forced "
            f"acoustic-mel/audio pairs from {args.from_acoustic}"
            + (f" ({len(holdout_pairs)} held out)" if holdout_pairs
               else ""))
    # the holdout eval runs on rank 0 alone
    if not rank0:
        holdout_pairs = None

    eval_fn = (make_holdout_eval(state.gen, audio) if holdout_pairs
               else None)
    eval_secs = []

    def eval_holdout(phase):
        t0 = time.perf_counter()
        m = evaluate_pairs(state.gen, holdout_pairs, audio,
                           batch=args.eval_batch, eval_fn=eval_fn)
        eval_secs.append(time.perf_counter() - t0)
        m = {k: round(float(v), 5) for k, v in m.items()}
        m.update(eval="holdout", phase=phase, step=state.step)
        print(m, flush=True)
        log_f.write(json.dumps(m) + "\n")
        log_f.flush()
        return m

    def sample_batch():
        b = args.batch_size
        out = np.zeros((b, args.segment), np.float32)
        if acoustic_pairs is not None:
            mel = np.zeros((b, seg_frames, n_mels), np.float32)
            for i in range(b):
                mel_u, wav_u = acoustic_pairs[
                    int(nrng.integers(len(acoustic_pairs)))]
                t = mel_u.shape[0]
                if t <= seg_frames:
                    mel[i, :t] = mel_u
                    out[i, : t * hop] = wav_u / 32767.0
                else:
                    f0 = int(nrng.integers(t - seg_frames))
                    mel[i] = mel_u[f0: f0 + seg_frames]
                    out[i] = wav_u[f0 * hop: (f0 + seg_frames) * hop] \
                        / 32767.0
            return mel, out
        for i in range(b):
            path = wav_paths[int(nrng.integers(len(wav_paths)))]
            wav = cache.get(path)
            if wav is None:
                wav = load_wav(path, audio.sampling_rate)
                if len(cache) < 2000:
                    cache[path] = wav
            if len(wav) <= args.segment:
                out[i, : len(wav)] = wav
            else:
                s = int(nrng.integers(len(wav) - args.segment))
                out[i] = wav[s: s + args.segment]
        return out

    try:
        before = eval_holdout("before") if holdout_pairs else None
        t0 = time.time()
        for step in range(start_step + 1, args.steps + 1):
            # every rank draws the global batch and keeps its rows
            if acoustic_pairs is not None:
                mel_np, wav_np = sample_batch()
                rows = shard_batch({"mel": mel_np, "wav": wav_np}, mesh)
                mel = torch.from_numpy(rows["mel"]).to(device)
                wav = torch.from_numpy(rows["wav"]).to(device)
            else:
                wav = torch.from_numpy(shard_batch(
                    {"wav": sample_batch()}, mesh)["wav"]).to(device)
                with torch.no_grad():
                    mel = mel_of(wav)[:, : args.segment // hop, :]
            state, metrics = train_step(state, mel, wav)
            if not rank0:
                continue
            if step % args.log_every == 0 or step == args.steps:
                keys = sorted(metrics)
                values = torch.stack([metrics[k] for k in keys]).cpu()
                m = {k: round(float(v), 4) for k, v in zip(keys, values)}
                m.update(step=step, wall_secs=round(time.time() - t0, 1))
                print(m, flush=True)
                log_f.write(json.dumps(m) + "\n")
                log_f.flush()
            if step % args.checkpoint_every == 0:
                save_vocoder_checkpoint(args.checkpoint_dir, state)
        path = (save_vocoder_checkpoint(args.checkpoint_dir, state)
                if rank0 else None)
        # the checkpoint is on disk before any rank returns
        barrier(mesh)
        after = None
        if holdout_pairs:
            after = eval_holdout("after")
            print("holdout delta (after - before): "
                  + ", ".join(f"{k} {after[k] - before[k]:+.5f}"
                              for k in ("mel_l1", "mr_stft")))
    finally:
        if log_f is not None:
            log_f.close()
    say(f"done at step {state.step}; checkpoint {path}")
    return {"step": state.step, "checkpoint": path, "before": before,
            "after": after, "eval_secs": eval_secs or None}


if __name__ == "__main__":
    main()
