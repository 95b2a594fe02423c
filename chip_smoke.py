#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. device  - a CUDA card must be present; prints nvidia-smi's name and
               power limit;
  2. build   - compiles the CUDA kernels of csrc/ with nvcc, in parallel;
  3. K1      - folded_matmul at the main path's shapes for 2,048 mel frames
               (+ one w = 13 case with residual, accum and out_scale),
               against its plain PyTorch version, with CUDA-event timings of
               the kernel, the plain version and a library yardstick;
  4. K2      - mrf_fused for the four vocoder stages at 2,048 frames, the
               same way;
  5. slice   - the synthesizer (tiny acoustic model, LJ_V2-width vocoder,
               random weights from seed 0, bf16, vocoder_mode
               "folded_kernel"): one long request (>= 2,048 speculative
               frames, so the kernels engage) and three short ones, with
               launch counts, a check of every waveform, and the long
               request held against the plain vocoder route.
The kernel table goes on a JSON line before the last; the last line is
{"ok": true, "device": {...}}.  With --profile, the slice phase also
traces the long request with torch.profiler and prints where its device
time goes and the device's idle share.

Tolerances: both kernels multiply in bf16 with float32 accumulation (the
TPU's MXU arithmetic) while the plain versions multiply in float32, so
each kernel is held to its plain version at SNR >= 35 dB (the bar the JAX
package's own folded-vocoder test sets), and rows at or beyond `valid`
must be exactly zero.  The end-to-end waveform of the kernel route is held
to the plain route's (bf16 operands, float32 products) at SNR >= 30 dB.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FRAMES = 2048
KERNEL_SNR_DB = 35.0
E2E_SNR_DB = 30.0
LONG_TEXT = (
    "The polyphase folded vocoder turns every convolution of the waveform "
    "generator into a dense matrix product over frame rate activations. "
    "Each stage of the generator first upsamples its input with a "
    "transposed convolution, then runs a multi receptive field block of "
    "three residual chains, whose dilated convolutions see eleven, seven "
    "and three taps. On the graphics card, a windowed matrix kernel runs "
    "the upsamplers and the final convolution, and a second kernel runs "
    "each whole block in shared memory, one tile of rows at a time, with "
    "its halo recomputed at the edges. This long request makes the "
    "speculative buffer large enough for both kernels to engage.")
SHORT_TEXTS = ("Hello there.", "How are you today?",
               "The quick brown fox jumps over the lazy dog.")


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    err = (got.double() - ref.double()).pow(2).mean()
    sig = ref.double().pow(2).mean()
    return float(10 * torch.log10(sig / err.clamp_min(1e-30)))


def time_ms(fn, iters: int):
    """(device ms, host ms) per call, after a warm-up.  The card first
    sleeps while the host queues all the calls, so the CUDA events around
    them time the device's work and not the host's launch rate; the host
    clock around the queueing gives the host's cost per call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def bound(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"{torch.cuda.get_device_name(0)}, power limit unknown"
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build(card: str):
    from efficientspeech_tpu_torch.ops.kernels import build

    secs = build.build()
    print(f"[build] nvcc sm_90a, {len(build.SOURCES)} sources in parallel: "
          f"{secs:.1f} s | {card}")


def phase_k1(synth, card: str):
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        kernel_op_shapes)
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm

    dev = synth.device
    gen = torch.Generator(device="cpu").manual_seed(1)
    ops, _ = kernel_op_shapes(synth.hifigan_cfg, FRAMES)
    cases = [(key, t, d_in, d_out, w, key) for key, t, d_in, d_out, w in ops]
    # one wide-window case with every epilogue operand
    wide = "rb0_2_c1_2"
    cases.append(("w13+res+acc+scale", 4 * FRAMES, 128, 128,
                  synth.fold_meta["widths"][wide], wide))
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    worst_err, bound_by = 0.0, set()
    for name, t, d_in, d_out, w, key in cases:
        W, b = synth.folded[key]
        assert W.shape == ((2 * w + 1) * d_in, d_out), (key, W.shape)
        x = torch.randn(t, d_in, generator=gen).to(dev)
        valid_rows = t - t // 16
        valid = torch.tensor([valid_rows], dtype=torch.int32, device=dev)
        extra = name.startswith("w13")
        res = torch.randn(t, d_out, generator=gen).to(dev) if extra else None
        acc = torch.randn(t, d_out, generator=gen).to(dev) if extra else None
        kw = dict(residual=res, accum=acc,
                  out_scale=1.0 / 3 if extra else None, pre_lrelu=True,
                  lrelu_slope=0.01 if key == "post" else 0.1)
        got = fm.folded_matmul(x, W, b, w, valid, **kw)
        want = fm.folded_matmul_plain(x, W, b, w, valid, **kw)
        torch.cuda.synchronize()
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            fail(f"K1 {name}: non-finite output")
        if got[valid_rows:].any():
            fail(f"K1 {name}: rows at or beyond valid are not zero")
        if snr < KERNEL_SNR_DB:
            fail(f"K1 {name}: SNR {snr:.1f} dB < {KERNEL_SNR_DB} dB")
        win = fm.window(fm.leaky(x, kw["lrelu_slope"]), w).to(torch.bfloat16)
        ms, host_ms = time_ms(
            lambda: fm.folded_matmul(x, W, b, w, valid, **kw), 50)
        plain_ms, _ = time_ms(
            lambda: fm.folded_matmul_plain(x, W, b, w, valid, **kw), 10)
        lib_ms, _ = time_ms(lambda: torch.matmul(win, W), 50)
        flops = 2.0 * valid_rows * (2 * w + 1) * d_in * d_out
        nbytes = (x.numel() * 4 + W.numel() * 2 + b.numel() * 4
                  + t * d_out * 4 * (1 + (res is not None) + (acc is not None)))
        b_ms, by = bound(flops, nbytes)
        print(f"[K1] {name}: T {t} x {d_in} -> {d_out}, w {w} | SNR "
              f"{snr:.1f} dB (tol >= {KERNEL_SNR_DB}) max_abs_err {err:.3g} "
              f"| kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{lib_ms:.4f} bound_ms {b_ms:.4f} ({by}) | wrapper host_ms "
              f"{host_ms:.4f} | {card}")
        if extra:
            continue  # not on the main path: kept out of the totals
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += lib_ms
        totals["bound_ms"] += b_ms
        worst_err = max(worst_err, err)
        bound_by.add(by)
    return dict(totals, max_abs_err=worst_err,
                bound_by="operations" if "operations" in bound_by
                else "bytes")


def phase_k2(synth, card: str):
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        kernel_op_shapes)
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    dev = synth.device
    nk = len(synth.hifigan_cfg.resblock_kernel_sizes)
    gen = torch.Generator(device="cpu").manual_seed(2)
    _, stages = kernel_op_shapes(synth.hifigan_cfg, FRAMES)
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    worst_err, bound_by = 0.0, set()
    for stage, t in stages:
        chains, W_all, b_all, H = synth.mrf[stage]
        x = torch.randn(t, 128, generator=gen).to(dev)
        valid_rows = t - t // 16
        valid = torch.tensor([valid_rows], dtype=torch.int32, device=dev)
        got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, nk)
        want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid,
                                         nk)
        torch.cuda.synchronize()
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            fail(f"K2 stage {stage}: non-finite output")
        if got[valid_rows:].any():
            fail(f"K2 stage {stage}: rows at or beyond valid are not zero")
        if snr < KERNEL_SNR_DB:
            fail(f"K2 stage {stage}: SNR {snr:.1f} dB < {KERNEL_SNR_DB} dB")
        ms, host_ms = time_ms(lambda: mrf_block.mrf_fused(
            x, chains, W_all, b_all, H, valid, nk), 20)
        plain_ms, _ = time_ms(lambda: mrf_block.mrf_fused_plain(
            x, chains, W_all, b_all, H, valid, nk), 3)
        flops = sum(2.0 * valid_rows * n_win * 128 * 128
                    for chain in chains for _, n_win, _, _ in chain)
        nbytes = (2 * t * 128 * 4 + W_all.numel() * 2 + b_all.numel() * 4)
        b_ms, by = bound(flops, nbytes)
        print(f"[K2] stage {stage}: T {t} x 128, halo {H}, tile "
              f"{mrf_block.tile_rows(H)} | {flops / 1e9:.1f} GFLOP | SNR "
              f"{snr:.1f} dB (tol >= {KERNEL_SNR_DB}) max_abs_err {err:.3g} "
              f"| kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
              f"bound_ms {b_ms:.4f} ({by}) | achieved "
              f"{flops / ms / 1e9:.1f} TFLOP/s | wrapper host_ms "
              f"{host_ms:.4f} | {card}")
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += b_ms
        worst_err = max(worst_err, err)
        bound_by.add(by)
    return dict(totals, max_abs_err=worst_err, library_ms=None,
                bound_by="operations" if "operations" in bound_by
                else "bytes")


def phase_slice(synth, card: str):
    from efficientspeech_tpu_torch import infer
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    texts = (LONG_TEXT,) + SHORT_TEXTS
    seqs = [synth.phonemize(t) for t in texts]
    long_frames = synth._spec_frames(len(seqs[0]),
                                     synth._pad_to_bucket(seqs[0])[2])
    if long_frames < infer.KERNEL_MIN_FRAMES:
        fail(f"long request sizes {long_frames} frames < "
             f"{infer.KERNEL_MIN_FRAMES}: the kernels would not engage")
    for seq in seqs:  # warm-up: first-call set-up stays out of the timings
        synth.synthesize_ids(seq)
    synth._obs_ratio = None
    synth._obs_recent.clear()

    # the main path: launch counts from 0, read right after
    fm.launches = mrf_block.launches = 0
    results = []
    for text in texts:
        torch.cuda.synchronize()
        before = (fm.launches, mrf_block.launches)
        wav, info = synth.tts(text)
        after = (fm.launches, mrf_block.launches)
        results.append((wav, info, after[0] - before[0],
                        after[1] - before[1]))
    launches = {"folded_matmul": fm.launches, "mrf_fused": mrf_block.launches}

    for i, (wav, info, k1, k2) in enumerate(results):
        tag = "long" if i == 0 else f"short{i}"
        print(f"[slice] {tag}: phonemes {info['phoneme_len']} mel_len "
              f"{info['mel_len']} | {info['total_secs'] * 1e3:.1f} ms RTF "
              f"{info['rtf']:.1f} | launches K1 {k1} K2 {k2} | {card}")
        if info["mel_len"] <= 0:
            fail(f"{tag}: mel_len {info['mel_len']}")
        if wav.shape != (info["mel_len"] * synth.hifigan_cfg.total_upsample,):
            fail(f"{tag}: wav shape {wav.shape}")
        if not np.isfinite(wav).all() or np.abs(wav).max() < 1e-4:
            fail(f"{tag}: waveform not finite or silent")
    if (results[0][2], results[0][3]) != (5, 4):
        fail(f"long request launched K1 {results[0][2]} and K2 "
             f"{results[0][3]} times; expected 5 and 4")

    # the kernel route against the plain route on the long request
    wav_k, mel_k, _ = synth.synthesize_ids(seqs[0])
    synth.vocoder_mode = "folded"
    wav_p, mel_p, _ = synth.synthesize_ids(seqs[0])
    synth.vocoder_mode = "folded_kernel"
    if mel_k != mel_p:
        fail(f"kernel route mel_len {mel_k} != plain route {mel_p}")
    snr = snr_db(torch.from_numpy(wav_p), torch.from_numpy(wav_k))
    print(f"[slice] long request, kernel route vs plain route: SNR "
          f"{snr:.1f} dB (tol >= {E2E_SNR_DB}) | {card}")
    if snr < E2E_SNR_DB:
        fail(f"end-to-end SNR {snr:.1f} dB < {E2E_SNR_DB} dB")
    return launches


def phase_profile(synth, card: str):
    """Trace one long request: device time by kernel and the idle share
    of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    seq = synth.phonemize(LONG_TEXT)
    synth.synthesize_ids(seq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize_ids(seq)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only: an op's own entry repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms == 0:
        print(f"[profile] no device time in the trace: not measured | {card}")
        return
    n_kernels = sum(e.count for e in events)
    print(f"[profile] long request: wall {wall_ms:.2f} ms, device busy "
          f"{device_ms:.2f} ms in {n_kernels} kernels, idle share "
          f"{1 - device_ms / wall_ms:.3f} | {card}")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def main():
    parser = argparse.ArgumentParser(description="Smoke run of the port "
                                     "on one CUDA card.")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one long request with "
                             "torch.profiler")
    args = parser.parse_args()
    card = phase_device()
    phase_build(card)

    from efficientspeech_tpu_torch.infer import build_synthesizer

    t0 = time.perf_counter()
    synth = build_synthesizer(preset="tiny", seed=0, bench_duration_bias=6.0,
                              dtype=torch.bfloat16,
                              vocoder_mode="folded_kernel")
    print(f"[setup] synthesizer on {synth.device} in "
          f"{time.perf_counter() - t0:.1f} s | {card}")

    k1 = phase_k1(synth, card)
    k2 = phase_k2(synth, card)
    launches = phase_slice(synth, card)
    if args.profile:
        phase_profile(synth, card)

    table = []
    for name, src, replaces, stats in (
            ("folded_matmul",
             "efficientspeech_tpu_torch/csrc/folded_matmul.cu",
             "efficientspeech_tpu/ops/pallas/folded_matmul.py:231", k1),
            ("mrf_fused", "efficientspeech_tpu_torch/csrc/mrf_block.cu",
             "efficientspeech_tpu/ops/pallas/mrf_block.py:176", k2)):
        if launches[name] == 0:
            fail(f"{name} was not launched on the main path")
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": stats["max_abs_err"],
                      "ms": stats["ms"], "plain_ms": stats["plain_ms"],
                      "bound_ms": stats["bound_ms"],
                      "bound_by": stats["bound_by"],
                      "library_ms": stats["library_ms"]})
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
