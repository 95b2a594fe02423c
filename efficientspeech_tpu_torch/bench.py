"""Benchmark of the port: text → wav real-time factor (RTF) and its parts
on one card, the counterpart of the JAX package's root ``bench.py``.

    python -m efficientspeech_tpu_torch.bench [--metric all] [--iter 50]

Each metric prints one JSON object on a line of its own, {"metric",
"value", "unit", "vs_baseline", ..., "device"}.  ``--metric all`` prints
mel_rtf, device_rtf and batch_text_to_wav_rtf first and the single-stream
text_to_wav_rtf last.  RTF is seconds of speech per second of wall time;
the baselines are the reference's: RTF 1,300 on an A100 (small model,
long text) and mRTF 104 on a Raspberry Pi 4.

Weights are a random init from ``--seed``, the duration head's bias set to
6.0 so that the model predicts frame counts of LJSpeech's order, unless
``--checkpoint`` loads a model (then its own bias stays).  Every
time is taken after ``--warmup`` requests, by CUDA events on the card (by
the host's clock with ``--device cpu``, where no number is a device's).
It runs on the card unless ``--device cpu`` is given, and without a card
it raises.

``--verbose`` prints each single-stream request's timing and, on
stderr, a JSON line of the model-only RTF and the run's shape.
``--profile DIR`` traces the timed runs with torch.profiler (CPU and
CUDA activity) into ``DIR/bench_trace.json`` and prints, on a line
before the metrics, the wall time, the device's busy time (the union of
its kernels' intervals) and its idle share; the metrics of such a run
carry the profiler's host cost and are not comparable with a run
without it.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from efficientspeech_tpu_torch.audio.transfer import FORMATS
from efficientspeech_tpu_torch.infer import VOCODER_MODES

# the reference README's long benchmark text
LONG_TEXT = (
    "Once upon a time, in a magical forest filled with colorful flowers and "
    "sparkling streams, there lived a group of adorable kittens. Their names "
    "were Fluffy, Sparkle, and Whiskers. With their soft fur and twinkling "
    "eyes, they charmed everyone they met. Every day, they would play "
    "together, chasing their tails and pouncing on sunbeams that danced "
    "through the trees. Their purrs filled the forest with joy, and all the "
    "woodland creatures couldn't help but smile whenever they saw the cute "
    "trio. The animals knew that these kittens were truly the epitome of "
    "cuteness, bringing happiness wherever they went."
)

BASELINE_RTF = 1300.0   # the reference on an A100 (its README)
BASELINE_MEL_RTF = 104.0  # the reference's mRTF on a Raspberry Pi 4
BENCH_DURATION_BIAS = 6.0
# device_rtf: syntheses queued back to back in one timed run
DEVICE_CHAIN = 16
DEVICE_RTF_NOTE = ("device_rtf times back-to-back device programs with no "
                   "host read between them: where the host bounds a "
                   "request, it measures the host's launch rate")


def timed_ms(synth, fn):
    """(fn(), ms): CUDA events around the call on the card (its work ends
    in a host read or a synchronise), the host's clock on the CPU."""
    if synth.device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _result(metric: str, value: float, baseline: float, **extra) -> dict:
    return dict({"metric": metric, "value": round(value, 2),
                 "unit": "x_realtime",
                 "vs_baseline": round(value / baseline, 3)}, **extra)


def run_mel_rtf(synth, text: str, iters: int) -> dict:
    """The acoustic model alone (the reference's mRTF): seconds of mel per
    wall second, at the bucket's full mel size, the mel length read."""
    phoneme, _, _ = synth._pad_to_bucket(synth.phonemize(text))
    hop_secs = synth.hop_length / synth.sampling_rate
    rtfs = []
    for _ in range(iters):
        mel_len, ms = timed_ms(
            synth, lambda: int(synth._acoustic_split(phoneme)[1][0]))
        rtfs.append(mel_len * hop_secs / (ms / 1e3))
    return _result("mel_rtf", float(np.median(rtfs)), BASELINE_MEL_RTF)


def run_device_rtf(synth, text: str, iters: int) -> dict:
    """The fused program (acoustic model, vocoder, wire encode) queued
    DEVICE_CHAIN times with no host read between; the median over
    max(5, iters // 5) runs of the time a synthesis."""
    _, info = synth.tts(text)  # observes the ratio and the voice length
    seq = synth.phonemize(text)
    phoneme, _, bucket = synth._pad_to_bucket(seq)
    spec = synth._spec_frames(int(min(len(seq), bucket)), bucket)

    def chain():
        for _ in range(DEVICE_CHAIN):
            synth._run(phoneme, spec)
        if synth.device.type == "cuda":
            torch.cuda.synchronize()

    per_ms = [timed_ms(synth, chain)[1] / DEVICE_CHAIN
              for _ in range(max(5, iters // 5))]
    ms = float(np.median(per_ms))
    return _result("device_rtf", info["voice_secs"] / (ms / 1e3),
                   BASELINE_RTF, ms_per_synthesis=round(ms, 4),
                   spec_frames=spec, note=DEVICE_RTF_NOTE)


def run_batch_rtf(synth, text: str, batch: int, iters: int) -> dict:
    """Serving throughput: ``batch`` copies of the text through
    ``tts_batch`` (the host's decode of the wire included), the median
    RTF of ``iters`` batches (``run_metrics`` runs max(3, --iter // 10))."""
    texts = [text] * batch
    synth.tts_batch(texts[:2])
    synth.tts_batch(texts)
    rtfs = []
    for _ in range(iters):
        outs, ms = timed_ms(synth, lambda: synth.tts_batch(texts))
        voice = sum(info["voice_secs"] for _, info in outs)
        rtfs.append(voice / (ms / 1e3))
    return _result("batch_text_to_wav_rtf", float(np.median(rtfs)),
                   BASELINE_RTF, batch=batch, transfer=synth.transfer)


def run_rtf(synth, text: str, iters: int, verbose: bool = False) -> dict:
    """Single stream: the median RTF of ``tts`` (text frontend included).
    ``verbose`` prints each request's line and, on stderr, the mean
    model-only RTF (the host's clock around the device work)."""
    rtfs, model_rtfs, info = [], [], {}
    for _ in range(iters):
        (_, info), ms = timed_ms(synth,
                                 lambda: synth.tts(text, verbose=verbose))
        rtfs.append(info["voice_secs"] / (ms / 1e3))
        model_rtfs.append(info["model_rtf"])
    if verbose:
        print(json.dumps({
            "model_rtf_mean": round(float(np.mean(model_rtfs)), 2),
            "voice_secs": round(info["voice_secs"], 3),
            "phonemes": int(info["phoneme_len"]),
            "device": str(synth.device),
            "precision": "bf16" if synth.dtype == torch.bfloat16
            else "f32"}), file=sys.stderr)
    return _result("text_to_wav_rtf", float(np.median(rtfs)), BASELINE_RTF,
                   voice_secs=round(info["voice_secs"], 3),
                   phonemes=int(info["phoneme_len"]),
                   transfer=synth.transfer)


def run_metrics(synth, batch_synth, args) -> list:
    """The results ``args.metric`` asks for, in print order: with "all",
    text_to_wav_rtf last."""
    runners = {
        "mel_rtf": lambda: run_mel_rtf(synth, args.text,
                                       max(10, args.iter // 2)
                                       if args.metric == "all"
                                       else args.iter),
        "device_rtf": lambda: run_device_rtf(synth, args.text, args.iter),
        "batch_rtf": lambda: run_batch_rtf(batch_synth, args.text,
                                           args.batch,
                                           max(3, args.iter // 10)),
        "rtf": lambda: run_rtf(synth, args.text, args.iter,
                               getattr(args, "verbose", False)),
    }
    names = (("mel_rtf", "device_rtf", "batch_rtf", "rtf")
             if args.metric == "all" else (args.metric,))
    return [runners[name]() for name in names]


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--iter", type=int, default=50)
    parser.add_argument("--warmup", type=int, default=10)
    parser.add_argument("--text", default=LONG_TEXT)
    parser.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--metric", default="all",
                        choices=["all", "rtf", "mel_rtf", "batch_rtf",
                                 "device_rtf"],
                        help="rtf: text → wav, single stream; mel_rtf: the "
                             "acoustic model alone; batch_rtf: --batch "
                             "copies of the text through tts_batch; "
                             "device_rtf: the device program alone; all: "
                             "each, rtf last")
    parser.add_argument("--batch", type=int, default=128,
                        help="batch size of batch_rtf")
    parser.add_argument("--batch-transfer", default="adpcm3",
                        choices=list(FORMATS),
                        help="wire format of batch_rtf")
    parser.add_argument("--vocoder", default="folded_kernel",
                        choices=list(VOCODER_MODES))
    parser.add_argument("--transfer", default="adpcm4",
                        choices=list(FORMATS),
                        help="card → host PCM wire format of the single "
                             "stream")
    parser.add_argument("--checkpoint", default=None,
                        help="reference .ckpt, a step_*.pt of the port's "
                             "trainer (or its directory), or a native "
                             "parameter file; random weights without one")
    parser.add_argument("--profile", default=None,
                        help="write a torch.profiler trace of the timed "
                             "runs into this directory (the metrics then "
                             "include the profiler's host cost)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    return parser.parse_args(argv)


def profiled(fn, out_dir: str, device: torch.device):
    """``fn()`` under torch.profiler (CPU activity, and CUDA's on the
    card), its trace written to ``out_dir/bench_trace.json``; returns
    (fn(), a summary: wall ms, and on the card the device's busy ms and
    idle share, else "not measured")."""
    from torch.profiler import ProfilerActivity, profile

    from efficientspeech_tpu_torch.utils.timing import busy_ms

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, "bench_trace.json")
    prof.export_chrome_trace(path)
    summary = {"profile": path, "wall_ms": round(wall, 3)}
    busy = busy_ms(prof) if device.type == "cuda" else 0.0
    if busy > 0:
        summary.update(device_busy_ms=round(busy, 3),
                       idle_share=round(1 - busy / wall, 4))
    else:
        summary.update(device_busy_ms="not measured",
                       idle_share="not measured")
    return out, summary


def main(argv=None):
    args = get_args(argv)
    from efficientspeech_tpu_torch.device import resolve_device, set_full_f32
    from efficientspeech_tpu_torch.infer import build_synthesizer

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if dtype == torch.float32:
        set_full_f32()

    def build(transfer):
        return build_synthesizer(
            preset=args.preset, checkpoint=args.checkpoint, seed=args.seed,
            dtype=dtype,
            bench_duration_bias=(None if args.checkpoint
                                 else BENCH_DURATION_BIAS),
            transfer=transfer, vocoder_mode=args.vocoder, device=device)

    synth = build(args.transfer)
    batch_synth = synth
    if args.batch_transfer != args.transfer and args.metric in ("all",
                                                                "batch_rtf"):
        batch_synth = build(args.batch_transfer)  # the same seeded weights
    if device.type == "cuda":
        from efficientspeech_tpu_torch.utils.timing import card

        where = card()
    else:
        where = "cpu (host clock; no device number)"
    synth.warmup(args.text, iters=args.warmup)
    if args.profile:
        results, summary = profiled(
            lambda: run_metrics(synth, batch_synth, args), args.profile,
            device)
        print(json.dumps(dict(summary, device=where)), flush=True)
    else:
        results = run_metrics(synth, batch_synth, args)
    for result in results:
        print(json.dumps(dict(result, device=where)), flush=True)


if __name__ == "__main__":
    main()
