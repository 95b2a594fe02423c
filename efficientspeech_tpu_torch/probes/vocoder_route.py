"""Probe of the folded vocoder's two routes on the card:

    python -m efficientspeech_tpu_torch.probes.vocoder_route [--reps 5]
        [--out FILE.jsonl] [--preset base --hifigan-config
        configs/hifigan_v1.json --dtypes bf16]

For bf16 and float32 serving (by default the tiny preset with the LJ_V2
vocoder; ``--preset`` and ``--hifigan-config``, a HiFi-GAN config.json,
choose others, and ``--dtypes`` one of the two; random weights from
seed 0, the int16 wire), a synthesizer is built and
warmed as the server warms it (``precompile`` of buckets 128 and 512 at
batch 1 and 32), and runs a ``tts_batch``.  Then, at frame counts that
warm-up did not run (512 and 1,536 frames, 1 and 32 rows), it times a
first call of ``Synthesizer._vocode_folded`` against the next one at that
shape.  Then it times both routes of the folded vocoder: the plain route
(``vocoder_mode="folded"``) and the kernel route ("folded_kernel"), at
1-32 rows and every speculative frame count of buckets 32-512
(``_spec_levels``, 512-8,192 frames) through ``_vocode_folded``, and at
the split pipeline's 128·2^k-frame slices (128-8,192) through
``_vocode_split`` (a slice of the bucket's mel, then the int16 encode).
The mel is random, its valid length four fifths of the frames.

A time is the host's clock from a synchronized card to the end of the
call's work on the card (a synchronize), the median of ``--reps`` calls
after a warm one (3 where the warm call took over a second); ``host_ms``
is the median time until the call returned.  A shape the plain route
cannot hold in the card's memory reads ``oom``.  Each line is printed
with the card's name and power limit and, with ``--out``, appended to
that file as JSON.  It needs a card and raises without one.
"""

import argparse
import json
import statistics
import time

import torch

from efficientspeech_tpu_torch.infer import build_synthesizer
from efficientspeech_tpu_torch.ops.kernels import folded_matmul, mrf_block
from efficientspeech_tpu_torch.utils.timing import card

ROWS = (1, 2, 4, 8, 16, 32)
BUCKETS = (32, 64, 128, 256, 512)
# the server's warm-up: buckets and batch sizes (serve.py's defaults)
WARM_BUCKETS = (128, 512)
WARM_BATCHES = (1, 32)
FIRST_CALLS = ((512, 1), (512, 32), (1536, 1), (1536, 32))
TEXTS = ("the quick brown fox jumps over the lazy dog",
         "printing, in the only sense with which we are at present "
         "concerned, differs from most if not all the arts",
         "a short one")
MODES = {"plain": "folded", "kernel": "folded_kernel"}


def mel_batch(synth, rows: int, frames: int, seed: int = 0):
    """A random mel (rows, frames, n_mels) on the card and its valid
    lengths, four fifths of the frames."""
    g = torch.Generator(device=synth.device).manual_seed(seed)
    mel = torch.randn(rows, frames, synth.cfg.n_mel_channels, generator=g,
                      device=synth.device) * 2.0 - 5.0
    mel_len = torch.full((rows,), frames * 4 // 5, dtype=torch.int64,
                         device=synth.device)
    return mel, mel_len


def timed(fn):
    """(wall ms to the card's end of the call's work, host ms until the
    call returned) of one call from a synchronized card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t2 - t0) * 1e3, (t1 - t0) * 1e3


def launches(dtype):
    return folded_matmul.launches[dtype], mrf_block.launches[dtype]


def route_call(synth, caller: str, rows: int, frames: int):
    """The call the sweep times: ``_vocode_folded`` on a (rows, frames)
    mel, or ``_vocode_split`` on the first ``frames`` of a bucket-sized
    one."""
    if caller == "fused":
        mel, mel_len = mel_batch(synth, rows, frames)
        return lambda: synth._vocode_folded(mel, mel_len)
    full = max(frames, BUCKETS[0] * synth.mel_expansion)
    mel, mel_len = mel_batch(synth, rows, full)
    mel_len.fill_(frames * 4 // 5)
    return lambda: synth._vocode_split(mel[:, :frames], mel_len)


def measure(synth, caller: str, route: str, rows: int, frames: int,
            reps: int):
    """One shape on one route: {wall_ms, host_ms, reps}, or {oom}."""
    synth.vocoder_mode = MODES[route]
    fn = route_call(synth, caller, rows, frames)
    try:
        before = launches(synth.dtype)
        warm, _ = timed(fn)
        after = launches(synth.dtype)
        n = reps if warm < 1000 else 3
        walls, hosts = zip(*(timed(fn) for _ in range(n)))
    except torch.cuda.OutOfMemoryError:
        return {"oom": True}
    finally:
        del fn
        synth.vocoder_mode = MODES["kernel"]
        torch.cuda.empty_cache()
    k1, k2 = (a - b for a, b in zip(after, before))
    want = (5 * rows, 4 * rows) if route == "kernel" else (0, 0)
    if (k1, k2) != want:
        raise RuntimeError(f"{caller} {route} {rows}x{frames}: launches K1 "
                           f"{k1} K2 {k2}, expected {want}")
    return {"wall_ms": statistics.median(walls),
            "host_ms": statistics.median(hosts), "reps": n}


def first_calls(synth):
    """A first kernel-route call at each of FIRST_CALLS' shapes, which
    the warm-up did not run, and the next call at the same shape."""
    out = []
    for frames, rows in FIRST_CALLS:
        mel, mel_len = mel_batch(synth, rows, frames, seed=1)
        first, _ = timed(lambda: synth._vocode_folded(mel, mel_len))
        second, _ = timed(lambda: synth._vocode_folded(mel, mel_len))
        out.append({"frames": frames, "rows": rows, "first_ms": first,
                    "second_ms": second})
    return out


def sweep_frames(synth, caller: str):
    if caller == "fused":
        return sorted({f for b in BUCKETS for f in synth._spec_levels(b)})
    top = BUCKETS[-1] * synth.mel_expansion
    return [synth.VOCODER_CHUNK << k for k in range(16)
            if synth.VOCODER_CHUNK << k <= top]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5,
                        help="timed calls a shape and route after a warm one")
    parser.add_argument("--out", default=None,
                        help="append each line as JSON to this file")
    parser.add_argument("--preset", default="tiny")
    parser.add_argument("--hifigan-config", default=None,
                        help="a HiFi-GAN config.json (default LJ_V2)")
    parser.add_argument("--dtypes", default="bf16,f32")
    args = parser.parse_args()
    name = card()
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec["card"] = name
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()

    for dname in args.dtypes.split(","):
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
        synth = build_synthesizer(preset=args.preset, dtype=dtype,
                                  hifigan_config=args.hifigan_config,
                                  bench_duration_bias=6.0, transfer="int16",
                                  device="cuda")
        t0 = time.perf_counter()
        shapes = synth.precompile(WARM_BUCKETS, WARM_BATCHES)
        synth.tts_batch(list(TEXTS))
        torch.cuda.synchronize()
        emit({"dtype": dname, "warm_s": time.perf_counter() - t0,
              "warm_shapes": shapes})
        for rec in first_calls(synth):
            emit({"dtype": dname, "first_call": rec})
        for caller in ("fused", "split"):
            for frames in sweep_frames(synth, caller):
                for rows in ROWS:
                    rec = {"dtype": dname, "caller": caller, "rows": rows,
                           "frames": frames}
                    for route in MODES:
                        rec[route] = measure(synth, caller, route, rows,
                                             frames, args.reps)
                    p, k = rec["plain"], rec["kernel"]
                    if "wall_ms" in p and "wall_ms" in k:
                        rec["plain_over_kernel"] = round(
                            p["wall_ms"] / k["wall_ms"], 3)
                    emit(rec)
        del synth
        torch.cuda.empty_cache()
    if out:
        out.close()


if __name__ == "__main__":
    main()
