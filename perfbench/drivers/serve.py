"""Serving: the measured HTTP server runs in this process, wired as its
``serve.main`` wires it (dynamic batcher, device lock, deadlines, the
warm-up of its buckets before ready) at the settings of its own argument
parser, on the benchmark's weights; the closed-loop clients run in a
child process (``serve_client.py``).

The window is the client's: its rate is the seconds of audio in the
answers completed within it over its seconds; every request completed in
it counts as attempted, and every one not answered 200 as failed.
``--trace 1`` profiles ``traced_s`` seconds from a third of the way into
the window (the FLOPs count the batches that ran wholly inside it).  Afterwards the reference judges the answers the client
kept.

Fault, for the tests: ``alter_answer`` turns over the sign of a tenth of
every answer's audio.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from perfbench.drivers import synthesis as syn
from perfbench.drivers.narration_batch import plant
from perfbench.yardstick.trace import Tracing
from perfbench.yardstick.traffic import lexicon_path, quantile_lengths

CLIENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "serve_client.py")


def start_server(synth, mix):
    """The server as ``serve.main`` wires it, at the settings that
    ``serve.get_args`` gives for the mix's ``server_args`` (none: its
    defaults), on port 0, warmed before it returns."""
    from efficientspeech_tpu_torch import serve

    args = serve.get_args(["--port", "0"] + mix.get("server_args", []))
    state = serve.ServeState()
    state.ready = False
    lock = threading.Lock()
    handler = serve.make_handler(
        synth, lock=lock,
        stream_segment_phonemes=args.stream_segment_phonemes,
        dynamic_batch=args.dynamic_batch,
        batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        fetch_timeout_s=args.fetch_timeout or None,
        queue_deadline_s=args.queue_deadline or None,
        breaker_cooldown_s=args.breaker_cooldown, state=state)
    server = serve.make_server(args.host, args.port, handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    buckets = sorted(int(x) for x in args.precompile_buckets.split(",")
                     if x)
    serve.init_and_warm(synth, state, lock, args.warmup_text, buckets,
                        serve.warm_batch_sizes(args.dynamic_batch,
                                               args.max_batch))
    return server


def batch_summary(batches, ok, res):
    """Where a request's time went, read from outside the program: the
    batches formed in the window, their sizes and walls, and for each
    answered request its wait before its batch started and after it
    ended (quartiles in ms)."""
    inside = [b for b in batches
              if res["t_w0"] <= b["t0"] and b["t1"] <= res["t_w1"]]
    start = {}
    for b in batches:
        for text in b["texts"]:
            start.setdefault(text, []).append((b["t0"], b["t1"]))
    before, after = [], []
    for r in ok:
        span = next(((a, z) for a, z in start.get(r[7], [])
                     if r[3] <= a and z <= r[4]), None)
        if span:
            before.append(span[0] - r[3])
            after.append(r[4] - span[1])
    q = lambda v, scale=1e3: [round(scale * x, 1) for x in np.percentile(
        v, [25, 50, 75, 95])] if v else None
    return {"batches": len(inside),
            "batch_sizes": q([len(b["texts"]) for b in inside], 1),
            "batch_wall_ms": q([b["t1"] - b["t0"] for b in inside]),
            "frames": sorted({b["frames"] for b in inside}),
            "queue_wait_ms": q(before), "after_batch_ms": q(after)}


def run(cell, args, clock, device):
    mix = cell.mix
    synth, weights = syn.build_synth(cell, args.seed, device)
    plant(synth, args.fault)
    rec = syn.BatchRecorder(synth)
    clock.mark("synthesizer")
    server = start_server(synth, mix)
    clock.mark("server warm")
    rng = np.random.default_rng(args.seed)
    lengths = rng.permutation(quantile_lengths(
        *mix["phonemes"], mix["phonemes"][1] - mix["phonemes"][0] + 1))
    out_dir = tempfile.mkdtemp(prefix="perfbench-serve-")
    job = {"port": server.server_port, "seed": args.seed,
           "clients": mix["clients"], "lengths": [int(n) for n in lengths],
           "keep_clients": [int(c) for c in np.random.default_rng(
               [args.seed, 1]).permutation(mix["clients"])[:mix["sample"]]],
           "warm_s": mix["warm_s"], "seconds": args.seconds,
           "timeout_s": mix["client_timeout_s"],
           "lexicon": lexicon_path(cell.root, mix),
           "pause_every": mix.get("pause_every", 8),
           "sampling_rate": synth.sampling_rate, "out_dir": out_dir}
    with open(os.path.join(out_dir, "job.json"), "w") as fh:
        json.dump(job, fh)
    wall0, pc0 = time.time(), time.perf_counter()
    proc = subprocess.Popen([sys.executable, CLIENT,
                             os.path.join(out_dir, "job.json")])
    clock.setup_done(at=pc0 + mix["warm_s"])
    # the profiler runs on this thread (the one that first used it); the
    # device's activity of the batcher's thread is in its trace, the
    # host's operations of that thread are not
    tracing = Tracing(device, args.trace, 1, 1)
    if args.trace:
        time.sleep(max(0.0, wall0 + mix["warm_s"] + args.seconds / 3
                       - time.time()))
        for secs in (mix["traced_s"], mix["named_s"]):
            tracing.before()
            time.sleep(secs)
            tracing.after()
    try:
        proc.wait(timeout=mix["warm_s"] + args.seconds
                  + mix["client_timeout_s"] + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    server.shutdown()
    server.server_close()
    tracing.finish()
    memory = (torch.cuda.max_memory_allocated() if device.type == "cuda"
              else 0)
    if proc.returncode != 0:
        raise RuntimeError(f"load client exited with {proc.returncode}")
    with open(os.path.join(out_dir, "result.json")) as fh:
        res = json.load(fh)

    window = res["t_w1"] - res["t_w0"]
    done = [r for r in res["rows"] if res["t_w0"] <= r[4] <= res["t_w1"]]
    ok = [r for r in done if r[5] == 200]
    first = tracing.stretches[0]
    # a traced run's latency is that of the requests answered before the
    # profiler started: its start and its stop (the profiler's own
    # processing) hold the host for seconds, and the queue behind
    lat = [r[4] - r[3] for r in ok
           if first.state == "waiting" or r[4] < first.wall_begin]
    layer = {"trace": tracing.read(),
             "latency_p95_ms": (1e3 * float(np.percentile(lat, 95))
                                if lat else None)}
    traced = [b for b in rec.batches if first.state == "done"
              and first.wall0 <= b["t0"] and b["t1"] <= first.wall1]
    if traced:
        layer["traced_flops"] = syn.synthesis_flops(
            cell, [len(syn.ids_of(b, r)) for b in traced
                   for r in range(len(b["texts"]))],
            [f for b in traced for f in b["mel_len"]])
    print(json.dumps(batch_summary(rec.batches, ok, res)), file=sys.stderr)

    items = []
    for k in res["kept"]:
        with open(k["file"], "rb") as fh:
            body = fh.read()
        wav = np.frombuffer(body[44:], "<i2").astype(np.float32) / 32768.0
        # the batch that served it: the one holding its text that ran
        # while it waited
        b = next((b for b in rec.batches if k["text"] in b["texts"]
                  and k["t0"] <= b["t0"] and b["t1"] <= k["t1"]), None)
        items.append(rec.judged_item(b, b["texts"].index(k["text"]),
                                     k["text"], wav) if b else
                     syn.unserved_item(k["text"], wav))
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    os.rmdir(out_dir)
    del synth, rec, server
    syn.release()
    numbers, extra = syn.judge(cell, weights, items, args, device)
    return {"attempted": len(done), "failed": len(done) - len(ok),
            "e2e": {"served_speech_s_per_s":
                    sum(r[6] for r in ok) / window},
            "layer": layer, "trace": layer["trace"], "numbers": numbers,
            "memory_peak_bytes": memory, **extra}
