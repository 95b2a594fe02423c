"""Narration batches: one caller runs ``Synthesizer.tts_batch`` back to
back, each call on ``batch`` fresh paragraphs whose phoneme counts are
the mix's quantiles over ``phonemes`` in an order drawn from the seed.

The window runs whole calls until ``--seconds`` have passed and ends with
the last one; its rate is the seconds of waveform returned over the
window's seconds.  ``--trace 1`` profiles ``traced_calls`` calls from a
third of the way into the window.  Afterwards the reference judges
``sample`` texts drawn from the seed among those served, one from each of
``sample`` equal stretches of a batch's rows (however few calls the
window held), and the longest.

Faults, for the tests: ``alter_answer`` turns over the sign of a tenth
of every answer's audio; ``half_batch``
synthesizes only the first half of each call's texts and hands their
answers round to the rest.
"""

import json
import sys
import time

import numpy as np
import torch

from perfbench.drivers import synthesis as syn
from perfbench.yardstick.trace import Tracing
from perfbench.yardstick.traffic import quantile_lengths


def plant(synth, fault):
    if fault is None:
        return
    inner = synth.tts_batch
    if fault == "alter_answer":
        def tts_batch(texts):
            outs = inner(texts)
            for w, _ in outs:
                w[len(w) // 3: len(w) // 3 + len(w) // 10] *= -1.0
            return outs
    elif fault == "half_batch":
        def tts_batch(texts):
            half = inner(texts[: max(1, len(texts) // 2)])
            return [half[i % len(half)] for i in range(len(texts))]
    else:
        raise ValueError(f"unknown fault {fault!r}")
    synth.tts_batch = tts_batch


def run(cell, args, clock, device):
    mix = cell.mix
    rng = np.random.default_rng(args.seed)
    maker = syn.text_maker(cell)
    lengths = quantile_lengths(*mix["phonemes"], mix["batch"])

    def batch_texts():
        order = rng.permutation(lengths)
        return [maker.text(rng, int(n)) for n in order], int(order.argmax())

    synth, weights = syn.build_synth(cell, args.seed, device)
    plant(synth, args.fault)
    rec = syn.BatchRecorder(synth)
    sr = synth.sampling_rate
    clock.mark("synthesizer")
    for _ in range(mix["warm_calls"]):
        synth.tts_batch(batch_texts()[0])
        clock.mark(f"warm call {len(rec.batches)}")
    fastest = min(b["t1"] - b["t0"] for b in rec.batches)
    # the texts of every call the window can hold, made before it starts
    calls = [batch_texts()
             for _ in range(int(args.seconds / (0.5 * fastest)) + 4)]
    rec.batches.clear()
    clock.setup_done()

    tracing = Tracing(device, args.trace, mix["traced_calls"],
                      mix["named_calls"])
    # each call draws from the seed a row in each of k stretches of the
    # batch's rows; of its answers only the call's longest (known from its
    # lengths) and the row of stretch i % k are kept for the judgement,
    # and of the first call the rows of every stretch, so that the sample
    # below takes a row from every stretch however few calls there were
    k = min(mix["sample"], mix["batch"])
    edges = np.linspace(0, mix["batch"], k + 1).astype(int)
    draw = np.random.default_rng([args.seed, 1])
    rows_of = [draw.integers(edges[:-1], edges[1:]) for _ in calls]
    kept, speech, batch_secs, traced, named = [], 0, [], [], []
    cpu0, t0 = time.thread_time(), time.perf_counter()
    for i, (texts, longest) in enumerate(calls):
        now = time.perf_counter() - t0
        if now >= args.seconds:
            break
        tracing.before(now >= args.seconds / 3)
        (traced if tracing.measuring else named if tracing.on
         else []).append(i)
        with torch.profiler.record_function("perfbench.tts_batch"):
            outs = synth.tts_batch(texts)
        tracing.after()
        speech += sum(len(w) for w, _ in outs)
        batch_secs.append(outs[0][1]["batch_secs"])
        keep = rows_of[i] if i == 0 else [rows_of[i][i % k]]
        kept.append({int(r): outs[r][0] for r in [*keep, longest]})
        del outs
    window = time.perf_counter() - t0
    cpu_share = (time.thread_time() - cpu0) / window
    tracing.finish()

    done = rec.batches
    walls = [b["t1"] - b["t0"] for b in done]
    print(json.dumps({"call_wall_s": [round(w, 4) for w in walls],
                      "main_thread_cpu_share": cpu_share}), file=sys.stderr)
    plain = [j for j in range(len(done)) if j not in traced + named]
    layer = {"hifigan": cell.config["hifigan"], "trace": tracing.read()}
    if plain:
        layer["host_tail_share"] = 1.0 - sum(
            batch_secs[j] for j in plain) / sum(walls[j] for j in plain)
    if traced:
        tb = [done[j] for j in traced]
        layer["traced_frames"] = [f for b in tb for f in b["mel_len"]]
        layer["traced_flops"] = syn.synthesis_flops(
            cell, [len(syn.ids_of(b, r)) for b in tb
                   for r in range(len(b["texts"]))],
            layer["traced_frames"])
    memory = (torch.cuda.max_memory_allocated() if device.type == "cuda"
              else 0)

    # the sample: for each stretch a call drawn from the seed among those
    # that kept its row, and the longest text served
    pick = np.random.default_rng([args.seed, 2])
    chosen = []
    for s in range(k):
        j = int(pick.choice([0, *range(s or k, len(done), k)]))
        chosen.append((j, int(rows_of[j][s])))
    chosen.sort()
    longest = max(((j, r) for j in range(len(done)) for r in kept[j]),
                  key=lambda jr: len(syn.ids_of(done[jr[0]], jr[1])))
    if longest not in chosen:
        chosen.append(longest)
    items = [rec.judged_item(done[j], r, done[j]["texts"][r], kept[j][r])
             for j, r in chosen]
    n_calls = len(done)
    del synth, rec, kept, done
    syn.release()
    numbers, extra = syn.judge(cell, weights, items, args, device)
    return {"attempted": n_calls, "failed": 0,
            "e2e": {"narration_speech_s_per_s":
                    speech / sr / window},
            "layer": layer, "trace": layer["trace"], "numbers": numbers,
            "memory_peak_bytes": memory, **extra}
