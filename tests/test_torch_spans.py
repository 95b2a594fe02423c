"""The port's span recorder (``efficientspeech_tpu_torch.utils.spans``)
and the spans placed in the synthesizer and the server, on the CPU: parent
links, ids and self time, the ring's bound, counters under threads, spans
stamped on two threads, the profiler's view of a span, the phases of a
``tts_batch`` call and the timers read from them, the batcher's queue
spans and counters, ``/statusz``, and the benchmark's readers of the
recorder."""

import collections
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from efficientspeech_tpu_torch import infer
from efficientspeech_tpu_torch import serve as pserve
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.infer import build_synthesizer
from efficientspeech_tpu_torch.utils import spans

from test_torch_synth import SMALL_HIFIGAN

torch.set_num_threads(2)

TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog",
         "a b c"]
# the spans of one run of the fused program inside a call
RUN = {"synth.upload": 1, "synth.acoustic": 1, "synth.vocoder": 1,
       "synth.encode": 1, "synth.fetch.wait": 2, "synth.fetch.copy": 2}


@pytest.fixture(scope="module")
def synth():
    """test_torch_serve.py's small synthesizer (int16 wire)."""
    s = build_synthesizer(preset="tiny",
                          hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN),
                          dtype=torch.float32, bench_duration_bias=4.0,
                          transfer="int16", vocoder_mode="folded",
                          device="cpu")
    s.phoneme_buckets = (16, 32)
    s.mel_expansion = 6
    s.spec_min_frames = 32
    return s


def _call_records(s, call):
    return [r for r in spans.records(s.span_id)
            if r.ids.get("call") == call]


def _last_call(s, name="tts_batch"):
    return [r for r in spans.records(s.span_id) if r.name == name][-1]


# --- the recorder -------------------------------------------------------------

def test_parent_links_ids_and_self_time():
    rec = spans.Recorder()
    with rec.span("outer", synth=7, call=1) as outer:
        time.sleep(0.02)
        with rec.span("inner", row=0) as inner:
            time.sleep(0.03)
            with rec.span("leaf"):
                pass
        with rec.span("inner", row=1):
            time.sleep(0.01)
    by = {r.seq: r for r in rec.records()}
    assert by[outer.seq].parent is None
    assert by[inner.seq].parent == outer.seq
    assert by[inner.seq].ids == {"synth": 7, "call": 1, "row": 0}
    leaf = next(r for r in by.values() if r.name == "leaf")
    assert leaf.parent == inner.seq
    assert leaf.ids == {"synth": 7, "call": 1, "row": 0}
    assert rec.current() is None
    snap = rec.snapshot()["spans"]
    assert snap["inner"]["count"] == 2 and snap["outer"]["count"] == 1
    inner_ns = sum(r.end_ns - r.start_ns for r in by.values()
                   if r.name == "inner")
    want = (outer.end_ns - outer.start_ns - inner_ns) / 1e6
    assert snap["outer"]["self_ms"] == pytest.approx(want, abs=1e-6)
    assert 15 <= snap["outer"]["self_ms"] < snap["outer"]["total_ms"]
    assert snap["inner"]["p95_ms"] >= snap["inner"]["p50_ms"] >= 10
    # the stamps are the epoch's, the clock of the profiler's events
    assert abs(outer.start_ns - time.time_ns()) < 60e9
    assert rec.snapshot(synth=8)["spans"] == {}


def test_ring_keeps_the_newest_records():
    rec = spans.Recorder(ring=8)
    for i in range(20):
        with rec.span("s", i=i):
            pass
    got = rec.records()
    assert len(got) == 8
    assert [r.ids["i"] for r in got] == list(range(12, 20))
    assert rec.snapshot()["spans"]["s"]["count"] == 8


def test_counters_under_eight_threads():
    rec = spans.Recorder()
    start = threading.Barrier(8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            start.wait(timeout=30)
            with rec.span("worker", synth=k % 2):
                for _ in range(2000):
                    rec.count("hits")
                    rec.count("all", 2, synth="x")
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters() == {"hits": 16000, "all": 32000}
    assert rec.counters(synth=0) == {"hits": 8000}
    assert rec.counters(synth="x") == {"all": 32000}
    assert len(rec.records()) == 8
    assert {r.thread for r in rec.records()} == {t.ident for t in threads}


def test_record_across_threads():
    rec = spans.Recorder()
    box = {}

    def submit():
        box["t0"] = time.time_ns()

    t = threading.Thread(target=submit)
    t.start()
    t.join(timeout=30)
    time.sleep(0.01)
    rec.record("queue", box["t0"], time.time_ns(), synth=3, request=5)
    (r,) = rec.records(synth=3)
    assert r.name == "queue" and r.parent is None
    assert r.thread == threading.get_ident() != t.ident
    assert r.ids == {"synth": 3, "request": 5}
    assert r.end_ns - r.start_ns >= 10e6
    assert rec.snapshot()["spans"]["queue"]["count"] == 1


def test_span_adopts_a_parent_of_another_thread():
    rec = spans.Recorder()
    with rec.span("call", synth=2, call=4) as call:
        t = threading.Thread(target=lambda: rec.span(
            "read", parent=call).__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
    read = next(r for r in rec.records() if r.name == "read")
    assert read.parent == call.seq and read.thread == t.ident
    assert read.ids == {"synth": 2, "call": 4}


def test_span_is_a_host_op_of_the_profiler_on_its_clock():
    """A running profiler records the span as a host op of its name, not
    a user annotation (which the benchmark's trace reader skips), starting
    within 200 µs of the recorded stamp."""
    from torch.profiler import ProfilerActivity, profile

    rec = spans.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with rec.span("probe.span", i=i):
                torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe.span"]
    assert len(events) == 3
    for e, r in zip(sorted(events, key=lambda e: e.start_ns()),
                    rec.records()):
        assert not e.is_user_annotation()
        assert abs(e.start_ns() - r.start_ns) < 200_000
        assert abs(e.end_ns() - r.end_ns) < 200_000


# --- the synthesizer's spans ----------------------------------------------------

@pytest.mark.parametrize("kernel_route", [False, True])
def test_tts_batch_spans_cover_each_phase(synth, monkeypatch, kernel_route):
    """One ``tts_batch`` span a call; its phases carry its call id, lie
    inside it one after another, and their number is fixed (a run of the
    program each, plus one ``synth.vocoder.row`` a padded row on the
    kernel route); every padded row of every run counts under the
    vocoder's counter of the route taken and none under the other."""
    if kernel_route:
        monkeypatch.setattr(infer, "KERNEL_MIN_FRAMES", 0)
        monkeypatch.setattr(synth, "vocoder_mode", "folded_kernel")
    before = spans.counters(synth.span_id)
    synth.tts_batch(TEXTS)
    counts = spans.counters(synth.span_id)
    delta = {k: counts.get(k, 0) - before.get(k, 0)
             for k in ("synth.rows", "synth.pad_rows", "synth.reruns",
                       "synth.vocoder.kernel_rows",
                       "synth.vocoder.plain_rows")}
    assert delta["synth.rows"] == 3 and delta["synth.pad_rows"] == 1
    rows = ((delta["synth.rows"] + delta["synth.pad_rows"])
            * (1 + delta["synth.reruns"]))
    assert ((delta["synth.vocoder.kernel_rows"],
             delta["synth.vocoder.plain_rows"])
            == ((rows, 0) if kernel_route else (0, rows)))
    call = _last_call(synth)
    recs = _call_records(synth, call.ids["call"])
    assert [r for r in recs if r.name == "tts_batch"] == [call]
    runs = 1 + delta["synth.reruns"]
    want = collections.Counter({"tts_batch": 1, "tts_batch.frontend": 1,
                                "tts_batch.pack": 1, "tts_batch.decode": 1})
    for name, n in RUN.items():
        want[name] += n * runs
    if kernel_route:
        want["synth.vocoder.row"] = 4 * runs
    assert collections.Counter(r.name for r in recs) == want
    for r in recs:
        assert r.ids["synth"] == synth.span_id
        assert call.start_ns <= r.start_ns <= r.end_ns <= call.end_ns
        if r.name == "synth.vocoder.row":
            vocoder = next(v for v in recs if v.seq == r.parent)
            assert vocoder.name == "synth.vocoder"
        elif r.seq != call.seq:
            assert r.parent == call.seq
    order = [r.name for r in sorted(recs, key=lambda r: r.start_ns)
             if r.parent == call.seq]
    assert order[:4] == ["tts_batch.frontend", "tts_batch.pack",
                         "synth.upload", "synth.acoustic"]
    assert order[-1] == "tts_batch.decode"
    top = sorted((r for r in recs if r.parent == call.seq),
                 key=lambda r: r.start_ns)
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns


# the vocoder's route: on the card at every frame count (the route table
# of PERF.md §5), off it from KERNEL_MIN_FRAMES = 2,048 frames on, and
# never in "folded" mode; one shape on each side of each branch
@pytest.mark.parametrize("mode,device,rows,frames,kernel", [
    ("folded_kernel", "cuda", 1, 512, True),
    ("folded_kernel", "cuda", 32, 1024, True),
    ("folded_kernel", "cpu", 32, 2047, False),
    ("folded_kernel", "cpu", 1, 2048, True),
    ("folded", "cuda", 32, 1024, False),
    ("folded", "cpu", 1, 4096, False)])
def test_vocoder_route_by_device_rows_and_frames(synth, monkeypatch, mode,
                                                 device, rows, frames,
                                                 kernel):
    """``_vocode_folded`` hands ``folded_plan_apply`` the route of the
    rule (K1 and K2 together) and counts its rows under that route's
    counter."""
    seen = []

    def spy(arrays, meta, cfg, mel, **kwargs):
        seen.append((mel.shape[:2], kwargs["use_kernel"],
                     kwargs["fuse_mrf"]))
        return torch.zeros(mel.shape[0], mel.shape[1] * cfg.total_upsample)

    monkeypatch.setattr(infer, "folded_plan_apply", spy)
    monkeypatch.setattr(synth, "device", torch.device(device))
    monkeypatch.setattr(synth, "vocoder_mode", mode)
    before = spans.counters(synth.span_id)
    mel = torch.zeros(1, 1, 80).expand(rows, frames, 80)
    wav = synth._vocode_folded(mel, torch.full((rows,), frames))
    counts = spans.counters(synth.span_id)
    assert wav.shape == (rows, frames * synth.hifigan_cfg.total_upsample)
    assert seen == [((rows, frames), kernel, kernel)]
    delta = {k: counts.get(k, 0) - before.get(k, 0)
             for k in ("synth.vocoder.kernel_rows",
                       "synth.vocoder.plain_rows")}
    assert delta == {"synth.vocoder.kernel_rows": rows if kernel else 0,
                     "synth.vocoder.plain_rows": 0 if kernel else rows}


def test_batch_secs_is_read_from_the_spans(synth):
    """``batch_secs``: from the end of the pack to the start of the
    decode, the program and its reads (a re-run included)."""
    outs = synth.tts_batch(TEXTS)
    recs = _call_records(synth, _last_call(synth).ids["call"])
    pack = next(r for r in recs if r.name == "tts_batch.pack")
    decode = next(r for r in recs if r.name == "tts_batch.decode")
    want = (decode.start_ns - pack.end_ns) / 1e9
    assert all(info["batch_secs"] == want for _, info in outs)
    runs = [r for r in recs if r.name.startswith("synth.")]
    assert pack.end_ns <= min(r.start_ns for r in runs)
    assert max(r.end_ns for r in runs) <= decode.start_ns


def test_split_route_batch_secs_is_read_from_the_spans(synth, monkeypatch):
    monkeypatch.setattr(synth, "fused_pipeline", False)
    outs = synth.tts_batch(TEXTS)
    recs = _call_records(synth, _last_call(synth).ids["call"])
    pack = next(r for r in recs if r.name == "tts_batch.pack")
    decode = next(r for r in recs if r.name == "tts_batch.decode")
    assert outs[0][1]["batch_secs"] == (decode.start_ns - pack.end_ns) / 1e9
    assert {"synth.acoustic", "synth.vocoder",
            "synth.fetch.copy"} <= {r.name for r in recs}


def test_tts_and_stream_timers_are_read_from_the_spans(synth):
    _, info = synth.tts("hello world")
    call = _last_call(synth, "tts")
    (front,) = [r for r in _call_records(synth, call.ids["call"])
                if r.name == "tts.frontend"]
    assert info["frontend_secs"] == (front.end_ns - front.start_ns) / 1e9
    assert info["total_secs"] == (call.end_ns - call.start_ns) / 1e9
    assert info["model_secs"] == (call.end_ns - front.end_ns) / 1e9
    assert {"synth.acoustic", "synth.fetch.copy"} <= {
        r.name for r in _call_records(synth, call.ids["call"])}
    infos = [i for _, i in synth.tts_stream(
        "hello there my good friend, how are you", segment_phonemes=8)]
    segs = [r for r in spans.records(synth.span_id)
            if r.name == "tts_stream.segment"][-len(infos):]
    assert len(infos) >= 2
    assert [i["secs"] for i in infos] == [
        (r.end_ns - r.start_ns) / 1e9 for r in segs]
    assert [r.ids["segment"] for r in segs] == list(range(len(infos)))


def test_fetch_with_a_deadline_keeps_the_callers_ids(synth, monkeypatch):
    """With ``fetch_timeout_s`` the read runs on a thread of its own; its
    spans still hang from the call that asked for it."""
    monkeypatch.setattr(synth, "fetch_timeout_s", 60.0)
    synth.tts_batch(TEXTS[:1])
    call = _last_call(synth)
    fetches = [r for r in _call_records(synth, call.ids["call"])
               if r.name.startswith("synth.fetch.")]
    assert len(fetches) >= 4
    assert all(r.parent == call.seq for r in fetches)
    assert all(r.thread != call.thread for r in fetches)


# --- the server's spans ---------------------------------------------------------

class StubSynth:
    """A synthesizer that answers at once, under an id of its own."""

    def __init__(self):
        self.span_id = f"stub-{time.time_ns()}"
        self.calls = []

    def tts_batch(self, texts):
        self.calls.append(list(texts))
        return [(np.zeros(8, np.float32),
                 {"voice_secs": 0.1, "batch_secs": 0.01})
                for _ in texts]


def _submit_all(batcher, texts):
    out = {}

    def go(i, text):
        out[i] = batcher.submit(text)

    threads = [threading.Thread(target=go, args=(i, t))
               for i, t in enumerate(texts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_batcher_records_queue_spans_and_counts_rows():
    stub = StubSynth()
    batcher = pserve.DynamicBatcher(stub, threading.Lock(), window_ms=100,
                                    max_batch=4)
    t_submit = time.time_ns()
    out = _submit_all(batcher, [f"text {i}" for i in range(6)])
    assert len(out) == 6
    recs = spans.records(stub.span_id)
    queue = [r for r in recs if r.name == "serve.queue"]
    assert len(queue) == 6
    assert sorted(r.ids["request"] for r in queue) == list(range(6))
    assert all(t_submit <= r.start_ns <= r.end_ns for r in queue)
    counts = spans.counters(stub.span_id)
    assert counts["serve.rows"] == 6
    assert counts["serve.batches"] == len(stub.calls)
    assert sum(map(len, stub.calls)) == 6
    batches = {r.ids["batch"]: r for r in recs if r.name == "serve.batch"}
    assert len(batches) == len(stub.calls)
    for r in queue:
        assert r.end_ns <= batches[r.ids["batch"]].start_ns
    names = {r.name for r in recs}
    assert {"serve.collect", "serve.lock_wait"} <= names


def test_batcher_counts_shed_requests():
    stub = StubSynth()
    lock = threading.Lock()
    lock.acquire()  # the batcher waits behind a held device lock
    batcher = pserve.DynamicBatcher(stub, lock, window_ms=1, max_batch=1,
                                    queue_deadline_s=0.05)
    box = {}
    threads = [threading.Thread(
        target=lambda i=i: box.setdefault(i, _try_submit(batcher, i)))
        for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    lock.release()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    shed = sum(isinstance(v, pserve.RequestShed) for v in box.values())
    assert shed >= 1
    assert spans.counters(stub.span_id).get("serve.shed") == shed


def _try_submit(batcher, i):
    try:
        return batcher.submit(f"t{i}")
    except pserve.RequestShed as e:
        return e


def test_handler_counts_a_timeout_once_a_request():
    """A read past its deadline inside a batch: each of the batch's
    requests answers 503 and counts one ``serve.timeouts``."""
    from http.server import ThreadingHTTPServer
    from types import SimpleNamespace

    class WedgedSynth(StubSynth):
        preprocess_cfg = SimpleNamespace(
            audio=SimpleNamespace(max_wav_value=32768.0))
        sampling_rate = 22050

        def tts_batch(self, texts):
            raise infer.SynthesisTimeout("wedged")

    stub = WedgedSynth()
    server = ThreadingHTTPServer(("127.0.0.1", 0), pserve.make_handler(
        stub, dynamic_batch=True, batch_window_ms=100))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    codes = []

    def get(i):
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/tts?text=t{i}",
                                   timeout=60)
        except urllib.error.HTTPError as e:
            codes.append(e.code)

    try:
        port = server.server_address[1]
        threads = [threading.Thread(target=get, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.shutdown()
    assert codes == [503, 503]
    assert spans.counters(stub.span_id)["serve.timeouts"] == 2


def test_statusz_carries_the_spans(synth):
    from http.server import ThreadingHTTPServer

    synth.tts_batch(TEXTS[:2])
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 pserve.make_handler(synth))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz",
                                    timeout=60) as r:
            status = json.loads(r.read())
    finally:
        server.shutdown()
    got = status["spans"]
    assert got["spans"]["tts_batch"]["count"] >= 1
    assert set(got["spans"]["tts_batch"]) == {
        "count", "total_ms", "self_ms", "p50_ms", "p95_ms"}
    assert got["counters"]["synth.rows"] >= 2


# --- the benchmark's readers ----------------------------------------------------

NARRATION = ["narration.frontend_share", "narration.launch_share",
             "narration.copy_share", "narration.decode_share"]
SERVE = ["serve.queue_wait_ms", "serve.batch_rows"]


@pytest.fixture(scope="module")
def served(synth):
    """The newest synthesizer's records: two ``tts_batch`` calls, then
    five requests through a batcher around it."""
    newest = build_synthesizer(preset="tiny",
                               hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN),
                               dtype=torch.float32, bench_duration_bias=4.0,
                               transfer="int16", vocoder_mode="folded",
                               device="cpu")
    newest.phoneme_buckets = (16, 32)
    newest.spec_min_frames = 32
    for _ in range(2):
        newest.tts_batch(TEXTS)
    batcher = pserve.DynamicBatcher(newest, threading.Lock(),
                                    window_ms=200, max_batch=8)
    _submit_all(batcher, TEXTS + ["hello there", "good day"])
    # each synthesizer takes the next id: the readers read the newest's
    assert spans.RECORDER.newest_synth == newest.span_id > synth.span_id
    return newest


@pytest.mark.parametrize("name", NARRATION + SERVE)
def test_reader_reads_the_recorder(served, name):
    from perfbench import harness

    read = harness.metric_reader(name)
    assert read({}) is None
    v = read({"trace": {"busy_s": 1.0, "window_s": 2.0}})
    assert v is not None
    if name in NARRATION:
        assert 0 < v < 100
    elif name == "serve.batch_rows":
        counts = spans.counters(served.span_id)
        assert v == counts["serve.rows"] / counts["serve.batches"]
        assert 1 <= v <= 5
    else:
        queue = [r.end_ns - r.start_ns for r in
                 spans.records(served.span_id) if r.name == "serve.queue"]
        assert len(queue) == 5
        assert v == pytest.approx(float(np.median(queue)) / 1e6)


def test_narration_shares_split_the_call(served):
    """The four shares are parts of one call: together under 100 %."""
    from perfbench import harness

    m = {"trace": {"busy_s": 1.0, "window_s": 2.0}}
    total = sum(harness.metric_reader(n)(m) for n in NARRATION)
    assert 0 < total <= 100


def test_bench_profile_trace_shows_the_spans(synth, tmp_path):
    """``bench.py --profile``'s chrome trace holds the spans as host ops
    of their names, as it stands."""
    from efficientspeech_tpu_torch.bench import profiled

    _, summary = profiled(lambda: synth.tts_batch(TEXTS[:2]), str(tmp_path),
                          torch.device("cpu"))
    with open(summary["profile"]) as fh:
        events = json.load(fh)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"tts_batch", "tts_batch.frontend", "tts_batch.pack",
            "synth.acoustic", "synth.vocoder", "synth.fetch.copy",
            "tts_batch.decode"} <= ops
