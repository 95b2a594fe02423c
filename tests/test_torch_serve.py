"""The port's serving layer (``efficientspeech_tpu_torch.serve``) on the
CPU: its answers against the JAX package's server (root ``serve.py``) on
the same parameters, every behaviour test of ``tests/test_serve.py`` but
the pinning of compiled programs (the eager port has none), and the
port's own: the warm-up that fails ends the process, the read counter,
``precompile``, the re-exec command."""

import concurrent.futures
import http.client
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from efficientspeech_tpu_torch import serve as pserve
from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.infer import (
    SynthesisTimeout, build_synthesizer, to_host)

from test_torch_synth import SMALL_HIFIGAN, synths  # noqa: F401

torch.set_num_threads(2)

# the parity bar: test_synthesize_ids_matches_jax's rtol 1e-3, atol 2e-4
# on float samples, in int16 steps
PCM_LSB = 8
STREAM_TEXT = "hello there my good friend, how are you doing today"


@pytest.fixture(scope="module")
def synth():
    """The port's small synthesizer (test_serve.py's sizes), int16 wire."""
    s = build_synthesizer(preset="tiny",
                          hifigan_cfg=HifiGanConfig(**SMALL_HIFIGAN),
                          dtype=torch.float32, bench_duration_bias=4.0,
                          transfer="int16", vocoder_mode="folded",
                          device="cpu")
    s.phoneme_buckets = (16, 32)
    s.mel_expansion = 6
    s.spec_min_frames = 32
    return s


def _start(handler):
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


def _get(port, path, timeout=300):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read(), r.headers


# --- parity with the JAX server -------------------------------------------

@pytest.fixture(scope="module")
def servers(synths):
    """The JAX server and the port's, around synthesizers built from the
    same parameters (float32, int16 wire)."""
    import serve as jserve

    jsynth, psynth = synths
    jsynth.transfer = psynth.transfer = "int16"
    started = [_start(jserve.make_handler(jsynth, stream_segment_phonemes=8)),
               _start(pserve.make_handler(psynth, stream_segment_phonemes=8))]
    yield started[0][1], started[1][1]
    for server, _ in started:
        server.shutdown()


@pytest.mark.parametrize("path", [
    "/tts?text=hello+world",
    "/tts_stream?text=" + urllib.request.quote(STREAM_TEXT)])
def test_answers_match_jax_server(servers, path):
    """The same request to both servers: byte-equal WAV headers, equal
    PCM lengths, PCM within PCM_LSB."""
    jport, pport = servers
    want, jhead = _get(jport, path)
    got, phead = _get(pport, path)
    assert phead["Content-Type"] == jhead["Content-Type"] == "audio/wav"
    if path.startswith("/tts_stream"):
        assert (phead["Transfer-Encoding"] == jhead["Transfer-Encoding"]
                == "chunked")
    else:
        assert phead["Content-Length"] == jhead["Content-Length"]
        assert float(phead["X-RTF"]) > 0
    assert got[:44] == want[:44]
    assert len(got) == len(want) > 44 + 1000
    p = np.frombuffer(got[44:], "<i2").astype(np.int32)
    j = np.frombuffer(want[44:], "<i2").astype(np.int32)
    assert np.abs(j).max() > 100
    assert np.abs(p - j).max() <= PCM_LSB


# --- the behaviour tests of tests/test_serve.py ---------------------------

def test_serve_tts_roundtrip(synth):
    server, port = _start(pserve.make_handler(synth))
    try:
        assert _get(port, "/healthz", 30)[0] == b"ok"
        data, _ = _get(port, "/tts?text=hello+world")
        assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
        pcm = np.frombuffer(data[44:], dtype="<i2")
        assert len(pcm) > 0
        assert np.isfinite(pcm.astype(np.float32)).all()
    finally:
        server.shutdown()


def test_serve_streaming_first_chunk_before_completion(synth):
    """The generator holds segment 2 until the client has read segment
    1's audio: reading it while ``produced_all`` is unset shows the server
    sent audio before synthesis finished."""
    gate = threading.Event()
    produced_all = threading.Event()

    class GatedSynth:
        def __getattr__(self, name):
            return getattr(synth, name)

        def tts_stream(self, text, segment_phonemes=None):
            gen = synth.tts_stream(text, segment_phonemes=8)
            yield next(gen)
            assert gate.wait(timeout=120), "client never confirmed chunk 1"
            for item in gen:
                yield item
            produced_all.set()

    server, port = _start(pserve.make_handler(GatedSynth()))
    try:
        seq = synth.phonemize(STREAM_TEXT)
        assert len(synth._segment(seq, 8)) >= 2, "need a multi-segment text"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("GET", "/tts_stream?text="
                     + urllib.request.quote(STREAM_TEXT))
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        header = resp.read(44)
        assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
        first_audio = resp.read(256)  # blocks until segment 1's PCM
        assert len(first_audio) > 0
        assert not produced_all.is_set()
        gate.set()
        rest = resp.read()
        assert produced_all.is_set()
        pcm = np.frombuffer(first_audio + rest, dtype="<i2")
        assert len(pcm) > 0
        assert np.isfinite(pcm.astype(np.float32)).all()
        conn.close()
    finally:
        gate.set()
        server.shutdown()


def test_tts_stream_concat_matches_tts(synth):
    """The streamed segments, concatenated, are the one-shot synthesis of
    the same text at the same segmentation."""
    text = "the quick brown fox jumps over the lazy dog"
    seq = synth.phonemize(text)
    streamed = np.concatenate(
        [w for w, _ in synth.tts_stream(text, segment_phonemes=8)])
    parts = [synth.synthesize_ids(s)[0] for s in synth._segment(seq, 8)]
    np.testing.assert_allclose(streamed, np.concatenate(parts), atol=1e-6)


def test_index_page_served(synth):
    server, port = _start(pserve.make_handler(synth))
    try:
        body, headers = _get(port, "/", 30)
        assert b"<audio" in body and b"/tts" in body
        assert headers["Content-Type"].startswith("text/html")
    finally:
        server.shutdown()


def _hanging_fetch(release, hang):
    def fetch(tensors):
        if hang["on"]:
            release.wait(timeout=60)  # a read stuck on the card
        return to_host(tensors)
    return fetch


def test_fetch_timeout_503_breaker_and_recovery(synth):
    """A read that hangs (the read hook standing in for a wedged card)
    answers a timely 503 with Retry-After; while the breaker is open the
    next request gets an immediate 503; once the read recovers and the
    cooldown passes, requests succeed again."""
    release = threading.Event()
    hang = {"on": True}
    server, port = _start(pserve.make_handler(
        synth, fetch_timeout_s=0.3, breaker_cooldown_s=1.5))
    synth._fetch_fn = None
    synth.fetch_timeout_s = None
    _get(port, "/tts?text=warm+me", 600)
    synth.fetch_timeout_s = 0.3
    synth._fetch_fn = _hanging_fetch(release, hang)
    try:
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/tts?text=hello", 30)
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert time.time() - t0 < 10
        t1 = time.time()
        with pytest.raises(urllib.error.HTTPError) as e2:
            _get(port, "/tts?text=world", 30)
        assert e2.value.code == 503
        assert time.time() - t1 < 0.5
        hang["on"] = False
        release.set()
        time.sleep(1.6)
        assert _get(port, "/tts?text=back+again")[0][:4] == b"RIFF"
    finally:
        synth._fetch_fn = None
        synth.fetch_timeout_s = None
        release.set()
        server.shutdown()


def test_queue_deadline_sheds_stale_requests(synth):
    """With the batcher's read wedged, a queued request past the queue
    deadline is shed with 503 instead of waiting forever; after recovery a
    fresh request succeeds."""
    release = threading.Event()
    hang = {"on": True}
    server, port = _start(pserve.make_handler(
        synth, dynamic_batch=True, batch_window_ms=5.0,
        fetch_timeout_s=1.0, queue_deadline_s=0.2,
        breaker_cooldown_s=0.5))
    synth._fetch_fn = None
    synth.fetch_timeout_s = None
    _get(port, "/tts?text=warm+me+too", 600)
    synth.fetch_timeout_s = 1.0
    synth._fetch_fn = _hanging_fetch(release, hang)
    try:
        results = {}

        def req(name):
            try:
                results[name] = _get(port, f"/tts?text={name}", 30)[0][:4]
            except urllib.error.HTTPError as e:
                results[name] = e.code

        ta = threading.Thread(target=req, args=("first",))
        ta.start()
        time.sleep(0.4)  # first is mid-read (wedged); second queues
        tb = threading.Thread(target=req, args=("second",))
        tb.start()
        ta.join(30)
        tb.join(30)
        assert not ta.is_alive() and not tb.is_alive()
        assert results["first"] == 503   # the read's deadline
        assert results["second"] == 503  # shed (queue deadline) or breaker
        hang["on"] = False
        release.set()
        time.sleep(0.6)  # past the breaker's cooldown
        assert _get(port, "/tts?text=recovered")[0][:4] == b"RIFF"
    finally:
        synth._fetch_fn = None
        synth.fetch_timeout_s = None
        release.set()
        server.shutdown()


def test_dynamic_batching_groups_concurrent_requests(synth):
    """Concurrent /tts requests within the window run as ONE batch
    (X-Batch-Size > 1) and every caller gets a valid WAV."""
    server, port = _start(pserve.make_handler(synth, dynamic_batch=True,
                                              batch_window_ms=150.0))
    try:
        _get(port, "/tts?text=warm+up+line", 600)

        def fetch(i):
            data, headers = _get(port, f"/tts?text=hello+number+{i}", 600)
            return data, int(headers.get("X-Batch-Size", "1"))

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            results = list(ex.map(fetch, range(4)))
        assert all(d[:4] == b"RIFF" for d, _ in results)
        assert max(b for _, b in results) > 1, [b for _, b in results]
    finally:
        server.shutdown()


def test_statusz_reports_generation_and_inflight(synth):
    state = pserve.ServeState(generation=3)
    server, port = _start(pserve.make_handler(synth, state=state))
    try:
        s = json.loads(_get(port, "/statusz", 30)[0])
        assert s["generation"] == 3
        assert s["rss_mb"] > 0
        assert s["inflight"] >= 1  # this very request
        assert s["draining"] is False
    finally:
        server.shutdown()


class FakeServer:
    def shutdown(self):
        pass


def test_rss_recycler_drains_inflight_before_exec(synth):
    """An RSS breach stops the accept loop but keeps the listening socket
    open (new connections wait, not refused), and the requests in flight
    finish before the (injected) exec fires."""
    release = threading.Event()
    entered = threading.Event()

    class GatedSynth:
        def __getattr__(self, name):
            return getattr(synth, name)

        def tts(self, text, speaker=None):
            entered.set()
            release.wait(timeout=60)
            return synth.tts(text)

    state = pserve.ServeState(generation=0)
    server, port = _start(pserve.make_handler(GatedSynth(), state=state))
    execd = threading.Event()
    seen = {}

    def fake_exec(srv):
        seen["inflight_at_exec"] = state.inflight
        seen["socket_open"] = srv.socket.fileno() != -1
        execd.set()

    rec = pserve.RssRecycler(server, state, limit_mb=1.0,
                             check_interval_s=0.05, drain_timeout_s=30.0,
                             min_uptime_s=0.0, arm_guard=False,
                             exec_fn=fake_exec)
    results = {}

    def slow_request():
        results["data"] = _get(port, "/tts?text=held+request")[0]

    t = threading.Thread(target=slow_request)
    t.start()
    assert entered.wait(timeout=60)
    rec.start()  # breaches at once; must WAIT for the held request
    time.sleep(0.5)
    assert not execd.is_set(), "exec fired while a request was in flight"
    c = socket.create_connection(("127.0.0.1", port), timeout=5)
    c.close()
    release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    assert results["data"][:4] == b"RIFF"
    assert execd.wait(timeout=30)
    assert seen["inflight_at_exec"] == 0
    assert seen["socket_open"]
    server.server_close()


def test_rss_recycler_arm_guard_and_min_uptime():
    """A limit at or below the warm resident set is raised (floor +
    headroom) at arm time, and a later breach still recycles, but never
    within min_uptime_s of arming."""
    rss = {"mb": 3000.0}
    execd = threading.Event()
    rec = pserve.RssRecycler(FakeServer(), pserve.ServeState(),
                             limit_mb=2000.0, check_interval_s=0.02,
                             min_uptime_s=0.3, headroom_mb=500.0,
                             exec_fn=lambda srv: execd.set(),
                             rss_fn=lambda: rss["mb"])
    rec.start()
    assert rec.limit_mb == 3500.0
    rss["mb"] = 4000.0
    assert not execd.wait(timeout=0.15), "recycled before min_uptime_s"
    assert execd.wait(timeout=2.0), "never recycled after min_uptime_s"
    assert time.time() - rec._armed_at >= 0.3


def test_warmup_window_sheds_503_until_ready(synth):
    """While not ready, /tts and /healthz answer a fast 503 with
    Retry-After; /statusz stays live; ready restores service."""
    state = pserve.ServeState()
    state.ready = False
    server, port = _start(pserve.make_handler(synth, state=state))
    try:
        for path in ("/tts?text=hello", "/healthz"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(port, path, 30)
            assert ei.value.code == 503
            assert float(ei.value.headers["Retry-After"]) > 0
        assert json.loads(_get(port, "/statusz", 30)[0])["ready"] is False
        state.ready = True
        assert _get(port, "/tts?text=hello", 60)[0][:4] == b"RIFF"
    finally:
        server.shutdown()


def test_recycle_waits_for_warm_lock():
    """A recycle does not exec while device work (the warm thread's, or
    a request's) holds the device lock."""
    device_lock = threading.Lock()
    execd = threading.Event()
    rec = pserve.RssRecycler(FakeServer(), pserve.ServeState(),
                             limit_mb=1.0, check_interval_s=0.02,
                             min_uptime_s=0.0, arm_guard=False,
                             device_lock=device_lock,
                             exec_fn=lambda srv: execd.set(),
                             rss_fn=lambda: 100.0)
    device_lock.acquire()  # a warm run is on the card
    rec.start()
    assert not execd.wait(timeout=0.5), "exec fired mid-warm"
    device_lock.release()
    assert execd.wait(timeout=5.0)


def test_recycle_waits_for_abandoned_fetch(synth):
    """A read abandoned by its deadline (its request answered 503, its
    thread still waiting) holds the recycle's exec until it ends."""
    release = threading.Event()
    old_fn, old_to = synth._fetch_fn, synth.fetch_timeout_s
    synth._fetch_fn = lambda tensors: (release.wait(30), to_host(tensors))[1]
    synth.fetch_timeout_s = 0.1
    try:
        with pytest.raises(SynthesisTimeout):
            synth._device_get(torch.zeros(3))
        assert synth.pending_fetches() == 1
        execd = threading.Event()
        rec = pserve.RssRecycler(FakeServer(), pserve.ServeState(),
                                 limit_mb=1.0, check_interval_s=0.02,
                                 min_uptime_s=0.0, arm_guard=False,
                                 synth=synth,
                                 exec_fn=lambda srv: execd.set(),
                                 rss_fn=lambda: 100.0)
        rec.start()
        assert not execd.wait(timeout=1.0), "exec fired mid-read"
        release.set()
        assert execd.wait(timeout=10.0)
        assert synth.pending_fetches() == 0
    finally:
        synth._fetch_fn, synth.fetch_timeout_s = old_fn, old_to
        release.set()


def test_make_server_adopts_inherited_fd(synth):
    """The child of a recycle: make_server takes SERVE_INHERIT_FD and
    serves on the SAME listening socket instead of binding again."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(64)
    port = lsock.getsockname()[1]
    lsock.set_inheritable(True)
    os.environ["SERVE_INHERIT_FD"] = str(lsock.fileno())
    try:
        server = pserve.make_server("127.0.0.1", port,
                                    pserve.make_handler(synth))
        assert "SERVE_INHERIT_FD" not in os.environ
        assert server.server_port == port
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            assert _get(port, "/healthz", 30)[0] == b"ok"
        finally:
            server.shutdown()
            server.server_close()
    finally:
        os.environ.pop("SERVE_INHERIT_FD", None)


# --- the port's own -----------------------------------------------------------

def test_failed_warmup_exits_with_1(synth, capsys):
    """A warm-up that raises prints its traceback and calls the exit hook
    with 1, and the server never turns ready (without the exit it would
    answer 503 forever)."""

    class BrokenSynth:
        def __getattr__(self, name):
            return getattr(synth, name)

        def precompile(self, buckets, batch_sizes=(1,)):
            raise RuntimeError("kernel library failed to build")

    state = pserve.ServeState()
    state.ready = False
    codes, ready_calls = [], []
    pserve.init_and_warm(BrokenSynth(), state, threading.Lock(), "hi there",
                         [16], [1], on_ready=lambda: ready_calls.append(1),
                         exit_fn=codes.append)
    assert codes == [1]
    assert state.ready is False and not ready_calls
    assert "kernel library failed to build" in capsys.readouterr().err


def test_warmup_turns_ready_under_the_device_lock(synth):
    """The warm thread's runs hold the device lock; ready and on_ready
    follow them, and the exit hook is not called."""
    lock = threading.Lock()
    held = []

    class Probe:
        def __getattr__(self, name):
            return getattr(synth, name)

        def synthesize_ids(self, seq):
            held.append(lock.locked())
            return synth.synthesize_ids(seq)

        def precompile(self, buckets, batch_sizes=(1,)):
            held.append(lock.locked())
            return synth.precompile(buckets, batch_sizes)

    state = pserve.ServeState()
    state.ready = False
    codes, ready_calls = [], []
    pserve.init_and_warm(Probe(), state, lock, "hi there", [16], [1, 2],
                         on_ready=lambda: ready_calls.append(state.ready),
                         exit_fn=codes.append)
    assert held == [True, True, True]
    assert state.ready and ready_calls == [True] and codes == []


def test_pending_fetches_counts_reads_without_deadline(synth):
    """A read with no deadline is counted while it is in flight."""
    release, entered = threading.Event(), threading.Event()

    def fetch(tensors):
        entered.set()
        release.wait(30)
        return to_host(tensors)

    old_fn, old_to = synth._fetch_fn, synth.fetch_timeout_s
    synth._fetch_fn, synth.fetch_timeout_s = fetch, None
    out = {}
    t = threading.Thread(
        target=lambda: out.update(r=synth._device_get(torch.arange(4))))
    try:
        t.start()
        assert entered.wait(10)
        assert synth.pending_fetches() == 1
        release.set()
        t.join(10)
        assert not t.is_alive()
        assert synth.pending_fetches() == 0
        np.testing.assert_array_equal(out["r"][0], np.arange(4))
    finally:
        synth._fetch_fn, synth.fetch_timeout_s = old_fn, old_to
        release.set()


@pytest.mark.parametrize("mode", ["folded", "chunked"])
def test_precompile_warms_shapes_and_leaves_tracker(synth, monkeypatch,
                                                    mode):
    """One run a (batch, bucket, frames) shape with real phonemes in every
    row, through the fused program or (chunked mode) the split pipeline's
    acoustic call and vocoder; the speculation tracker is left as it
    was."""
    synth.synthesize_ids(synth.phonemize("hello world"))  # a real ratio
    before = (list(synth._obs_recent), synth._obs_ratio)
    monkeypatch.setattr(synth, "vocoder_mode", mode)
    runs = []
    name = "_run" if mode == "folded" else "_acoustic_split"
    program = getattr(synth, name)

    def spy(phoneme, *args):
        runs.append((phoneme.shape, bool((phoneme != 0).all())))
        return program(phoneme, *args)

    monkeypatch.setattr(synth, name, spy)
    shapes = synth.precompile(buckets=[32, 16], batch_sizes=[1, 2])
    f16, f32 = synth._spec_frames(16, 16), synth._spec_frames(32, 32)
    assert shapes == [(1, 16, f16), (2, 16, f16), (1, 32, f32),
                      (2, 32, f32)]
    assert runs == [((bs, b), True) for bs, b, _ in shapes]
    assert (list(synth._obs_recent), synth._obs_ratio) == before


def test_reexec_runs_the_module():
    """The recycle re-execs ``python -m efficientspeech_tpu_torch.serve``
    with the server's arguments, not the module file as a script."""
    import sys

    assert pserve.reexec_argv(["--port", "9000", "--device", "cpu"]) == [
        sys.executable, "-m", "efficientspeech_tpu_torch.serve",
        "--port", "9000", "--device", "cpu"]


def test_reexec_with_socket_hands_the_socket_across(monkeypatch):
    calls = []
    monkeypatch.setattr(os, "execv", lambda exe, argv: calls.append(
        (exe, argv)))
    monkeypatch.setenv("SERVE_GENERATION", "4")
    monkeypatch.delenv("SERVE_INHERIT_FD", raising=False)
    lsock = socket.socket()
    try:
        lsock.bind(("127.0.0.1", 0))
        lsock.listen(1)

        class Srv:
            socket = lsock

        pserve.reexec_with_socket(Srv(), ["--port", "1"])
        assert calls == [(calls[0][0], pserve.reexec_argv(["--port", "1"]))]
        assert os.environ["SERVE_INHERIT_FD"] == str(lsock.fileno())
        assert os.environ["SERVE_GENERATION"] == "5"
        assert lsock.get_inheritable()
    finally:
        os.environ.pop("SERVE_INHERIT_FD", None)
        lsock.close()


def test_warm_batch_sizes():
    assert pserve.warm_batch_sizes(False, 32) == [1]
    assert pserve.warm_batch_sizes(True, 32) == [1, 32]
    assert pserve.warm_batch_sizes(True, 20) == [1, 32]
    assert pserve.warm_batch_sizes(True, 1) == [1]
