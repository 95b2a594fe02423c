"""The serving layer on the card: a warm Synthesizer behind HTTP
(counterpart of the JAX package's root ``serve.py``).

    python -m efficientspeech_tpu_torch.serve --port 8000
    curl "localhost:8000/tts?text=hello+world" -o out.wav
    curl -N "localhost:8000/tts_stream?text=..." -o out.wav   # chunked
    curl "localhost:8000/healthz"

It runs on the card unless ``--device cpu`` is given.  The server accepts
at once and answers 503 with Retry-After until its warm thread has run
the warm-up text and every precompiled shape; a warm-up that raises ends
the process with exit code 1.  Concurrent ``/tts`` requests are batched
(``tts_batch``); ``/tts_stream`` sends the audio of each pause-bounded
segment as soon as it is synthesized (chunked transfer encoding).  A read
from the card past ``--fetch-timeout`` answers 503 and opens a circuit
breaker; queued requests past ``--queue-deadline`` are shed with 503;
past ``--rss-limit-mb`` the worker drains and re-execs itself on the same
listening socket.  ``/statusz`` carries the span recorder's ``snapshot``
(``utils/spans.py``): the batcher's ``serve.queue`` (a request's wait
from ``submit`` until its batch is taken), ``serve.collect``,
``serve.lock_wait`` and ``serve.batch``, the handler's ``serve.respond``,
the synthesizer's own spans, and the counters ``serve.batches``,
``serve.rows``, ``serve.shed`` and ``serve.timeouts`` (requests whose
read from the card missed its deadline).

The acoustic model's weights are a random init from ``--seed`` unless
``--checkpoint`` names a reference EfficientSpeech checkpoint (a
Lightning ``.ckpt``, converted on load) or one of the port's trainer; the
vocoder's come from ``--hifigan-checkpoint`` when that file exists (its
``config.json`` beside it chooses the shape), else a random init.
"""

import argparse
import itertools
import json
import os
import socket as socketlib
import struct
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from efficientspeech_tpu_torch.audio.transfer import FORMATS
from efficientspeech_tpu_torch.config import add_arch_args, arch_overrides
from efficientspeech_tpu_torch.infer import SynthesisTimeout
from efficientspeech_tpu_torch.utils import spans

# a zero-dependency page over the /tts endpoints
INDEX_HTML = b"""<!doctype html>
<html><head><meta charset="utf-8"><title>EfficientSpeech</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:720px;margin:3rem auto;
      padding:0 1rem;color:#222}
 textarea{width:100%;height:7rem;font:inherit;padding:.5rem;
          box-sizing:border-box}
 button{font:inherit;padding:.5rem 1.5rem;margin-right:.5rem;cursor:pointer}
 #stats{color:#666;margin-top:.75rem;font-size:.9rem}
 audio{width:100%;margin-top:1rem}
</style></head><body>
<h2>EfficientSpeech</h2>
<p>Type text, press Synthesize (buffered) or Stream (chunked WAV &mdash;
audio starts after the first segment).</p>
<textarea id="t">The quick brown fox jumps over the lazy dog.</textarea>
<div>
 <button onclick="go('/tts')">Synthesize</button>
 <button onclick="go('/tts_stream')">Stream</button>
</div>
<div id="stats"></div>
<audio id="a" controls></audio>
<script>
async function go(ep){
  const text=document.getElementById('t').value.trim();
  if(!text)return;
  const t0=performance.now();
  const url=ep+'?text='+encodeURIComponent(text);
  const a=document.getElementById('a');
  const s=document.getElementById('stats');
  s.textContent='synthesizing\\u2026';
  try{
    const r=await fetch(url);
    if(!r.ok){s.textContent='error: '+await r.text();return;}
    const blob=await r.blob();
    const ms=performance.now()-t0;
    const rtf=r.headers.get('X-RTF');
    s.textContent='latency '+ms.toFixed(0)+' ms'+(rtf?'  \\u00b7  RTF '+rtf:'');
    a.src=URL.createObjectURL(blob);
    a.play();
  }catch(e){s.textContent='error: '+e;}
}
</script></body></html>
"""



def wav_header(n_pcm_bytes: int, sampling_rate: int) -> bytes:
    """RIFF header of mono 16-bit PCM; pass n_pcm_bytes=0xFFFFFFF0 - 36
    for a stream of unknown length (players accept the over-long size)."""
    fmt = struct.pack("<IHHIIHH", 16, 1, 1, sampling_rate,
                      sampling_rate * 2, 2, 16)
    riff_len = (36 + n_pcm_bytes) & 0xFFFFFFFF
    return (b"RIFF" + struct.pack("<I", riff_len) + b"WAVEfmt " + fmt
            + b"data" + struct.pack("<I", n_pcm_bytes & 0xFFFFFFFF))


def pcm16(wav, max_wav_value: float) -> bytes:
    return np.clip(wav * max_wav_value, -max_wav_value,
                   max_wav_value - 1).astype("<i2").tobytes()


def wav_bytes(wav, sampling_rate: int, max_wav_value: float) -> bytes:
    pcm = pcm16(wav, max_wav_value)
    return wav_header(len(pcm), sampling_rate) + pcm


class CircuitBreaker:
    """Fail fast while the card is wedged; recover by itself.

    A read past the deadline (SynthesisTimeout) opens the breaker for
    ``cooldown_s``: requests in that window get an immediate 503 with
    Retry-After instead of queueing more work behind the stuck stream.
    After the cooldown the next request probes the card (half-open), and
    a success closes the breaker."""

    def __init__(self, cooldown_s: float = 10.0):
        self.cooldown_s = cooldown_s
        self._open_until = 0.0
        self._lock = threading.Lock()

    def trip(self):
        with self._lock:
            self._open_until = time.time() + self.cooldown_s

    def close(self):
        with self._lock:
            self._open_until = 0.0

    def is_open(self) -> bool:
        return time.time() < self._open_until

    def retry_after(self) -> int:
        return max(1, int(self._open_until - time.time() + 0.999))


class RequestShed(Exception):
    """A request shed before it ran (queue deadline passed or breaker
    open); answered with 503."""

    def __init__(self, msg: str, retry_after: int = 1):
        super().__init__(msg)
        self.retry_after = retry_after


def rss_mb() -> float:
    """This process's resident set size in MB (/proc, Linux)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class ServeState:
    """State across requests: the in-flight count (drained before a
    recycle), readiness, and the recycle generation (passed across
    re-execs in SERVE_GENERATION)."""

    def __init__(self, generation: int = 0):
        self.generation = generation
        self.draining = False
        # False while the warm thread runs (main() sets it): /tts and
        # /healthz then answer a fast 503 with Retry-After instead of
        # holding clients behind the device lock
        self.ready = True
        self._inflight = 0
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)

    def enter(self):
        with self._lock:
            self._inflight += 1

    def leave(self):
        with self._idle:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.notify_all()

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def wait_idle(self, timeout_s: float) -> bool:
        deadline = time.time() + timeout_s
        with self._idle:
            while self._inflight > 0:
                left = deadline - time.time()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True


def reexec_argv(argv=None) -> list:
    """The command a recycle re-execs: this module under ``-m`` (so the
    package stays importable) with the server's own arguments."""
    args = sys.argv[1:] if argv is None else list(argv)
    return [sys.executable, "-m", "efficientspeech_tpu_torch.serve"] + args


def reexec_with_socket(server, argv=None) -> None:
    """Replace this process with a fresh server, handing the LISTENING
    socket across the exec: the child adopts it (SERVE_INHERIT_FD), so
    connections that arrive during its warm-up wait in the kernel's
    backlog instead of being refused.  Never returns."""
    sock = server.socket
    sock.set_inheritable(True)
    os.environ["SERVE_INHERIT_FD"] = str(sock.fileno())
    os.environ["SERVE_GENERATION"] = str(
        int(os.environ.get("SERVE_GENERATION", "0")) + 1)
    sys.stdout.flush()
    sys.stderr.flush()
    cmd = reexec_argv(argv)
    os.execv(cmd[0], cmd)


def make_server(host: str, port: int, handler) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer that adopts an inherited listening socket
    (the child of a recycle) instead of binding when SERVE_INHERIT_FD is
    set: the socket never closes across recycles, so no client sees a
    refused connection."""

    class _Server(ThreadingHTTPServer):
        # connections that arrive during a recycle's warm-up wait here in
        # the kernel's backlog; the default of 5 would drop them
        request_queue_size = 128

    fd = os.environ.pop("SERVE_INHERIT_FD", None)
    if fd is None:
        return _Server((host, port), handler)
    server = _Server((host, port), handler, bind_and_activate=False)
    server.socket.close()
    server.socket = socketlib.socket(fileno=int(fd))
    server.server_address = server.socket.getsockname()
    server.server_name = socketlib.getfqdn(host)
    server.server_port = server.server_address[1]
    return server


class RssRecycler:
    """Worker-recycle watchdog: when the resident set exceeds
    ``limit_mb``, stop accepting (``server.shutdown()``; the listening
    socket stays open and new connections wait in the kernel's backlog),
    drain the requests in flight, wait for the device work and the reads
    from the card to end, and re-exec the server in place.  The child
    adopts the socket and warms up again; clients see a latency bump, not
    errors.

    ``device_lock`` is the lock every piece of device work holds (the
    handlers' synthesis and the warm thread's runs): the recycle takes it
    before the exec, so no device work is cut off mid-way.  ``synth``'s
    ``pending_fetches()`` counts the reads that a deadline abandoned and
    that still wait on the card; the recycle waits for 0.
    ``exec_fn``/``rss_fn`` are injectable for tests."""

    def __init__(self, server, state: ServeState, limit_mb: float,
                 check_interval_s: float = 5.0,
                 drain_timeout_s: float = 120.0,
                 min_uptime_s: float = 120.0,
                 headroom_mb: float = 512.0,
                 arm_guard: bool = True,
                 device_lock=None, synth=None,
                 exec_fn=None, rss_fn=None):
        self.server = server
        self.state = state
        self.limit_mb = limit_mb
        self.check_interval_s = check_interval_s
        self.drain_timeout_s = drain_timeout_s
        self.min_uptime_s = min_uptime_s
        self.headroom_mb = headroom_mb
        self.arm_guard = arm_guard
        self.device_lock = device_lock
        self.synth = synth
        self.exec_fn = exec_fn or reexec_with_socket
        self.rss_fn = rss_fn or rss_mb
        self.recycling = False
        self._armed_at = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        # recycle-loop guard: a limit at or below the warm server's
        # resident set would recycle forever without serving a request;
        # raise it to that floor plus headroom, loudly
        mb = self.rss_fn()
        if self.arm_guard and mb >= self.limit_mb:
            eff = mb + self.headroom_mb
            print(f"[serve] RSS {mb:.0f} MB already >= limit "
                  f"{self.limit_mb:.0f} MB at arm time: raising effective "
                  f"limit to {eff:.0f} MB (recycle-loop guard)", flush=True)
            self.limit_mb = eff
        self._armed_at = time.time()
        self._thread.start()

    def _run(self):
        while True:
            time.sleep(self.check_interval_s)
            mb = self.rss_fn()
            # min uptime: each generation serves before the next warm-up
            if (mb > self.limit_mb
                    and time.time() - self._armed_at >= self.min_uptime_s):
                print(f"[serve] RSS {mb:.0f} MB > limit "
                      f"{self.limit_mb:.0f} MB: recycling worker "
                      f"(generation {self.state.generation})", flush=True)
                self.recycle()
                return

    def recycle(self):
        self.recycling = True
        self.state.draining = True
        # stop the accept loop; the listening socket stays open, so the
        # kernel's backlog holds new connections through the re-exec
        threading.Thread(target=self.server.shutdown, daemon=True).start()
        drained = self.state.wait_idle(self.drain_timeout_s)
        print(f"[serve] drained={drained} inflight={self.state.inflight}; "
              f"re-exec", flush=True)
        if self.device_lock is not None:
            # quiesce the device work (the warm thread's included); not
            # released: the exec follows
            t0 = time.time()
            got = self.device_lock.acquire(timeout=600.0)
            print(f"[serve] device quiesce "
                  f"{'ok' if got else 'TIMED OUT'} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if self.synth is not None:
            # reads that a deadline abandoned outlive their (503'd,
            # drained) requests; wait for them, bounded: one that never
            # ends means the card is wedged and the exec cannot make it
            # worse
            t0 = time.time()
            while (n := self.synth.pending_fetches()) > 0 \
                    and time.time() - t0 < 300.0:
                time.sleep(0.5)
            print(f"[serve] fetch quiesce "
                  f"{'ok' if n == 0 else f'TIMED OUT ({n} live)'} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        self.exec_fn(self.server)


class DynamicBatcher:
    """Aggregate concurrent /tts requests into one batched synthesis.

    Requests that arrive within ``window_ms`` of the first pending one run
    together through ``tts_batch`` (one program and one read for the whole
    group); a lone request pays only the window."""

    def __init__(self, synth, lock, window_ms: float = 8.0,
                 max_batch: int = 32, queue_deadline_s=None,
                 breaker=None):
        self.synth = synth
        self.lock = lock
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        # a request older than this when its turn comes is shed with 503
        # instead of synthesized late (its client has likely given up)
        self.queue_deadline_s = queue_deadline_s
        self.breaker = breaker
        # the spans' ids: the synthesizer's, and a request's and a batch's
        self.span_id = getattr(synth, "span_id", None)
        self._requests = itertools.count()
        self._batches = itertools.count()
        self._mutex = threading.Lock()
        # (text, done, box, time.time_ns() at submit, request id)
        self._pending = []
        self._wake = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # submit() polls at this granularity so that a dead worker thread
    # surfaces as a 5xx instead of blocking handler threads forever
    WAIT_SLICE_SECS = 5.0

    def submit(self, text: str):
        done = threading.Event()
        box = {}
        with self._mutex:
            self._pending.append((text, done, box, time.time_ns(),
                                  next(self._requests)))
        self._wake.set()
        while not done.wait(self.WAIT_SLICE_SECS):
            if not self._worker.is_alive():
                raise RuntimeError("synthesis worker died")
        if "error" in box:
            raise box["error"]
        return box["wav"], box["info"]

    def _shed_stale(self):
        """Fail queued requests that outlived the deadline (503)."""
        if self.queue_deadline_s is None:
            return
        now = time.time()
        with self._mutex:
            stale = [e for e in self._pending
                     if now - e[3] / 1e9 > self.queue_deadline_s]
            self._pending = [e for e in self._pending
                             if now - e[3] / 1e9 <= self.queue_deadline_s]
        if stale:
            spans.count("serve.shed", len(stale), synth=self.span_id)
        for _, done, box, t_in, _ in stale:
            box["error"] = RequestShed(
                f"shed after {now - t_in / 1e9:.1f}s in queue "
                f"(deadline {self.queue_deadline_s:.1f}s)")
            done.set()

    def _run(self):
        sid = self.span_id
        while True:
            self._wake.wait()
            with self._mutex:
                backlog = len(self._pending)
            if backlog < self.max_batch:
                with spans.span("serve.collect", synth=sid):
                    time.sleep(self.window)  # the collection window
            self._shed_stale()
            with self._mutex:
                group = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if not self._pending:
                    self._wake.clear()
            if not group:
                continue
            batch, taken = next(self._batches), time.time_ns()
            for _, _, _, t_in, rid in group:
                spans.record("serve.queue", t_in, taken, synth=sid,
                             request=rid, batch=batch)
            spans.count("serve.batches", synth=sid)
            spans.count("serve.rows", len(group), synth=sid)
            texts = [e[0] for e in group]
            try:
                with spans.span("serve.lock_wait", synth=sid, batch=batch):
                    self.lock.acquire()
                try:
                    with spans.span("serve.batch", synth=sid, batch=batch,
                                    rows=len(group)):
                        outs = self.synth.tts_batch(texts)
                finally:
                    self.lock.release()
                if self.breaker is not None:
                    self.breaker.close()  # the card answered
                voice_total = sum(info["voice_secs"] for _, info in outs)
                for (t, done, box, _, _), (wav, info) in zip(group, outs):
                    box["wav"] = wav
                    # rtf: this request's share of the batch; batch_rtf:
                    # the batch's voice seconds over its time, the figure
                    # comparable across batch sizes
                    box["info"] = dict(
                        info, batch_size=len(group),
                        rtf=info["voice_secs"]
                        / max(info["batch_secs"], 1e-9),
                        batch_rtf=voice_total
                        / max(info["batch_secs"], 1e-9))
                    done.set()
            except BaseException as e:  # every waiter gets the failure
                if isinstance(e, SynthesisTimeout) and self.breaker:
                    self.breaker.trip()  # wedged card: fail fast now
                for _, done, box, _, _ in group:
                    box["error"] = (e if isinstance(e, Exception)
                                    else RuntimeError(repr(e)))
                    done.set()
                if not isinstance(e, Exception):
                    raise


def make_handler(synth, lock=None, stream_segment_phonemes=None,
                 dynamic_batch: bool = False,
                 batch_window_ms: float = 8.0, max_batch: int = 32,
                 fetch_timeout_s=None, queue_deadline_s=None,
                 breaker_cooldown_s: float = 10.0,
                 state: ServeState = None):
    """The request handler around a warm Synthesizer (main() and the
    tests build it).

    ``lock`` serialises every piece of device work (one stream, one
    Synthesizer state).  ``fetch_timeout_s`` sets the Synthesizer's
    deadline on reads from the card (a miss answers 503 with
    Retry-After), a miss opens a circuit breaker for
    ``breaker_cooldown_s``, and queued requests older than
    ``queue_deadline_s`` are shed with 503 before they run."""
    lock = lock or threading.Lock()
    state = state or ServeState()
    if fetch_timeout_s is not None:
        synth.fetch_timeout_s = fetch_timeout_s
    breaker = CircuitBreaker(cooldown_s=breaker_cooldown_s)
    batcher = DynamicBatcher(synth, lock, window_ms=batch_window_ms,
                             max_batch=max_batch,
                             queue_deadline_s=queue_deadline_s,
                             breaker=breaker) if dynamic_batch else None
    sid = getattr(synth, "span_id", None)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _chunk(self, data: bytes):
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        def _send(self, code: int, body: bytes, content_type=None,
                  headers=()):
            self.send_response(code)
            if content_type:
                self.send_header("Content-Type", content_type)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _unavailable(self, msg: str, retry_after: int):
            self._send(503, msg.encode(),
                       headers=[("Retry-After", str(retry_after))])

        def do_GET(self):
            state.enter()  # drained before a worker recycle
            try:
                self._do_GET()
            finally:
                state.leave()

        def _do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/statusz":
                self._send(200, json.dumps({
                    "generation": state.generation,
                    "rss_mb": round(rss_mb(), 1),
                    "inflight": state.inflight,
                    "ready": state.ready,
                    "draining": state.draining,
                    "spans": spans.snapshot()}).encode(),
                    "application/json")
                return
            if parsed.path == "/healthz":
                if not state.ready:
                    self._unavailable("warming", 15)
                    return
                self._send(200, b"ok")
                return
            if parsed.path in ("/", "/index.html"):
                self._send(200, INDEX_HTML, "text/html; charset=utf-8")
                return
            if parsed.path not in ("/tts", "/tts_stream"):
                self._send(404, b"")
                return
            q = urllib.parse.parse_qs(parsed.query)
            text = (q.get("text") or [""])[0]
            if not text:
                self._send(400, b"missing ?text=")
                return
            # optional multi-speaker conditioning (?speaker=K); such a
            # request takes the direct path (the batcher groups requests
            # of one conditioning only)
            try:
                speaker = int((q.get("speaker") or ["-1"])[0])
            except ValueError:
                speaker = -1
            speaker = speaker if speaker >= 0 else None
            if not state.ready:
                # warm-up (or a recycle's): shed fast with a retry hint
                self._unavailable("warming up (worker recycle)", 30)
                return
            if breaker.is_open():
                self._unavailable("device unavailable (circuit open)",
                                  breaker.retry_after())
                return
            max_wav = synth.preprocess_cfg.audio.max_wav_value
            t0 = time.time()

            if parsed.path == "/tts_stream":
                # chunked WAV: the header, then PCM per segment as soon as
                # it is synthesized
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                self._chunk(wav_header(0xFFFFFFF0 - 36,
                                       synth.sampling_rate))
                first_ms = None
                # the device lock is held per SEGMENT, not across writes
                # to the client: a slow client never stalls the others
                seg_gen = synth.tts_stream(
                    text, segment_phonemes=stream_segment_phonemes)
                while True:
                    with lock:
                        try:
                            wav, info = next(seg_gen)
                        except StopIteration:
                            break
                        except SynthesisTimeout as e:
                            # the headers are out: end the stream early
                            # (the client keeps the segments it got) and
                            # open the breaker for everyone else
                            spans.count("serve.timeouts", synth=sid)
                            breaker.trip()
                            print(f"[serve] /tts_stream timeout: {e}")
                            break
                    if first_ms is None:
                        first_ms = (time.time() - t0) * 1e3
                    self._chunk(pcm16(wav, max_wav))
                self._chunk(b"")  # terminator
                print(f"[serve] /tts_stream first-audio "
                      f"{first_ms if first_ms is None else round(first_ms, 1)}"
                      f" ms, total {(time.time() - t0) * 1e3:.1f} ms")
                return

            try:
                if batcher is not None and speaker is None:
                    wav, info = batcher.submit(text)
                else:
                    with lock:
                        wav, info = synth.tts(text, speaker=speaker)
                        breaker.close()
            except SynthesisTimeout as e:
                # wedged card: 503 now, and the breaker sheds the pile-up
                # until the next success closes it
                spans.count("serve.timeouts", synth=sid)
                breaker.trip()
                self._unavailable(f"synthesis timed out: {e}",
                                  breaker.retry_after())
                return
            except RequestShed as e:
                self._unavailable(str(e), e.retry_after)
                return
            except Exception as e:
                self._send(500, f"synthesis failed: {e}".encode())
                return
            headers = []
            if "batch_size" in info:
                headers.append(("X-Batch-Size", str(info["batch_size"])))
            if "batch_rtf" in info:
                # the batch's throughput; X-RTF is this request's share
                headers.append(("X-Batch-RTF", f"{info['batch_rtf']:.1f}"))
            headers.append(("X-RTF", f"{info['rtf']:.1f}"))
            headers.append(("X-Latency-Ms",
                            f"{(time.time() - t0) * 1e3:.1f}"))
            with spans.span("serve.respond", synth=sid):
                self._send(200, wav_bytes(wav, synth.sampling_rate,
                                          max_wav), "audio/wav", headers)

        def log_message(self, fmt, *a):
            print(f"[serve] {fmt % a}")

    return Handler


def warm_batch_sizes(dynamic_batch: bool, max_batch: int) -> list:
    """The batch sizes warmed before ready: 1, and with dynamic batching
    the rows of a full batch (``tts_batch`` pads to a power of two)."""
    if not dynamic_batch:
        return [1]
    full = 1
    while full < max_batch:
        full *= 2
    return sorted({1, full})


def init_and_warm(synth, state: ServeState, lock, warmup_text: str,
                  buckets, batch_sizes, on_ready=None, exit_fn=os._exit):
    """The warm thread's body (main() runs it on a thread of its own):
    the warm-up text twice, then ``synth.precompile`` of every bucket at
    each of ``batch_sizes``, each under the device lock; then ``ready``
    and ``on_ready()``.  If any of it raises, the traceback is printed and
    the process ends with exit code 1 through ``exit_fn``: a server that
    cannot warm up would otherwise answer 503 forever."""
    try:
        print("warming up ...", flush=True)
        seq = synth.phonemize(warmup_text)
        for it in range(2):
            ti = time.time()
            with lock:
                synth.synthesize_ids(seq)
            print(f"[serve] warmup iter {it} {time.time() - ti:.1f}s",
                  flush=True)
        t0 = time.time()
        with lock:
            shapes = synth.precompile(buckets, batch_sizes)
        print(f"[serve] warm shapes ({time.time() - t0:.1f}s): {shapes}",
              flush=True)
        state.ready = True
        print(f"[serve] ready: 503 window closed "
              f"(generation {state.generation})", flush=True)
        if on_ready is not None:
            on_ready()
    except BaseException:  # the process ends here: nothing to re-raise to
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        exit_fn(1)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="tiny",
                        choices=["tiny", "small", "base"])
    parser.add_argument("--checkpoint", default=None,
                        help="a reference .ckpt (converted), or a "
                             "step_*.pt checkpoint of the port's trainer or "
                             "its directory (the latest is read); default: "
                             "a random init from --seed")
    parser.add_argument("--hifigan-checkpoint", default=None,
                        help="reference HiFi-GAN generator file; a random "
                             "vocoder when it is missing")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--transfer", default="int16",
                        choices=list(FORMATS),
                        help="card → host PCM wire format (adpcm4/3/2: "
                             "encoded by a CUDA kernel, decoded in C++)")
    parser.add_argument("--stream-segment-phonemes", type=int, default=128)
    parser.add_argument("--dynamic-batch", action="store_true", default=True,
                        help="aggregate concurrent /tts requests into one "
                             "batched synthesis (default on)")
    parser.add_argument("--no-dynamic-batch", dest="dynamic_batch",
                        action="store_false")
    parser.add_argument("--batch-window-ms", type=float, default=8.0)
    parser.add_argument("--max-batch", type=int, default=32)
    parser.add_argument("--warmup-text",
                        default="the quick brown fox jumps over the lazy dog")
    parser.add_argument("--precompile-buckets", default="128,512",
                        help="comma-separated phoneme buckets warmed before "
                             "ready, each at its speculative frames for a "
                             "full bucket, at batch 1 and (with dynamic "
                             "batching) at the rows of a full batch")
    parser.add_argument("--fetch-timeout", type=float, default=30.0,
                        help="deadline (seconds) of every read from the "
                             "card: a miss answers 503 with Retry-After "
                             "instead of holding the client; 0 disables")
    parser.add_argument("--queue-deadline", type=float, default=60.0,
                        help="shed queued requests older than this "
                             "(seconds) with 503 before they run; 0 "
                             "disables")
    parser.add_argument("--breaker-cooldown", type=float, default=10.0,
                        help="after a missed deadline, answer 503 at once "
                             "for this many seconds before probing the "
                             "card again")
    parser.add_argument("--rss-limit-mb", type=float, default=0.0,
                        help="recycle the worker when its resident set "
                             "exceeds this (MB): drain the requests in "
                             "flight and re-exec with the listening socket "
                             "handed across (connections wait in the "
                             "kernel's backlog meanwhile); 0 disables")
    parser.add_argument("--drain-timeout", type=float, default=120.0,
                        help="most seconds to wait for requests in flight "
                             "before a recycle re-execs anyway")
    parser.add_argument("--min-uptime", type=float, default=120.0,
                        help="seconds after the RSS watchdog arms before a "
                             "recycle may fire (and a limit at or below the "
                             "warm resident set is raised to it + 512 MB)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random init")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    add_arch_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    import torch

    from efficientspeech_tpu_torch.infer import build_synthesizer

    synth = build_synthesizer(
        preset=args.preset, checkpoint=args.checkpoint,
        hifigan_checkpoint=args.hifigan_checkpoint, seed=args.seed,
        dtype=torch.bfloat16, transfer=args.transfer,
        bench_duration_bias=None if args.checkpoint else 6.0,
        model_overrides=arch_overrides(args), device=args.device)
    # the server accepts at once: until ready, /tts and /healthz answer a
    # fast 503 with Retry-After
    state = ServeState(generation=int(os.environ.get("SERVE_GENERATION",
                                                     "0")))
    state.ready = False
    lock = threading.Lock()
    handler = make_handler(
        synth, lock=lock,
        stream_segment_phonemes=args.stream_segment_phonemes,
        dynamic_batch=args.dynamic_batch,
        batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
        fetch_timeout_s=args.fetch_timeout or None,
        queue_deadline_s=args.queue_deadline or None,
        breaker_cooldown_s=args.breaker_cooldown, state=state)
    server = make_server(args.host, args.port, handler)
    serve_argv = sys.argv[1:] if argv is None else list(argv)

    def arm_recycler():
        if args.rss_limit_mb <= 0:
            return
        RssRecycler(server, state, limit_mb=args.rss_limit_mb,
                    drain_timeout_s=args.drain_timeout,
                    min_uptime_s=args.min_uptime, device_lock=lock,
                    synth=synth,
                    exec_fn=lambda srv: reexec_with_socket(
                        srv, serve_argv)).start()
        print(f"[serve] RSS watchdog armed: limit {args.rss_limit_mb:.0f} "
              f"MB (generation {state.generation})", flush=True)

    buckets = sorted(int(x) for x in args.precompile_buckets.split(",")
                     if x)
    threading.Thread(
        target=init_and_warm, daemon=True,
        args=(synth, state, lock, args.warmup_text, buckets,
              warm_batch_sizes(args.dynamic_batch, args.max_batch)),
        kwargs={"on_ready": arm_recycler}).start()
    print(f"serving on http://{args.host}:{server.server_port} on "
          f"{synth.device}  (UI at /, /tts?text=..., /tts_stream?text=..., "
          f"/healthz, /statusz)  generation {state.generation}: 503 until "
          f"warm", flush=True)
    server.serve_forever()
    # serve_forever returns when a recycle's shutdown() fires; the
    # recycler drains the requests in flight and re-execs meanwhile
    threading.Event().wait()


if __name__ == "__main__":
    main()
