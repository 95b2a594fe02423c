"""The port's span recorder: named host phases, stamped on the clock that
``torch.profiler`` stamps its events in.

One recorder per process (``RECORDER``), always on.  ``span(name,
**ids)`` is a context manager that records ``(seq, name, start_ns,
end_ns, thread, parent, ids)`` into a ring of the last ``RING`` records;
the parent is the enclosing span on the same thread, whose ids the span
inherits.  While it runs, a running ``torch.profiler`` sees it as a host
op of that name (``_RecordFunctionFast``: not a user annotation, so a
trace reader that skips annotations still names the host's time by it).
``record`` adds a span whose ends were stamped on different threads (a
request's wait in a queue), ``count`` keeps integer counters, and
``snapshot`` sums both up per name.

Stamps are ``time.time_ns()``: Unix-epoch nanoseconds, the clock of the
profiler's events, so a span lines up with the kernels of a device trace.
A span costs a microsecond or two with no profiler running.

    with span("tts_batch", synth=3, call=7):
        with span("tts_batch.frontend"):   # ids {"synth": 3, "call": 7}
            ...
"""

import collections
import functools
import itertools
import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional

try:
    from torch._C._profiler import _RecordFunctionFast
    from torch.autograd import profiler as _profiler
    _profiler._is_profiler_enabled  # the flag a running profiler sets
except (ImportError, AttributeError):  # records only, no profiler range
    _RecordFunctionFast = None

RING = 1 << 16
_now = time.time_ns
_thread = threading.get_ident


class Record(NamedTuple):
    seq: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    ids: Dict


def _merged(inherited: Optional[Dict], own: Dict) -> Dict:
    return {**inherited, **own} if inherited and own else (
        inherited or own)


class Span:
    """An open span (what ``with span(...) as s`` binds); ``start_ns``,
    ``end_ns`` and ``secs`` read its stamps once it has started and
    ended, ``ids`` its ids with those it inherits."""

    __slots__ = ("_rec", "_stack", "_range", "_inherited", "_ids", "name",
                 "own", "seq", "parent", "start_ns", "end_ns")

    def __init__(self, rec: "Recorder", name: str,
                 parent: Optional["Span"] = None, **ids):
        self._rec = rec
        self.name = name
        self.own = ids
        self.parent = parent
        self._ids = None

    def __enter__(self) -> "Span":
        rec = self._rec
        try:
            stack = rec._local.stack
        except AttributeError:
            stack = rec._local.stack = []
        self._stack = stack
        up = self.parent
        if up is None and stack:
            up = self.parent = stack[-1]
        # the parent's ids, merged with this span's own only when read:
        # a row of the vocoder's loop costs no dict
        self._inherited = None if up is None else (up._ids or up.ids)
        self.seq = next(rec._seq)
        stack.append(self)
        # a range only while a profiler runs: it costs a fifth of a span
        if (_RecordFunctionFast is not None
                and _profiler._is_profiler_enabled):
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start_ns = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self.end_ns = _now()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._stack.pop()
        up = self.parent
        self._rec._ring.append((self.seq, self.name, self.start_ns, end,
                                _thread(), None if up is None else up.seq,
                                self._inherited, self.own))
        return False

    @property
    def ids(self) -> Dict:
        if self._ids is None:
            self._ids = _merged(self._inherited, self.own)
        return self._ids

    @property
    def secs(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _rank(sorted_ns: List[int], q: float) -> int:
    """The nearest-rank ``q`` quantile of a sorted list."""
    return sorted_ns[max(0, math.ceil(len(sorted_ns) * q) - 1)]


class Recorder:
    """Spans and counters of one process (see the module's docstring)."""

    def __init__(self, ring: int = RING):
        self._ring = collections.deque(maxlen=ring)
        self._seq = itertools.count()
        self._local = threading.local()
        self._counts: Dict = {}
        self._lock = threading.Lock()
        self._synths = itertools.count(1)
        self.newest_synth = None
        # ``span(name, parent=None, **ids)``: a context manager recording
        # ``name`` with ``ids`` and those of its parent, the enclosing
        # span on this thread or ``parent``, an open span of another
        # thread that this one works for
        self.span = functools.partial(Span, self)

    def current(self) -> Optional[Span]:
        """The innermost open span of this thread."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def record(self, name: str, start_ns: int, end_ns: int, **ids):
        """A span stamped elsewhere: its ends may fall on two threads."""
        self._ring.append((next(self._seq), name, int(start_ns), int(end_ns),
                           threading.get_ident(), None, None, ids))

    def count(self, name: str, n: int = 1, synth=None):
        """Add ``n`` to the counter ``name`` of ``synth`` (by default the
        synthesizer of the enclosing span)."""
        if synth is None:
            top = self.current()
            synth = None if top is None else top.ids.get("synth")
        with self._lock:
            key = (name, synth)
            self._counts[key] = self._counts.get(key, 0) + n

    def new_synth(self) -> int:
        """A synthesizer's id (a sequence number): spans carry it as the
        id ``synth``, and it becomes ``newest_synth``."""
        self.newest_synth = next(self._synths)
        return self.newest_synth

    def records(self, synth=None) -> List[Record]:
        """The ring, oldest first (those of one synthesizer's id, where
        given)."""
        # one C call, which no other thread's append can interleave
        out = [Record(*r[:6], _merged(r[6], r[7])) for r in list(self._ring)]
        if synth is not None:
            out = [r for r in out if r.ids.get("synth") == synth]
        return out

    def counters(self, synth=None) -> Dict[str, int]:
        """Counters by name, summed over synthesizers unless one is
        given."""
        out: Dict[str, int] = {}
        with self._lock:
            for (name, s), n in self._counts.items():
                if synth is None or s == synth:
                    out[name] = out.get(name, 0) + n
        return out

    def snapshot(self, synth=None) -> Dict:
        """Per span name over the ring: count, total, self time (the
        duration less what its child spans cover), p50 and p95, in ms;
        and the counters."""
        recs = self.records(synth)
        child_ns: Dict[int, int] = collections.defaultdict(int)
        for r in recs:
            if r.parent is not None:
                child_ns[r.parent] += r.end_ns - r.start_ns
        by_name = collections.defaultdict(list)
        own = collections.defaultdict(int)
        for r in recs:
            d = r.end_ns - r.start_ns
            by_name[r.name].append(d)
            own[r.name] += max(0, d - child_ns.get(r.seq, 0))
        spans = {}
        for name, ds in sorted(by_name.items()):
            ds.sort()
            spans[name] = {"count": len(ds), "total_ms": sum(ds) / 1e6,
                           "self_ms": own[name] / 1e6,
                           "p50_ms": _rank(ds, 0.5) / 1e6,
                           "p95_ms": _rank(ds, 0.95) / 1e6}
        return {"spans": spans, "counters": self.counters(synth)}


RECORDER = Recorder()
span = RECORDER.span
current = RECORDER.current
record = RECORDER.record
count = RECORDER.count
new_synth = RECORDER.new_synth
records = RECORDER.records
counters = RECORDER.counters
snapshot = RECORDER.snapshot
