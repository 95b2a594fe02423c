"""Readings of the port's own span recorder
(``efficientspeech_tpu_torch.utils.spans``), taken in the run's process
once its window has ended: the records and counters of the newest
synthesizer only, so that runs made one after another in one process do
not mix.  A program without the recorder gives no reading."""

import collections
import statistics
from typing import Iterable, Optional


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from efficientspeech_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.RECORDER


def _newest(m):
    rec = recorder() if m.get("trace") else None
    if rec is None or rec.newest_synth is None:
        return None, None
    return rec, rec.newest_synth


def call_share(m, parts: Iterable[str],
               call: str = "tts_batch") -> Optional[float]:
    """The median over the newest synthesizer's ``call`` spans of the
    time its ``parts`` spans took (those that carry the call's id) over
    the call's, in %."""
    rec, synth = _newest(m)
    if rec is None:
        return None
    parts = set(parts)
    recs = rec.records(synth)
    calls = {r.ids["call"]: r.end_ns - r.start_ns
             for r in recs if r.name == call}
    spent = collections.defaultdict(int)
    for r in recs:
        if r.name in parts and r.ids.get("call") in calls:
            spent[r.ids["call"]] += r.end_ns - r.start_ns
    shares = [100.0 * spent[c] / d for c, d in calls.items() if d > 0]
    return statistics.median(shares) if shares else None


def median_ms(m, name: str) -> Optional[float]:
    """The median of the newest synthesizer's ``name`` spans, in ms."""
    rec, synth = _newest(m)
    if rec is None:
        return None
    ds = [r.end_ns - r.start_ns for r in rec.records(synth)
          if r.name == name]
    return statistics.median(ds) / 1e6 if ds else None


def counter_ratio(m, num: str, den: str) -> Optional[float]:
    """The newest synthesizer's counter ``num`` over its counter
    ``den``."""
    rec, synth = _newest(m)
    if rec is None:
        return None
    c = rec.counters(synth)
    return c[num] / c[den] if c.get(den) else None
