"""Minimal Praat TextGrid reader (long text format); a copy of the JAX
package's ``data/textgrid.py``.

Replaces the reference's ``tgt`` dependency (reference:
preprocessor/preprocessor.py:163).  Only IntervalTiers are needed — the
Montreal Forced Aligner emits "words" and "phones" tiers.
"""

import re
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


_ITEM_RE = re.compile(r'item\s*\[\d+\]\s*:')
_CLASS_RE = re.compile(r'class\s*=\s*"([^"]*)"')
_NAME_RE = re.compile(r'name\s*=\s*"([^"]*)"')
_XMIN_RE = re.compile(r'xmin\s*=\s*([\d.eE+-]+)')
_XMAX_RE = re.compile(r'xmax\s*=\s*([\d.eE+-]+)')
_TEXT_RE = re.compile(r'text\s*=\s*"((?:[^"]|"")*)"')
_INTERVAL_RE = re.compile(r'intervals\s*\[\d+\]\s*:')


def read_textgrid(path: str) -> Dict[str, List[Interval]]:
    """Parse a long-format TextGrid → {tier_name: [Interval, ...]}."""
    with open(path, encoding="utf-8") as f:
        content = f.read()

    tiers: Dict[str, List[Interval]] = {}
    item_spans = [m.start() for m in _ITEM_RE.finditer(content)]
    item_spans.append(len(content))
    for a, b in zip(item_spans[:-1], item_spans[1:]):
        block = content[a:b]
        cls = _CLASS_RE.search(block)
        name = _NAME_RE.search(block)
        if not cls or not name or cls.group(1) != "IntervalTier":
            continue
        intervals: List[Interval] = []
        parts = [m.start() for m in _INTERVAL_RE.finditer(block)]
        parts.append(len(block))
        for ia, ib in zip(parts[:-1], parts[1:]):
            chunk = block[ia:ib]
            xmin = _XMIN_RE.search(chunk)
            xmax = _XMAX_RE.search(chunk)
            text = _TEXT_RE.search(chunk)
            if xmin and xmax and text is not None:
                intervals.append(Interval(
                    float(xmin.group(1)), float(xmax.group(1)),
                    text.group(1).replace('""', '"')))
        tiers[name.group(1)] = intervals
    return tiers
