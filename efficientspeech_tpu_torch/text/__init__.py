"""Tokenizer: text (with ``{ARPAbet}`` escapes) ↔ symbol ID sequences.

Behavior-compatible with the reference tokenizer
(reference: text/__init__.py:15-75): curly-brace spans are ARPAbet phones,
everything else is cleaned character text; ``_`` and ``~`` are dropped.
"""

import re
from typing import Iterable, List, Sequence

from efficientspeech_tpu_torch.text import cleaners as _cleaners_mod
from efficientspeech_tpu_torch.text.symbols import symbols, symbols_tagalog

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}


def enable_tagalog_symbols() -> int:
    """Activate the Tagalog phone inventory (appended AFTER the default
    set — existing IDs unchanged, so English checkpoints stay valid).

    The reference ships these phones commented out of its symbol table
    (reference: text/symbols.py:28), which makes its ``t1`` inference
    path drop every lexicon phone at tokenization; this opt-in repairs
    that.  Returns the extended vocab size (embedding rows).
    """
    for i, s in enumerate(symbols_tagalog):
        _symbol_to_id.setdefault(s, i)
        _id_to_symbol.setdefault(i, s)
    return len(symbols_tagalog) + 1


def disable_tagalog_symbols() -> None:
    """Restore the default (English) symbol table — the inverse of
    enable_tagalog_symbols, for process-level isolation (tests, or a
    server switching served languages)."""
    _symbol_to_id.clear()
    _symbol_to_id.update({s: i for i, s in enumerate(symbols)})
    _id_to_symbol.clear()
    _id_to_symbol.update({i: s for i, s in enumerate(symbols)})

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text: str, cleaner_names: Iterable[str]) -> List[int]:
    """Convert text to a list of symbol IDs.

    ARPAbet sequences can be embedded in curly braces:
    ``"Turn left on {HH AW1 S S T AH0 N} Street."``
    """
    sequence: List[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Inverse mapping; ARPAbet phones are re-wrapped in curly braces."""
    result = ""
    for symbol_id in sequence:
        if symbol_id in _id_to_symbol:
            s = _id_to_symbol[symbol_id]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def _clean_text(text: str, cleaner_names: Iterable[str]) -> str:
    for name in cleaner_names:
        cleaner = _cleaners_mod.CLEANERS.get(name)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms: Iterable[str]) -> List[int]:
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s: str) -> bool:
    return s in _symbol_to_id and s != "_" and s != "~"
