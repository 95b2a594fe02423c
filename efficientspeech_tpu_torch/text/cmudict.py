"""CMU Pronouncing Dictionary file parser (reference: text/cmudict.py:96-140).

Thin wrapper for word → ARPAbet pronunciations; usable as the lexicon source
for the G2P front door.
"""

import re
from typing import Dict, List, Optional

from efficientspeech_tpu_torch.text.cmudict_phones import ARPABET_SET

_alt_re = re.compile(r"\([0-9]+\)")


def _parse_entry(line: str):
    if len(line) and (line[0].isalpha() or line[0] == "'"):
        parts = line.split("  ")
        if len(parts) != 2:
            return None
        word = re.sub(_alt_re, "", parts[0])
        pron = parts[1].strip()
        phones = pron.split(" ")
        if all(p in ARPABET_SET for p in phones):
            return word, pron
    return None


class CMUDict:
    """word → list of space-joined pronunciations."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = self._parse(f)
        else:
            entries = self._parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries: Dict[str, List[str]] = entries

    @staticmethod
    def _parse(f) -> Dict[str, List[str]]:
        entries: Dict[str, List[str]] = {}
        for line in f:
            parsed = _parse_entry(line)
            if parsed is None:
                continue
            word, pron = parsed
            entries.setdefault(word.upper(), []).append(pron)
        return entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())

    def as_lexicon(self) -> Dict[str, List[str]]:
        """First pronunciation per word, split to phone lists (the format
        ``text2phoneme`` consumes)."""
        return {w.lower(): p[0].split(" ") for w, p in self._entries.items()}
