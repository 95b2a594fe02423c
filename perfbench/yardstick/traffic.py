"""The one traffic generator: texts of exact phoneme counts built from
lexicon words, drawn from a seed.

Every seed gets the same multiset of lengths (evenly spaced quantiles of
the mix's range) in its own order, with its own words: a seed changes
what is said and in which order, never how much work there is.
"""

import os
import re
from typing import Dict, List

import numpy as np

from perfbench.reference.frontend import read_lexicon

# words whose reading the measured frontend resolves from their
# neighbours (stress-shifting and other homographs): left out, so that a
# word's phones are its first lexicon entry
HOMOGRAPHS = frozenset(
    "record present object produce content desert contract permit conduct "
    "conflict protest suspect increase decrease insult project convert "
    "contrast rebel refuse read live wind tear close use lead bass".split())

PUNCTUATION = (", ", ". ")


def quantile_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` lengths evenly spaced over [lo, hi] (each quantile's middle),
    the same for every seed."""
    q = (np.arange(n) + 0.5) / n
    return np.round(lo + q * (hi - lo)).astype(np.int64)


class TextMaker:
    """Texts of exactly ``n`` phonemes: lexicon words of letters only,
    homographs left out, with a sentence mark (one pause phoneme) before
    about one word in ``pause_every``."""

    def __init__(self, lexicon_path: str, pause_every: int = 8):
        lex = read_lexicon(lexicon_path)
        self.words = [w for w in sorted(lex) if re.fullmatch(r"[a-z]+", w)
                      and w not in HOMOGRAPHS]
        self.plen = np.asarray([len(lex[w]) for w in self.words])
        self.by_len: Dict[int, List[str]] = {}
        for w, k in zip(self.words, self.plen):
            self.by_len.setdefault(int(k), []).append(w)
        self.pause_every = pause_every

    def _exact(self, rng, left: int) -> List[str]:
        """Words of exactly ``left`` phonemes in all (one or two)."""
        if left in self.by_len:
            ws = self.by_len[left]
            return [ws[int(rng.integers(len(ws)))]]
        a = max(k for k in self.by_len if k < left)
        return self._exact(rng, a) + self._exact(rng, left - a)

    def text(self, rng: np.random.Generator, n: int) -> str:
        m = n // 2 + 4
        idx = rng.integers(len(self.words), size=m)
        pause = rng.integers(self.pause_every, size=m) == 0
        pause[0] = False
        cost = np.cumsum(self.plen[idx] + pause)
        # whole words while at least 4 phonemes stay for the last ones
        take = int(np.searchsorted(cost, n - 4, side="right"))
        left = n - (int(cost[take - 1]) if take else 0)
        parts = []
        for i in range(take):
            if pause[i]:
                parts.append(PUNCTUATION[int(rng.integers(2))].rstrip())
            parts.append(" " + self.words[idx[i]])
        parts += [" " + w for w in self._exact(rng, left)]
        return "".join(parts).strip().capitalize() + "."


def lexicon_path(root: str, mix: Dict) -> str:
    return os.path.join(root, mix.get("lexicon", "lexicon/builtin-en.txt"))
