"""Text → phoneme ids for texts made of lexicon words and sentence
punctuation: each word's first lexicon entry, one ``sp`` for each
punctuation mark inside the text, nothing for spaces, trailing
punctuation dropped; ids from the 152-symbol table of the published
EfficientSpeech (pad, specials, punctuation, letters, 84 ``@``-prefixed
ARPAbet phones, silences)."""

import re
import string
from typing import Dict, List

import numpy as np

_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
           "OW", "OY", "UH", "UW"]
_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
               "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
               "Z", "ZH"]
ARPABET = sorted([v + s for v in _VOWELS for s in ("", "0", "1", "2")]
                 + _CONSONANTS)
SYMBOLS = (["_"] + list("-/") + list("!'(),.:;? ")
           + list(string.ascii_uppercase + string.ascii_lowercase)
           + ["@" + p for p in ARPABET] + ["@sp", "@spn", "@sil"])
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}
SENTENCE_MARKS = ",;.-?!"


def read_lexicon(path: str) -> Dict[str, List[str]]:
    """word (lower case) → its first entry's phones."""
    lex: Dict[str, List[str]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            word, *phones = re.split(r"\s+", line.strip("\n"))
            lex.setdefault(word.lower(), phones)
    return lex


def phoneme_ids(lexicon: Dict[str, List[str]], text: str) -> np.ndarray:
    phones: List[str] = []
    for tok in re.split(r"([,;.\-\?\!\s+])", text.rstrip(string.punctuation)):
        if tok.lower() in lexicon:
            phones += lexicon[tok.lower()]
        elif tok and tok in SENTENCE_MARKS:
            phones.append("sp")
        elif tok.strip():
            raise ValueError(f"{tok!r} is not in the lexicon")
    return np.asarray([SYMBOL_ID["@" + p] for p in phones], np.int64)
