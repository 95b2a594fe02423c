"""Text cleaners (reference: text/cleaners.py:70-92).

``english_cleaners`` = ASCII transliteration + lowercase + number expansion +
abbreviation expansion + whitespace collapse.  The ASCII transliteration is a
self-contained fold table (the ``unidecode`` package is not a dependency);
it covers Latin-1/Latin Extended letters and typographic punctuation, which
is what LJSpeech-style corpora contain.
"""

import re
import unicodedata

from efficientspeech_tpu_torch.text.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

# (regex, replacement) abbreviation pairs (reference: text/cleaners.py:23-42)
_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

# Typographic characters that NFKD does not fold to the ASCII we want.
_CHAR_FOLD = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "-", "―": "-", "−": "-",
    "…": "...",
    " ": " ", " ": " ", " ": " ", " ": " ", " ": " ",
    "«": '"', "»": '"', "‹": "'", "›": "'",
    "×": "x", "÷": "/",
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ß": "ss", "þ": "th", "Þ": "Th",
    "ð": "d", "Ð": "D", "ł": "l", "Ł": "L",
    "ø": "o", "Ø": "O", "đ": "d", "Đ": "D",
}


def convert_to_ascii(text: str) -> str:
    """Transliterate to ASCII: fold table + Unicode NFKD accent stripping."""
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _CHAR_FOLD:
            out.append(_CHAR_FOLD[ch])
            continue
        decomp = unicodedata.normalize("NFKD", ch)
        ascii_part = decomp.encode("ascii", "ignore").decode("ascii")
        out.append(ascii_part)
    return "".join(out)


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text: str) -> str:
    """Full English pipeline including number/abbreviation expansion."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text


CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
}
