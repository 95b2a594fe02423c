"""Tagalog phone inventory for the ``isip`` Filipino dataset.

Kept out of the default symbol set, same as the reference
(reference: text/tagdict.py:6-54, text/symbols.py:28).
"""

TAGALOG_SYMBOLS = [
    "I", "a", "ae", "ang", "ao", "aw", "ay", "b", "c", "ch", "d", "dh",
    "e", "er", "ey", "f", "g", "h", "i", "iw", "iy", "j", "jh", "k", "l",
    "ly", "m", "n", "ng", "ny", "o", "ow", "oy", "p", "q", "r", "s", "sh",
    "t", "th", "u", "uh", "uy", "v", "w", "y", "z",
]

TAGALOG_SET = frozenset(TAGALOG_SYMBOLS)
