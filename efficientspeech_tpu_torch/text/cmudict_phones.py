"""The 84-symbol ARPAbet phone inventory (CMUdict phone set with stress marks).

Standard public phone set; order is alphabetical, matching the reference
vocabulary exactly so symbol IDs line up (reference: text/cmudict.py:6-91).
"""

_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
           "IH", "IY", "OW", "OY", "UH", "UW"]
_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
               "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
               "Z", "ZH"]

_stressed = []
for _v in _VOWELS:
    _stressed.extend([_v, _v + "0", _v + "1", _v + "2"])

# Alphabetical order interleaves vowel families and consonants exactly as the
# reference lists them (AA..AY2, B, CH, D, DH, EH..ER2, EY.., F, G, HH, ...).
ARPABET_SYMBOLS = sorted(_stressed + _CONSONANTS)

ARPABET_SET = frozenset(ARPABET_SYMBOLS)
VOWEL_PHONES = frozenset(_VOWELS)
