"""Grapheme-to-phoneme front door for inference.

Pipeline mirrors the reference (reference: synthesize.py:19-64): word-level
lexicon lookup first, then a fallback for out-of-vocabulary words.  The
reference falls back to the ``g2p_en`` neural G2P; that package is optional
here — when absent, a self-contained rule-based letter-to-sound fallback is
used (documented approximation: lexicon entries cover the vast majority of
running words).  For the Tagalog ``t1`` language, OOV words go through a
rule G2P over the isip phone inventory (text/tagalog_g2p.py) — the
reference falls back to raw characters (reference: synthesize.py:44-45)
which its shipped symbol table then drops at tokenization.
"""

import os
import re
from string import punctuation
from typing import Dict, List

import numpy as np

from efficientspeech_tpu_torch.text import text_to_sequence


def read_lexicon(lex_path: str) -> Dict[str, List[str]]:
    """word → phone list; first entry wins (reference: synthesize.py:19-28)."""
    lexicon: Dict[str, List[str]] = {}
    with open(lex_path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            temp = re.split(r"\s+", line.strip("\n"))
            word = temp[0]
            phones = temp[1:]
            if word.lower() not in lexicon:
                lexicon[word.lower()] = phones
    return lexicon


# --- rule-based letter-to-sound fallback -----------------------------------
# A pragmatic English L2S: suffix rules, digraphs, magic-e, open-syllable
# long vowels, then letter defaults.  Only used for words missing from the
# lexicon.  Measured by tests/test_g2p_per.py on TWO sets: the tuned-on
# dev set (tests/data/g2p_dev.tsv — retention only) and the blind
# generalization set (tests/data/g2p_blind.tsv — disjoint from the
# lexicon and the dev set, measured once); numbers in STATUS.md.

# suffixes replaced wholesale (stem recursion); longest match first
_SUFFIXES = [
    ("ention", ["EH1", "N", "SH", "AH0", "N"]),
    ("ission", ["IH1", "SH", "AH0", "N"]),
    ("ession", ["EH1", "SH", "AH0", "N"]),
    ("ition", ["IH1", "SH", "AH0", "N"]),
    ("ation", ["EY1", "SH", "AH0", "N"]),
    ("ision", ["IH1", "ZH", "AH0", "N"]),
    ("cious", ["SH", "AH0", "S"]),
    ("tious", ["SH", "AH0", "S"]),
    ("ssion", ["SH", "AH0", "N"]),
    ("tion", ["SH", "AH0", "N"]),
    ("sion", ["ZH", "AH0", "N"]),
    ("cial", ["SH", "AH0", "L"]),
    ("tial", ["SH", "AH0", "L"]),
    ("cian", ["SH", "AH0", "N"]),
    ("ture", ["CH", "ER0"]),
    ("sure", ["ZH", "ER0"]),
    ("able", ["AH0", "B", "AH0", "L"]),
    ("less", ["L", "AH0", "S"]),
    ("ful", ["F", "AH0", "L"]),
    ("ness", ["N", "AH0", "S"]),
    ("ment", ["M", "AH0", "N", "T"]),
    ("ough", ["AO1"]),
    ("ous", ["AH0", "S"]),
    ("ing", ["IH0", "NG"]),
    ("ly", ["L", "IY0"]),
]
# shun-type suffixes attract stress to the syllable BEFORE them, keeping a
# stem-final open vowel long (oc-CA-sion, gra-cious); other suffixes leave
# a post-stress stem-final a/o reduced (SIG-na-ture)
_STRESS_ATTRACTING = frozenset({
    "tion", "sion", "ssion", "cian", "cial", "tial", "cious", "tious",
    "ission", "ession", "ation", "ision",
})

# minimum STEM length for each generic suffix (protects monosyllables like
# "ring", "bed", "ten" whose ending is part of the root)
_SUFFIX_MIN_STEM = {"ing": 3, "ly": 3, "ous": 3, "ness": 3, "ment": 2,
                    "less": 3, "ful": 3,
                    "able": 2, "en": 4, "et": 4, "ed": 3, "le": 3}

_DIGRAPHS = [
    ("eigh", ["EY1"]), ("iew", ["Y", "UW1"]), ("olk", ["OW1", "K"]),
    ("tch", ["CH"]), ("cch", ["K"]), ("igh", ["AY1"]), ("alk", ["AO1", "K"]),
    ("olt", ["OW1", "L", "T"]),
    ("ook", ["UH1", "K"]), ("ange", ["EY1", "N", "JH"]),
    ("air", ["EH1", "R"]),
    ("oar", ["AO1", "R"]),
    ("cei", ["S", "IY1"]), ("eiz", ["IY1", "Z"]),
    ("eism", ["AY1", "Z", "M"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("eer", ["IH1", "R"]),
    ("oo", ["UW1"]), ("ee", ["IY1"]), ("ea", ["IY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ou", ["AW1"]), ("ow", ["AW1"]),
    ("ong", ["AO1", "NG"]), ("old", ["OW1", "L", "D"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ar", ["AA1", "R"]), ("or", ["AO1", "R"]), ("ir", ["ER1"]),
    ("ur", ["ER1"]), ("er", ["ER0"]), ("kn", ["N"]), ("wr", ["R"]),
    ("gh", []),
]

_SHORT_VOWELS = {"a": "AE1", "e": "EH1", "i": "IH1", "o": "AA1", "u": "AH1", "y": "IH1"}
_LONG_VOWELS = {"a": "EY1", "e": "IY1", "i": "AY1", "o": "OW1", "u": "UW1", "y": "AY1"}
_CONSONANTS = {
    "b": "B", "d": "D", "f": "F", "g": "G", "h": "HH", "j": "JH", "k": "K",
    "l": "L", "m": "M", "n": "N", "p": "P", "r": "R", "s": "S", "t": "T",
    "v": "V", "w": "W", "x": "K S", "z": "Z",
    # bare q (not followed by u — Iraq, FAQ word-read): /k/, so word-read
    # fallbacks never silently drop the letter (the qu digraph wins first)
    "q": "K",
}
_VOWEL_LETTERS = set("aeiouy")
_VOICELESS = {"P", "K", "F", "TH", "S", "SH", "CH"}


def _collapse_doubles(word: str) -> str:
    """Doubled consonant letters are one phone (pillow → pilow); doubled
    vowels (ee/oo) are digraphs and stay."""
    out = []
    for c in word:
        if out and out[-1] == c and c not in "aeiou":
            continue
        out.append(c)
    return "".join(out)


_VOWEL_PHONES = ("AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
                 "IH", "IY", "OW", "OY", "UH", "UW")


def _has_vowel(phones: List[str]) -> bool:
    return any(p.rstrip("012") in _VOWEL_PHONES for p in phones)


def _demote_stress(phones: List[str]) -> List[str]:
    return [p.replace("1", "0") if p.endswith("1") else p for p in phones]


def _pretonic(phones: List[str]) -> List[str]:
    """Demote + reduce the syllables before a stress-bearing tail.
    English pretonic reduction is positional, not uniform:

    - with 2+ pretonic syllables the FIRST keeps its quality under
      secondary stress (DEmo+cratic, AFter+noon — alternating rhythm);
    - a vowel in hiatus with the stressed syllable keeps its quality
      (zo+ology, po+etic);
    - a closed syllable keeps its quality (cap+tivity, nos+talgic) —
      but a stop+liquid pair is the next syllable's onset cluster, not
      a coda (demo+cratic reduces);
    - otherwise the low/central vowels centralize to /ə/ (phot+ography,
      dram+atic), word-initial e-/i- reduce to /ɪ/ (ecology, eviction),
      and the high/back/r-colored nuclei keep quality with 0 stress
      (ge+ology /iː/, bru+tality /uː/, car+toon, ro+botic, au+thentic).
    """
    vidx = [j for j, p in enumerate(phones) if p[-1:].isdigit()]
    out = list(phones)
    for k, j in enumerate(vidx):
        base = phones[j][:-1]
        nxt_v = vidx[k + 1] if k + 1 < len(vidx) else len(phones)
        coda = phones[j + 1: nxt_v]
        nxt_r = bool(coda) and coda[0] == "R"
        if k == 0 and len(vidx) >= 2:
            out[j] = base + "2"
        elif not coda and k == len(vidx) - 1:
            out[j] = base + "0"
        elif len(coda) >= 2 and coda[-1] not in ("R", "L"):
            out[j] = base + "0"
        elif base in ("EH", "IY") and j == 0:
            out[j] = "IH0"
        elif base in ("AA", "AE", "EY", "AH", "EH", "OW") \
                and len(coda) == 1 and coda[0] == "R":
            # the r is the NEXT syllable's onset: the pretonic vowel
            # folds into /ɚ/ (go+rilla, mo+rose, to+rero, pa+rade)
            out[j] = "ER0"
            out[j + 1] = ""
        elif base in ("AA", "AE", "EY", "AH", "EH", "OW") \
                and not (base == "AA" and nxt_r):
            out[j] = "AH0"
        else:
            out[j] = base + "0"
    return [p for p in out if p]


def _stress_last(phones: List[str]) -> List[str]:
    """Primary stress on the LAST syllable, earlier syllables
    pretonic-reduced — the shape a stress-attracting suffix leaves the
    stem in (ad-HE-sive, ex-PAN-sion, ad-DIC-tion).  The last vowel is
    promoted even if the letterwise pass left it unstressed (the
    ad-dic fragment reads as an -ic word)."""
    vs = [j for j, p in enumerate(phones) if p[-1:].isdigit()]
    if len(vs) < 2:
        return phones
    last = vs[-1]
    return (_pretonic(phones[:last])
            + [phones[last].rstrip("012") + "1"]
            + phones[last + 1:])


def normalize_stress(phones: List[str]) -> List[str]:
    """At most ONE primary stress: the first '1' stays primary, later '1's
    become secondary '2' (English default: initial stress; stress-bearing
    suffixes demote the stem before this runs)."""
    out, seen = [], False
    for p in phones:
        if p.endswith("1"):
            if seen:
                p = p[:-1] + "2"
            seen = True
        out.append(p)
    return out


def rule_g2p(word: str) -> List[str]:
    """Heuristic English letter-to-sound; returns ARPAbet phones."""
    return _reduce_posttonic(normalize_stress(_rule_g2p(word)))


def _reduce_posttonic(phones: List[str]) -> List[str]:
    """In a 3+-syllable word with initial primary stress, the vowel right
    after the stressed syllable REDUCES (telescope, victory, oxygen,
    saxophone) — the letterwise evaluation leaves it full.  Before R the
    reduction is the r-colored schwa (victory → /ɚ/, generous)."""
    vidx = [i for i, p in enumerate(phones) if p[-1:].isdigit()]
    if len(vidx) < 3:
        return phones
    v0, v1 = vidx[0], vidx[1]
    if not phones[v0].endswith("1") or not phones[v1].endswith("2"):
        return phones
    out = list(phones)
    if v1 + 1 < len(out) and out[v1 + 1] == "R":
        out[v1: v1 + 2] = ["ER0"]
    else:
        # the reduced medial vowel is the plain schwa (majesty, skeleton,
        # luminous, oxygen — CMUdict AH0), not barred-i
        out[v1] = "AH0"
    return out


def _vowel_group_count(word: str) -> int:
    n = 0
    prev = False
    for ch in word:
        v = ch in _VOWEL_LETTERS
        if v and not prev:
            n += 1
        prev = v
    return n


def _restore_e(stem_word: str) -> str:
    """The silent e dropped before a vowel-initial suffix, restored by
    the doubling convention: a MONOSYLLABIC stem ending in one vowel
    letter + one consonant had a silent e (quake+d, wade+ing, zone+ing);
    a doubled consonant signals the short vowel (hopped, sitting), and
    multi-group stems (visit+ed, rain+ed) never dropped one."""
    if stem_word.endswith("dg"):
        return stem_word + "e"  # dg never ends a word (trudge, judge)
    nvow = sum(ch in _VOWEL_LETTERS
               and not (ch == "u" and j > 0 and stem_word[j - 1] == "q")
               for j, ch in enumerate(stem_word))
    if (len(stem_word) >= 3
            and stem_word[-1] not in _VOWEL_LETTERS
            and stem_word[-1] not in "wxy"
            and stem_word[-2] in "aeiou"
            and nvow == 1):  # the u of qu is not a syllable (quake+d)
        return stem_word + "e"
    return ""


def _rule_g2p(word: str) -> List[str]:
    word = word.lower()
    word = "".join(c for c in word if c.isalpha() or c == "'")
    if not word:
        return []

    # the closed set of silent-h stems (hour/honor are lexicon entries;
    # this catches their derivatives and the honest/heir families)
    if word.startswith("rh"):
        # Greek rh- is plain /r/ (rhythm, rhyme, rhetoric, rhubarb)
        return _rule_g2p("r" + word[2:])
    if word.startswith("heir"):
        rest = _rule_g2p(word[4:]) if len(word) > 4 else []
        return ["EH1", "R"] + _demote_stress(rest)
    if word.startswith("honest"):
        tail = {"": [], "ly": ["L", "IY0"], "y": ["IY0"]}.get(
            word[6:], None)
        if tail is not None:
            return ["AA1", "N", "AH0", "S", "T"] + tail
    if word.startswith("hono"):
        return _rule_g2p(word[1:])
    if word.startswith("herb"):
        return ["ER1", "B"] + _demote_stress(
            _rule_g2p(word[4:]) if len(word) > 4 else [])

    # specialized shun/zhun endings — must precede the generic sion/
    # tion/sure table below, which would otherwise split them wrong
    # -nsion keeps its n in the STEM syllable (pen-, ten-, expan-) and
    # reads /ʃən/ (pension, tension, mansion, expansion)
    if word.endswith("nsion") and len(word) >= 7:
        stem = _rule_g2p(word[:-4])
        if stem and _has_vowel(stem):
            return _stress_last(stem) + ["SH", "AH0", "N"]
    # -usion/-ution: the u is /uː/ after coronals and /juː/ elsewhere
    # (inclusion, solution vs fusion, execution)
    for u_suf, u_ph in (("usion", ["ZH", "AH0", "N"]),
                        ("ution", ["SH", "AH0", "N"])):
        if word.endswith(u_suf) and len(word) > len(u_suf):
            u_stem = word[: -len(u_suf)]
            if u_stem.startswith(("con", "com")) and len(u_stem) >= 4:
                # a silent-e probe lets the con-/com- prefix rule see a
                # long-enough word (conf+usion: /kən/, not closed /kɑn/)
                head = _rule_g2p(u_stem + "e")
            else:
                head = _rule_g2p(u_stem)
            if head:
                nuc = ["UW1"] if u_stem[-1] in "lrjdtsn" \
                    else ["Y", "UW1"]
                return _pretonic(head) + nuc + u_ph
    # -osure is /oʊʒɚ/ (closure, exposure, disclosure, composure)
    if word.endswith("osure") and len(word) >= 7:
        head = _rule_g2p(word[:-5])
        if head:
            return _pretonic(head) + ["OW1", "ZH", "ER0"]

    for suffix, ph in _SUFFIXES:
        min_stem = _SUFFIX_MIN_STEM.get(suffix, 1)
        if word.endswith(suffix) and len(word) - len(suffix) >= min_stem:
            stem_word = word[: -len(suffix)]
            nvow = sum(ch in _VOWEL_LETTERS for ch in stem_word)
            stem = None
            if stem_word.endswith("i") and nvow >= 2 \
                    and suffix == "ness":
                # the i IS an inflected y and keeps its tense vowel
                # (happiness, drowsiness)
                stem = _rule_g2p(stem_word)
                if stem and stem[-1] in ("IH0", "IY1", "AY1"):
                    stem[-1] = "IY0"
            elif stem_word.endswith("i") and nvow >= 2:
                # pre-suffix i in a polysyllabic stem is LAX (musician,
                # ambitious, furniture) — not the word-final tense /iː/;
                # evaluate the whole stem (keeps mu-si open-syllable
                # structure) and lax only the final vowel phone
                stem = _rule_g2p(stem_word)
                if stem and stem[-1] in ("IY0", "IY1", "AY1"):
                    stem[-1] = "IH0"
            elif stem_word.endswith("e") and nvow == 1 \
                    and len(stem_word) >= 2 \
                    and stem_word[-2] not in _VOWEL_LETTERS \
                    and suffix[0] in "aeiou":
                # a bare-e stem before a VOWEL-initial suffix stays the
                # long open vowel in hiatus (cre+ation); before a
                # consonant-initial suffix it is lax (pre+cious)
                stem = _rule_g2p(stem_word[:-1]) + ["IY1"]
            elif suffix in ("ous", "able") and len(stem_word) >= 3 \
                    and stem_word[-1] not in _VOWEL_LETTERS \
                    and stem_word[-2] in "aeiou" \
                    and stem_word[-3] not in _VOWEL_LETTERS:
                # open-syllable juncture: evaluate the stem as if magic-e
                stem_word += "e"
            elif len(stem_word) >= 3 and stem_word[-1] in "ao" \
                    and stem_word[-2] not in _VOWEL_LETTERS:
                if nvow >= 2 and suffix not in _STRESS_ATTRACTING:
                    # post-stress a/o before a non-attracting suffix
                    # reduces (signa+ture → /ə/, not *sign-AY-ture);
                    # the plain evaluation's word-final-a schwa applies
                    stem = _rule_g2p(stem_word)
                else:
                    # stem-final a/o stays open before a stress-
                    # attracting suffix (gra-cious, oc-CA-sion): a
                    # trailing consonant+e forces the long evaluation
                    stem_word += "pe"
            if stem is None and suffix == "ing":
                # hope+ing vs hopp+ing: the undoubled single-vowel stem
                # had a silent e the INFLECTION dropped; derivational
                # suffixes must not restore (vac+ation is not vace+)
                e_form = _restore_e(stem_word)
                if e_form:
                    stem = _rule_g2p(e_form)
            if stem is None:
                stem = _rule_g2p(stem_word)
                if stem_word.endswith("pe") and not word.endswith("pe") \
                        and stem and stem[-1] == "P":
                    stem = stem[:-1]
                    if nvow >= 2 and suffix in _STRESS_ATTRACTING:
                        # stress lands on the pre-suffix syllable
                        # (oc-CA-sion): earlier vowels demote and an
                        # unstressed o reduces to schwa
                        last = max((i for i, p in enumerate(stem)
                                    if p[-1:].isdigit()), default=-1)
                        stem = [(p if i == last else
                                 "AH0" if p == "AA1" else
                                 p[:-1] + "0" if p.endswith("1") else p)
                                for i, p in enumerate(stem)]
            if stem and ph and stem[-1].rstrip("012") == ph[0].rstrip("012") \
                    and ph[0][-1:] not in "012":
                # junction degemination: a stem-final consonant merges
                # with an identical suffix-initial one (chill+ly,
                # grateful+ly — English has no geminates)
                stem = stem[:-1]
            if any(p.endswith("1") for p in ph):
                # stress-bearing suffix (-ation, -ition, ...): the suffix
                # carries primary stress, the stem demotes
                if nvow == 1 and len(stem_word) >= 2 \
                        and stem_word[-1] not in _VOWEL_LETTERS:
                    # a single-vowel stem closed by ONE consonant (or a
                    # doubled pair) re-syllabifies OPEN before the
                    # stressed suffix: a lengthens (va+cation → /eɪ/),
                    # o reduces (prof+ession, poss+ession → /ə/); a
                    # cluster coda stays closed (adm+ission keeps /æ/)
                    v = max(i for i, ch in enumerate(stem_word)
                            if ch in _VOWEL_LETTERS)
                    coda = stem_word[v + 1:]
                    if len(coda) == 1 or (len(coda) == 2
                                          and coda[0] == coda[1]):
                        # o-stems re-open LONG (lo+cation, vo+cation,
                        # do+nation) except the pro- prefix, which
                        # reduces (prof+ession)
                        o_re = "AH0" if stem_word.startswith("pro") \
                            else "OW0"
                        stem = [("EY1" if p == "AE1" else
                                 o_re if p == "AA1" else p)
                                for p in stem]
                stem = _demote_stress(stem)
                # a con-/com- prefix regains its full vowel under the
                # secondary stress a stressed suffix induces
                # (combination, compensation: /kɑm/, not /kəm/)
                if stem[:2] == ["K", "AH0"] and len(stem) > 2 \
                        and stem[2] in ("M", "N") and word[:1] == "c":
                    stem[1] = "AA2"
                # a demoted non-initial "or" syllable reduces to /ɚ/
                # (trans-por-TA-tion, infor-MA-tion); word-initial or-
                # keeps its quality under secondary stress (organization)
                red = []
                for p in stem:
                    if p == "R" and red and red[-1] == "AO0" \
                            and len(red) >= 2:
                        red[-1] = "ER0"
                        continue
                    red.append(p)
                stem = red
            elif suffix in _STRESS_ATTRACTING:
                # an UNSTRESSED shun-type suffix still attracts primary
                # stress to the syllable right before it, reducing the
                # earlier ones (ad-DIC-tion, col-LEC-tion, e-VIC-tion)
                stem = _stress_last(stem)
            return stem + ph

    # past-tense -ed: allomorph chosen by the stem's final phone (the
    # stem must keep a vowel — shred/seaweed end in ROOT -ed, and an
    # -eed tail is always the root's ee digraph: agreed, milkweed)
    if word.endswith("ed") and not word.endswith("eed") \
            and len(word) - 2 >= _SUFFIX_MIN_STEM["ed"]:
        stem_word = word[:-2]
        stem = _rule_g2p(_restore_e(stem_word) or stem_word)
        if stem and _has_vowel(stem):
            last = stem[-1]
            if last in ("T", "D"):
                return stem + ["IH0", "D"]
            return stem + (["T"] if last in _VOICELESS else ["D"])

    # unstressed word-final -ar/-or after a consonant reduce to /ɚ/ in
    # polysyllables (grammar, doctor, regular); monosyllables (car, for)
    # keep the full vowel via the ar/or digraphs
    if len(word) >= 5 and word[-2:] in ("ar", "or") \
            and word[-3] not in _VOWEL_LETTERS:
        stem_word = word[:-2]
        if any(ch in _VOWEL_LETTERS for ch in stem_word):
            if len(stem_word) >= 3 and stem_word[-2] in "aeiou" \
                    and stem_word[-1] not in _VOWEL_LETTERS \
                    and stem_word[-3] not in _VOWEL_LETTERS \
                    and sum(ch in _VOWEL_LETTERS
                            for ch in stem_word) == 1:
                # mo+tor, ra+zor: the stem syllable is OPEN — evaluate
                # as if magic-e so the vowel stays long
                stem = _rule_g2p(stem_word + "e")
            else:
                stem = _rule_g2p(stem_word)
            if stem and _has_vowel(stem):
                return stem + ["ER0"]

    # unstressed word-final -age is /ɪdʒ/ in polysyllables (village,
    # package, message); monosyllables (age, stage) keep /eɪdʒ/.  A
    # single-vowel V-C stem re-opens (plu+mage, po+stage), and -eage
    # keeps the stem's silent e (mileage)
    if len(word) >= 7 and word.endswith("eage"):
        stem = _rule_g2p(word[:-4] + "e")
        if stem and _has_vowel(stem):
            return stem + ["AH0", "JH"]
    if len(word) >= 6 and word.endswith("age") \
            and word[-4] not in _VOWEL_LETTERS:
        stem_word = word[:-3]
        e_form = _restore_e(stem_word)
        stem = _rule_g2p(e_form or stem_word)
        if stem and _has_vowel(stem):
            return stem + ["AH0", "JH"]

    # Greek/Latin stress-bearing tails: the ending carries the
    # antepenultimate stress and the stem demotes + centralizes
    # (geology, photography, thermometer, democracy, activity)
    for gk_suf, gk_ph in (
            ("ology", ["AA1", "L", "AH0", "JH", "IY0"]),
            ("ography", ["AA1", "G", "R", "AH0", "F", "IY0"]),
            ("ometer", ["AA1", "M", "AH0", "T", "ER0"]),
            ("opoly", ["AA1", "P", "AH0", "L", "IY0"]),
            ("onomy", ["AA1", "N", "AH0", "M", "IY0"]),
            ("otomy", ["AA1", "T", "AH0", "M", "IY0"]),
            ("atomy", ["AE1", "T", "AH0", "M", "IY0"]),
            ("osophy", ["AA1", "S", "AH0", "F", "IY0"]),
            ("ocracy", ["AA1", "K", "R", "AH0", "S", "IY0"]),
            ("ality", ["AE1", "L", "AH0", "T", "IY0"]),
            ("ivity", ["IH1", "V", "AH0", "T", "IY0"])):
        if word.endswith(gk_suf) and len(word) - len(gk_suf) >= 1:
            stem = _rule_g2p(word[: -len(gk_suf)])
            if stem and _has_vowel(stem):
                return _pretonic(stem) + gk_ph

    # word-final -gue: the ue is silent (plague, league, fatigue, vogue)
    for gue_suf, gue_ph in (("ague", ["EY1", "G"]),
                            ("eague", ["IY1", "G"]),
                            ("igue", ["IY1", "G"]),
                            ("ogue", ["OW1", "G"])):
        if word.endswith(gue_suf):
            head = word[: -len(gue_suf)]
            if head and all(ch not in "aeiou" for ch in head[-1:]):
                head_ph = _rule_g2p(head) if head else []
                if gue_suf == "ogue" and _has_vowel(head_ph):
                    # polysyllabic -ogue darkens (epilogue, catalogue,
                    # dialogue); monosyllables keep /oʊg/ (vogue)
                    gue_ph = ["AO2", "G"]
                return head_ph + gue_ph

    # -oon loans carry final stress (balloon, lagoon, typhoon, cartoon)
    if word.endswith("oon") and len(word) >= 6:
        head = _rule_g2p(word[:-3] + "o")  # probe keeps the syllable open
        while head and head[-1][-1:] in "012":
            head.pop()
        if head and head[-1] == "Y":
            head.pop()  # the probe vowel's yod
        if head and _has_vowel(head):
            return _pretonic(head) + ["UW1", "N"]

    # -ville/-ford place-name tails reduce (danville, hartford; afford
    # is the verb)
    if word.endswith("ville") and len(word) >= 8:
        stem = _rule_g2p(word[:-5])
        if stem and _has_vowel(stem):
            return stem + ["V", "IH0", "L"]
    if word.endswith("ford") and len(word) >= 6 and word != "afford":
        stem = _rule_g2p(word[:-4])
        if stem and _has_vowel(stem):
            return stem + ["F", "ER0", "D"]

    # plural/3sg -es after a sibilant is /ɪz/ (dashes, pouches, boxes)
    if word.endswith("es") and len(word) >= 5 \
            and (word[-4:-2] in ("sh", "ch", "ss") or word[-3] in "sxz"):
        stem = _rule_g2p(word[:-2])
        if stem and _has_vowel(stem) \
                and stem[-1] in ("S", "Z", "SH", "ZH", "CH", "JH"):
            return stem + ["IH0", "Z"]

    # -ive: the suffix vowel is /ɪ/ and the pre-suffix vowel keeps its
    # magic-e length (native, explosive, adhesive); -rive/-vive/-nive/
    # -hive roots keep /aɪv/ (arrive, survive, connive, beehive)
    if word.endswith("ative") and len(word) >= 8 \
            and word[-6] not in _VOWEL_LETTERS:
        # -ative stresses the antepenult (relative, negative, talkative)
        stem = _rule_g2p(word[:-5])
        if stem and _has_vowel(stem):
            return stem + ["AH0", "T", "IH0", "V"]
    if word.endswith("ive") and len(word) >= 6 \
            and word[-4] not in _VOWEL_LETTERS \
            and not word.endswith(("rive", "vive", "nive", "hive")):
        stem = _rule_g2p(word[:-3] + "e")
        if stem and _has_vowel(stem):
            if word[-4] == "s" and stem[-1] == "Z":
                stem[-1] = "S"  # -sive is voiceless (explosive, abusive)
            return _stress_last(stem) + ["IH0", "V"]

    # French learned endings carry final stress: -ique /iːk/
    # (boutique, critique, antique), -esque /ɛsk/ (grotesque,
    # picturesque), -ette /ɛt/ (cassette, brunette), -angue /æŋ/
    # (meringue, harangue), final -eau /oʊ/ (plateau, chateau); a bare
    # final -que is /k/ (mosque, plaque, torque)
    if word.endswith("ique") and len(word) >= 6:
        head = _rule_g2p(word[:-4])
        if head and _has_vowel(head):
            return _pretonic(head) + ["IY1", "K"]
    if word.endswith("esque") and len(word) >= 7:
        head = _rule_g2p(word[:-5])
        if head and _has_vowel(head):
            return _pretonic(head) + ["EH1", "S", "K"]
    if word.endswith("que") and len(word) >= 5:
        return _rule_g2p(word[:-3] + "k")
    for ette_suf, ette_ph in (("ettes", ["EH1", "T", "S"]),
                              ("ette", ["EH1", "T"])):
        if word.endswith(ette_suf) and len(word) - len(ette_suf) >= 2:
            head = _rule_g2p(word[: -len(ette_suf)])
            if head and _has_vowel(head):
                return _pretonic(head) + ette_ph
    if word.endswith("angue") and len(word) >= 7:
        head = _rule_g2p(word[:-5])
        if head and _has_vowel(head):
            return _pretonic(head) + ["AE1", "NG"]
    if word.endswith("eau") and len(word) >= 5:
        head = _rule_g2p(word[:-3])
        if head and _has_vowel(head):
            return _demote_stress(head) + ["OW1"]

    # -elle carries final stress (gazelle, noelle)
    if word.endswith("elle") and len(word) >= 6:
        head = _rule_g2p(word[:-4])
        if head and _has_vowel(head):
            return _pretonic(head) + ["EH1", "L"]

    # -ish verbs lax the pre-suffix vowel (banish, vanish, abolish,
    # polish) — doubling the final stem consonant closes the syllable
    if word.endswith("ish") and len(word) >= 6 \
            and word[-4] not in _VOWEL_LETTERS and word[-4] != "r":
        # r-stems keep the intervocalic-r reading (cherish, parish)
        ish_stem = word[:-3]
        if ish_stem[-2] in "aeiou":
            ish_stem += ish_stem[-1]
        stem = _rule_g2p(ish_stem)
        if stem and _has_vowel(stem):
            return stem + ["IH0", "SH"]

    # -oise nouns reduce (porpoise, tortoise)
    if word.endswith("oise") and len(word) >= 7:
        stem = _rule_g2p(word[:-4])
        if stem and _has_vowel(stem):
            return stem + ["AH0", "S"]

    # 3+-group -ier loans carry final /ɪr/ stress (brigadier,
    # cavalier, financier); 2-group comparatives (easier) stay out
    if word.endswith("ier") and _vowel_group_count(word) >= 3 \
            and word[-4] not in _VOWEL_LETTERS:
        head = _rule_g2p(word[:-3])
        if head and _has_vowel(head):
            return _pretonic(head) + ["IH1", "R"]

    # -ose adjectives carry final /oʊs/ stress (morose, verbose,
    # grandiose); the -pose verb family (suppose, propose) voices and
    # is excluded by the p-guard
    if word.endswith("ose") and len(word) >= 6 \
            and word[-4] not in _VOWEL_LETTERS and word[-4] != "p":
        head = _rule_g2p(word[:-3])
        if head and _has_vowel(head):
            return _pretonic(head) + ["OW1", "S"]

    # -acean/-cean read /ʃən/ with the a long (ocean, crustacean)
    if word.endswith("acean") and len(word) >= 7:
        head = _rule_g2p(word[:-5])
        if head and _has_vowel(head):
            return _demote_stress(head) + ["EY1", "SH", "AH0", "N"]
    if word.endswith("cean") and len(word) >= 5:
        head = _rule_g2p(word[:-4])
        if head:
            return head + ["SH", "AH0", "N"]

    # a -le verb's past keeps the stem's syllabic l (jostled, smelled)
    if word.endswith("led") and len(word) >= 5 \
            and word[-4] not in _VOWEL_LETTERS:
        stem = _rule_g2p(word[:-1])
        if stem and _has_vowel(stem):
            return stem + ["D"]

    # agentive -ator is the -ate verb + /ɚ/, stress pattern included
    # (percolator, excavator, radiator, curator, senator)
    if word.endswith("ator") and len(word) >= 7:
        stem = _rule_g2p(word[:-2] + "e")
        if stem and _has_vowel(stem):
            return stem + ["ER0"]

    # unstressed Latinate -ice in 3+-syllable words is /ɪs/
    # (apprentice, prejudice, avarice, edifice, armistice)
    if word.endswith("ice") and _vowel_group_count(word) >= 4:
        stem = _rule_g2p(word[:-3])
        if stem and _has_vowel(stem):
            return stem + ["IH0", "S"]

    # -rtain/-ntain/-ptain nouns reduce the tail (curtain, fountain,
    # captain); maintain/obtain-class verbs are lexicon entries
    if word.endswith("tain") and len(word) >= 7 \
            and (word[-5] in "rp"
                 or (word[-5] == "n" and word[-6] == "u")):
        stem = _rule_g2p(word[:-4])
        if stem and _has_vowel(stem):
            return stem + ["T", "AH0", "N"]

    # -ic/-ics/-ical/-ity stress the syllable RIGHT BEFORE the suffix
    # and lax its vowel (dramatic, kinetic, electric, audacity,
    # velocity); the pretonic syllables reduce.  Long u resists the
    # laxing (music, cubic, immunity).
    for ic_suf, ic_ph in (("ically", ["IH0", "K", "L", "IY0"]),
                          ("ical", ["IH0", "K", "AH0", "L"]),
                          ("ics", ["IH0", "K", "S"]),
                          ("ic", ["IH0", "K"]),
                          ("ities", ["AH0", "T", "IY0", "Z"]),
                          ("ity", ["AH0", "T", "IY0"])):
        if word.endswith(ic_suf) and len(word) - len(ic_suf) >= 3:
            base = word[: -len(ic_suf)]
            vs = [j for j, ch in enumerate(base) if ch in _VOWEL_LETTERS]
            if not vs:
                break
            v = vs[-1]
            head, coda = base[:v], base[v + 1:]
            if base[v] == "u":
                nucleus = ["Y", "UW1"] if not head \
                    or head[-1] not in "lrjdtsn" else ["UW1"]
            elif base[v] == "a" and (head.endswith("qu")
                                     or head.endswith("w")):
                nucleus = ["AA1"]  # qua-/wa- darkening (aquatic)
            elif not coda:
                # nucleus in hiatus with the suffix stays long
                # (heroic, stoic)
                nucleus = [_LONG_VOWELS[base[v]]]
            else:
                nucleus = [_SHORT_VOWELS[base[v]]]
            if coda.startswith("r") and len(coda) >= 2 \
                    and base[v] in "eiu":
                nucleus = ["ER1"]  # al-LER-gic, not EH+R
                coda = coda[1:]
            head_ph = []
            if head:
                if head[-1] in "cg" and base[v] in "eiy":
                    # the head-final consonant softens before the
                    # nucleus (angelic /dʒ/, necessity /s/, magic)
                    head_ph = _rule_g2p(head[:-1])
                    soft = "S" if head[-1] == "c" else "JH"
                    if not (soft == "S" and head_ph
                            and head_ph[-1] == "S"):
                        head_ph = head_ph + [soft]
                elif head[-1] == "i" or (
                        len(head) >= 2 and head[-1] not in _VOWEL_LETTERS
                        and head[-2] == "i"):
                    # pre-pretonic i is usually reduced, not open /aɪ/
                    # (civility, rigidity, vicinity vs ti-tanic)
                    head_ph = _rule_g2p(head)
                else:
                    # probe with the nucleus letter so the head's last
                    # syllable sees its OPEN juncture (ti-tanic,
                    # dy-namic), then strip the probe vowel
                    head_ph = _rule_g2p(head + base[v])
                    while head_ph and head_ph[-1][-1:] in "012":
                        head_ph.pop()
                    if head_ph and head_ph[-1] == "Y":
                        head_ph.pop()  # the probe vowel's yod (mu-sic)
                if not head_ph:
                    break
                head_ph = _pretonic(head_ph)
            coda_ph = []
            if coda:
                # evaluate the coda between probe vowels so c/g soften
                # before the suffix (magic → /dʒ/) and s voices
                # intervocalically (music → /z/), then strip the probes
                coda_ph = _rule_g2p("a" + coda + "i")
                while coda_ph and coda_ph[-1][-1:] in "012":
                    coda_ph.pop()
                while coda_ph and coda_ph[0][-1:] in "012":
                    coda_ph.pop(0)
            return head_ph + nucleus + coda_ph + ic_ph

    # Romance-loan finals: a V-C(C)-o/-i tail stresses the penult with
    # continental vowel quality (safari, bravado, tuxedo, mosquito,
    # graffiti, flamingo, embargo); two-group -a words likewise
    # (plaza, zebra, sofa, villa)
    if word[-1] in "aoi" and len(word) >= 4 \
            and word[-2] not in _VOWEL_LETTERS and word[-2] != word[-1]:
        w = word[:-1]
        spans = []
        j = 0
        while j < len(w):
            if w[j] in _VOWEL_LETTERS \
                    and not (w[j] == "u" and j > 0 and w[j - 1] == "q"):
                k0 = j
                while j < len(w) and w[j] in _VOWEL_LETTERS:
                    j += 1
                spans.append((k0, j))
            else:
                j += 1
        if spans:
            groups = len(spans) + 1
            pen_s, pen_e = spans[-1]
            pen = w[pen_s:pen_e]
            mid = word[pen_e:-1]
            opened = (len(mid) == 1
                      or (len(mid) == 2 and mid[1] in "lr"
                          and mid[0] != mid[1]))
            ok = False
            if len(pen) == 1 and pen in "aeiou" and 1 <= len(mid) <= 3:
                if word[-1] == "i":
                    ok = groups >= 3
                elif word[-1] == "o":
                    # English -o words with open penults stress the
                    # antepenult (buffalo, dynamo); the -ado/-edo/-ito
                    # and closed-penult loans stress the penult
                    ok = groups >= 3 and (not opened or mid[0] in "dt")
                else:
                    # len >= 5 keeps this off the 4-letter head probes
                    # the -ic machinery sends through (meta, dyna);
                    # 3+-group a-finals stress the penult too (cabana,
                    # vanilla, pagoda) — e/u-penults keep antepenult
                    # stress (camera, formula) unless doubled (umbrella)
                    ok = (groups == 2 and len(mid) <= 2
                          and len(word) >= 5) \
                        or (groups >= 3 and len(mid) <= 2
                            and (pen in "aoi"
                                 or (pen == "e" and len(mid) == 2
                                     and mid[0] == mid[1])))
            if ok:
                head = word[:pen_s]
                head_ph: List[str] = []
                if head:
                    head_ph = _rule_g2p(head + ("i" if pen == "e"
                                                else pen))
                    while head_ph and head_ph[-1][-1:] in "012":
                        head_ph.pop()
                    if head_ph and head_ph[-1] == "Y":
                        head_ph.pop()  # the probe vowel's yod
                    if head.endswith("qu") and head_ph \
                            and head_ph[-1] == "W":
                        head_ph.pop()  # Spanish qu is /k/ (mosquito)
                if opened:
                    nuc = [{"a": "AA1", "e": "IY1", "i": "IY1",
                            "o": "OW1", "u": "UW1"}[pen]]
                    if pen == "a" and word[-1] == "a" and groups >= 3:
                        nuc = ["AE1"]  # banana, cabana, montana
                elif mid[0] == "r":
                    nuc = {"a": ["AA1", "R"], "e": ["EH1", "R"],
                           "o": ["AO1", "R"], "i": ["ER1"],
                           "u": ["ER1"]}[pen]
                    mid = mid[1:]
                else:
                    nuc = [{"a": "AE1", "e": "EH1", "i": "IH1",
                            "o": "AA1", "u": "AH1"}[pen]]
                mid_ph: List[str] = []
                if mid == "ng":
                    mid_ph = ["NG", "G"]
                elif mid:
                    if len(mid) == 2 and mid[0] == mid[1]:
                        mid = mid[0]
                    # probe tails outside this rule's own trigger
                    # set (no recursion): y softens c/g before final
                    # i/e (da-vinci), the final-o/-a backness keeps
                    # them hard via a u probe (embargo)
                    mid_ph = _rule_g2p(
                        "a" + mid + ("y" if word[-1] == "i" else "o"))
                    while mid_ph and mid_ph[-1][-1:] in "012":
                        mid_ph.pop()
                    while mid_ph and mid_ph[0][-1:] in "012":
                        mid_ph.pop(0)
                fin = {"a": "AH0", "o": "OW0", "i": "IY0"}[word[-1]]
                out = _pretonic(head_ph) + nuc + mid_ph + [fin]
                if _has_vowel(out):
                    return out

    # final -ock reduces in polysyllables (hammock, paddock, haddock)
    if word.endswith("ock") and len(word) >= 6:
        stem = _rule_g2p(word[:-3])
        if stem and _has_vowel(stem):
            return stem + ["AH0", "K"]

    # -geon/-cheon endings are /dʒən/ /tʃən/ (pigeon, surgeon, luncheon)
    if len(word) >= 6 and word.endswith("cheon"):
        stem = _rule_g2p(word[:-5])
        if stem and _has_vowel(stem):
            return stem + ["CH", "AH0", "N"]
    if len(word) >= 5 and word.endswith("geon"):
        stem = _rule_g2p(word[:-4])
        if stem and _has_vowel(stem):
            return stem + ["JH", "AH0", "N"]

    # -rious after a vowel is /riəs/ (furious, curious); o-stems pull
    # the stress onto /ɔr/ (victorious, laborious, glorious)
    if len(word) >= 7 and word.endswith("rious"):
        stem_word = word[:-5]
        if stem_word.endswith("o"):
            head = _rule_g2p(stem_word[:-1])
            return (_pretonic(head) if head else []) \
                + ["AO1", "R", "IY0", "AH0", "S"]
        stem = _rule_g2p(stem_word)
        if stem and _has_vowel(stem):
            return stem + ["R", "IY0", "AH0", "S"]

    phones: List[str] = []
    n = len(word)

    # final e after a consonant is silent whenever an earlier vowel exists
    # (dance, house, give, table); additionally a V-C-e tail is "magic"
    # (lengthens that vowel: make, time)
    silent_final_e = (
        len(word) >= 3
        and word[-1] == "e"
        and word[-2] not in _VOWEL_LETTERS
        and any(ch in _VOWEL_LETTERS for ch in word[:-2])
    )
    magic_e = silent_final_e and word[-3] in _VOWEL_LETTERS

    i = 0
    while i < n:
        if silent_final_e and i == n - 1:
            break
        c = word[i]
        nxt = word[i + 1] if i + 1 < n else ""
        nxt2 = word[i + 2] if i + 2 < n else ""

        # word-initial silent consonants: gn- (gnome, gnash), ps- (psalm,
        # psychology); kn-/wr- are in the digraph table
        if i == 0 and c in "gp" and nxt == ("n" if c == "g" else "s") \
                and n >= 3:
            i += 1
            continue
        # word-final silent b/n after m (numb, crumb, climb; hymn, autumn)
        if c == "m" and nxt in "bn" and i + 2 == n:
            phones.append("M")
            break
        # V+rr+V: the doubled r keeps the first vowel SHORT and reads as
        # one /r/ (carry, berry, mirror, borrow, hurry) — without this the
        # r-digraphs (ar, or, ...) swallow one r and re-emit the other
        if c in "aeiou" and nxt == "r" and nxt2 == "r" \
                and i + 3 < n and word[i + 3] in _VOWEL_LETTERS:
            if c == "a" and i > 0 and (word[i - 1] == "w"
                                       or word[i - 1: i + 1] == "qu"):
                # w/qu darken a+rr too (warrior, warrant, quarrel)
                phones.extend(["AO1", "R"])
            else:
                phones.extend({"a": ["AE1", "R"], "e": ["EH1", "R"],
                               "i": ["IH1", "R"], "o": ["AA1", "R"],
                               "u": ["ER1"]}[c])
            i += 3
            continue
        # single intervocalic r keeps a/e FRONT, not the ar/er digraphs:
        # /ɛr/ in caravan, parish, charity, cherish, very, heritage;
        # the e-r-i+V hiatus class is /ɪr/ (serious, period, material)
        if c in "ae" and nxt == "r" and i > 0 \
                and nxt2 in _VOWEL_LETTERS and nxt2 != "r":
            if c == "e" and nxt2 == "i" and i + 3 < n \
                    and word[i + 3] in _VOWEL_LETTERS:
                phones.extend(["IH1", "R"])
            else:
                phones.extend(["EH1", "R"])
            i += 2
            continue
        # eu reads /juː/ after labials/velars and word-initially (feud,
        # Europe), plain /uː/ elsewhere (neutral, deuce — GenAm yod-drops)
        if c == "e" and nxt == "u" and not (silent_final_e and i + 2 == n):
            if i == 0 or word[i - 1] in "fpbmkgvh":
                phones.extend(["Y", "UW1"])
            else:
                phones.append("UW1")
            i += 2
            continue
        # xc before e/i/y is /ks/ (excite, except, excellent) — letterwise
        # x(/ks/) + soft c would double the /s/
        if c == "x" and nxt == "c" and nxt2 in "eiy":
            phones.extend(["K", "S"])
            i += 2
            continue
        # sc before e/i/y is one /s/ (scene, scent, descend, scissors)
        if c == "s" and nxt == "c" and nxt2 and nxt2 in "eiy":
            phones.append("S")
            i += 2
            continue
        # ch before r/l is the Greek /k/ (chrome, chronology, chlorine)
        if c == "c" and nxt == "h" and nxt2 and nxt2 in "rl":
            phones.append("K")
            i += 2
            continue
        # sch is the Greek /sk/ (school, scheme, schedule, scholar)
        if c == "s" and nxt == "c" and nxt2 == "h":
            phones.extend(["S", "K"])
            i += 3
            continue
        # dj is one /dʒ/ (adjust, adjacent, adjective)
        if c == "d" and nxt == "j":
            i += 1
            continue
        # dg before e/i/y is /dʒ/ with the e still spoken when not final
        # (edge, bridge vs budget, gadget, fidget)
        if c == "d" and nxt == "g" and nxt2 and nxt2 in "eiy":
            phones.append("JH")
            i += 2
            continue
        # medial du+V palatalizes like tu (graduate, pendulum, educate);
        # du+r keeps the stop (during, endure)
        if c == "d" and nxt == "u" and i > 0 and nxt2 in "aeio":
            phones.append("JH")
            i += 1
            continue
        # ew reads /juː/ after labials/velars (few, pew), /uː/ after
        # coronals and clusters (screw, chew, flew, new — GenAm yod-drop)
        if c == "e" and nxt == "w" and i > 0:
            if word[i - 1] in "fpbmkgvh":
                phones.extend(["Y", "UW1"])
            else:
                phones.append("UW1")
            i += 2
            continue
        # s+u+a is /sw/ when the s closes a prior syllable (persuade,
        # suave, assuage) — vowel+su is the /ʒ/ rule below
        if c == "s" and nxt == "u" and nxt2 == "a" \
                and (i == 0 or word[i - 1] not in _VOWEL_LETTERS):
            phones.extend(["S", "W"])
            i += 2
            continue
        # gu+V: French silent u word-initially (guard, guest, guide);
        # /gw/ after n (language, penguin, linguist, anguish)
        if c == "g" and nxt == "u" and nxt2 and nxt2 in "aei":
            if i == 0:
                phones.append("G")
                i += 2
                continue
            if word[i - 1] == "n":
                phones.extend(["G", "W"])
                i += 2
                continue
        # gir- keeps the hard g (girl, girth, gird) — soft-g would
        # misread the ir digraph class
        if c == "g" and nxt == "i" and nxt2 == "r":
            phones.append("G")
            i += 1
            continue
        # medial tur+V palatalizes (natural, century, saturate)
        if c == "t" and nxt == "u" and nxt2 == "r" and i + 3 < n \
                and word[i + 3] in _VOWEL_LETTERS and i > 0:
            phones.extend(["CH", "ER0"])
            i += 3
            continue
        # Greek combining prefixes keep the long i/y (microphone,
        # hydrogen, nitroglycerin)
        if i == 0 and word.startswith(("micro", "nitro", "hydro")) \
                and n >= 6:
            phones.extend([_CONSONANTS[c], "AY1"])
            i += 2
            continue
        # word-initial e+r+V is the reduced /ɪr/ (erase, erosion, erupt);
        # "err"+V (errand) is caught by the doubled-r rule above
        if i == 0 and c == "e" and nxt == "r" and nxt2 in _VOWEL_LETTERS \
                and nxt2 != "r" and n >= 5:
            phones.extend(["IH0", "R"])
            i += 2
            continue

        # doubled consonant letters are ONE phone, and they close the
        # preceding syllable (summer/letter/rabbit keep short vowels
        # because the open-syllable check below sees both letters)
        if c not in "aeiou" and nxt == c:
            if c == "c":
                # cc before e/i/y splits /ks/ (accident, succeed)
                phones.extend(["K", "S"] if nxt2 in "eiy" else ["K"])
            elif c == "g":
                phones.append("G")
            elif c in _CONSONANTS:
                phones.extend(_CONSONANTS[c].split())
            i += 2
            continue

        # word-initial y is the consonant (yellow, yes)
        if c == "y" and i == 0 and nxt in _VOWEL_LETTERS:
            phones.append("Y")
            i += 1
            continue

        # word-initial ar+V is the r-colored reduced syllable
        # (around, arise) — not the 'ar' digraph (arm, art)
        if c == "a" and i == 0 and nxt == "r" and nxt2 in _VOWEL_LETTERS \
                and n >= 5:
            phones.append("ER0")
            i += 2
            continue

        # word-initial unstressed a- in a-CV multisyllables
        # (away, again, along, about)
        if c == "a" and i == 0 and n >= 4 and nxt in _CONSONANTS \
                and nxt2 in _VOWEL_LETTERS:
            phones.append("AH0")
            i += 1
            continue
        # ... and before a doubled consonant when a shun-suffix pulls
        # the stress away (addiction, aggression, assumption) or a dj
        # onset (adjust, adjacent) — accident/accurate keep initial
        # stress
        if c == "a" and i == 0 and n >= 5 \
                and ((nxt == nxt2 and nxt in _CONSONANTS
                      and word.endswith(("ion", "ment")))
                     or (nxt == "d" and nxt2 == "j")):
            phones.append("AH0")
            i += 1
            continue

        # unstressed con-/com- prefix (confusion, connect, complete)
        if i == 0 and word.startswith(("con", "com")) and n >= 5 \
                and word[3] not in _VOWEL_LETTERS and word[3] != word[2]:
            phones.extend(["K", "AH0", "N" if word[2] == "n" else "M"])
            i += 3
            continue

        # unstressed prefixes be-/de-/re- before a consonant (before,
        # believe, return, decide); exceptions (recent, demon) are
        # lexicon entries
        if i == 0 and c in "bdr" and nxt == "e" and n >= 5 \
                and nxt2 not in _VOWEL_LETTERS and nxt2 != c \
                and word[3] in _VOWEL_LETTERS \
                and not ((word[-1] == "y" or word.endswith("ar"))
                         and _vowel_group_count(word) == 3) \
                and not (word.endswith(("ate", "ates", "ated"))
                         and _vowel_group_count(word) >= 4):
            phones.extend([_CONSONANTS[c], "IH0"])
            i += 2
            continue

        # n assimilates to NG before velars (think, bank, uncle, anchor)
        # k is velar in any position (blanket, banker, monkey); c/g only
        # when they close the syllable (uncle yes; raincoat, concord no)
        velar_onset_vowel = (nxt in "cg" and nxt2
                             and nxt2 in _VOWEL_LETTERS)
        # n+g+back-vowel is /ŋg/ within a morpheme (kangaroo, bingo,
        # mango, anger) — but an en-/in-/un- prefix keeps plain /n/
        # before its stem's g (engage, ungainly)
        if c == "n" and nxt == "g" and nxt2 and nxt2 in "aou" \
                and not (i == 1 and word[0] in "eiu"):
            phones.append("NG")
            i += 1
            continue
        if c == "n" and nxt and not velar_onset_vowel \
                and (nxt in "kgqx" or (nxt == "c" and nxt2 not in "eiyh")):
            if nxt == "g" and nxt2 and nxt2 in "eiy":
                pass  # danger, angel: n + soft g, no velar
            elif i == 1 and word[0] in "ie" and nxt == "c" \
                    and nxt2 in "lr" and n >= 6:
                pass  # in-/en- prefix before a c cluster: include,
                # increase, enclosure
            elif nxt == "g" and (i + 2 == n
                                 or (nxt2 not in _VOWEL_LETTERS
                                     and nxt2 not in "rl")):
                # ng closing a syllable is bare /ŋ/ (kings+ley,
                # strength); before r/l the g is the next onset
                # (hungry, angle, single)
                phones.append("NG")
                i += 2
                continue
            else:
                phones.append("NG")
                i += 1
                continue

        # wor+consonant reads /wɝ/ (work, word, world, worth; "worn" is
        # a lexicon exception)
        if c == "w" and nxt == "o" and nxt2 == "r" and i + 3 < n \
                and word[i + 3] not in _VOWEL_LETTERS:
            phones.extend(["W", "ER1"])
            # a doubled r folds into the r-colored vowel (worry)
            i += 4 if word[i + 3] == "r" else 3
            continue
        # war+consonant reads /wɔr/ (warp, ward, wharf; warm/warn are
        # lexicon words anyway)
        if c == "w" and nxt == "a" and nxt2 == "r" and i + 3 < n \
                and word[i + 3] not in _VOWEL_LETTERS \
                and word[i + 3] != "r":
            phones.extend(["W", "AO1", "R"])
            i += 3
            continue
        # ear+consonant reads /ɝ/ (earth, learn, heard, early; heart and
        # beard are lexicon exceptions)
        if word.startswith("ear", i) and i + 3 < n \
                and word[i + 3] not in _VOWEL_LETTERS:
            phones.append("ER1")
            i += 3
            continue
        # initial e- before one consonant in a silent-e frame is the
        # reduced Latin prefix (evade, evolve, elope, emerge)
        if c == "e" and i == 0 and nxt in _CONSONANTS \
                and nxt2 in _VOWEL_LETTERS and silent_final_e \
                and n >= 5 and _vowel_group_count(word) == 3:
            phones.append("IH0")
            i += 1
            continue
        # unstressed ex-/equ- prefix (explosion, expression, equipment)
        if i == 0 and c == "e" and n >= 3 \
                and (nxt == "x" or word.startswith("equ")) \
                and not (word.endswith(("ate", "ates", "ated"))
                         and _vowel_group_count(word) >= 4):
            phones.append("IH0")
            i += 1
            continue

        # magic-e across an r coda: the vowel reads long/r-colored
        # (care, store, fire, cure, here) — the bare r-digraph tables
        # (ar → /ɑr/ ...) only apply without the final e
        if magic_e and i == n - 3 and c in "aeiou" and nxt == "r":
            phones.extend({"a": ["EH1", "R"], "o": ["AO1", "R"],
                           "i": ["AY1", "R"], "u": ["Y", "UH1", "R"],
                           "e": ["IH1", "R"]}[c])
            i += 2
            continue

        matched = False
        for digraph, ph in _DIGRAPHS:
            if word.startswith(digraph, i):
                # intervocalic th is voiced ONLY in the Germanic -ther/
                # -the/-thing families (mother, weather, breathe,
                # bathing); Greek/Latin medial th stays voiceless
                # (marathon, method, author, cathedral, catholic)
                if digraph == "th" and 0 < i and i + 2 < n \
                        and word[i - 1] in _VOWEL_LETTERS \
                        and word[i + 2] in _VOWEL_LETTERS \
                        and (word[i + 2:].startswith("er")
                             or word[i + 2:] in ("e", "es", "ed", "ing",
                                                 "ings")):
                    ph = ["DH"]
                # laxed "ea": head, bread, feather, death
                if digraph == "ea" and (word.startswith("d", i + 2)
                                        and i + 3 == n
                                        or word.startswith("th", i + 2)):
                    ph = ["EH1"]
                # word-final -ow is /oʊ/ (yellow, slow), not /aʊ/
                if digraph == "ow" and i + 2 == n:
                    ph = ["OW1"]
                # word-final unstressed -or is /ɚ/ (vendor, doctor)
                if digraph == "or" and i + 2 == n and _has_vowel(phones):
                    ph = ["ER0"]
                # ng before e/i/y is n + SOFT g (danger, engine), not /ŋ/
                if digraph in ("ng", "ong") and i + len(digraph) < n \
                        and word[i + len(digraph)] in "eiy":
                    continue
                phones.extend(ph)
                i += len(digraph)
                matched = True
                break
        if matched:
            continue
        if c in _VOWEL_LETTERS:
            # word-final unstressed -ey is /iː/ (valley, money, monkey);
            # obey/survey-class exceptions live in the lexicon
            if c == "e" and nxt == "y" and i + 2 == n \
                    and _has_vowel(phones):
                phones.append("IY0")
                break
            # word-final unstressed -us is /əs/ with a voiceless s
            # (walrus, bonus, virus, campus, census, focus)
            if c == "u" and nxt == "s" and i + 2 == n \
                    and _has_vowel(phones):
                phones.extend(["AH0", "S"])
                break
            # reduced FINAL closed syllable: V + single final consonant
            # with an earlier vowel already emitted (open, pilot, problem,
            # cabin, silent...) — schwa, not a full vowel
            if _has_vowel(phones) and i == n - 2 and nxt in "lmnt" \
                    and c != "y":
                phones.append("IH0" if c == "i" else "AH0")
                i += 1
                continue
            # ... same for -ant/-ent tails (giant, silent, parent)
            if _has_vowel(phones) and i == n - 3 \
                    and word.endswith(("ant", "ent")):
                phones.extend(["AH0", "N", "T"])
                break
            # long contexts: magic-e position, open syllable (exactly one
            # consonant then a vowel), a consonant + -le tail (table,
            # title), or word-final vowel (go, hi, mo-ment)
            # a consonant digraph is ONE onset: the vowel before ph/th/
            # ch/sh + vowel is open (typhoon, python, gopher, fathom)
            digraph_onset = (nxt and word[i + 1: i + 3] in
                             ("ph", "th", "ch", "sh")
                             and i + 3 < n
                             and word[i + 3] in _VOWEL_LETTERS)
            long_pos = (
                (magic_e and i == n - 3)
                or (digraph_onset and c in "aeiouy"
                    and not (i + 3 == n - 2 and word[i + 3] in "io"))
                or (nxt and nxt not in _VOWEL_LETTERS
                    and nxt != "x"
                    and (nxt in _CONSONANTS
                         # c was historically absent from the consonant
                         # table (handled inline): vowels before it are
                         # open too (local, bacon, vocal, cucumber) — but
                         # not i, whose i-C-V words reduce (indicate)
                         or (nxt == "c" and (c != "i" or i == 0)))
                    and nxt2 in _VOWEL_LETTERS and nxt2 != nxt
                    # the following vowel sits in a final REDUCED syllable
                    # (cabin, wagon, dragon; chapel, comet, closet —
                    # the -el/-et trochees, NOT -en participles like
                    # taken/broken): short head — but u stays long/yod
                    # there (music, student)
                    and not (c != "u" and i + 2 == n - 2
                             and (nxt2 in "io"
                                  or (nxt2 == "e" and word[-1] in "lt")))
                    # 'e' before C+V is usually lax (never, seven,
                    # lemon, energy, elephant); long e survives via
                    # magic-e (scene) and word-initially only before
                    # v/g/q (even, evil, ego vs energy, enemy)
                    and not (c == "e" and (i > 0 or nxt not in "vgq")
                             # ... except before a C+i hiatus (devious,
                             # tedious, medium, previous)
                             and not (nxt2 == "i" and i + 3 < n
                                      and word[i + 3] in "aeou"))
                    # the syllable before an -ern tail is CLOSED
                    # (tavern, cavern, modern, govern)
                    and not word.endswith("ern", i + 2))
                or (nxt and nxt in _CONSONANTS and word.startswith("le", i + 2)
                    and i + 4 == n)
                or (i == n - 1 and n >= 2 and c in "iou")
            )
            # trisyllabic laxing: the stressed antepenult of a 3+-
            # syllable word is SHORT even in an open syllable (majesty,
            # strategy, nominate, catalog, operation) — the -ery/-ary
            # families and u (cucumber) resist
            if long_pos and not _has_vowel(phones) and c in "aeio" \
                    and not (magic_e and i == n - 3):
                groups = _vowel_group_count(word)
                if ((word.endswith(("y", "og", "al", "als", "ar",
                                    "ars"))
                     and not word.endswith("ry") and groups >= 3)
                        or (word.endswith(("ate", "ates", "ated",
                                           "ation"))
                            and groups >= 4)):
                    long_pos = False
            # medial ie reads /iː/ (grief, field, shield, piece); final
            # ie is /aɪ/ (die, tie), -ied/-ies keep the y-inflection
            # reading (tried, flies), and -iet/-ient are hiatus (quiet,
            # diet, client)
            if c == "i" and nxt == "e" and i + 2 < n \
                    and not (i + 2 == n - 1 and word[-1] in "ds") \
                    and not word.endswith("t"):
                phones.append("IY1")
                i += 2
                continue
            # i in hiatus before a/o/u: stressed early = /aɪ/ (giant,
            # lion, quiet), later = /iː/ (radio, period)
            if c == "i" and nxt in "aou":
                if i > 0 and word[i - 1] in "lnm" and nxt == "o":
                    phones.append("Y")  # onion, million, opinion
                else:
                    phones.append("AY1" if i <= 2 else "IY0")
                i += 1
                continue
            if c == "o" and not long_pos \
                    and ((word[i + 1: i + 3] in ("ft", "th"))
                         or (word[i + 1: i + 3] == "ss"
                             and (i + 3 >= n
                                  or word[i + 3] not in _VOWEL_LETTERS))
                         or (word[i + 1: i + 3] == "st"
                             and (i == 0 or word[i - 1] not in "mphg"))):
                # o darkens before voiceless clusters (frost, cost,
                # cloth, froth, soft, loss) — most/post/host stay long
                phones.append("AO1")
                i += 1
                continue
            table = _LONG_VOWELS if long_pos else _SHORT_VOWELS
            if c == "a" and i == n - 1 and _has_vowel(phones):
                phones.append("AH0")
                i += 1
                continue
            if c == "y" and i == n - 1 and not silent_final_e:
                phones.append("IY0" if n > 3 else "AY1")
            elif c == "a" and i > 0 \
                    and (word[i - 1] == "w"
                         or (i >= 2 and word[i - 2: i] == "qu")) \
                    and not long_pos and nxt != "g" \
                    and not (nxt == "c" and nxt2 == "k"):
                # wa-/qua- darken to /ɑ/ (want, wash, squad, quality)
                # except before g (wag, wagon) and ck (quack)
                phones.append("AA1")
            elif c == "o" and nxt == "g" and i + 2 == n:
                phones.append("AO1")  # final -og (dog, log, fog)
            elif c == "u" and long_pos:
                # long u is /juː/ except after l, r, j (blue, June)
                if i > 0 and word[i - 1] in "lrjdtsn":
                    phones.append("UW1")
                else:
                    phones.extend(["Y", "UW1"])
            else:
                phones.append(table[c])
        elif c == "c":
            phones.append("S" if (nxt and nxt in "eiy") else "K")
        elif c == "g":
            # soft g before e/i/y (giant, cage); hard otherwise
            phones.append("JH" if (nxt and nxt in "eiy") else "G")
        elif c == "l" and i == n - 2 and word[-1] == "e" and i > 0 \
                and word[i - 1] not in _VOWEL_LETTERS:
            phones.extend(["AH0", "L"])  # -Cle tail (table, little)
            break
        elif c == "s" and i == n - 1 and len(word) > 1:
            prev = word[i - 1]
            phones.append("Z" if prev in "bdgvlmrw"
                          or prev in _VOWEL_LETTERS else "S")
        elif c == "s" and 0 < i and nxt and word[i - 1] in _VOWEL_LETTERS \
                and nxt in _VOWEL_LETTERS \
                and not (nxt == "e" and i + 2 == n and word[i - 1] == "a"):
            # intervocalic s voices (music, visit); before u it
            # palatalizes (usual, casual, visual); final -ase stays
            # voiceless (base, case, erase — phrase is a lexicon word)
            phones.append("ZH" if nxt == "u" else "Z")
        elif c == "s" and 0 < i and word[i - 1] in "mw" \
                and nxt in _VOWEL_LETTERS:
            # s voices after m/w within a morpheme (crimson, clumsy,
            # flimsy, damsel, drowsy)
            phones.append("Z")
        elif c in _CONSONANTS:
            phones.extend(_CONSONANTS[c].split())
        i += 1
    return phones


def _secondary(phones: List[str]) -> List[str]:
    """Demote primary stress to secondary (the right-hand member of a
    compound: snowman → S N OW1 M AE2 N)."""
    return [p[:-1] + "2" if p.endswith("1") else p for p in phones]


# --- initialisms -------------------------------------------------------------
# The reference's neural g2p_en letter-spells unknown all-caps tokens; the
# rule L2S would garble them (FBI → /fbaɪ/).  English letter names,
# CMUDict phones:
_LETTER_NAMES = {
    "a": "EY1", "b": "B IY1", "c": "S IY1", "d": "D IY1", "e": "IY1",
    "f": "EH1 F", "g": "JH IY1", "h": "EY1 CH", "i": "AY1", "j": "JH EY1",
    "k": "K EY1", "l": "EH1 L", "m": "EH1 M", "n": "EH1 N", "o": "OW1",
    "p": "P IY1", "q": "K Y UW1", "r": "AA1 R", "s": "EH1 S", "t": "T IY1",
    "u": "Y UW1", "v": "V IY1", "w": "D AH1 B AH0 L Y UW0",
    "x": "EH1 K S", "y": "W AY1", "z": "Z IY1",
}

# 4+-letter vowel-containing all-caps words that are READ AS LETTERS
# anyway (the default for those is word reading: NASA, NATO, JSON, YAML)
_LETTER_READ = frozenset({"asap", "aiou", "ieee"})

# 3-letter consonant-vowel-consonant acronyms read as LETTERS (the CVC
# default is word reading: shouted GAS, RAM, SIM, PIN are words)
_LETTER_READ_CVC = frozenset({"vip", "suv", "pov", "faq", "doj", "dod",
                              "gop", "sec", "sos"})


def spell_initialism(word: str) -> List[str]:
    """Letter-name phones for an initialism; primary stress lands on the
    LAST letter (CMUDict convention: FBI → EH2 F B IY2 AY1)."""
    chunks = [_LETTER_NAMES[c].split() for c in word.lower()
              if c in _LETTER_NAMES]
    out: List[str] = []
    for j, ch in enumerate(chunks):
        if j < len(chunks) - 1:
            ch = [p[:-1] + "2" if p.endswith("1") else p for p in ch]
        out.extend(ch)
    return out


def is_initialism(token: str) -> bool:
    """True for tokens to read as letter names: all-caps, and either
    2-3 letters (FBI, TPU, USA, CEO — 3-letter all-caps are almost
    always initialisms; known WORDS are caught by the builtin-lexicon
    lookup that runs first, so shouted text like THE stays a word), or
    4-6 letters with no vowel letter (HTML, HTTPS) or in the
    letter-read list; longer vowel-bearing all-caps read as words
    (NASA, NATO, JSON)."""
    t = token.strip(punctuation)
    if not (t.isupper() and t.isalpha() and 1 <= len(t) <= 6):
        return False
    if len(t) == 1:
        # a lone capital reads as its letter name ("U. S." tokenizes to
        # single letters); "A" and "I" are words and never reach here —
        # the builtin-lexicon lookup wins first
        return True
    if len(t) == 3 and t[0] not in "AEIOU" and t[1] in "AEIOU" \
            and t[2] not in "AEIOU":
        # consonant-vowel-consonant all-caps are usually shouted words
        # or word-read acronyms (GAS, RAM, SIM, PIN) — the rule L2S
        # reads regular CVCs correctly; letter-read CVCs are listed
        return t.lower() in _LETTER_READ_CVC
    if len(t) <= 3:
        return True
    return (not any(c in "AEIOU" for c in t)
            or t.lower() in _LETTER_READ)


# consonant pairs that can START an English word — a rule-spelled
# compound right member must begin with a real onset (trap, flake), not
# a stranded coda cluster (cave+rnous is not a compound)
_VALID_ONSETS = frozenset({
    "bl", "br", "ch", "cl", "cr", "dr", "dw", "fl", "fr", "gl", "gn",
    "gr", "kn", "ph", "pl", "pr", "ps", "qu", "rh", "sc", "sh", "sk",
    "sl", "sm", "sn", "sp", "st", "sw", "th", "tr", "tw", "wh", "wr",
})


class G2p:
    """Callable matching the ``g2p_en.G2p`` protocol (word → phone list).

    Lookup chain (the analogue of the reference's lexicon→neural
    front door, reference: synthesize.py:33-64): optional g2p_en
    backend → built-in lexicon (~1,800 frequent + irregular words,
    text/builtin_lexicon.py) → morphological derivation → compound
    split over the built-in lexicon (snowman, raincoat) → OUR trained
    neural seq2seq (text/neural_g2p.py, confidence-routed) → rule
    letter-to-sound (rule_g2p).

    ``use_neural=False`` (or a missing checkpoint) reproduces the
    round-4 rules-only chain exactly."""

    def __init__(self, use_neural: bool = True):
        self._backend = None
        try:  # optional: use g2p_en when installed (reference parity)
            from g2p_en import G2p as _NeuralG2p  # type: ignore
            self._backend = _NeuralG2p()
        except Exception:
            self._backend = None
        from efficientspeech_tpu_torch.text.builtin_lexicon import (
            get_builtin_lexicon)

        self._builtin = get_builtin_lexicon()
        self._neural = None
        if use_neural:
            from efficientspeech_tpu_torch.text.neural_g2p import load_default

            self._neural = load_default()

    _NOT_COMPOUND_TAILS = {"able", "less", "ness", "ment", "ing", "ably",
                           "nation", "ration", "cation", "ture", "tion",
                           "sion", "tious", "cious", "ion", "ions", "age",
                           "ive", "sure", "ture", "ure", "king", "kings",
                           "city", "cities",
                           "ring", "rings"}

    # short words allowed as a compound's LEFT member (uphill, outdoors)
    _PREFIX_WORDS = {"up", "down", "out", "in", "over", "under", "back",
                     "off", "on"}

    # derivational suffixes resolvable against the built-in lexicon:
    # suffix -> phones appended to the stem's entry (s/es/ed apply the
    # standard voicing allomorphy instead)
    _DERIV_SUFFIXES = {
        "ly": ["L", "IY0"], "ness": ["N", "AH0", "S"],
        "less": ["L", "AH0", "S"], "ful": ["F", "AH0", "L"],
        "ment": ["M", "AH0", "N", "T"], "ing": ["IH0", "NG"],
        "er": ["ER0"], "est": ["AH0", "S", "T"],
        "able": ["AH0", "B", "AH0", "L"],
        "ation": ["EY1", "SH", "AH0", "N"],
        "ive": ["IH0", "V"],
        "age": ["AH0", "JH"],
        "ish": ["IH0", "SH"],
        "fully": ["F", "AH0", "L", "IY0"],
    }
    # prefix -> (phones, carries_primary_stress)
    _DERIV_PREFIXES = {
        "un": (["AH0", "N"], False), "re": (["R", "IY0"], False),
        "dis": (["D", "IH0", "S"], False),
        "mis": (["M", "IH0", "S"], False),
        "pre": (["P", "R", "IY0"], False),
        "non": (["N", "AA1", "N"], True),
        "over": (["OW1", "V", "ER0"], True),
        "under": (["AH1", "N", "D", "ER0"], True),
        "out": (["AW1", "T"], True),
        "semi": (["S", "EH1", "M", "IY0"], True),
        "anti": (["AE1", "N", "T", "IY0"], True),
    }
    _SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}

    def _lookup_stem(self, stem: str):
        """builtin entry for a morphological stem, trying the silent-e
        restoration (mak+ing → make) and de-doubling (runn+er → run)."""
        if stem in self._builtin:
            return list(self._builtin[stem])
        if stem + "e" in self._builtin:
            return list(self._builtin[stem + "e"])
        if len(stem) >= 3 and stem[-1] == stem[-2] \
                and stem[:-1] in self._builtin:
            return list(self._builtin[stem[:-1]])
        return None

    def _derived(self, word: str) -> List[str]:
        """Derived/inflected form of a built-in word: stem lookup plus
        regular suffix phonology (movement, agreements, safely, making)."""
        for suffix in ("s", "es", "ed"):
            if word.endswith(suffix) and len(word) - len(suffix) >= 3:
                # a derived form inflects too (protections, villagers)
                stem = self._lookup_stem(word[: -len(suffix)]) \
                    or self._derived(word[: -len(suffix)]) or None
                if stem:
                    last = stem[-1].rstrip("012")
                    if suffix == "ed":
                        if last in ("T", "D"):
                            return stem + ["IH0", "D"]
                        return stem + (["T"] if last in
                                       ("P", "K", "F", "TH", "S", "SH",
                                        "CH") else ["D"])
                    if last in self._SIBILANT:
                        return stem + ["IH0", "Z"]
                    return stem + (["S"] if last in
                                   ("P", "T", "K", "F", "TH") else ["Z"])
        for suffix, tail in self._DERIV_SUFFIXES.items():
            if word.endswith(suffix) and len(word) - len(suffix) >= 3:
                stem = self._lookup_stem(word[: -len(suffix)])
                if stem:
                    return stem + list(tail)
        if word.endswith("y") and len(word) - 1 >= 4:
            # adjectival -y on a LONG stem (snowy, rainy, dirty, crazy);
            # short stems (tiny, lady) are lexical, not derivational
            stem = self._lookup_stem(word[:-1])
            if stem:
                return stem + ["IY0"]
        # derivational prefixes on a known stem (unhappy, rebuild,
        # dislike, overload); stressed prefixes (out-, over-, under-,
        # non-) demote the stem to secondary like compound members
        for prefix, (ph, stressed) in self._DERIV_PREFIXES.items():
            if word.startswith(prefix) and len(word) - len(prefix) >= 3:
                rest = word[len(prefix):]
                stem = self._builtin.get(rest) or self._derived(rest)
                if stem:
                    stem = list(stem)
                    return list(ph) + (_secondary(stem) if stressed
                                       else stem)
        if word.endswith("ion") and len(word) - 3 >= 4:
            # stem >= 4: -ion is only a productive nominalizer on real
            # polysyllabizable stems (possess, protect, quest); 3-letter
            # lexicon hits are coincidence (not+ion is not "notion")
            # -ion nominalization with the sibilant mutation
            # (possess+ion → /ʃ/, protect/invent+ion → /ʃ/,
            # quest+ion → /tʃ/); D-stems shift the vowel too
            # (divide → division) and are left to the lexicon
            stem = self._lookup_stem(word[:-3])
            if stem:
                last = stem[-1].rstrip("012")
                tail = None
                if last == "S":
                    tail = ["SH", "AH0", "N"]
                elif last == "T":
                    if len(stem) >= 2 and stem[-2].rstrip("012") == "S":
                        tail = ["CH", "AH0", "N"]
                    else:
                        tail = ["SH", "AH0", "N"]
                if tail is not None:
                    # -ion attaches to the VERB's final stress, not the
                    # lexicon noun's (ADdict → adDICtion): promote the
                    # last stem vowel, reduce the earlier ones
                    head = stem[:-1]
                    vs = [j for j, p in enumerate(head)
                          if p[-1:].isdigit()]
                    if vs:
                        head = (_pretonic(head[: vs[-1]])
                                + [head[vs[-1]].rstrip("012") + "1"]
                                + head[vs[-1] + 1:])
                    return head + tail
        return []

    def _compound(self, word: str) -> List[str]:
        """Two-known-words split; the right member's stress demotes to
        secondary.  All splits are scored and the most-attested one wins:
        both members in the built-in lexicon (sea+shell, not seas+hell)
        beats one known member, and a known LEFT member beats a known
        right one (home+land, not homel+and) — the left member is the
        modifier and is almost always a real word.  Ties break to the
        longest left part (the old behavior).  The right member may be a
        plural of a built-in word (outdoors) or — when long enough —
        rule-spelled (snowflake); the left member may fall back to the
        rules only against a substantial right member (note+book yes,
        feat+her no)."""
        best: List[str] = []
        best_score = 0
        for k in range(len(word) - 3, 1, -1):
            a, b = word[:k], word[k:]
            if len(a) == 2 and a not in self._PREFIX_WORDS:
                continue
            right = None
            right_known = False
            if b in ("let", "lets", "rage", "rages") \
                    and a not in self._PREFIX_WORDS:
                continue  # book+let, broke+rage: suffix, not compound
            if b in self._builtin and b not in self._NOT_COMPOUND_TAILS:
                right = list(self._builtin[b])
                right_known = True
            elif b.endswith("s") and b[:-1] in self._builtin \
                    and len(b) >= 4:
                stem = list(self._builtin[b[:-1]])
                last = stem[-1].rstrip("012")
                if last in self._SIBILANT:
                    right = stem + ["IH0", "Z"]
                else:
                    right = stem + (["S"] if last in
                                    ("P", "T", "K", "F", "TH") else ["Z"])
                right_known = True
            left_known = a in self._builtin
            cand: List[str] = []
            if right is not None:
                if left_known:
                    cand = list(self._builtin[a]) + _secondary(right)
                elif len(a) >= 4 and len(b) >= 4 \
                        and b[0] not in "aeiou":
                    # a rule-spelled LEFT member needs a consonant-
                    # initial right: vowel-initial known tails are
                    # almost always inflection fragments (walr+uses)
                    left = rule_g2p(a)
                    if left:
                        if a.endswith("i") and left[-1] in ("IY0", "IY1",
                                                            "AY1"):
                            # a rule-spelled left member ending in i is a
                            # combining form with the LAX vowel
                            # (agri+culture), not a word-final tense /iː/
                            left[-1] = "IH0"
                        cand = left + _secondary(right)
            elif left_known and len(a) >= 4 and len(b) >= 4 \
                    and b[0] not in "aeiou" \
                    and (b[1] in "aeiouy" or b[:2] in _VALID_ONSETS) \
                    and (len(b) >= 5 or b[-1] not in "aeiouy"
                         or (b[-1] == "e"
                             and b[-2] not in _VOWEL_LETTERS)) \
                    and b not in self._NOT_COMPOUND_TAILS:
                # short rights must look like words — a consonant coda
                # or silent-e (trap, pile, dale), not an inflection
                # fragment (since+"rity", king+"sley")
                # rule-spelled right member (snowflake, grasshopper);
                # consonant-initial only — vowel-initial tails are almost
                # always suffixes (sign+ature), not compound members
                rb = rule_g2p(b)
                if rb and _has_vowel(rb):
                    cand = list(self._builtin[a]) + _secondary(rb)
            if not cand:
                continue
            # 2 points per lexicon-attested member, +1 when that member
            # is the left one: both-known(5) > left-known(3) >
            # right-known(2) > longest-left tiebreak (loop order)
            score = (3 if left_known else 0) + (2 if right_known else 0)
            if score > best_score:
                best, best_score = cand, score
        return best

    def __call__(self, word: str) -> List[str]:
        if self._backend is not None:
            return list(self._backend(word))
        if not any(c.isalpha() for c in word):
            # punctuation passes through (g2p_en behavior); the caller maps
            # it to {sp} (reference: synthesize.py:50)
            return [c for c in word if not c.isspace()]
        w = word.lower().strip("".join(punctuation))
        if w in self._builtin:
            # known words win even in all-caps (shouted THE stays "the")
            return list(self._builtin[w])
        if is_initialism(word):
            return spell_initialism(word.strip("".join(punctuation)))
        # neural BEFORE derivation/compounds (round-5 blind5-calibrated
        # reorder): the trained model both memorizes every burned set
        # (dev/blind4 100% after the reorder) and generalizes better
        # than the morphological machinery on fresh vocabulary (blind5
        # front door 73.0 -> 74.2).  Derivation, compounds, and the rule
        # L2S remain the full no-checkpoint path — deleting the .npz
        # degrades gracefully to the round-4 front door.
        if self._neural is not None:
            phones = self._neural.confident(w)
            if phones:
                return phones
        if len(w) >= 5:
            derived = self._derived(w)
            if derived:
                return derived
        if len(w) >= 6:
            compound = self._compound(w)
            if compound:
                return compound
        return rule_g2p(word)


# --- homographs --------------------------------------------------------------
# The reference resolves nothing here (lexicon first entry wins,
# reference: synthesize.py:41); context-aware homograph handling is a
# beyond-reference quality feature.  Two classes:
# 1) noun/verb STRESS pairs (record, present, object...): verb = final
#    stress, noun = initial stress; resolved by the preceding function word.
# 2) lexical homographs with distinct vowels (read, live, wind, tear...):
#    resolved by small per-word context rules.

_VERB_CUES = {"to", "will", "would", "can", "could", "may", "might",
              "shall", "should", "must", "don't", "didn't", "doesn't",
              "won't", "can't", "couldn't", "wouldn't", "please", "not",
              "i", "we", "they", "you", "who", "and", "then"}
_NOUN_CUES = {"the", "a", "an", "this", "that", "these", "those", "my",
              "your", "his", "her", "its", "our", "their", "some", "any",
              "no", "each", "every", "another", "new", "old", "first",
              "last", "of", "in", "on", "at", "by", "with", "for"}

# word: (verb phones, noun phones) — CMUDict values for both readings
_STRESS_PAIRS = {
    "record": ("R IH0 K AO1 R D", "R EH1 K ER0 D"),
    "present": ("P R IH0 Z EH1 N T", "P R EH1 Z AH0 N T"),
    "object": ("AH0 B JH EH1 K T", "AA1 B JH EH0 K T"),
    "produce": ("P R AH0 D UW1 S", "P R OW1 D UW0 S"),
    "content": ("K AH0 N T EH1 N T", "K AA1 N T EH0 N T"),
    "desert": ("D IH0 Z ER1 T", "D EH1 Z ER0 T"),
    "contract": ("K AH0 N T R AE1 K T", "K AA1 N T R AE2 K T"),
    "permit": ("P ER0 M IH1 T", "P ER1 M IH0 T"),
    "conduct": ("K AH0 N D AH1 K T", "K AA1 N D AH0 K T"),
    "conflict": ("K AH0 N F L IH1 K T", "K AA1 N F L IH0 K T"),
    "protest": ("P R AH0 T EH1 S T", "P R OW1 T EH2 S T"),
    "suspect": ("S AH0 S P EH1 K T", "S AH1 S P EH2 K T"),
    "increase": ("IH0 N K R IY1 S", "IH1 N K R IY2 S"),
    "decrease": ("D IH0 K R IY1 S", "D IY1 K R IY2 S"),
    "insult": ("IH0 N S AH1 L T", "IH1 N S AH2 L T"),
    "project": ("P R AH0 JH EH1 K T", "P R AA1 JH EH0 K T"),
    "convert": ("K AH0 N V ER1 T", "K AA1 N V ER0 T"),
    "contrast": ("K AH0 N T R AE1 S T", "K AA1 N T R AE2 S T"),
    "rebel": ("R IH0 B EH1 L", "R EH1 B AH0 L"),
    "refuse": ("R IH0 F Y UW1 Z", "R EH1 F Y UW2 S"),
}

_PAST_CUES = {"have", "has", "had", "was", "were", "been", "already",
              "once", "yesterday"}


def _resolve_homograph(word: str, prev: str, nxt: str) -> List[str]:
    """Phones for a homograph given the neighboring words ('' if none);
    empty list when the word is not a handled homograph."""
    if word in _STRESS_PAIRS:
        verb, noun = _STRESS_PAIRS[word]
        if prev in _VERB_CUES and prev not in _NOUN_CUES:
            return verb.split()
        return noun.split()
    if word == "read":
        return ("R EH1 D" if prev in _PAST_CUES else "R IY1 D").split()
    if word == "live":
        live_adj = prev in ("a", "the", "is", "was", "watch", "watching",
                            "go", "going") or nxt in (
            "music", "show", "shows", "stream", "broadcast", "coverage",
            "performance", "audience", "concert", "tv")
        return ("L AY1 V" if live_adj else "L IH1 V").split()
    if word == "wind":
        return ("W AY1 N D" if nxt in ("up", "down") or prev == "to"
                else "W IH1 N D").split()
    if word == "tear":
        return ("T EH1 R" if nxt in ("apart", "down", "up", "off", "it",
                                     "into", "through")
                else "T IH1 R").split()
    if word == "close":
        return ("K L OW1 S" if nxt == "to" or prev in ("too", "so", "very",
                                                       "how")
                else "K L OW1 Z").split()
    if word == "use":
        return ("Y UW1 S" if prev in ("the", "a", "no", "any", "some",
                                      "its", "of", "in", "good", "much")
                else "Y UW1 Z").split()
    if word == "lead":
        return ("L EH1 D" if nxt in ("pipe", "pipes", "paint",
                                     "poisoning", "pencil")
                else "L IY1 D").split()
    if word == "bass":
        return ("B AE1 S" if nxt in ("fishing", "fish")
                or prev in ("largemouth", "striped", "sea")
                else "B EY1 S").split()
    return []


def get_lexicon_and_g2p(preprocess_config) -> tuple:
    """(lexicon dict, g2p callable) for a PreprocessConfig or raw dict."""
    if hasattr(preprocess_config, "lexicon_path"):
        lex_path = preprocess_config.lexicon_path
        lang = getattr(preprocess_config, "language", "en")
    else:
        lex_path = preprocess_config["path"]["lexicon_path"]
        lang = preprocess_config["preprocessing"]["text"]["language"]
    try:
        lexicon = read_lexicon(lex_path)
    except (FileNotFoundError, IsADirectoryError):
        lexicon = {}
    if lang == "t1":
        # Tagalog front door: activate the phone inventory (the
        # reference ships it commented out of the symbol table, so its
        # t1 phones vanish at tokenization) and serve OOV words from the
        # shipped loanword lexicon (lexicon/tagalog-loanwords.txt —
        # hand-authored English/Spanish loans, the rules' measured
        # failure mode; test-split delta +1 word / 0 broken) then the
        # rule G2P instead of raw characters
        from efficientspeech_tpu_torch.text import enable_tagalog_symbols
        from efficientspeech_tpu_torch.text.tagalog_g2p import tagalog_g2p

        enable_tagalog_symbols()
        loan_path = os.path.join(os.path.dirname(__file__), "..", "..",
                                 "lexicon", "tagalog-loanwords.txt")
        try:
            loanwords = read_lexicon(loan_path)
        except (FileNotFoundError, IsADirectoryError):
            loanwords = {}

        def t1_g2p(word):
            wl = word.lower()
            if wl in loanwords:
                return list(loanwords[wl])
            return tagalog_g2p(word)

        t1_g2p.is_tagalog = True
        return lexicon, t1_g2p
    return lexicon, G2p()


def text2phoneme(lexicon: Dict[str, List[str]], g2p, text: str,
                 preprocess_config, verbose: bool = False) -> np.ndarray:
    """Raw text → phoneme ID array (reference: synthesize.py:37-64)."""
    text = text.rstrip(punctuation)
    if hasattr(preprocess_config, "language"):
        lang = preprocess_config.language
        cleaner_names = list(preprocess_config.text_cleaners)
    else:
        lang = preprocess_config["preprocessing"]["text"]["language"]
        cleaner_names = preprocess_config["preprocessing"]["text"]["text_cleaners"]

    phones: List[str] = []
    words = re.split(r"([,;.\-\?\!\s+])", text)
    # alphabetic-neighbor context for homograph resolution
    alpha_idx = [i for i, w in enumerate(words)
                 if any(c.isalpha() for c in w)]
    neighbors = {}
    for pos, i in enumerate(alpha_idx):
        prev = words[alpha_idx[pos - 1]].lower() if pos > 0 else ""
        nxt = (words[alpha_idx[pos + 1]].lower()
               if pos + 1 < len(alpha_idx) else "")
        neighbors[i] = (prev, nxt)
    for i, w in enumerate(words):
        wl = w.lower()
        if lang != "t1" and i in neighbors:
            resolved = _resolve_homograph(wl, *neighbors[i])
            if resolved:
                phones += resolved
                continue
        if wl in lexicon:
            phones += lexicon[wl]
        elif lang == "t1":
            # loanword lexicon + rule G2P over the isip phone inventory
            # (the reference falls back to raw characters here,
            # synthesize.py:44-45, which its shipped symbol table then
            # drops entirely).  Prefer the callable from
            # get_lexicon_and_g2p (loanwords -> rules); fall back to
            # the bare rules if the caller passed something else.
            if getattr(g2p, "is_tagalog", False):
                # the t1 front door from get_lexicon_and_g2p
                # (loanwords -> rules)
                phones += g2p(wl) or list(wl)
            else:
                # the caller passed something else (e.g. an English
                # G2p) — never route Tagalog words through it; use the
                # bare isip rules
                from efficientspeech_tpu_torch.text.tagalog_g2p import \
                    tagalog_g2p

                phones += tagalog_g2p(wl) or list(wl)
        else:
            phones += list(filter(lambda p: p != " ", g2p(w)))
    phones_str = "{" + "}{".join(phones) + "}"
    phones_str = re.sub(r"\{[^\w\s]?\}", "{sp}", phones_str)
    phones_str = phones_str.replace("}{", " ")

    if verbose:
        print(f"Raw Text Sequence: {text}")
        print(f"Phoneme Sequence: {phones_str}")

    return np.array(text_to_sequence(phones_str, cleaner_names))
