"""Training-data assembly for the neural G2P.

Gold pairs are the legitimately-burned word→pron sets (builtin lexicon +
dev + blind1-3 — VERDICT r4 next #1 inventories them); blind4 is the
model-selection VALIDATION set and blind5 is the untouched gate.
Augmentation multiplies the gold set with phonologically deterministic
transforms (regular inflection allomorphy, derivational suffixes/
prefixes mirroring text/g2p.py's tables, and synthetic two-member
compounds with right-member stress demotion) — teaching the model
grapheme contexts the 4.4k gold words alone can't cover.

Every augmented form is mechanically excluded from the blind4/blind5
word lists, so validation and gate stay uncontaminated.
"""

import os
import re
from typing import Dict, Iterable, List, Tuple

import numpy as np

from efficientspeech_tpu_torch.text import g2p_model as M

# the training and evaluation lexicons are data files shared with the JAX
# package and its tests; they are read by path (not imported), like the
# neural G2P checkpoints (text/neural_g2p.py)
_REPO = os.path.join(os.path.dirname(__file__), "..", "..")
_TESTS_DATA = os.path.join(_REPO, "tests", "data")

_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOICELESS_STOP = {"P", "T", "K", "F", "TH"}
_VOWEL_PHONES = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
                 "IH", "IY", "OW", "OY", "UH", "UW"}


def _base(p: str) -> str:
    return p.rstrip("012")


def _is_vowel(p: str) -> bool:
    return _base(p) in _VOWEL_PHONES


def _n_vowels(pron: List[str]) -> int:
    return sum(_is_vowel(p) for p in pron)


def _secondary(pron: List[str]) -> List[str]:
    return [p[:-1] + "2" if p.endswith("1") else p for p in pron]


def _cvc_monosyllable(word: str, pron: List[str]) -> bool:
    """Single-vowel word ending in one consonant letter after one vowel
    letter — the class whose -ed/-ing double the final consonant."""
    return (_n_vowels(pron) == 1 and len(word) >= 3
            and word[-1] not in "aeiouwxy"
            and word[-2] in "aeiou" and word[-3] not in "aeiou")


def _silent_e(word: str) -> bool:
    return (word.endswith("e") and len(word) >= 3
            and word[-2] not in "aeiouy")


def inflections(word: str, pron: List[str]) -> Iterable[Tuple[str, List[str]]]:
    """Deterministic regular inflections/derivations of a gold pair.
    Only forms whose spelling AND phonology are unambiguous are
    generated; anything uncertain (polysyllabic CVC doubling, -le
    adverbs, y-stem comparatives with vowel change) is skipped."""
    last = _base(pron[-1])

    # plural / 3sg-s
    if word.endswith(("s", "sh", "ch", "x", "z")) or last in _SIBILANT:
        if word[-1] in "sxz" or word.endswith(("sh", "ch")):
            yield word + "es", pron + ["IH0", "Z"]
        else:  # horse+s
            yield word + "s", pron + ["IH0", "Z"]
    elif word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
        if pron[-1] in ("IY0", "IY1"):
            yield word[:-1] + "ies", pron + ["Z"]
    else:
        yield word + "s", pron + (["S"] if last in _VOICELESS_STOP
                                  else ["Z"])

    # past -ed (verbs and verb-like stems; emitted for every pair — the
    # mapping is what matters, not whether English uses the form)
    ed_tail = (["IH0", "D"] if last in ("T", "D")
               else ["T"] if last in _VOICELESS_STOP | {"SH", "CH"}
               else ["D"])
    ing_ok = ed_ok = False
    if _silent_e(word):
        yield word + "d", pron + ed_tail
        yield word[:-1] + "ing", pron + ["IH0", "NG"]
    elif word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
        if pron[-1] in ("IY0", "IY1"):
            yield word[:-1] + "ied", pron + ["D"]
            yield word + "ing", pron + ["IH0", "NG"]
    elif _cvc_monosyllable(word, pron):
        yield word + word[-1] + "ed", pron + ed_tail
        yield word + word[-1] + "ing", pron + ["IH0", "NG"]
    elif len(word) >= 3 and word[-1] not in "aeiou" \
            and word[-2] not in "aeiou":
        # consonant-cluster enders never double (help, thank, fold)
        yield word + "ed", pron + ed_tail
        yield word + "ing", pron + ["IH0", "NG"]

    # adverbial -ly (skip y/le stems: happily/gently change spelling)
    if not word.endswith(("y", "le", "l")):
        yield word + "ly", pron + ["L", "IY0"]
    elif word.endswith("l") and not word.endswith("ll"):
        yield word + "ly", pron + ["IY0"]

    # -ness (y→i keeps the IY0)
    if word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
        yield word[:-1] + "iness", pron + ["N", "AH0", "S"]
    else:
        yield word + "ness", pron + ["N", "AH0", "S"]

    # -ment / -less / -ful / -ish on plain stems
    if not word.endswith("e") or _silent_e(word):
        yield word + "ment", pron + ["M", "AH0", "N", "T"]
    yield word + "less", pron + ["L", "AH0", "S"]
    yield word + "ful", pron + ["F", "AH0", "L"]
    if not word.endswith(("e", "y", "i")):
        yield word + "ish", pron + ["IH0", "SH"]

    # agentive/comparative -er
    if _silent_e(word):
        yield word + "r", pron + ["ER0"]
    elif word.endswith("y") and len(word) > 2 and word[-2] not in "aeiou":
        if pron[-1] in ("IY0", "IY1"):
            yield word[:-1] + "ier", pron + ["ER0"]
    elif _cvc_monosyllable(word, pron):
        yield word + word[-1] + "er", pron + ["ER0"]
    elif word[-1] not in "aeiou" and word[-2] not in "aeiou":
        yield word + "er", pron + ["ER0"]


_PREFIXES = {
    "un": (["AH0", "N"], False), "re": (["R", "IY0"], False),
    "dis": (["D", "IH0", "S"], False), "mis": (["M", "IH0", "S"], False),
    "pre": (["P", "R", "IY0"], False), "non": (["N", "AA1", "N"], True),
    "over": (["OW1", "V", "ER0"], True),
    "under": (["AH1", "N", "D", "ER0"], True),
    "out": (["AW1", "T"], True), "semi": (["S", "EH1", "M", "IY0"], True),
    "anti": (["AE1", "N", "T", "IY0"], True),
}


_EXTRA_TSV = os.path.join(_REPO, "efficientspeech_tpu", "text", "data",
                          "g2p_train_extra.tsv")


def load_gold(include_blind123: bool = True,
              include_blind4: bool = False) -> Dict[str, List[str]]:
    """Gold pairs: authored extra training lexicon (lowest priority;
    text/data/g2p_train_extra.tsv, ~2.2k entries, 96% agreement with
    the trusted sets on their 549-word overlap) + builtin lexicon +
    dev + (optionally) blind1-3 + (optionally) blind4.  Later sources
    override earlier ones, so the long-vetted lexicon/dev/blind prons
    win every conflict.  include_blind4 is only legitimate once a
    LATER blind set gates the resulting model (blind4 was the round-5
    calibration set; with blind6 frozen, blind5 calibrates and blind4
    may train — excluded_words() enforces the frontier)."""
    from efficientspeech_tpu_torch.text.builtin_lexicon import (
        get_builtin_lexicon)
    from efficientspeech_tpu_torch.text.g2p_eval import load_eval_lexicon

    gold: Dict[str, List[str]] = {}
    if os.path.isfile(_EXTRA_TSV):
        for w, ph in load_eval_lexicon(_EXTRA_TSV).items():
            gold[w] = list(ph)
    for w, ph in get_builtin_lexicon().items():
        gold[w] = list(ph)
    names = ["g2p_dev.tsv"]
    if include_blind123:
        names += ["g2p_blind.tsv", "g2p_blind2.tsv", "g2p_blind3.tsv"]
    if include_blind4:
        names += ["g2p_blind4.tsv"]
    for name in names:
        for w, ph in load_eval_lexicon(
                os.path.join(_TESTS_DATA, name)).items():
            gold[w] = list(ph)
    return {w: ph for w, ph in gold.items()
            if re.fullmatch(r"[a-z']+", w)}


def excluded_words() -> set:
    """Words that must NEVER appear in training data: the calibration
    set (blind5, burned for tuning but still never trained on) and the
    current gate set (blind6).  Blind4 left this list when blind6 was
    frozen: it was the round-5 calibration set and may now train, with
    blind5 calibrating and blind6 gating."""
    from efficientspeech_tpu_torch.text.g2p_eval import load_eval_lexicon

    out = set()
    for name in ("g2p_blind5.tsv", "g2p_blind6.tsv"):
        out |= set(load_eval_lexicon(os.path.join(_TESTS_DATA, name)))
    return out


def build_pairs(gold_repeat: int = 3, n_compounds: int = 8000,
                n_prefixed: int = 6000, seed: int = 0,
                include_blind4: bool = False
                ) -> List[Tuple[str, List[str], bool]]:
    """(word, pron, is_gold) list: gold (repeated gold_repeat×) +
    deterministic inflections + sampled prefixed forms + sampled
    synthetic compounds, all excluded-word-filtered and deduped
    (gold wins over augmented)."""
    rng = np.random.default_rng(seed)
    gold = load_gold(include_blind4=include_blind4)
    excl = excluded_words()

    pairs: Dict[str, Tuple[List[str], bool]] = {}
    for w, ph in gold.items():
        if w not in excl and M.encode_word(w) is not None \
                and M.encode_phones(ph) is not None:
            pairs[w] = (ph, True)

    def add(w, ph):
        if w in pairs or w in excl:
            return
        if M.encode_word(w) is None or M.encode_phones(ph) is None:
            return
        pairs[w] = (ph, False)

    for w, ph in list(gold.items()):
        if not re.fullmatch(r"[a-z]+", w) or len(w) < 3:
            continue
        for form, fp in inflections(w, ph):
            add(form, fp)

    # prefixed forms on sampled stems
    stems = [w for w in gold if re.fullmatch(r"[a-z]+", w) and len(w) >= 4]
    prefs = list(_PREFIXES.items())
    for _ in range(n_prefixed):
        w = stems[int(rng.integers(len(stems)))]
        pre, (ph, stressed) = prefs[int(rng.integers(len(prefs)))]
        stem = gold[w]
        add(pre + w, list(ph) + (_secondary(list(stem)) if stressed
                                 else list(stem)))

    # synthetic compounds: short left + short right, right demoted
    shorts = [w for w in gold
              if re.fullmatch(r"[a-z]+", w) and 3 <= len(w) <= 7
              and 1 <= _n_vowels(gold[w]) <= 2]
    for _ in range(n_compounds):
        a = shorts[int(rng.integers(len(shorts)))]
        b = shorts[int(rng.integers(len(shorts)))]
        if a == b or len(a) + len(b) > M.MAX_SRC:
            continue
        add(a + b, list(gold[a]) + _secondary(list(gold[b])))

    out: List[Tuple[str, List[str], bool]] = []
    for w, (ph, is_gold) in pairs.items():
        reps = gold_repeat if is_gold else 1
        for _ in range(reps):
            out.append((w, ph, is_gold))
    return out


def encode_pairs(pairs) -> Tuple[np.ndarray, np.ndarray]:
    """pairs → (src [N, MAX_SRC], tgt [N, MAX_TGT]) int32 arrays."""
    src = np.stack([M.encode_word(w) for w, _, _ in pairs])
    tgt = np.stack([M.encode_phones(ph) for _, ph, _ in pairs])
    return src.astype(np.int32), tgt.astype(np.int32)
