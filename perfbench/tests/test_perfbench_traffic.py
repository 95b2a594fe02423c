"""The traffic generator: texts of exact phoneme counts that the port's
frontend reads as the reference's does, deterministic per seed, and the
same multiset of lengths for every seed."""

import json
import os

import numpy as np
import pytest

from perfbench.reference.frontend import phoneme_ids, read_lexicon
from perfbench.tests.conftest import REPO
from perfbench.yardstick import traffic

LEXICON = os.path.join(REPO, "lexicon", "builtin-en.txt")


def mix(name):
    with open(os.path.join(REPO, "perfbench", "traffic",
                           name + ".json")) as fh:
        return json.load(fh)


def test_texts_have_exact_lengths_and_repeat_per_seed():
    maker = traffic.TextMaker(LEXICON)
    lex = read_lexicon(LEXICON)
    lengths = list(range(1, 40)) + [130, 200, 351, 500]
    a = [maker.text(np.random.default_rng(7), n) for n in lengths]
    b = [maker.text(np.random.default_rng(7), n) for n in lengths]
    c = [maker.text(np.random.default_rng(8), n) for n in lengths]
    assert a == b and a != c
    assert [len(phoneme_ids(lex, t)) for t in a] == lengths


def test_port_frontend_reads_the_texts_as_the_reference():
    from efficientspeech_tpu_torch.config import PreprocessConfig
    from efficientspeech_tpu_torch.text.g2p import (
        get_lexicon_and_g2p, text2phoneme)

    cfg = PreprocessConfig(lexicon_path=LEXICON)
    port_lex, g2p = get_lexicon_and_g2p(cfg)
    lex = read_lexicon(LEXICON)
    maker = traffic.TextMaker(LEXICON)
    rng = np.random.default_rng(2 ** 33 + 1)
    for n in list(range(15, 131, 5)) + [200, 333, 500]:
        text = maker.text(rng, n)
        assert list(text2phoneme(port_lex, g2p, text, cfg)) == list(
            phoneme_ids(lex, text)), text


def test_same_lengths_for_every_seed():
    q = traffic.quantile_lengths(200, 500, 128)
    assert q.min() >= 200 and q.max() <= 500 and len(q) == 128
    assert (q == traffic.quantile_lengths(200, 500, 128)).all()
