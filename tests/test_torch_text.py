"""The port's copy of the English text frontend gives the JAX package's
phoneme IDs."""

import numpy as np
import pytest

from efficientspeech_tpu.config import PreprocessConfig as JaxPreprocessConfig
from efficientspeech_tpu.text.g2p import (
    get_lexicon_and_g2p as jax_lexicon, text2phoneme as jax_text2phoneme)
from efficientspeech_tpu_torch.config import PreprocessConfig
from efficientspeech_tpu_torch.text.g2p import (
    get_lexicon_and_g2p, text2phoneme)

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "In 1865, the 42nd regiment paid $3.50 for 2,000 rations.",
    "I read the book yesterday; now I read the paper.",
    "They live near the live wire.",
    "The FBI and NASA met the CEO at 9 a.m.",
    "Zyphorex and quintabulous flarbed the grommeters!",
    "Well... is it? Yes -- no; maybe: (perhaps) \"quoted\".",
    "Dr. Smith lives on St. James St., apt. 4B.",
    "She wound the bandage around the wound.",
    "It's 3:45pm on Jan. 1st, 2024 -- 100% sure.",
]


@pytest.fixture(scope="module")
def frontends():
    return (jax_lexicon(JaxPreprocessConfig()),
            get_lexicon_and_g2p(PreprocessConfig()))


@pytest.mark.parametrize("text", SENTENCES)
def test_text2phoneme_matches_jax(frontends, text):
    (j_lex, j_g2p), (lex, g2p) = frontends
    want = jax_text2phoneme(j_lex, j_g2p, text, JaxPreprocessConfig())
    got = text2phoneme(lex, g2p, text, PreprocessConfig())
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)
