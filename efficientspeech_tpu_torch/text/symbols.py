"""Symbol vocabulary for text input.

Same 152-symbol inventory as the reference (reference: text/symbols.py:22-31):
pad ``_``, specials ``-/``, punctuation, upper/lowercase ASCII letters,
84 ``@``-prefixed ARPAbet phones, and the silence tokens ``@sp @spn @sil``.
The embedding table is sized ``len(symbols) + 1`` (reference:
layers/networks.py:32).
"""

from efficientspeech_tpu_torch.text.cmudict_phones import ARPABET_SYMBOLS
from efficientspeech_tpu_torch.text.tagdict_phones import TAGALOG_SYMBOLS

PAD = "_"
_punctuation = "!'(),.:;? "
_special = "-/"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_silences = ["@sp", "@spn", "@sil"]

# "@" prefix keeps ARPAbet phones distinct from uppercase letters
# (reference: text/symbols.py:18).
_arpabet = ["@" + s for s in ARPABET_SYMBOLS]
_tagalog = ["@" + s for s in TAGALOG_SYMBOLS]  # available, not in default set

symbols = (
    [PAD]
    + list(_special)
    + list(_punctuation)
    + list(_letters)
    + _arpabet
    + _silences
)

PAD_ID = 0
VOCAB_SIZE = len(symbols) + 1  # embedding rows (reference: layers/networks.py:32)

# Opt-in Tagalog extension: the reference ships the Tagalog inventory
# commented OUT of the symbol set (text/symbols.py:28), so its isip path
# silently drops every phone at tokenization.  Here the phones append
# AFTER the default inventory — English IDs (and checkpoint parity) are
# untouched; a Tagalog model simply sizes its embedding to
# TAGALOG_VOCAB_SIZE (ModelConfig.vocab_size).
symbols_tagalog = symbols + _tagalog
TAGALOG_VOCAB_SIZE = len(symbols_tagalog) + 1
