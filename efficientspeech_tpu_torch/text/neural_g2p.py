"""Serving-side neural G2P: numpy-only decode of the trained
char→phone transformer (text/g2p_model.py, trained by train_g2p.py).

This is the front door's OOV fallback (the analogue of the reference's
``g2p_en`` neural model, reference: synthesize.py:8,33-35).  It runs in
the text frontend of every CLI and the HTTP server, so it must be pure
numpy.

Checkpoints are plain .npz files committed under the JAX
package's text/data/ and read from there by path: the
primary ``neural_g2p_en.npz`` plus optional ensemble members
``neural_g2p_en.E*.npz`` (independently seeded trainings whose per-step
log-probs are averaged — g2p_model.beam_decode).  ``load_default()``
memoizes the whole ensemble.  Each decode returns a confidence (mean
per-token log-prob of the winning hypothesis); the front door routes to
the rule L2S below a threshold calibrated on the burned blind4 set
(scripts/g2p_calibrate.py stores it in the primary npz meta).
"""

import glob
import json
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from efficientspeech_tpu_torch.text import g2p_model as M

# the checkpoints are data files shared with the JAX package; they are
# read by path (not imported), like lexicon/builtin-en.txt
DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
                            "efficientspeech_tpu", "text", "data",
                            "neural_g2p_en.npz")

_lock = threading.Lock()
_default = None
_default_tried = False


def _load_npz(path):
    z = np.load(path)
    params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    meta = {}
    if "__meta" in z.files:
        meta = json.loads(bytes(z["__meta"]).decode())
    return params, meta


class NeuralG2p:
    """word → (phones, confidence); thread-safe, with a small LRU.

    ``path`` is the primary checkpoint; sibling ``<stem>.E*.npz`` files
    are loaded as ensemble members.  ``beam`` ≤ 1 uses the batched
    greedy decode (single model only); ≥ 2 uses length-normalized beam
    search over the ensemble (g2p_model.beam_decode).
    """

    def __init__(self, path: str = DEFAULT_PATH, cache_size: int = 4096,
                 beam: Optional[int] = None):
        params, self.meta = _load_npz(path)
        self.params_list = [params]
        stem = path[:-4] if path.endswith(".npz") else path
        for extra in sorted(glob.glob(stem + ".E*.npz")):
            p2, _ = _load_npz(extra)
            self.params_list.append(p2)
        self.threshold = float(self.meta.get("route_threshold", -0.35))
        self.beam = int(self.meta.get("beam", 4)) if beam is None else beam
        self._cache = {}
        self._cache_size = cache_size

    def __call__(self, word: str) -> Tuple[List[str], float]:
        """(phones, mean per-token log-prob); ([], -inf) when the word
        can't be encoded (too long / non-alphabetic)."""
        got = self._cache.get(word)
        if got is not None:
            return list(got[0]), got[1]
        src = M.encode_word(word)
        if src is None:
            return [], float("-inf")
        if self.beam <= 1 and len(self.params_list) == 1:
            toks, conf = M.greedy_decode(self.params_list[0], src[None, :])
            phones = M.tokens_to_phones(toks[0])
            c = float(conf[0]) if phones else float("-inf")
        else:
            phones, c = M.beam_decode(self.params_list, src,
                                      beam=max(self.beam, 2))
        if len(self._cache) >= self._cache_size:
            self._cache.clear()
        self._cache[word] = (phones, c)
        return list(phones), c

    def confident(self, word: str) -> Optional[List[str]]:
        """phones when confidence clears the routing threshold, else
        None (caller falls back to the rule L2S)."""
        phones, conf = self(word)
        if phones and conf >= self.threshold:
            return phones
        return None


def load_default() -> Optional[NeuralG2p]:
    """Memoized default model; None when the checkpoint is absent or
    unreadable (the front door then behaves exactly as before)."""
    global _default, _default_tried
    with _lock:
        if _default_tried:
            return _default
        _default_tried = True
        try:
            if os.path.isfile(DEFAULT_PATH):
                _default = NeuralG2p(DEFAULT_PATH)
        except Exception:
            _default = None
        return _default


def reset_default_cache() -> None:
    """Testing hook: forget the memoized default model."""
    global _default, _default_tried
    with _lock:
        _default = None
        _default_tried = False
