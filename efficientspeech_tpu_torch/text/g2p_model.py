"""Neural G2P model: a compact char→phone transformer seq2seq.

The reference's OOV fallback is the trained ``g2p_en`` seq2seq
(reference: synthesize.py:8,33-35 — a checkpoint-backed neural model);
four rounds of hand rules plateaued at ~50% blind word accuracy, so this
model replaces the rules as the primary OOV path (VERDICT r4 next #1).

Design constraints drive the shape of this file:

- The SAME forward runs under numpy (serving-time inference inside the
  text frontend, which must stay light) and under torch (training on the
  card, ``train_g2p.py``).  Every function therefore takes ``xp`` (the
  numpy module, or a ``TorchXP`` namespace of the same functions over
  torch tensors) and the params are a flat dict of arrays — no framework
  state.  Dropout draws from a ``torch.Generator`` (the ``rng``
  argument); serving decodes with ``rng=None``.
- Sub-1M parameters (d=128, 3 encoder + 2 decoder pre-LN blocks,
  4 heads, FFN 256): trained on ~5k gold + augmented pairs, anything
  bigger memorizes.
- Static shapes everywhere (MAX_SRC/MAX_TGT): every training batch has
  one shape.
"""

import math
from typing import Dict, List

import numpy as np

from efficientspeech_tpu_torch.text.cmudict_phones import ARPABET_SET

# --- vocab -------------------------------------------------------------------
CHARS = "abcdefghijklmnopqrstuvwxyz'"
CHAR_PAD = 0
CHAR_TO_ID = {c: i + 1 for i, c in enumerate(CHARS)}
N_CHARS = len(CHARS) + 1

PHONE_PAD, PHONE_BOS, PHONE_EOS = 0, 1, 2
PHONES = sorted(ARPABET_SET)
PHONE_TO_ID = {p: i + 3 for i, p in enumerate(PHONES)}
ID_TO_PHONE = {i + 3: p for i, p in enumerate(PHONES)}
N_PHONES = len(PHONES) + 3

MAX_SRC = 20   # chars; longer words fall back to the rules
MAX_TGT = 26   # phones incl. EOS

D_MODEL = 128
N_HEADS = 4
D_FF = 256
N_ENC = 3
N_DEC = 2


def encode_word(word: str) -> np.ndarray:
    """word → padded char-id array [MAX_SRC] (None if unencodable)."""
    ids = [CHAR_TO_ID.get(c) for c in word]
    if None in ids or not ids or len(ids) > MAX_SRC:
        return None
    out = np.zeros((MAX_SRC,), np.int32)
    out[: len(ids)] = ids
    return out


def encode_phones(phones: List[str]) -> np.ndarray:
    """phone list → [MAX_TGT] of ids ending in EOS (None if too long)."""
    ids = [PHONE_TO_ID.get(p) for p in phones]
    if None in ids or len(ids) + 1 > MAX_TGT:
        return None
    out = np.zeros((MAX_TGT,), np.int32)
    out[: len(ids)] = ids
    out[len(ids)] = PHONE_EOS
    return out


# --- params ------------------------------------------------------------------

def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Flat params dict (numpy; upload to device with jnp.asarray).
    Scaled-normal init, final-LN pre-norm transformer."""
    rng = np.random.default_rng(seed)

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[0])
        return (rng.normal(0, scale, shape)).astype(np.float32)

    p = {
        "char_emb": dense((N_CHARS, D_MODEL), 0.02),
        "src_pos": dense((MAX_SRC, D_MODEL), 0.02),
        "phone_emb": dense((N_PHONES, D_MODEL), 0.02),
        "tgt_pos": dense((MAX_TGT, D_MODEL), 0.02),
        "head_w": dense((D_MODEL, N_PHONES)),
        "head_b": np.zeros((N_PHONES,), np.float32),
    }

    def block(prefix, cross=False):
        for a in (["self"] + (["cross"] if cross else [])):
            for m in ("q", "k", "v", "o"):
                p[f"{prefix}_{a}_{m}w"] = dense((D_MODEL, D_MODEL))
            p[f"{prefix}_{a}_ln_s"] = np.ones((D_MODEL,), np.float32)
            p[f"{prefix}_{a}_ln_b"] = np.zeros((D_MODEL,), np.float32)
        p[f"{prefix}_ffn_w1"] = dense((D_MODEL, D_FF))
        p[f"{prefix}_ffn_b1"] = np.zeros((D_FF,), np.float32)
        p[f"{prefix}_ffn_w2"] = dense((D_FF, D_MODEL))
        p[f"{prefix}_ffn_b2"] = np.zeros((D_MODEL,), np.float32)
        p[f"{prefix}_ffn_ln_s"] = np.ones((D_MODEL,), np.float32)
        p[f"{prefix}_ffn_ln_b"] = np.zeros((D_MODEL,), np.float32)

    for i in range(N_ENC):
        block(f"enc{i}")
    for i in range(N_DEC):
        block(f"dec{i}", cross=True)
    p["enc_ln_s"] = np.ones((D_MODEL,), np.float32)
    p["enc_ln_b"] = np.zeros((D_MODEL,), np.float32)
    p["dec_ln_s"] = np.ones((D_MODEL,), np.float32)
    p["dec_ln_b"] = np.zeros((D_MODEL,), np.float32)
    return p


# --- forward (xp = numpy | TorchXP) -------------------------------------------

class TorchXP:
    """The numpy functions the forward calls, over torch tensors on
    ``device`` (default: the card, raising without one), plus
    ``bernoulli`` for dropout's keep mask."""

    def __init__(self, device=None):
        import torch

        from efficientspeech_tpu_torch.device import resolve_device

        self._torch = torch
        self.device = resolve_device(device)
        self.float32 = torch.float32
        self.sqrt, self.exp = torch.sqrt, torch.exp
        self.where, self.broadcast_to = torch.where, torch.broadcast_to

    @staticmethod
    def mean(x, axis, keepdims=False):
        return x.mean(axis, keepdim=keepdims)

    @staticmethod
    def max(x, axis, keepdims=False):
        return x.amax(axis, keepdim=keepdims)

    @staticmethod
    def sum(x, axis, keepdims=False):
        return x.sum(axis, keepdim=keepdims)

    @staticmethod
    def maximum(x, y):
        return x.clamp_min(y)

    def arange(self, n):
        return self._torch.arange(n, device=self.device)

    def asarray(self, x, dtype=None):
        return self._torch.asarray(x, dtype=dtype, device=self.device)

    def bernoulli(self, gen, p, shape):
        """True with probability ``p``, from the generator ``gen``."""
        return self._torch.rand(shape, generator=gen,
                                device=self.device) < p


def _ln(x, s, b, xp):
    mu = xp.mean(x, axis=-1, keepdims=True)
    var = xp.mean((x - mu) ** 2, axis=-1, keepdims=True)
    return (x - mu) / xp.sqrt(var + 1e-5) * s + b


def _softmax(x, xp):
    x = x - xp.max(x, axis=-1, keepdims=True)
    e = xp.exp(x)
    return e / xp.sum(e, axis=-1, keepdims=True)


def _mha(p, prefix, x_q, x_kv, mask, xp):
    """mask: additive [..., Lq, Lk] (0 or -1e9)."""
    B, Lq, _ = x_q.shape
    Lk = x_kv.shape[1]
    dh = D_MODEL // N_HEADS

    def split(x, w, L):
        y = x @ p[f"{prefix}_{w}w"]
        return y.reshape(B, L, N_HEADS, dh).swapaxes(1, 2)

    q = split(x_q, "q", Lq)
    k = split(x_kv, "k", Lk)
    v = split(x_kv, "v", Lk)
    att = q @ k.swapaxes(2, 3) / math.sqrt(dh)
    att = att + mask[:, None, :, :]
    att = _softmax(att, xp)
    y = (att @ v).swapaxes(1, 2).reshape(B, Lq, D_MODEL)
    return y @ p[f"{prefix}_ow"]


def _ffn(p, prefix, x, xp):
    h = xp.maximum(x @ p[f"{prefix}_w1"] + p[f"{prefix}_b1"], 0.0)
    return h @ p[f"{prefix}_w2"] + p[f"{prefix}_b2"]


def _dropout(x, rate, rng, xp):
    if rng is None or rate <= 0.0:
        return x
    keep = xp.bernoulli(rng, 1.0 - rate, x.shape)
    return xp.where(keep, x / (1.0 - rate), 0.0)


def encoder(p, char_ids, xp, dropout=0.0, rng=None):
    """char_ids [B, MAX_SRC] → (memory [B, MAX_SRC, D], src additive
    mask [B, 1, MAX_SRC])."""
    B = char_ids.shape[0]
    pad = (char_ids == CHAR_PAD)
    mask = xp.asarray(xp.where(pad[:, None, :], -1e9, 0.0),
                      dtype=xp.float32)
    x = p["char_emb"][char_ids] + p["src_pos"][None, :, :]
    for i in range(N_ENC):
        pre = f"enc{i}"
        h = _ln(x, p[f"{pre}_self_ln_s"], p[f"{pre}_self_ln_b"], xp)
        x = x + _dropout(_mha(p, f"{pre}_self", h, h,
                              xp.broadcast_to(mask, (B, MAX_SRC, MAX_SRC)),
                              xp), dropout, rng, xp)
        h = _ln(x, p[f"{pre}_ffn_ln_s"], p[f"{pre}_ffn_ln_b"], xp)
        x = x + _dropout(_ffn(p, f"{pre}_ffn", h, xp),
                         dropout, rng, xp)
    x = _ln(x, p["enc_ln_s"], p["enc_ln_b"], xp)
    return x, mask


def decoder_logits(p, memory, src_mask, tgt_in, xp, dropout=0.0, rng=None):
    """Teacher-forced decode: tgt_in [B, L] (BOS-shifted) → logits
    [B, L, N_PHONES].  L may be < MAX_TGT (greedy decode grows it)."""
    B, L = tgt_in.shape
    causal = xp.asarray(xp.where(
        xp.arange(L)[None, :, None] < xp.arange(L)[None, None, :],
        -1e9, 0.0), dtype=xp.float32)
    causal = xp.broadcast_to(causal, (B, L, L))
    cross_mask = xp.broadcast_to(src_mask, (B, L, MAX_SRC))
    x = p["phone_emb"][tgt_in] + p["tgt_pos"][None, :L, :]
    for i in range(N_DEC):
        pre = f"dec{i}"
        h = _ln(x, p[f"{pre}_self_ln_s"], p[f"{pre}_self_ln_b"], xp)
        x = x + _dropout(_mha(p, f"{pre}_self", h, h, causal, xp),
                         dropout, rng, xp)
        h = _ln(x, p[f"{pre}_cross_ln_s"], p[f"{pre}_cross_ln_b"], xp)
        x = x + _dropout(_mha(p, f"{pre}_cross", h, memory, cross_mask, xp),
                         dropout, rng, xp)
        h = _ln(x, p[f"{pre}_ffn_ln_s"], p[f"{pre}_ffn_ln_b"], xp)
        x = x + _dropout(_ffn(p, f"{pre}_ffn", h, xp),
                         dropout, rng, xp)
    x = _ln(x, p["dec_ln_s"], p["dec_ln_b"], xp)
    return x @ p["head_w"] + p["head_b"]


def greedy_decode(p, char_ids, xp=np, max_len: int = MAX_TGT):
    """Batched greedy decode: char_ids [B, MAX_SRC] →
    (tokens [B, max_len], mean log-prob per emitted token [B]).

    O(L²) full-prefix re-decode per step — a word is ≤26 tokens at
    d=128, so the whole decode is ~1 ms in numpy; no KV cache needed.
    """
    B = char_ids.shape[0]
    memory, src_mask = encoder(p, char_ids, xp)
    tokens = xp.full((B, 1), PHONE_BOS, dtype=xp.int32)
    done = xp.zeros((B,), bool)
    logp_sum = xp.zeros((B,), xp.float32)
    n_emitted = xp.zeros((B,), xp.float32)
    for _ in range(max_len):
        logits = decoder_logits(p, memory, src_mask, tokens, xp)[:, -1, :]
        logprobs = logits - xp.log(
            xp.sum(xp.exp(logits - xp.max(logits, -1, keepdims=True)),
                   -1, keepdims=True)) - xp.max(logits, -1, keepdims=True)
        nxt = xp.argmax(logits, axis=-1).astype(xp.int32)
        step_lp = xp.take_along_axis(logprobs, nxt[:, None], -1)[:, 0]
        logp_sum = xp.where(done, logp_sum, logp_sum + step_lp)
        n_emitted = n_emitted + xp.where(done, 0.0, 1.0)
        done = done | (nxt == PHONE_EOS)
        tokens = xp.concatenate([tokens, nxt[:, None]], axis=1)
        if bool(xp.all(done)):
            break
    conf = logp_sum / xp.maximum(n_emitted, 1.0)
    return tokens[:, 1:], conf


def beam_decode(params_list, src: np.ndarray, beam: int = 4,
                max_len: int = MAX_TGT):
    """Single-word beam search with model ensembling (numpy only).

    ``params_list``: one or more params dicts; per-step log-probs are
    averaged across models (logit-space ensemble of independently
    seeded trainings — the standard cheap G2P accuracy win).  ``src``
    is [MAX_SRC].  Returns (phones, confidence) where confidence is the
    winning hypothesis's mean per-token log-prob under the ensemble —
    the same scale greedy_decode reports, so the front door's routing
    threshold applies unchanged.

    Beams are the batch dimension, so each step is one [beam, ...]
    forward per model; a word costs ~beam× the greedy decode (~4 ms at
    beam 4 / d=128) and serving caches per-word results (neural_g2p).
    """
    if not isinstance(params_list, (list, tuple)):
        params_list = [params_list]
    encs = [encoder(p, src[None, :], np) for p in params_list]
    mems = [np.broadcast_to(m, (beam,) + m.shape[1:]) for m, _ in encs]
    masks = [np.broadcast_to(k, (beam,) + k.shape[1:]) for _, k in encs]

    tokens = np.full((beam, 1), PHONE_BOS, np.int32)
    scores = np.full((beam,), -np.inf, np.float32)
    scores[0] = 0.0  # all beams start identical; keep one live
    done = np.zeros((beam,), bool)
    lengths = np.zeros((beam,), np.float32)

    for _ in range(max_len):
        step = np.zeros((beam, N_PHONES), np.float32)
        for p, mem, mask in zip(params_list, mems, masks):
            logits = decoder_logits(p, mem, mask, tokens, np)[:, -1, :]
            m = logits.max(-1, keepdims=True)
            step += (logits - m
                     - np.log(np.exp(logits - m).sum(-1, keepdims=True)))
        step /= len(params_list)
        # finished beams only extend with PAD at no cost
        step[done, :] = -np.inf
        step[done, PHONE_PAD] = 0.0
        cand = scores[:, None] + step                  # [beam, V]
        flat = np.argsort(cand.ravel())[::-1][:beam]
        rows, cols = flat // N_PHONES, flat % N_PHONES
        scores = cand[rows, cols]
        tokens = np.concatenate(
            [tokens[rows], cols[:, None].astype(np.int32)], axis=1)
        lengths = lengths[rows] + (~done[rows]).astype(np.float32)
        done = done[rows] | (cols == PHONE_EOS) | (cols == PHONE_PAD)
        if done.all():
            break

    norm = scores / np.maximum(lengths, 1.0)
    best = int(np.argmax(norm))
    phones = tokens_to_phones(tokens[best, 1:])
    conf = float(norm[best]) if phones else float("-inf")
    return phones, conf


def tokens_to_phones(tokens: np.ndarray) -> List[str]:
    """One row of greedy_decode output → phone strings (stops at EOS)."""
    out = []
    for t in np.asarray(tokens).tolist():
        if t == PHONE_EOS or t == PHONE_PAD:
            break
        out.append(ID_TO_PHONE.get(int(t), ""))
    return [p for p in out if p]


def n_params(p: Dict[str, np.ndarray]) -> int:
    return sum(int(np.prod(v.shape)) for v in p.values())
