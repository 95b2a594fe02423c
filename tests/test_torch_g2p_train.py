"""The port's G2P training against the JAX package's: the training pairs
bit-equal for a seed, the phone error rate, the torch forward and three
optimiser steps against a JAX step built as the root ``train_g2p.py``
builds it, dropout, the 8-word overfit check and the CLI's ``.npz``."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from efficientspeech_tpu.text import g2p_data as JD
from efficientspeech_tpu.text import g2p_eval as JE
from efficientspeech_tpu.text import g2p_model as JM
from efficientspeech_tpu.text.neural_g2p import NeuralG2p as JaxNeuralG2p
from efficientspeech_tpu_torch import train_g2p
from efficientspeech_tpu_torch.text import g2p_data as D
from efficientspeech_tpu_torch.text import g2p_eval as E
from efficientspeech_tpu_torch.text import g2p_model as M
from efficientspeech_tpu_torch.text.neural_g2p import NeuralG2p

DEV_TSV = os.path.join(os.path.dirname(__file__), "data", "g2p_dev.tsv")

WORDS = {
    "cat": ["K", "AE1", "T"], "dog": ["D", "AO1", "G"],
    "house": ["HH", "AW1", "S"], "tree": ["T", "R", "IY1"],
    "water": ["W", "AO1", "T", "ER0"],
    "stone": ["S", "T", "OW1", "N"],
    "light": ["L", "AY1", "T"], "dream": ["D", "R", "IY1", "M"],
}
# float32 tolerances: one forward, and three AdamW steps (the Adam
# update divides by sqrt(v) + 1e-8, which magnifies a gradient's last
# bits where v is small, by up to ~lr per step)
FORWARD_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _keep_tf32_flags(monkeypatch):
    """The CLIs' float32 runs switch TF32 off process-wide; restore it."""
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)


def _word_batch():
    src = np.stack([M.encode_word(w) for w in WORDS]).astype(np.int32)
    tgt = np.stack([M.encode_phones(p) for p in WORDS.values()]
                   ).astype(np.int32)
    return src, tgt


@pytest.mark.parametrize("kw", [
    {},
    {"seed": 1, "n_compounds": 500, "n_prefixed": 500, "gold_repeat": 1},
], ids=["cli_defaults", "seed1_500"])
def test_pairs_bit_equal_to_jax(kw):
    pairs = D.build_pairs(**kw)
    want = JD.build_pairs(**kw)
    assert pairs == want
    for got, ref in zip(D.encode_pairs(pairs), JD.encode_pairs(want)):
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)


def test_phone_error_rate_matches_jax():
    from efficientspeech_tpu_torch.text.g2p import rule_g2p

    lex = E.load_eval_lexicon(DEV_TSV)
    assert lex == JE.load_eval_lexicon(DEV_TSV) and len(lex) > 600
    for stress in (True, False):
        got = E.phone_error_rate(rule_g2p, lex, ignore_stress=stress)
        want = JE.phone_error_rate(rule_g2p, lex, ignore_stress=stress)
        assert got == want
        assert 0.0 < got[0] < 1.0


def test_numpy_forward_unchanged_and_torch_forward_matches_jax():
    """The numpy serving forward stays bit-equal to the JAX package's
    numpy forward; the torch forward holds JAX's jnp forward."""
    p = M.init_params(3)
    src = np.stack([M.encode_word("parity"), M.encode_word("check")])
    tgt_in = np.array([[M.PHONE_BOS, 7, 9, 11, 3]] * 2, np.int32)

    want_np = JM.decoder_logits(p, *JM.encoder(p, src, np), tgt_in, np)
    got_np = M.decoder_logits(p, *M.encoder(p, src, np), tgt_in, np)
    np.testing.assert_array_equal(got_np, want_np)

    pj = {k: jnp.asarray(v) for k, v in p.items()}
    want = JM.decoder_logits(pj, *JM.encoder(pj, jnp.asarray(src), jnp),
                             jnp.asarray(tgt_in), jnp)
    xp = M.TorchXP("cpu")
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = M.decoder_logits(pt, *M.encoder(pt, torch.from_numpy(src), xp),
                           torch.from_numpy(tgt_in), xp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FORWARD_ATOL, rtol=0)


def test_three_steps_match_the_jax_step():
    """Dropout 0: three updates of the port's trainer against the JAX
    step built from the JAX package's functions and optax exactly as the
    root train_g2p.py builds it (lr 1e-3, warmup 2 of 10 steps, b2 0.98,
    weight decay 0.01 on matrices, label smoothing 0.1)."""
    steps, lr, warmup, wd, ls = 10, 1e-3, 2, 0.01, 0.1
    src, tgt = _word_batch()
    params = M.init_params(0)

    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                               lr * 1e-2)
    tx = optax.adamw(sched, b1=0.9, b2=0.98, weight_decay=wd,
                     mask={k: v.ndim > 1 for k, v in params.items()})
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(pj)

    def loss_fn(p, s, t):
        mem, mask = JM.encoder(p, s, jnp, dropout=0.0, rng=None)
        tin = jnp.concatenate(
            [jnp.full((t.shape[0], 1), JM.PHONE_BOS, jnp.int32),
             t[:, :-1]], axis=1)
        logits = JM.decoder_logits(p, mem, mask, tin, jnp, dropout=0.0,
                                   rng=None)
        valid = (t != JM.PHONE_PAD).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits)
        onehot = jax.nn.one_hot(t, JM.N_PHONES)
        target = onehot * (1 - ls) + ls / JM.N_PHONES
        nll = -(target * logp).sum(-1)
        return (nll * valid).sum() / jnp.maximum(valid.sum(), 1.0)

    @jax.jit
    def jax_step(p, o, s, t):
        loss, grads = jax.value_and_grad(loss_fn)(p, s, t)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    trainer = train_g2p.G2pTrainer(params, steps, lr=lr, warmup=warmup,
                                   weight_decay=wd, dropout=0.0,
                                   label_smoothing=ls, device="cpu")
    assert trainer.warmup == warmup
    rows = [slice(0, 8), slice(2, 6), slice(0, 8)]
    for count, idx in enumerate(rows):
        assert trainer.lr(count) == pytest.approx(float(sched(count)),
                                                  rel=1e-6, abs=1e-12)
        pj, opt_state, want_loss = jax_step(pj, opt_state,
                                            jnp.asarray(src[idx]),
                                            jnp.asarray(tgt[idx]))
        got_loss = float(trainer.step(src[idx], tgt[idx]))
        assert got_loss == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    assert trainer.lr(0) == 0.0
    got = trainer.numpy_params()
    for k, v in pj.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)
    # the steps moved every parameter (the first at rate 0 moved none)
    moved = [k for k in params if not np.array_equal(got[k], params[k])]
    assert len(moved) == len(params)


def test_dropout_keeps_scales_and_repeats_for_a_seed():
    xp = M.TorchXP("cpu")
    x = torch.ones(200, 1000)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return M._dropout(x, 0.2, gen, xp)

    a, b, c = draw(0), draw(0), draw(1)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.8) < 0.005
    assert torch.all((a == 0) | torch.isclose(a, torch.tensor(1 / 0.8)))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # dropout 0 or no generator: the identity
    assert M._dropout(x, 0.0, torch.Generator(), xp) is x
    assert M._dropout(x, 0.2, None, xp) is x


def test_trainer_overfits_tiny_set():
    """The JAX package's 8-pair overfit check (tests/test_neural_g2p.py)
    on the port's trainer: 150 steps, then greedy decode reproduces every
    pronunciation."""
    src, tgt = _word_batch()
    trainer = train_g2p.G2pTrainer(M.init_params(0), 150, lr=3e-3,
                                   warmup=1, weight_decay=0.0,
                                   device="cpu")
    for _ in range(150):
        loss = trainer.step(src, tgt)
    toks, conf = M.greedy_decode(trainer.numpy_params(), src)
    for i, (w, ref) in enumerate(WORDS.items()):
        assert M.tokens_to_phones(toks[i]) == ref, (w, float(loss))
    assert float(np.min(conf)) > -0.5


def test_cli_writes_an_npz_both_packages_decode_alike(tmp_path,
                                                     monkeypatch, capsys):
    """A tiny CPU run of the CLI: its JSON lines, the .npz format, and
    the port's and the JAX package's NeuralG2p decoding it alike; the
    default --eval-set resolves from another working directory."""
    lex = E.load_eval_lexicon(DEV_TSV)
    small = tmp_path / "eval.tsv"
    small.write_text("".join(f"{w} {' '.join(p)}\n"
                             for w, p in list(lex.items())[:24]))
    out, log = tmp_path / "g2p.npz", tmp_path / "log.jsonl"
    monkeypatch.chdir(tmp_path)
    assert os.path.isfile(train_g2p.repo_path(train_g2p.DEFAULT_EVAL_SET))
    assert not train_g2p.DEFAULT_OUT.startswith("efficientspeech_tpu")
    best = train_g2p.main([
        "--device", "cpu", "--steps", "6", "--batch-size", "16",
        "--warmup", "2", "--eval-every", "3", "--n-compounds", "50",
        "--n-prefixed", "50", "--gold-repeat", "1", "--eval-set",
        str(small), "--out", str(out), "--log", str(log)])
    printed = capsys.readouterr().out
    assert printed.startswith("training pairs: ")
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == [3, 6]
    assert set(lines[0]) == {"step", "loss", "val_per", "val_acc",
                             "val_skipped_long", "lr", "elapsed_s"}
    assert all(np.isfinite(x["loss"]) for x in lines)

    z = np.load(out)
    meta = json.loads(bytes(z["__meta"]).decode())
    assert meta["val_set"] == "eval.tsv" and meta["step"] == best["step"]
    assert meta["n_params"] == M.n_params(M.init_params(0))
    port, ref = NeuralG2p(str(out), beam=1), JaxNeuralG2p(str(out), beam=1)
    assert port.meta == ref.meta
    for a, b in zip(port.params_list, ref.params_list):
        assert a.keys() == b.keys()
    per, acc, _ = train_g2p.evaluate_neural(port.params_list[0], lex_small :=
                                            E.load_eval_lexicon(str(small)))
    assert round(acc, 4) == meta["val_acc"] and round(per, 4) == \
        meta["val_per"]
    for word in list(lex_small) + ["zyphorex", "quintabulous"]:
        assert port(word) == ref(word)
    beam_port, beam_ref = NeuralG2p(str(out)), JaxNeuralG2p(str(out))
    assert beam_port("grommeter") == beam_ref("grommeter")
