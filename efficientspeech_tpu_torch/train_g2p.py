"""Neural G2P training CLI of the PyTorch port (the flags of the JAX
package's ``train_g2p.py``, plus ``--device``).

It trains the compact char→phone transformer (``text/g2p_model.py``) on
the word→pron pairs of ``text/g2p_data.py``, validates on an evaluation
lexicon with the numpy greedy decode serving uses, and writes the best
checkpoint as a plain ``.npz`` (``__meta`` JSON bytes plus ``p_*``
arrays) that ``text/neural_g2p.NeuralG2p`` loads:

    python -m efficientspeech_tpu_torch.train_g2p --steps 6000 \\
        --batch-size 256 --out outputs/g2p/neural_g2p_en.npz

The step is AdamW (b1 0.9, b2 0.98, eps 1e-8, weight decay on matrices
only) under a linear-warmup cosine schedule to 1% of ``--lr``, whose
rate for an update is read at the count of updates before it, so the
first update runs at rate 0; the loss is the label-smoothed NLL over
non-pad targets.  Batches follow seeded permutations of the pairs, and
dropout draws from a ``torch.Generator`` seeded by ``--seed`` on the
run's device.  Everything runs in float32 with TF32 off.  It runs on
the CUDA card, and raises without one unless given ``--device cpu``.
"""

import argparse
import json
import math
import os
import time
from typing import Dict

import numpy as np
import torch

from efficientspeech_tpu_torch.text import g2p_model as M

REPO = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
DEFAULT_OUT = os.path.join("outputs", "g2p", "neural_g2p_en.npz")
DEFAULT_EVAL_SET = os.path.join("tests", "data", "g2p_blind4.tsv")
# the schedule decays to this fraction of the peak rate
END_LR_FRACTION = 1e-2


def get_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=300)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gold-repeat", type=int, default=3)
    ap.add_argument("--n-compounds", type=int, default=8000)
    ap.add_argument("--n-prefixed", type=int, default=6000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--eval-set", default=DEFAULT_EVAL_SET,
                    help="validation lexicon; a relative path that does "
                         "not exist from the working directory is read "
                         "from the repository root (never the current "
                         "gate set, blind6)")
    ap.add_argument("--include-blind4", action="store_true",
                    help="fold blind4 into the gold training pairs "
                         "(legitimate only with blind5 as --eval-set "
                         "and blind6 frozen as the gate)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="the best checkpoint's .npz")
    ap.add_argument("--log", default=None, help="metrics jsonl path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def repo_path(path: str) -> str:
    """``path`` as given when it is absolute or exists from the working
    directory, else under the repository root."""
    if os.path.isabs(path) or os.path.exists(path):
        return path
    return os.path.join(REPO, path)


def warmup_cosine_lr(count: int, peak: float, warmup: int,
                     steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, steps,
    peak * END_LR_FRACTION)`` at ``count``: linear from 0 to ``peak``
    over ``warmup`` counts, then a cosine to the end value at ``steps``,
    held there after."""
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs steps > warmup, got "
                         f"steps={steps} warmup={warmup}")
    if count < warmup:
        return peak * count / warmup
    t = min(count - warmup, decay)
    cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
    return peak * ((1.0 - END_LR_FRACTION) * cosine + END_LR_FRACTION)


def g2p_loss(params: Dict[str, torch.Tensor], src: torch.Tensor,
             tgt: torch.Tensor, xp: M.TorchXP, dropout: float = 0.0,
             gen=None, label_smoothing: float = 0.0) -> torch.Tensor:
    """Label-smoothed NLL of the teacher-forced decode over the non-pad
    targets: src (B, MAX_SRC), tgt (B, MAX_TGT) int64."""
    mem, mask = M.encoder(params, src, xp, dropout=dropout, rng=gen)
    tin = torch.cat([torch.full_like(tgt[:, :1], M.PHONE_BOS),
                     tgt[:, :-1]], dim=1)
    logits = M.decoder_logits(params, mem, mask, tin, xp, dropout=dropout,
                              rng=gen)
    valid = (tgt != M.PHONE_PAD).float()
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(tgt, M.N_PHONES).float()
    target = onehot * (1 - label_smoothing) + label_smoothing / M.N_PHONES
    nll = -(target * logp).sum(-1)
    return (nll * valid).sum() / valid.sum().clamp_min(1.0)


class G2pTrainer:
    """The G2P model's float32 parameters on ``device`` (default: the
    card, raising without one) and their AdamW state; ``step(src, tgt)``
    takes one update and returns its loss (a device tensor, not read)."""

    def __init__(self, params: Dict[str, np.ndarray], steps: int,
                 lr: float = 1e-3, warmup: int = 300,
                 weight_decay: float = 0.01, dropout: float = 0.0,
                 label_smoothing: float = 0.0, seed: int = 0,
                 device=None):
        from efficientspeech_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.xp = M.TorchXP(self.device)
        self.params = {k: torch.tensor(v, dtype=torch.float32,
                                       device=self.device,
                                       requires_grad=True)
                       for k, v in params.items()}
        self.peak, self.steps = lr, steps
        self.warmup = min(warmup, max(steps // 2, 1))
        self.dropout, self.label_smoothing = dropout, label_smoothing
        decay = [v for v in self.params.values() if v.ndim > 1]
        rest = [v for v in self.params.values() if v.ndim <= 1]
        self.opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": weight_decay},
             {"params": rest, "weight_decay": 0.0}],
            lr=0.0, betas=(0.9, 0.98), eps=1e-8)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.count = 0

    def lr(self, count: int) -> float:
        return warmup_cosine_lr(count, self.peak, self.warmup, self.steps)

    def backward(self, src: np.ndarray, tgt: np.ndarray) -> torch.Tensor:
        """The batch's loss, its gradients left in the parameters'
        ``.grad``; no update."""
        s = torch.from_numpy(np.asarray(src, np.int64)).to(self.device)
        t = torch.from_numpy(np.asarray(tgt, np.int64)).to(self.device)
        loss = g2p_loss(self.params, s, t, self.xp, self.dropout,
                        self.gen if self.dropout > 0 else None,
                        self.label_smoothing)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    def update(self):
        """One AdamW update from the gradients in ``.grad``, at the rate
        of the count of updates before it."""
        rate = self.lr(self.count)
        for group in self.opt.param_groups:
            group["lr"] = rate
        self.opt.step()
        self.count += 1

    def step(self, src: np.ndarray, tgt: np.ndarray) -> torch.Tensor:
        loss = self.backward(src, tgt)
        self.update()
        return loss

    def numpy_params(self) -> Dict[str, np.ndarray]:
        """A copy of the parameters as numpy arrays (on the CPU a view
        would follow later updates)."""
        return {k: np.array(v.detach().cpu()) for k, v in self.params.items()}


def evaluate_neural(params_np, lexicon, batch: int = 128):
    """Neural-only (PER, word accuracy, words too long to encode), stress
    insensitive, through the same numpy greedy decode serving uses."""
    from efficientspeech_tpu_torch.text.g2p_eval import (
        edit_distance, strip_stress)

    words = [w for w in lexicon if M.encode_word(w) is not None]
    total_d = total_ref = exact = 0
    for i in range(0, len(words), batch):
        chunk = words[i: i + batch]
        src = np.stack([M.encode_word(w) for w in chunk])
        toks, _ = M.greedy_decode(params_np, src)
        for j, w in enumerate(chunk):
            pred = strip_stress(M.tokens_to_phones(toks[j]))
            ref = strip_stress(lexicon[w])
            d = edit_distance(pred, ref)
            total_d += d
            total_ref += len(ref)
            exact += d == 0
    skipped = len(lexicon) - len(words)
    return (total_d / max(total_ref, 1), exact / max(len(lexicon), 1),
            skipped)


def save_npz(path: str, params_np, meta: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta=np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8),
             **{f"p_{k}": v for k, v in params_np.items()})


def main(argv=None):
    args = get_args(argv)
    from efficientspeech_tpu_torch.device import resolve_device, set_full_f32
    from efficientspeech_tpu_torch.text import g2p_data as D
    from efficientspeech_tpu_torch.text.g2p_eval import load_eval_lexicon

    device = resolve_device(args.device)
    set_full_f32()
    pairs = D.build_pairs(gold_repeat=args.gold_repeat,
                          n_compounds=args.n_compounds,
                          n_prefixed=args.n_prefixed, seed=args.seed,
                          include_blind4=args.include_blind4)
    src, tgt = D.encode_pairs(pairs)
    n = len(src)
    print(f"training pairs: {n} rows "
          f"({sum(1 for _, _, g in pairs if g)} gold rows, "
          f"{len({w for w, _, _ in pairs})} unique words)")

    params = M.init_params(args.seed)
    print(f"model: {M.n_params(params)} params "
          f"(d={M.D_MODEL}, enc={M.N_ENC}, dec={M.N_DEC}) on {device}")
    trainer = G2pTrainer(params, args.steps, lr=args.lr, warmup=args.warmup,
                         weight_decay=args.weight_decay,
                         dropout=args.dropout,
                         label_smoothing=args.label_smoothing,
                         seed=args.seed, device=device)

    eval_set = repo_path(args.eval_set)
    val_lex = load_eval_lexicon(eval_set)
    rng_np = np.random.default_rng(args.seed)
    perm = rng_np.permutation(n)
    cursor = 0
    best = {"acc": -1.0, "per": 1.0, "step": 0}
    logf = open(args.log, "a") if args.log else None
    t0 = time.time()
    try:
        for step in range(1, args.steps + 1):
            if cursor + args.batch_size > n:
                perm = rng_np.permutation(n)
                cursor = 0
            idx = perm[cursor: cursor + args.batch_size]
            cursor += args.batch_size
            loss = trainer.step(src[idx], tgt[idx])

            if step % args.eval_every == 0 or step == args.steps:
                params_np = trainer.numpy_params()
                per, acc, skipped = evaluate_neural(params_np, val_lex)
                line = {"step": step, "loss": round(float(loss), 4),
                        "val_per": round(per, 4), "val_acc": round(acc, 4),
                        "val_skipped_long": skipped,
                        "lr": round(trainer.lr(step), 6),
                        "elapsed_s": round(time.time() - t0, 1)}
                print(json.dumps(line), flush=True)
                if logf:
                    logf.write(json.dumps(line) + "\n")
                    logf.flush()
                if acc > best["acc"]:
                    best = {"acc": acc, "per": per, "step": step}
                    meta = {"d_model": M.D_MODEL, "n_enc": M.N_ENC,
                            "n_dec": M.N_DEC, "n_heads": M.N_HEADS,
                            "d_ff": M.D_FF, "max_src": M.MAX_SRC,
                            "max_tgt": M.MAX_TGT,
                            "val_set": os.path.basename(eval_set),
                            "val_acc": round(acc, 4),
                            "val_per": round(per, 4),
                            "step": step, "seed": args.seed,
                            "n_params": M.n_params(params_np)}
                    save_npz(args.out, params_np, meta)
                    print(f"  saved {args.out} (val acc {acc:.4f})")
    finally:
        if logf:
            logf.close()

    print(f"best: step {best['step']} val_acc {best['acc']:.4f} "
          f"val_per {best['per']:.4f}")
    return best


if __name__ == "__main__":
    main()
