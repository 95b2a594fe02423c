"""What the synthesis cells share: the measured synthesizer built on the
benchmark's weights, a record of each batch the timed path ran, the
profiled stretch, and the judgement of a sample of served texts by the
plain reference."""

import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import model as ref
from perfbench.reference.frontend import phoneme_ids, read_lexicon
from perfbench.reference.precision import Precision, reference_mode
from perfbench.yardstick import work
from perfbench.yardstick.traffic import TextMaker, lexicon_path
from perfbench.yardstick.weights import make_weights


def port_overrides(cfg: Dict) -> Dict:
    """The configuration's model sizes as the port's ``ModelConfig``
    fields."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["model"].items()}


def hifigan_config(cfg: Dict):
    from efficientspeech_tpu_torch.config import HifiGanConfig

    h = dict(cfg["hifigan"])
    h["resblock_dilation_sizes"] = tuple(map(tuple,
                                             h["resblock_dilation_sizes"]))
    return HifiGanConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in h.items()})


def build_synth(cell, seed: int, device):
    """(synthesizer, the weights it was built on): the port's model with
    the benchmark's weights, served as the configuration states."""
    from efficientspeech_tpu_torch.config import PreprocessConfig
    from efficientspeech_tpu_torch.infer import Synthesizer, build_model

    cfg = cell.config
    model = build_model(cfg["preset"], model_overrides=port_overrides(cfg),
                        hifigan_cfg=hifigan_config(cfg))
    weights = make_weights({k: tuple(v.shape) for k, v in
                            model.state_dict().items()}, seed, device,
                           cfg.get("duration_bias"))
    model.load_state_dict({k: v.cpu() for k, v in weights.items()})
    serving = cfg["serving"]
    synth = Synthesizer(
        model.cfg, model.hifigan_cfg, model,
        preprocess_cfg=PreprocessConfig(
            lexicon_path=lexicon_path(cell.root, cell.mix)),
        dtype=getattr(torch, serving["dtype"]),
        vocoder_mode=serving["vocoder_mode"],
        transfer=serving["transfer"], device=device)
    return synth, weights


class BatchRecorder:
    """Keeps, for each batch the timed path ran, its texts, start and end,
    and references to the phoneme ids and the continuous pitch, energy and
    duration predictions of the acoustic model's last run (the one whose
    audio was returned).  It reads them by a forward hook on the
    synthesizer's acoustic model (``synth.acoustic``) and wraps
    ``tts_batch``; it adds no device work.

    The program returns none of its discrete choices, so the reference
    reads them here.  A ``tts_batch`` during which the acoustic model ran
    no forward (a program that replays a captured graph, say) leaves
    nothing to judge by, and raises."""

    def __init__(self, synth):
        self.batches: List[Dict] = []
        self._last = None
        self._runs = 0
        tts_batch = synth.tts_batch

        def hook(module, args, kwargs, pred):
            frames = kwargs.get("max_mel_len",
                                args[2] if len(args) > 2 else None)
            self._last = (args[0], pred["pitch"], pred["energy"],
                          pred["duration"], frames)
            self._runs += 1

        def _tts_batch(texts):
            runs, t0 = self._runs, time.time()
            outs = tts_batch(texts)
            t1 = time.time()
            if self._runs == runs:
                raise RuntimeError(
                    "tts_batch ran no forward of synth.acoustic: the "
                    "benchmark reads the program's pitch, energy and "
                    "duration choices there")
            self.batches.append({"texts": list(texts), "t0": t0, "t1": t1,
                                 "acoustic": list(self._last[:4]),
                                 "frames": self._last[4],
                                 "mel_len": [o[1]["mel_len"] for o in outs]})
            return outs

        synth.acoustic.register_forward_hook(hook, with_kwargs=True)
        synth.tts_batch = _tts_batch

    def judged_item(self, batch: Dict, row: int, text: str,
                    wav: np.ndarray) -> Dict:
        """What the timed path produced for one text of a batch (its row
        is its index, the texts being shorter than the largest bucket)."""
        _, pitch, energy, duration = batch["acoustic"]
        ids = ids_of(batch, row)
        n = len(ids)
        take = lambda t: (t[row, :n, 0].float().cpu().numpy() if n
                          else np.zeros(0, np.float32))
        return {"text": text, "ids": ids, "pitch": take(pitch),
                "energy": take(energy), "duration": take(duration),
                "wav": np.asarray(wav, np.float32)}


def ids_of(batch: Dict, row: int) -> np.ndarray:
    """The phoneme ids the acoustic model ran for one row of a batch (none
    where it ran fewer rows)."""
    phoneme = batch["acoustic"][0]
    if not isinstance(phoneme, np.ndarray):
        phoneme = batch["acoustic"][0] = phoneme.cpu().numpy()
    if row >= len(phoneme):
        return phoneme[:0, 0]
    return phoneme[row][phoneme[row] != 0]


def unserved_item(text: str, wav: np.ndarray) -> Dict:
    """An answer that no recorded batch produced: it has no phoneme ids,
    which the judgement counts as a mismatch."""
    none = np.zeros(0, np.float32)
    return {"text": text, "ids": np.zeros(0, np.int64), "pitch": none,
            "energy": none, "duration": none, "wav": wav}


def synthesis_flops(cell, phonemes: List[int], frames: List[int]) -> float:
    cfg, h = cell.config["model"], cell.config["hifigan"]
    return sum(work.synthesis_flops(cfg, h, p, f)
               for p, f in zip(phonemes, frames))


# --- the reference's judgement ---------------------------------------------

def _interval_gap(x, lo, hi):
    return np.maximum(0.0, np.maximum(lo - x, x - hi))


def _choice_gap(judged: Dict, pred: Dict, tables: Dict) -> float:
    """The widest distance by which the reference's continuous prediction
    lies outside the interval that maps to the judged side's discrete
    choice: rounded durations in frames, pitch and energy buckets in
    bucket widths."""
    d = np.maximum(np.round(judged["duration"]), 0.0)
    x = pred["duration"]
    gaps = [_interval_gap(x, np.where(d == 0, -np.inf, d - 0.5), d + 0.5)]
    for k in ("pitch", "energy"):
        bins = tables[k].cpu().numpy().astype(np.float64)
        i = np.searchsorted(bins, judged[k], side="left")
        edges = np.concatenate([[-np.inf], bins, [np.inf]])
        width = bins[1] - bins[0]
        gaps.append(_interval_gap(pred[k], edges[i], edges[i + 1]) / width)
    return float(max(g.max(initial=0.0) for g in gaps))


@torch.no_grad()
def reference_items(P, cfg, hcfg, texts, lexicon, prec: Precision, device):
    """The reference computed at ``prec`` in the program's place: for each
    text its ids, continuous predictions and the waveform through the
    int16 wire."""
    out = []
    for text in texts:
        ids = torch.from_numpy(phoneme_ids(lexicon, text))[None].to(device)
        a = ref.acoustic(prec, P, cfg, ids, ids == 0, 16 * ids.shape[1])
        n = int(a["mel_len"][0])
        wav = ref.int16_wire(ref.generator(prec, P, hcfg,
                                           a["mel"][:, :n]))[0]
        out.append({"text": text, "ids": ids[0].cpu().numpy(),
                    **{k: a[k][0].float().cpu().numpy()
                       for k in ("pitch", "energy", "duration")},
                    "wav": wav.cpu().numpy()})
    return out


@torch.no_grad()
def judge_items(P, cfg, hcfg, items: List[Dict], lexicon, device):
    """The float32 reference against what a side produced for each text,
    with the per-text readings: phoneme ids (count of texts that differ),
    audio length (count of texts whose length is not the reference's for
    the same choices), the widest choice gap, and ``wav_err``: the
    waveform's distance from the float32 reference's on the same choices,
    in units of the distance at which the reference computed in bf16 (the
    configuration's precision: the acoustic model in bf16 throughout, the
    generator's products on bf16 operands and biases) and sent through the
    int16 wire lies from it.  With random weights the generator's output is
    mostly a pattern of its own that the text barely moves, and how much a
    rounding moves it depends on the weights: the unit holds that apart
    from the precision the product is computed in."""
    id_bad = len_bad = 0
    gap = err = 0.0
    per_item = []
    for it in items:
        ids = phoneme_ids(lexicon, it["text"])
        if len(ids) != len(it["ids"]) or (ids != it["ids"]).any():
            id_bad += 1
            continue
        t = torch.from_numpy(ids)[None].to(device)
        judged = {k: torch.from_numpy(it[k])[None].to(device)
                  for k in ("pitch", "energy", "duration")}
        frames = max(1, int(np.maximum(np.round(it["duration"]), 0).sum()))
        wavs = {}
        # (acoustic model, generator): float32; and bf16 as the
        # configuration serves, the acoustic model computing in bf16 and
        # the generator's products taking bf16 operands and biases
        for prec, (pa, pg) in {
                "float32": (Precision(), Precision()),
                "bf16": (Precision("bf16", acts=True),
                         Precision("bf16", biases=True))}.items():
            a = ref.acoustic(pa, P, cfg, t, t == 0, frames, judged=judged)
            n = int(a["mel_len"][0])
            wavs[prec] = ref.generator(pg, P, hcfg, a["mel"][:, :n])[0]
            if prec == "float32":
                pred = {k: a[k][0].cpu().numpy().astype(np.float64)
                        for k in ("pitch", "energy", "duration")}
                item_gap = _choice_gap(it, pred, a["tables"])
                gap = max(gap, item_gap)
        want = wavs["float32"]
        unit = (ref.int16_wire(wavs["bf16"]) - want).norm().clamp_min(1e-12)
        got = torch.from_numpy(it["wav"]).to(device)
        if got.shape != want.shape:
            len_bad += 1
            continue
        item_err = float((got - want).norm() / unit)
        err = max(err, item_err)
        per_item.append([len(ids), round(item_gap, 5), round(item_err, 4),
                         float(unit / want.norm())])
    return {"id_mismatch": id_bad, "len_mismatch": len_bad,
            "choice_gap": gap, "wav_err": err}, per_item


def judge(cell, weights, items: List[Dict], args, device):
    """(the float32 reference's numbers on what the timed path produced,
    {"control": the same numbers on the reference computed at
    ``--control``'s precision in the program's place, where asked})."""
    reference_mode()
    lexicon = read_lexicon(lexicon_path(cell.root, cell.mix))
    cfg, hcfg = cell.config["model"], cell.config["hifigan"]
    numbers, per_item = judge_items(weights, cfg, hcfg, items, lexicon,
                                    device)
    # each judged text: phonemes, choice gap, waveform error, the unit of
    # the waveform error relative to the reference waveform's norm
    print(json.dumps({"judged": per_item}), file=sys.stderr)
    extra = {}
    if args.control:
        ctrl = reference_items(weights, cfg, hcfg, [i["text"] for i in items],
                               lexicon, Precision(args.control), device)
        extra["control"], per_item = judge_items(weights, cfg, hcfg, ctrl,
                                                 lexicon, device)
        print(json.dumps({"judged_control": per_item}), file=sys.stderr)
    return numbers, extra


def text_maker(cell) -> TextMaker:
    return TextMaker(lexicon_path(cell.root, cell.mix),
                     cell.mix.get("pause_every", 8))


def release():
    """Return the freed program state's memory to the card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
