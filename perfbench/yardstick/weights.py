"""Random weights from a seed, made on the device in two draws (one
uniform, one normal) and sliced per parameter, float32 as the model
keeps its masters.  The rule by parameter: linear and convolution
weights and their biases uniform in ±1/√fan_in (fan_in: inputs × taps,
for a transposed convolution outputs × taps), embedding tables N(0, 1),
LayerNorm scale 1 and bias 0; the configuration may fix the duration
head's bias (``duration_bias``)."""

import math
from typing import Dict, Tuple

import torch

_TABLES = ("embed.weight", "pitch_embedding.weight",
           "energy_embedding.weight")
DURATION_BIAS = "phoneme2mel.encoder.duration_decoder.linear.bias"


def _kind(name: str, shapes: Dict[str, Tuple[int, ...]]):
    """("normal" | "uniform" | "one" | "zero", fan_in)."""
    if name.endswith(_TABLES):
        return "normal", 0
    owner = name.rsplit(".", 1)[0]
    leaf = name.rsplit(".", 1)[1]
    w = shapes.get(owner + ".weight")
    if "norm" in owner.rsplit(".", 1)[-1]:
        return ("one" if leaf == "weight" else "zero"), 0
    # (out, in) linear; (out, in/groups, k) convolution; (in, out, k)
    # transposed convolution, whose fan_in is out × k
    return "uniform", w[1] * (w[2] if len(w) == 3 else 1)


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
                 duration_bias=None) -> Dict[str, torch.Tensor]:
    kinds = {k: _kind(k, shapes) for k in shapes}
    count = lambda kind: sum(math.prod(shapes[k]) for k, (kk, _) in
                             kinds.items() if kk == kind)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    pools = {"uniform": torch.rand(count("uniform"), generator=gen,
                                   device=device),
             "normal": torch.randn(count("normal"), generator=gen,
                                   device=device)}
    at = {"uniform": 0, "normal": 0}
    out = {}
    for k, shape in shapes.items():
        kind, fan_in = kinds[k]
        n = math.prod(shape)
        if kind in pools:
            v = pools[kind][at[kind]: at[kind] + n].view(shape)
            at[kind] += n
            if kind == "uniform":
                bound = 1.0 / math.sqrt(fan_in)
                v = (v * 2.0 - 1.0) * bound
            out[k] = v.clone()
        else:
            out[k] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                device=device)
    if duration_bias is not None and DURATION_BIAS in out:
        out[DURATION_BIAS].fill_(float(duration_bias))
    return out
