"""Operations and bytes that the model's definition needs, counted from
shapes, and the published peaks of one NVIDIA H100 SXM they are held
against.

A FLOP count is 2 per multiply-add of a linear map, convolution or
attention product; elementwise work is left out of the model counts.
Only valid positions count (phonemes of the text, frames of its mel,
samples of its waveform): padding and speculative frames are work the
inputs do not need.  The counts follow the layer definitions of
EfficientSpeech and of HiFi-GAN's convolutional generator, whatever
layout a program computes them in.
"""

from typing import Dict, List

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3


def bound_s(tc_flops: float, f32_flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    over their peak (tensor-core and CUDA-core work side by side) and the
    bytes over the memory rate."""
    return max(tc_flops / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS,
               nbytes / PEAK_BYTES)


def _geometry(cfg: dict, n: int):
    small = cfg["embed_dim"] // cfg["reduction"]
    dims_in = [cfg["embed_dim"]] + [small * 2 ** i
                                    for i in range(cfg["depth"] - 1)]
    dims_out = [small * 2 ** i for i in range(cfg["depth"])]
    lengths, cur = [], n
    for i in range(cfg["depth"]):
        k = cfg["kernel_size"] - (2 if i else 0)
        stride = 1 if i == 0 else 2
        cur = (cur + 2 * (k // 2) - k) // stride + 1
        lengths.append(max(cur, 0))
    return dims_in, dims_out, lengths


def acoustic_phoneme_flops(cfg: dict, n: int) -> float:
    """Forward FLOPs of the phoneme-rate part (encoder, fusion, the three
    variance predictors) for one text of ``n`` phonemes."""
    dim = cfg["embed_dim"] // cfg["reduction"]
    dims_in, dims_out, lengths = _geometry(cfg, n)
    total = 0.0
    for i, (di, do, li) in enumerate(zip(dims_in, dims_out, lengths)):
        k = cfg["kernel_size"] - (2 if i else 0)
        h = cfg["head"] * (i + 1)
        hid = do * cfg["expansion"]
        total += li * (2 * di * di * k + 2 * di * do)          # merge convs
        total += li * (2 * do * 3 * h * do + 2 * h * do * do)  # qkv, proj
        total += 4 * h * do * li * li                          # QK^T, AV
        total += li * (2 * do * hid + 2 * hid * hid * 3 + 2 * hid * do)
        total += li * 2 * do * dim                             # fuse mlp_i
        up = do // dim
        if up > 1:
            total += li * 2 * dim * dim * cfg["kernel_size"]   # upsample_i
    total += n * 2 * dim * cfg["depth"] * dim                  # fuse
    total += 3 * n * (2 * 2 * dim * dim * 3 + 2 * dim)         # predictors
    return total


def decoder_width(cfg: dict) -> int:
    return min(4 * (cfg["embed_dim"] // cfg["reduction"]), 256)


def acoustic_frame_flops(cfg: dict) -> float:
    """Forward FLOPs of the mel decoder for one valid frame."""
    dim = cfg["embed_dim"] // cfg["reduction"]
    c = decoder_width(cfg)
    k = cfg["decoder_kernel_size"]
    blocks = cfg["n_blocks"] * cfg["block_depth"]
    return (2 * 4 * dim * c + blocks * (2 * c * k + 2 * c * c)
            + 2 * c * cfg["n_mel_channels"])


def _mrf_taps(hcfg: dict) -> int:
    """Convolution taps a sample passes through in one stage's MRF:
    every kernel's two convolutions per dilation."""
    return sum(2 * k * len(d) for k, d in
               zip(hcfg["resblock_kernel_sizes"],
                   hcfg["resblock_dilation_sizes"]))


def mrf_stages(hcfg: dict) -> List[Dict]:
    """Per upsampling stage of the generator: its channels, output samples
    per mel frame, and the MRF's FLOPs per output sample (2·C²·taps;
    252·C² for LJ_V2's kernels 3·7·11 at dilations 1·3·5)."""
    out, c, spf = [], hcfg["upsample_initial_channel"], 1
    for u in hcfg["upsample_rates"]:
        c //= 2
        spf *= u
        out.append({"channels": c, "samples_per_frame": spf,
                    "flops_per_sample": 2.0 * c * c * _mrf_taps(hcfg)})
    return out


def generator_frame_flops(hcfg: dict) -> float:
    """FLOPs of the convolutional generator for one valid mel frame."""
    c = hcfg["upsample_initial_channel"]
    total = 2.0 * hcfg["num_mels"] * c * 7                      # conv_pre
    spf = 1
    for u, k, st in zip(hcfg["upsample_rates"],
                        hcfg["upsample_kernel_sizes"], mrf_stages(hcfg)):
        total += spf * 2.0 * c * (c // 2) * k                   # up_i
        spf *= u
        c //= 2
        total += spf * st["flops_per_sample"]                   # MRF
    total += spf * 2.0 * c * 7                                  # conv_post
    return total


def synthesis_flops(cfg: dict, hcfg: dict, phonemes: int,
                    frames: int) -> float:
    """Text → waveform forward FLOPs of one text."""
    return (acoustic_phoneme_flops(cfg, phonemes)
            + frames * (acoustic_frame_flops(cfg)
                        + generator_frame_flops(hcfg)))


def mrf_bound_s(hcfg: dict, frames: int) -> float:
    """K2's least time for one row of ``frames`` valid mel frames: per
    stage, the MRF's bf16 products over the tensor-core peak, or its input
    and output activations (float32) over the memory rate, whichever is
    larger; stages add."""
    taps = _mrf_taps(hcfg)
    total = 0.0
    for st in mrf_stages(hcfg):
        c, s = st["channels"], st["samples_per_frame"] * frames
        convs = 2 * sum(len(d) for d in hcfg["resblock_dilation_sizes"])
        w_bytes = taps * c * c * 2 + convs * c * 4
        total += bound_s(st["flops_per_sample"] * s, 0.0,
                         2 * c * s * 4 + w_bytes)
    return total
