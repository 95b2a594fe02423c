"""Polyphase-folded HiFi-GAN generator: the whole vocoder as frame-rate
matmuls (counterpart of the JAX package's ``models/hifigan_folded.py``).

In the folded layout ``x_f[t, s·C + c] = x_long[t·r + s, c]`` (r samples
per row), a conv (or a transposed conv with k − 2·pad = stride) becomes

    y[t] = concat(x[t−w], ..., x[t+w]) @ W_folded + b_folded

with W_folded built exactly by scattering the original weights.  Masking
is row-level: validity boundaries are frame-aligned, so the valid region
equals the conv generator's.  With ``use_kernel`` the ops whose input is
a multiple of 128 wide run in the CUDA kernels (``ops/kernels``): the
upsamplers and the post conv in ``folded_matmul``, and with ``fuse_mrf``
each stage's MRF block in ``mrf_fused`` (on the card at the widths its
variants are built for: 128, and 256 in bf16).
"""

from typing import Dict, Optional

import torch

from efficientspeech_tpu_torch.config import HifiGanConfig
from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
from efficientspeech_tpu_torch.ops.kernels.folded_matmul import (
    folded_matmul, leaky, mask_rows, window)
from efficientspeech_tpu_torch.ops.kernels import mrf_block
from efficientspeech_tpu_torch.ops.kernels.mrf_block import (
    build_mrf_spec, mrf_fused)
from efficientspeech_tpu_torch.utils import spans

LRELU_SLOPE = 0.1

# the minimum-lane grid: every stage folds to D = C_s · g_s ≈ 128
D_TARGET_DEFAULT = 128


def _conv_entries(k: int, rate: int, dilation: int, padding: int):
    """Static (tap, p, off, q) scatter entries + window w for a conv fold:
    output sample o = t·rate + p reads s = p − padding + tap·dilation, i.e.
    frame t + off, phase q."""
    entries, offs = [], []
    for p in range(rate):
        for tap in range(k):
            s = p - padding + tap * dilation
            off = s // rate
            q = s - off * rate
            entries.append((tap, p, off, q))
            offs.append(off)
    return entries, max(abs(min(offs)), abs(max(offs)))


def _convt_entries(k: int, rate_in: int, stride: int, padding: int):
    """The same for a transposed conv: out[O] += x[J] · w[m] with
    m = O − stride·J + padding."""
    entries, offs = [], [0]
    for p in range(rate_in * stride):
        for m in range(k):
            num = p + padding - m
            if num % stride != 0:
                continue
            j = num // stride
            off = j // rate_in
            q = j - off * rate_in
            entries.append((m, p, off, q))
            offs.append(off)
    return entries, max(abs(min(offs)), abs(max(offs)))


def scatter_fold(w_kio: torch.Tensor, bias: torch.Tensor, entries, w: int,
                 rate_in: int, rate_out: int):
    """Scatter (k, C_in, C_out) weights into the folded
    ((2w+1)·C_in·rate_in, C_out·rate_out) matrix on w_kio's device."""
    k, c_in, c_out = w_kio.shape
    d_in, d_out = c_in * rate_in, c_out * rate_out
    dev = w_kio.device
    taps = torch.tensor([e[0] for e in entries], device=dev)
    rows0 = torch.tensor([(e[2] + w) * d_in + e[3] * c_in for e in entries],
                         device=dev)
    cols0 = torch.tensor([e[1] * c_out for e in entries], device=dev)
    R = rows0[:, None, None] + torch.arange(c_in, device=dev)[None, :, None]
    C = cols0[:, None, None] + torch.arange(c_out, device=dev)[None, None, :]
    vals = w_kio[taps]                                   # (E, C_in, C_out)
    W = torch.zeros(((2 * w + 1) * d_in, d_out), dtype=w_kio.dtype,
                    device=dev)
    W.index_put_((R.expand_as(vals), C.expand_as(vals)), vals,
                  accumulate=True)
    return W, bias.repeat(rate_out)


def make_grid_plan(cfg: HifiGanConfig, d_target: int = D_TARGET_DEFAULT):
    """Per-stage (channels, cumulative rate, samples per row g, rows per
    mel frame): g_s chosen so C_s · g_s ≈ d_target and g_s divides the
    stage rate."""
    ch, rate = [], []
    r = 1
    c0 = cfg.upsample_initial_channel
    for i, u in enumerate(cfg.upsample_rates):
        r *= u
        ch.append(c0 // (2 ** (i + 1)))
        rate.append(r)
    g = []
    for c_s, r_s in zip(ch, rate):
        gs = max(1, min(r_s, d_target // c_s))
        while r_s % gs:
            gs -= 1
        g.append(gs)
    rows_per_frame = [r_s // g_s for r_s, g_s in zip(rate, g)]
    return ch, rate, g, rows_per_frame


def fold_specs(cfg: HifiGanConfig, d_target: int = D_TARGET_DEFAULT):
    """The static plan: {key: (module path, entries, w, rate_in, rate_out,
    transposed)} plus meta (window widths, post-upsample row splits and the
    rows per mel frame at each op's output)."""
    _, _, g, rows_per_frame = make_grid_plan(cfg, d_target)
    specs, reshape, valid_mult = {}, {}, {}
    specs["pre"] = ("conv_pre", *_conv_entries(7, 1, 1, 3), 1, 1, False)
    valid_mult["pre"] = 1
    g_prev = 1
    for i, (u, kk) in enumerate(zip(cfg.upsample_rates,
                                    cfg.upsample_kernel_sizes)):
        e, w = _convt_entries(kk, g_prev, u, (kk - u) // 2)
        specs[f"up{i}"] = (f"up{i}", e, w, g_prev, g_prev * u, True)
        split = (g_prev * u) // g[i]
        if split * g[i] != g_prev * u or rows_per_frame[i] % split:
            raise ValueError(f"stage {i}: grid {g[i]} does not divide the "
                             f"upsampler's {g_prev * u} samples per row")
        reshape[f"up{i}"] = split
        # the up op masks before its row split
        valid_mult[f"up{i}"] = rows_per_frame[i] // split
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for m, d in enumerate(rd):
                rb = f"resblock_{i}_{j}"
                if cfg.resblock == "1":
                    specs[f"rb{i}_{j}_c1_{m}"] = (
                        f"{rb}.conv1_{m}",
                        *_conv_entries(rk, g[i], d, (rk * d - d) // 2),
                        g[i], g[i], False)
                    specs[f"rb{i}_{j}_c2_{m}"] = (
                        f"{rb}.conv2_{m}",
                        *_conv_entries(rk, g[i], 1, (rk - 1) // 2),
                        g[i], g[i], False)
                    valid_mult[f"rb{i}_{j}_c1_{m}"] = rows_per_frame[i]
                    valid_mult[f"rb{i}_{j}_c2_{m}"] = rows_per_frame[i]
                else:  # "2": one residual conv per dilation
                    specs[f"rb{i}_{j}_c_{m}"] = (
                        f"{rb}.conv_{m}",
                        *_conv_entries(rk, g[i], d, (rk * d - d) // 2),
                        g[i], g[i], False)
                    valid_mult[f"rb{i}_{j}_c_{m}"] = rows_per_frame[i]
        g_prev = g[i]
    specs["post"] = ("conv_post", *_conv_entries(7, g[-1], 1, 3),
                     g[-1], g[-1], False)
    valid_mult["post"] = rows_per_frame[-1]
    meta = {"widths": {k: v[2] for k, v in specs.items()},
            "reshape": reshape, "valid_mult": valid_mult}
    return specs, meta


def fold_hifigan(generator: HifiGanGenerator, dtype=torch.bfloat16,
                 d_target: int = D_TARGET_DEFAULT):
    """Generator → ({key: (W, b)}, meta), folded on the generator's
    device.  The original kernels are cast to ``dtype`` before folding
    (the matmul operand precision), as the JAX package does."""
    specs, meta = fold_specs(generator.cfg, d_target)
    arrays = {}
    with torch.no_grad():
        for key, (path, entries, w, r_in, r_out, transposed) in specs.items():
            mod = generator.get_submodule(path)
            # torch layouts → (k, C_in, C_out)
            kio = (mod.weight.permute(2, 0, 1) if transposed
                   else mod.weight.permute(2, 1, 0))
            arrays[key] = scatter_fold(kio.to(dtype), mod.bias.to(dtype),
                                       entries, w, r_in, r_out)
    return arrays, meta


# folded_matmul takes D_out in multiples of this
KERNEL_COLS = 16


def prepare_for_kernels(arrays: Dict, meta, cfg: HifiGanConfig):
    """The weights in the layout the kernels take, made once: W
    contiguous, b as float32 (its values stay those of the fold's dtype),
    the post conv's W and b padded with zero columns to a multiple of
    KERNEL_COLS (V1's and V3's 4 samples a row; ``folded_plan_apply``
    drops them), and each stage's stacked MRF spec (resblock "1" only)."""
    kernel_arrays = {k: (W.contiguous(), b.float().contiguous())
                     for k, (W, b) in arrays.items()}
    W, b = kernel_arrays["post"]
    pad = -W.shape[1] % KERNEL_COLS
    if pad:
        kernel_arrays["post"] = (
            torch.nn.functional.pad(W, (0, pad)).contiguous(),
            torch.nn.functional.pad(b, (0, pad)).contiguous())
    mrf = {}
    if cfg.resblock == "1":
        for i in range(len(cfg.upsample_rates)):
            chains, W_all, b_all, H = build_mrf_spec(
                kernel_arrays, meta["widths"], i,
                cfg.resblock_dilation_sizes)
            mrf[i] = (chains, W_all.contiguous(), b_all.contiguous(), H)
    return kernel_arrays, mrf


def _folded_apply(x: torch.Tensor, W: torch.Tensor, b: torch.Tensor, w: int,
                  dtype) -> torch.Tensor:
    """x (B, T, D_in) → (B, T, D_out) float32: the window matmul with its
    operands rounded to ``dtype`` and float32 products and sums."""
    win = torch.stack([window(xi, w) for xi in x])
    return (win.to(dtype).float() @ W.to(dtype).float()
            + b.to(dtype).float())


def folded_plan_apply(arrays: Dict, meta, cfg: HifiGanConfig,
                      mel: torch.Tensor,
                      valid_len: Optional[torch.Tensor] = None,
                      dtype=torch.bfloat16,
                      use_kernel: bool = False,
                      fuse_stage_sum: bool = True,
                      act_dtype=None,
                      fuse_mrf: bool = False,
                      mrf: Optional[Dict] = None) -> torch.Tensor:
    """mel (B, T, num_mels) → wav (B, T · total_upsample), equal to the
    conv generator with row-level masking.

    ``dtype``: matmul operand precision (the plain path rounds operands
    to it and multiplies in float32).  ``use_kernel``: the 128-wide ops
    run through ``folded_matmul``, one row of the batch at a time;
    ``fuse_stage_sum`` then
    folds each stage's resblock sum and ``/ num_kernels`` into the last
    conv of each resblock; ``fuse_mrf`` runs each stage's whole MRF in
    ``mrf_fused`` (resblock "1").  ``act_dtype``: activation dtype between
    kernel ops (float32 by default; the CUDA kernels take float32
    activations, and weights in ``dtype``, bf16 or float32, which selects
    the kernels' variant).
    ``mrf``: the per-stage MRF specs from ``prepare_for_kernels``, built
    here when not given.  ``valid_len`` (B,) int on mel's device."""
    widths, reshape = meta["widths"], meta["reshape"]
    valid_mult = meta["valid_mult"]
    num_kernels = len(cfg.resblock_kernel_sizes)
    x = mel.float()
    act_dtype = torch.float32 if act_dtype is None else act_dtype
    if use_kernel and x.shape[0] > 1:
        # the kernels take one utterance: the whole plan runs row by row,
        # as the JAX package maps it over the rows (jax.lax.map); each
        # row's valid length stays a tensor on the card.  A span a row
        # names the host's time in a trace (a span over the whole loop
        # lies too far back among the host's ops for a reader to find)
        rows = []
        for i in range(x.shape[0]):
            with spans.span("synth.vocoder.row", row=i):
                rows.append(folded_plan_apply(
                    arrays, meta, cfg, mel[i:i + 1],
                    None if valid_len is None else valid_len[i:i + 1],
                    dtype, use_kernel, fuse_stage_sum, act_dtype, fuse_mrf,
                    mrf))
        return torch.cat(rows)
    if valid_len is None:
        valid_len = torch.full((x.shape[0],), x.shape[1], device=x.device)
    vrows_cache = {}

    def vrows_for(mult):
        # valid rows at one grid, as a device int32 (never read on the host)
        if mult not in vrows_cache:
            vrows_cache[mult] = (valid_len * mult).to(torch.int32)
        return vrows_cache[mult]

    def apply_op(inp, key, pre_lrelu, slope=LRELU_SLOPE, residual=None,
                 accum=None, out_scale=None, cols=None):
        W, bb = arrays[key]
        w = widths[key]
        if cols is not None and inp.device.type != "cuda":
            # the plain versions need no padded columns
            W, bb = W[:, :cols], bb[:cols]
        vrows = vrows_for(valid_mult[key])
        d_in = W.shape[0] // (2 * w + 1)
        # the mel input op (d_in = 80) stays a plain matmul, as in the
        # JAX package
        if use_kernel and d_in % 128 == 0:
            out = folded_matmul(
                inp[0].to(act_dtype), W.to(dtype), bb.float(), w, vrows,
                residual=None if residual is None
                else residual[0].to(act_dtype),
                accum=None if accum is None else accum[0].to(act_dtype),
                out_scale=out_scale, pre_lrelu=pre_lrelu,
                lrelu_slope=slope)[None]
        else:
            src = leaky(inp, slope) if pre_lrelu else inp
            out = _folded_apply(src, W, bb, w, dtype)
            if residual is not None:
                out = out + residual
            if accum is not None:
                out = out + accum
            if out_scale is not None:
                out = out * out_scale
            out = torch.stack([mask_rows(o, v) for o, v in zip(out, vrows)])
        if cols is not None:
            out = out[..., :cols]
        split = reshape.get(key, 1)
        if split > 1:
            bb_, t_, d_ = out.shape
            out = out.reshape(bb_, t_ * split, d_ // split)
        return out

    fuse_sum = fuse_stage_sum and use_kernel
    x = apply_op(x, "pre", pre_lrelu=False)
    for i in range(len(cfg.upsample_rates)):
        x = apply_op(x, f"up{i}", pre_lrelu=True)
        width = x.shape[2]
        if (fuse_mrf and use_kernel and cfg.resblock == "1"
                and width % 128 == 0
                and (x.device.type != "cuda"
                     or mrf_block.supports(width, dtype))):
            if width == mrf_block.WIDE_D:
                spans.count("synth.vocoder.wide_rows", x.shape[0])
            if mrf is None:
                chains, W_all, b_all, H = build_mrf_spec(
                    arrays, widths, i, cfg.resblock_dilation_sizes)
                W_all, b_all = W_all.to(dtype), b_all.float()
            else:
                chains, W_all, b_all, H = mrf[i]
            x = mrf_fused(x[0].to(act_dtype), chains, W_all, b_all, H,
                          vrows_for(valid_mult[f"rb{i}_0_c1_0"]),
                          num_kernels)[None]
            continue
        xs = None
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            v = x
            for m in range(len(rd)):
                last = fuse_sum and m == len(rd) - 1
                scale = (1.0 / num_kernels
                         if last and j == num_kernels - 1 else None)
                acc = xs if (last and xs is not None) else None
                if cfg.resblock == "1":
                    t1 = apply_op(v, f"rb{i}_{j}_c1_{m}", pre_lrelu=True)
                    v = apply_op(t1, f"rb{i}_{j}_c2_{m}", pre_lrelu=True,
                                 residual=v, accum=acc, out_scale=scale)
                else:  # "2": v = conv(lrelu(v)) + v per dilation
                    v = apply_op(v, f"rb{i}_{j}_c_{m}", pre_lrelu=True,
                                 residual=v, accum=acc, out_scale=scale)
            xs = v if (xs is None or fuse_sum) else xs + v
        x = xs if fuse_sum else xs / num_kernels
    # the final activation uses torch's default slope 0.01; the post conv
    # gives one sample a channel of the last stage's row
    x = apply_op(x, "post", pre_lrelu=True, slope=0.01,
                 cols=x.shape[2] // (cfg.upsample_initial_channel
                                     >> len(cfg.upsample_rates)))
    x = torch.tanh(x.float())
    b_, t_, d_ = x.shape
    return x.reshape(b_, t_ * d_)


def kernel_op_shapes(cfg: HifiGanConfig, frames: int,
                     d_target: int = D_TARGET_DEFAULT):
    """The (key, T, D_in, D_out, w) of every op the kernel path sends to
    ``folded_matmul`` for ``frames`` mel frames, and the (stage, T) of
    every ``mrf_fused`` launch (resblock "1")."""
    specs, meta = fold_specs(cfg, d_target)
    _, _, g, rows_per_frame = make_grid_plan(cfg, d_target)
    ops, rows, mrf = [], frames, []
    ch_in = cfg.upsample_initial_channel
    for i, u in enumerate(cfg.upsample_rates):
        key = f"up{i}"
        _, _, w, r_in, r_out, _ = specs[key]
        c_out = ch_in // 2
        ops.append((key, rows, ch_in * r_in, c_out * r_out, w))
        rows = frames * rows_per_frame[i]
        if cfg.resblock == "1":
            mrf.append((i, rows))
        ch_in = c_out
    _, _, w, r_in, r_out, _ = specs["post"]
    ops.append(("post", rows, ch_in * r_in, r_out, w))
    return [op for op in ops if op[2] % 128 == 0], mrf
