#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. device  - a CUDA card must be present; prints nvidia-smi's name and
               power limit; TF32 is switched off for cuBLAS and cuDNN;
  2. build   - compiles the CUDA kernels of csrc/ with nvcc, in parallel,
               and prints the registers and spills (-Xptxas -v) of the
               kernels of folded_matmul.cu, mrf_block.cu,
               decoder_block.cu and adpcm_encode.cu (a spill or a
               serialised wgmma in
               mrf_block.cu or in any of K4's kernels fails the phase);
  3. K1      - folded_matmul at the main path's shapes for 2,048 mel frames
               (+ one w = 13 case with residual, accum and out_scale),
               against its plain PyTorch version, with CUDA-event timings of
               the kernel, the plain version and a library yardstick (the
               main path's ops also with the L2 cache flushed before each
               call);
  4. K2      - mrf_fused for the four vocoder stages at 2,048 frames, the
               same way, each with its tile plan (bf16: the tile, the
               weight ring's slots and each conv's wgmma N);
     V1      - EfficientSpeech base with HiFi-GAN V1 in bf16: K1 at V1's
               first upsampler (D_in 512) and padded post conv, K2's wide
               kernel at its 256-wide stage 0 (which has to beat the
               plain version's time), each at one row of 4,096 frames
               against its plain version; a tts_batch of 8 long texts on
               the kernel route (launches, wide rows), two of its rows
               held to the plain route;
  5. slice   - the synthesizer (tiny acoustic model, LJ_V2-width vocoder,
               random weights from seed 0, bf16, vocoder_mode
               "folded_kernel"): one long request (>= 2,048 speculative
               frames, so the kernels engage) and three short ones, with
               launch counts, a check of every waveform, and the long
               request held against the plain vocoder route;
     batch   - tts_batch on the adpcm3 wire: 128 copies of the long text
               (K1 5 and K2 4 launches a row through the kernel route's
               row loop, one ADPCM encode) and a mixed batch of the long
               and short texts, each row held to its text's single
               request on the same wire, with wall time and voice seconds;
     stream  - tts_stream of the long text (segment count, each finite),
               and the long request in vocoder_mode "chunked" held to the
               folded kernel route at the end-to-end bar;
     serve   - the port's server (efficientspeech_tpu_torch.serve) in this
               process on 127.0.0.1, warmed by the function its main()
               runs (503 until ready, the time to ready): a long /tts
               through the batcher and the direct path (K1 5 and K2 4
               launches inside the request), 32 clients of 4 mixed
               requests (latency percentiles, served RTF, batch sizes),
               /tts_stream (chunks, first audio), the adpcm4 wire through
               the C++ decoder, and the fetch deadline behind a stream
               stalled by torch.cuda._sleep (503, the breaker's fast 503,
               the abandoned read counted, recovery); every PCM held to
               its text's single request at the batch bar (the adpcm4
               answer to the int16 one at the codec's bar);
     vocoder - (after the reference, preprocess and validate phases)
               vocoder training in float32, TF32 off: the LJ_V2-width
               generator with the full MPD and MSD from seed 0, the first
               GAN step at batch 1 held to the same step on the CPU, 10
               steps at batch 8 x 8,192 samples (median step, peak
               memory, a trace of two), then python -m
               efficientspeech_tpu_torch.train_vocoder --from-acoustic on
               the preprocessed corpus from the validate phase's
               checkpoint with a holdout (before and after metrics, the
               eval's wall), its teacher-forced pairs' forward (K3 and K4
               float32 forward, counted) held to the plain route;
     export  - python -m efficientspeech_tpu_torch.convert on the card from
               the reference phase's files: --precision bf16 --export,
               then float32 --export --torchscript --onnx --output, at
               --insize 128 (sizes, the .onnx file's structure); the
               torch.export and TorchScript programs loaded back on the
               card and held to eager EfficientSpeech.predict there, the
               float32 ones also to the CPU's predict, and the exported
               float32 waveform to the serving kernel route's (K1 5, K2 4
               launches, the f32 wire) on the same padded phonemes; ms a
               call of each beside eager predict and the serving route;
     g2p     - python -m efficientspeech_tpu_torch.train_g2p on the card at
               its defaults for 300 steps into a temp dir (the pairs count,
               its eval lines), the written .npz decoded through NeuralG2p
               to the logged accuracy; the median step at batch 256 and a
               traced step's idle share; three dropout-0 steps (the first
               at rate 0, then at 1e-3) held to the same steps on the CPU:
               losses, the first step's gradients, and AdamW's moves from
               the same gradients;
  6. f32     - phases 3-5 again for a float32 synthesizer (the same model,
               folded in float32: --precision f32), through the kernels'
               float32 variants, with one long and one short request, and
               a batch of 4 long requests; first the reference phase for
               it, held to its seed build at the float32 bar;
     ADPCM   - the ADPCM encoder (csrc/adpcm_encode.cu) against its plain
               version, bit-equal, for 4, 3 and 2 bits at the long
               request's and the batch's shapes, with times and its byte
               bound; a speech-like signal through each wire at the JAX
               tests' SNR bars;
  7. K3      - layer_norm_fused forward and backward at the training shape
               (131,072 rows of C) against the plain version, with
               F.layer_norm and its autograd backward as the yardstick,
               for C = 128 (tiny) and C = 256 (small, base), in bf16 and
               in float32;
  8. K4      - decoder_block_fused forward and backward at (128, 1024, C)
               with about 1/6 of the frames masked, the same way, for
               C = 128 (tiny) and C = 256 (small, base), in bf16 and in
               float32 (each kernel with its tile plan);
  9. K5      - int8_window_matmul, bf16 input with tile quantisation and
               int8 input, at the int8 probe's shape (T 49,152, 128 -> 128,
               5 taps, tm 512) against its plain version, with
               torch._int_mm on the materialised window as the yardstick
               (also with the L2 cache flushed before each call);
               then the probe entry point (probes/int8_window.py) once,
               K5's main path, with its launches counted;
 10. train   - the acoustic Trainer (batch 128, 128 phonemes, 1,024
               frames, random init from seed 0) on a synthetic
               preprocessed corpus of 20 batches written from a seed, for
               the tiny preset (C = 128) and then the small preset
               (C = 256), in bf16 and then in float32: two epochs (40
               steps) each, with the launches of the dtype's K3 and K4
               variants counted per step (tiny 3 + 3 and 4 + 4, small
               4 + 4 and 6 + 6; no other variant may run), the median step
               time inside each epoch (the first reads the corpus from
               disk, the second from the loader's memory cache) and the
               cost of the epoch boundary, finite losses, the loss falling
               over repeated steps on one batch, and the kernel route's
               loss and gradients held against the plain route's on one
               batch;
 device-data - the tiny bf16 trainer's first epoch on the device-resident
               corpus (--device-data), in single steps and in chunks of 4
               (--device-data-scan-steps 4), against the loader's path over
               the same rows: epoch losses, K3 and K4 launches, median
               step times and a trace of a step of each path;
 parallel    - ranks spawned by parallel.launch that share the card over
               gloo (NCCL refuses two ranks on one device), each held to
               one process on the same global work: (a) the tiny Trainer
               at train.py's defaults on 2 ranks, float32 and bf16, by the
               loader and on the device-resident corpus (losses, summed
               gradients, K3 and K4 launches on each rank); (b) the GAN
               step of the LJ_V2 generator with the full MPD and MSD at
               batch 8 x 8,192 on 2 ranks; (c) seq_parallel_vocode of the
               LJ_V2-width folded generator on 4,096 frames whose valid
               length ends in shard 0, float32 and bf16, on 2 ranks; (d) a
               2 x 2 data x tensor parallel float32 step on 4 ranks; (e) a
               step through an NCCL group of one rank; per-rank step ms,
               all-reduce ms and bytes;
 11. bench   - python -m efficientspeech_tpu_torch.bench --iter 5 --warmup
               2 --batch 16 in a process of its own, its lines printed;
               then --metric rtf --iter 2 --profile DIR, whose profile
               line (the device's busy ms and idle share over the timed
               runs) is checked and whose profiled numbers are not kept.
The kernel table goes on a JSON line before the last, 25 rows, each with
its dtype (the rows of kernels redesigned for Hopper also name the
design; float32 product bounds at the faster of FFMA's 67 TFLOP/s and
3xTF32 on the tensor cores, the FFMA-route bound printed beside; K1/K2 times per utterance at 2,048 frames, K1 at V1's up0 and
K2 wide per launch at 4,096 frames, K2 wide's bound from the MRF's useful
products, its fold's zero taps left out, K3/K4 times per
train step: the per-launch time × the launches of a step, tiny preset for
C = 128 and small for C = 256; K5 per call at the probe's shape; the
ADPCM encoder per call at the batch's shape, adpcm3); the last
line is {"ok": true, "device": {...}}.  With --profile, the slice, batch and
train phases also trace a long request, a batch of 128 long requests
(bf16) and a train step with torch.profiler and print where the device
time goes and the device's idle share.

Tolerances: the bf16 kernels multiply in bf16 with float32 accumulation
(the TPU's MXU arithmetic) while the plain versions multiply in float32,
so each is held to its plain version at SNR >= 35 dB (the bar the JAX
package's own folded-vocoder test sets), and rows at or beyond `valid`
must be exactly zero; every bf16 row but K5's is also held to a
regression floor a few dB under the figures the card gives it.  The
end-to-end waveform of the bf16 kernel route is held to the plain route's
(bf16 operands, float32 products) at SNR >= 30 dB.  K3 and K4 in bf16 are held to their plain versions (which follow the
TPU kernels op for op in bf16) at SNR >= 35 dB on every output: y, dx and
each weight gradient.  The float32 variants keep float32 accuracy (K1 and
K2 by 3xTF32 split products on the tensor cores, about 21 bits a
product, and K4's float32 forward and backward likewise; K3 on the CUDA
cores), their plain versions
multiply in float32, in another summation order: each output is held at
SNR >= 90 dB (one TF32 or bf16 product would land below it), the float32
waveform at 80 dB.  K5's int32 sums are exact in the kernel and
its plain version alike, so the two are held to 1e-6 of the output's
largest magnitude (the one float32 multiply by the scale).  A bf16 train
step of the kernel route is held to the plain route's at loss relative
difference <= 1e-2 and cosine >= 0.99 for every parameter gradient that is
not zero (both run bf16 activations that round at other places); a
float32 step at 1e-4 and 0.999.  The ADPCM encoder is integer
arithmetic on float32 values that are exact, so it is held bit-equal.  A
batch row is held to its text's single request on the same wire at SNR
>= 35 dB, the bf16 kernels' bar: the acoustic model runs at another batch
size than the single request (the library picks other kernels, so bf16
rounds at other places), the mixed batch's short rows take the kernel
route at the long row's buffer where their single requests take the
plain route, and where such a difference moves an ADPCM block's step or
a quantiser decision the codec's error moves with it; a row holding
another row's audio, or shifted by a frame, lands near or below 0 dB.
"""

import argparse
import collections
import concurrent.futures
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

from efficientspeech_tpu_torch.utils.timing import busy_ms
from efficientspeech_tpu_torch.utils.timing import card as card_name
from efficientspeech_tpu_torch.utils.timing import time_ms, time_ms_flushed

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor cores
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FRAMES = 2048
KERNEL_SNR_DB = 35.0
E2E_SNR_DB = 30.0
# the float32 variants: float32 sums in another order land at 110 dB or
# more; TF32 or bf16 products would land near the bf16 figures (54-95 dB)
F32_KERNEL_SNR_DB = 90.0
# regression floors of two bf16 kernels, about 6 dB under what the card
# gives them (NVIDIA H100 80GB HBM3; this script): K2 68.0-68.2 dB a stage;
# K4's backward by width and output, C = 128 / 256: dx 81.0 / 77.4,
# d_dw_w 90.6 / 87.6, d_dw_b 95.7 / 92.7, d_pw_w 90.9 / 87.8, d_pw_b
# 105.9 / 100.8, d_ln_s 98.9 / 94.2, d_ln_b 132.8 / 134.5.  A build whose
# compiler contracted the depthwise's bf16 multiply and add gave K4
# 46-58 dB
K2_BF16_FLOOR_DB = 62.0
# the other bf16 rows' floors, about 6 dB under the card's readings
# (NVIDIA H100 80GB HBM3, 700 W; this script): K1 by main-path op (up0-3
# 55.6 / 55.7 / 55.6 / 54.8, post 54.7); K3 by width and output, C = 128
# / 256: y 95.3 / 95.0, dx 97.4 / 97.1, dscale 127.6 / 129.8, dbias
# 133.9 / 133.5; K4's forward, y 92.1 / 88.7
K1_BF16_FLOOR_DB = {"up0": 49.0, "up1": 49.0, "up2": 49.0, "up3": 48.0,
                    "post": 48.0}
K3_BF16_FLOOR_DB = {
    128: {"y": 89.0, "dx": 91.0, "dscale": 121.0, "dbias": 127.0},
    256: {"y": 89.0, "dx": 91.0, "dscale": 123.0, "dbias": 127.0}}
K4_BF16_FWD_FLOOR_DB = {128: 86.0, 256: 82.0}
K4_BF16_BWD_FLOOR_DB = {
    128: {"dx": 75.0, "d_dw_w": 84.0, "d_dw_b": 89.0, "d_pw_w": 84.0,
          "d_pw_b": 99.0, "d_ln_s": 92.0, "d_ln_b": 126.0},
    256: {"dx": 71.0, "d_dw_w": 81.0, "d_dw_b": 86.0, "d_pw_w": 81.0,
          "d_pw_b": 94.0, "d_ln_s": 88.0, "d_ln_b": 128.0}}
F32_E2E_SNR_DB = 80.0
# the batch phase: the bench's batch size and wire
BATCH_ROWS = 128
BATCH_TRANSFER = "adpcm3"
# a batch row against its text's single request on the same wire (see
# the module's note): the card gives 43.0-43.3 dB in bf16, 82.4 in f32
# (NVIDIA H100 80GB HBM3, 700 W; this script)
BATCH_SNR_DB = 35.0
# the JAX package's codec tests' bars on a speech-like signal
ADPCM_SNR_DB = {"adpcm4": 32.0, "adpcm3": 32.0, "adpcm2": 22.0}
# the serve phase: serve.py's defaults (buckets warmed, max batch,
# deadlines, stream segments), 32 clients of 4 requests, and a stalled
# stream of 2 s against a 0.5 s deadline and a 1 s breaker cooldown
SERVE_BUCKETS = (128, 512)
SERVE_MAX_BATCH = 32
SERVE_SEGMENT = 128
SERVE_FETCH_TIMEOUT_S, SERVE_QUEUE_DEADLINE_S = 30.0, 60.0
SERVE_CLIENTS, SERVE_PER_CLIENT = 32, 4
SERVE_STALL_MS, SERVE_STALL_FETCH_S, SERVE_STALL_COOLDOWN_S = 2000.0, 0.5, 1.0
K5_REL_ERR = 1e-6
# the training shape: train.py's defaults
TRAIN_BATCH, TRAIN_PHONEMES, TRAIN_FRAMES = 128, 128, 1024
# the corpus holds EPOCH_STEPS batches; the phase trains two epochs and
# times the steps inside each apart from the one across the boundary
EPOCH_STEPS, TRAIN_EPOCHS, WARMUP_STEPS = 20, 2, 3
ROUTE_LOSS_RTOL, ROUTE_GRAD_COS = 1e-2, 0.99
F32_ROUTE_LOSS_RTOL, F32_ROUTE_GRAD_COS = 1e-4, 0.999
# the reference-checkpoint phase: the waveform served from the files
# against the one served from the parameters the files hold, built
# directly (the same weights: the same waveform).  Against the seed
# build the files were written from, the weight-norm fold moves about a
# quarter of the vocoder's float32 weights by an ulp, 11 of 925,985 of
# them across a bf16 rounding, and the bf16 route spreads any change to
# its own noise (59.2 dB measured, NVIDIA H100 80GB HBM3, 700 W): that
# comparison is held at E2E_SNR_DB, the bf16 route's end-to-end bar.  The
# float32 synthesizer's files are held to its seed build at the float32
# route's F32_E2E_SNR_DB (the fold moves a weight by at most two float32
# ulps: 124.8 dB for the conv generator on the CPU)
REFERENCE_SNR_DB = 60.0
# the preprocessing phase: a raw corpus of LJSpeech's length range, and
# the card's run held to the CPU's (log-mel absolute; energy relative;
# stats.json's energy mean relative, its std, min and max within the
# energy's error scaled by mean / std, as tests/test_torch_preprocess.py
# holds them)
RAW_UTTERANCES, RAW_SECONDS, RAW_VAL = 128, (1.0, 10.0), 16
PREPROCESS_WORKERS = 4
PREPROCESS_LOG_MEL_ATOL, PREPROCESS_ENERGY_RTOL = 1e-3, 1e-5
PREPROCESS_STATS_RTOL = 1e-6
# the train + validation audio phase on that corpus: the tiny preset in
# bf16, batch 16 (7 steps an epoch), two epochs
VALIDATE_BATCH, VALIDATE_STEPS = 16, 14
# the vocoder phase: train_vocoder's defaults (batch 8 of 8,192-sample
# crops, the LJ_V2-width generator, the full MPD and MSD), float32 with
# TF32 off; the first step's metrics held to a CPU run of the same step
# at batch 1 (cuDNN sums in another order: about 1e-5 expected)
VOCODER_BATCH, VOCODER_SEGMENT, VOCODER_STEPS, VOCODER_TIMED = 8, 8192, 10, 5
VOCODER_CPU_RTOL = 1e-4
# --from-acoustic on the preprocessed corpus, from the validate phase's
# checkpoint: utterances of the pair sweep, held out share, GAN steps
FROM_ACOUSTIC_UTTERANCES, FROM_ACOUSTIC_HOLDOUT = 64, 0.125
FROM_ACOUSTIC_STEPS = 4
# the device-data phase: the tiny bf16 trainer's first epoch on the
# device-resident corpus, also with --device-data-scan-steps at this
# (single steps in the port); each step's losses held to the loader
# path's step on the same rows at DEVICE_DATA_STEP_RTOL, and a run that
# gathers the next row of the corpus must read apart by more.  Measured
# (NVIDIA H100 80GB HBM3, 700 W): 1.34e-3 sound (bf16 trajectories whose
# batches hold the rows in another order drift apart by step 14), 5.13e-2
# with the next-row gather; the bar sits between them
DEVICE_DATA_SCAN = 4
DEVICE_DATA_STEP_RTOL = 1e-2
# the parallel phase: ranks sharing the card over gloo against one process
# on the same global work.  float32 at test_train_step_matches_jax's
# tolerances (losses rtol 1e-5, each gradient leaf 1e-4 of its largest),
# bf16 at the train phase's route tolerances; the GAN step's metrics at
# the JAX package's multichip bar (rtol = atol = 2e-5); the sequence-
# parallel vocoder in float32 at the JAX test's rtol = atol = 1e-5, in
# bf16 at E2E_SNR_DB
PARALLEL_TRAIN_CASES = ((torch.float32, False), (torch.float32, True),
                        (torch.bfloat16, False), (torch.bfloat16, True))
PARALLEL_LOSS_RTOL, PARALLEL_GRAD_ATOL = 1e-5, 1e-4
PARALLEL_TIMED = 5
# where the phase's ranks run, and the backend of its one-rank group (a
# CPU rehearsal sets "cpu" and "gloo")
PARALLEL_DEVICE, PARALLEL_NCCL = "cuda:0", "nccl"
GAN_TOL = 2e-5
SEQ_FRAMES, SEQ_VALID = 4096, 1500
SEQ_RTOL = SEQ_ATOL = 1e-5
# the g2p phase: python -m efficientspeech_tpu_torch.train_g2p at its
# defaults (batch 256, dropout 0.2, ~80,800 pairs) for G2P_STEPS steps
# with an eval every G2P_EVAL_EVERY; the step timed over G2P_TIMED steps;
# then G2P_HELD dropout-0 steps of a trainer with a one-count warmup (the
# first update at rate 0, the next ones at the full 1e-3) held to the same
# steps on the CPU: each step's loss (float32, TF32 off: another
# summation order, about 1e-6), taken at parameters the earlier updates
# moved, and the first step's gradients at 1e-4 of each leaf's largest.
# Later steps' gradients are printed beside the CPU's own float32 distance
# from a float64 gradient at the same parameters, and not held: once the
# updates have moved the parameters, a ReLU's or a mask's kink can put
# the CPU's float32 gradient 1e-4 or more from the float64 one.  The card's
# AdamW updates from the CPU's gradients, so that both updates see the
# same input (Adam's update of a gradient near 0 follows its sign, which
# rounding can flip), and each leaf's move is held to the CPU's at
# G2P_UPDATE_RTOL of its largest (about eight float32 ulps of a parameter
# near 1, against a 1e-3 move)
G2P_STEPS, G2P_EVAL_EVERY, G2P_TIMED, G2P_HELD = 300, 150, 30, 3
G2P_LOSS_RTOL, G2P_GRAD_ATOL, G2P_UPDATE_RTOL = 1e-5, 1e-4, 1e-3
# the export phase: the convert CLI from the reference phase's files at
# the reference's --insize; each loaded program held to eager predict on
# the card, in float32 also to the CPU's, and the exported float32
# waveform to the serving kernel route's on the same padded phonemes
EXPORT_INSIZE, EXPORT_TIMED = 128, 10

# the kernel-table rows whose kernels were redesigned for Hopper after
# their first port, by launch key: the design each row's time belongs to
DESIGNS = {
    "folded_matmul": "Hopper redesign: persistent blocks of two warpgroups, "
                     "W panel loaded once per block, bulk-copy x stages, "
                     "wgmma with A in registers",
    "folded_matmul_f32": "Hopper redesign: 3xTF32 split products on wgmma, "
                         "transposed (W^T from L2 through registers as A, "
                         "the split x tile as K-major B), two warpgroups",
    "mrf_fused": "Hopper redesign: transposed conv on wgmma (output "
                 "channels as M, a warpgroup each half; conv rows as N in "
                 "one instruction; input channels as K), A the tap's W "
                 "slice from a TMA-fed ring of 128-byte-swizzled "
                 "shared-memory slots with full/empty mbarriers, running "
                 "across ops; B the bf16 activation buffer K-major; "
                 "stmatrix epilogue; v float32 in shared memory; tile plan "
                 "in Python",
    "mrf_fused_wide": "a variant at D = 256 (HiFi-GAN V1's first stage): "
                      "two warpgroups of 128 output channels (two wgmma a "
                      "k-step), quarter-tap ring slices loaded by thread 0 "
                      "after uniform empty-barrier waits, v float32 in "
                      "device memory, read and written by the residual "
                      "convs' epilogues, persistent blocks",
    "folded_matmul_v1": "as folded_matmul; at D_in 512 no x stage fits, "
                        "and the converter reads x from device memory",
    "mrf_fused_f32": "Hopper redesign: 3xTF32 split products on wgmma, "
                     "transposed (W^T from L2 through registers as A, the "
                     "split activation buffer as K-major B, 16-row output "
                     "chunks), v float32 in shared memory",
    "k4_bwd_128": "Hopper redesign: the three products on wgmma bf16 "
                  "from 128-byte-swizzled shared-memory tiles (one copy of "
                  "W for v = u W and du = dv W^T, the weight gradient u^T "
                  "dv MN-major, kept in the accumulators across the "
                  "block's tiles); x and dy by TMA tensor copies a tile "
                  "ahead; t, LayerNorm and dv in the accumulators; one "
                  "block a tile; tile plan in Python",
    "k4_bwd_256": "Hopper redesign: as C = 128, each tile over a cluster "
                  "of two blocks of 128 columns (u and dv halves by bulk "
                  "copies between the blocks' shared memory, the rows' "
                  "LayerNorm sums by st.async, mbarrier-signalled), so no "
                  "tile's u, v, t or dv is computed twice; each block "
                  "keeps its 256 x 128 weight gradient in registers",
    "k4_fwd_128": "Hopper redesign: the backward's front half; 64-row tiles "
                  "owning every row, x by TMA tensor copies a tile ahead "
                  "(rows outside the sequence as zeros), u by a window "
                  "sliding down each column two channels an instruction "
                  "into 128-byte-swizzled K-major tiles, v = u W on wgmma "
                  "(W's swizzled tiles loaded once a block), t and the "
                  "LayerNorm in the accumulators, y staged over u's "
                  "tiles for one TMA tensor store a warpgroup; three "
                  "blocks an SM; tile plan in Python",
    "k4_fwd_256": "Hopper redesign: as C = 128, four warpgroups a block "
                  "(one per 64 columns, the rows' statistics combined over "
                  "four slots), all of W in one block's shared memory, "
                  "one block an SM",
    "k4_fwd_128_f32": "Hopper redesign: 3xTF32 split products on the "
                      "tensor cores; v transposed on wgmma (W in A-fragment "
                      "order from L2 through registers, the split rows of u "
                      "as K-major B, 64 rows as N); u by a window sliding "
                      "down each column; v's rows over the split buffer, "
                      "the row pass from them; the next tile's x rows by "
                      "cp.async during the product and row pass; two "
                      "blocks an SM; tile plan in Python",
    "k4_fwd_256_f32": "Hopper redesign: as C = 128, each block's k loop "
                      "from its own step, a warpgroup's two m-blocks held in "
                      "registers until the split buffer is free; one block "
                      "an SM; tile plan in Python",
    "k4_bwd_128_f32": "Hopper redesign: 3xTF32 split products on the "
                      "tensor cores; v and du transposed on wgmma (W and W^T "
                      "in A-fragment order from L2 through registers, the "
                      "split rows as K-major B, 128 rows as N); the weight "
                      "gradient on mma.sync from shared memory into a "
                      "per-block partial in L2 in the accumulators' order; "
                      "tile plan in Python",
    "k4_bwd_256_f32": "Hopper redesign: 3xTF32 split products on the "
                      "tensor cores; v and du transposed on wgmma (W and W^T "
                      "in A-fragment order from L2 through registers, each "
                      "block's k loop from its own step, the split rows as "
                      "K-major B, 64 rows as N); the weight gradient on "
                      "mma.sync from shared memory into a per-block partial "
                      "in L2 in the accumulators' order; tile plan in Python",
    "k5_bf16": "Hopper redesign: tile split over a cluster, partial maxima "
               "through distributed shared memory, W^T pre-pass and bulk "
               "copy, wgmma s8",
    "k5_int8": "Hopper redesign: tile split over a cluster, W^T pre-pass "
               "and bulk copy, wgmma s8",
}
LONG_TEXT = (
    "The polyphase folded vocoder turns every convolution of the waveform "
    "generator into a dense matrix product over frame rate activations. "
    "Each stage of the generator first upsamples its input with a "
    "transposed convolution, then runs a multi receptive field block of "
    "three residual chains, whose dilated convolutions see eleven, seven "
    "and three taps. On the graphics card, a windowed matrix kernel runs "
    "the upsamplers and the final convolution, and a second kernel runs "
    "each whole block in shared memory, one tile of rows at a time, with "
    "its halo recomputed at the edges. This long request makes the "
    "speculative buffer large enough for both kernels to engage.")
SHORT_TEXTS = ("Hello there.", "How are you today?",
               "The quick brown fox jumps over the lazy dog.")
# 91 phonemes: bucket 128, whose speculative buffer is 1,024 frames, the
# short-sentence server's batches
MEDIUM_TEXT = ("Each stage of the generator first upsamples its input with "
               "a transposed convolution, then runs a multi receptive field "
               "block.")
# the slice phase's batch: the server's largest batch of sentences
SLICE_BATCH_ROWS = 32


def snr_bar(dtype) -> float:
    return F32_KERNEL_SNR_DB if dtype == torch.float32 else KERNEL_SNR_DB


def dname(dtype) -> str:
    return "f32" if dtype == torch.float32 else "bf16"


def f32_suffix(dtype, sep: str = " ") -> str:
    """What float32 phases append to their tags (sep " ") and launch keys
    (sep "_"); bf16 ones keep the names they had."""
    return sep + "f32" if dtype == torch.float32 else ""


def product_bound(flops: float, nbytes: float, dtype):
    """bound() of a matrix product: bf16 on the tensor cores; float32 by
    the faster of the CUDA cores (FFMA) and 3xTF32 split products on the
    tensor cores.  Returns (ms, what bounds it, the FFMA-route ms: the
    yardstick before 3xTF32, None for bf16)."""
    if dtype == torch.float32:
        return (*bound(0.0, nbytes, f32_products=flops),
                bound(0.0, nbytes, f32_flops=flops)[0])
    return (*bound(flops, nbytes), None)


def fail(msg: str):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    err = (got.double() - ref.double()).pow(2).mean()
    sig = ref.double().pow(2).mean()
    return float(10 * torch.log10(sig / err.clamp_min(1e-30)))


def bound(flops: float, nbytes: float, f32_flops: float = 0.0,
          int8_ops: float = 0.0, f32_products: float = 0.0):
    """The least time (ms) for the work and what bounds it: the largest of
    bf16 tensor-core FLOP, float32 FLOP outside the tensor cores, int8
    tensor-core operations and float32 product FLOP (``f32_products``, at
    the faster of FFMA and 3xTF32: three TF32 products each), each at its
    peak (the units run side by side), and bytes at the memory rate."""
    t_ops = max(flops / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS,
                int8_ops / PEAK_INT8_OPS,
                min(f32_products / PEAK_F32_FLOPS,
                    3 * f32_products / PEAK_TF32_FLOPS)) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ffma_note(ffma_ms) -> str:
    """What a float32 line prints beside its bound: the FFMA-route bound,
    the yardstick the rows before 3xTF32 were reckoned on."""
    return "" if ffma_ms is None else f" (FFMA route {ffma_ms:.4f})"


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    card = card_name()
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# the sources whose registers and spills the build phase prints, and, by
# source, a pattern of the kernels where a spill or a serialised wgmma
# fails the phase (every kernel of mrf_block.cu, and of decoder_block.cu:
# K4's forward and backward in bf16 and float32, all four on wgmma)
PTXAS_SOURCES = ("folded_matmul", "mrf_block", "decoder_block",
                 "adpcm_encode")
PTXAS_STRICT = {"mrf_block": "", "decoder_block": ""}


def ptxas_lines(log: str):
    """(kernel, registers, spill stores, spill loads) of each entry
    function in nvcc's -Xptxas -v output, names demangled where c++filt
    is at hand."""
    found, name, spills = [], None, ("?", "?")
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.append([name, int(m.group(1)), *spills])
            name = None
    filt = shutil.which("c++filt")
    if filt and found:
        out = subprocess.run([filt], input="\n".join(f[0] for f in found),
                             capture_output=True, text=True).stdout
        for f, demangled in zip(found, out.splitlines()):
            f[0] = re.sub(r"\(anonymous namespace\)::", "", demangled)
    return found


def phase_build(card: str):
    """Build every source of csrc/ into build/kernels/, and alongside, in
    parallel, the sources of PTXAS_SOURCES once more with -Xptxas -v to
    print each kernel's registers and spills."""
    from efficientspeech_tpu_torch.ops.kernels import build

    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, f"lib{name}.so"),
             str(build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for name in PTXAS_SOURCES}
        secs = build.build()
        logs = {name: proc.communicate()[0].decode(errors="replace")
                for name, proc in procs.items()}
    print(f"[build] nvcc sm_90a, {len(build.SOURCES)} sources in parallel: "
          f"{secs:.1f} s | {card}")
    for name, log in logs.items():
        if procs[name].returncode != 0:
            fail(f"nvcc -Xptxas -v failed for {name}.cu:\n{log}")
        for kernel, regs, stores, loads in ptxas_lines(log):
            print(f"[ptxas] {name}.cu {kernel}: {regs} registers, spill "
                  f"stores {stores} B, spill loads {loads} B")
            if (name in PTXAS_STRICT and re.search(PTXAS_STRICT[name], kernel)
                    and (stores, loads) != ("0", "0")):
                fail(f"{name}.cu {kernel} spills registers")
        serialised = [line.strip() for line in log.splitlines()
                      if re.search(r"wgmma.*serializ", line)]
        for line in serialised:
            print(f"[ptxas] {name}.cu: {line}")
        if name in PTXAS_STRICT and serialised:
            fail(f"ptxas serialises the wgmmas of {name}.cu")


def phase_k1(synth, card: str):
    """K1 on the synthesizer's folded weights (its serving dtype picks the
    kernel's variant), with torch.matmul on the materialised window in
    that dtype as the yardstick."""
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        kernel_op_shapes)
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm

    dev = synth.device
    dt = synth.dtype
    tag, bar = "K1" + f32_suffix(dt), snr_bar(dt)
    gen = torch.Generator(device="cpu").manual_seed(1)
    ops, _ = kernel_op_shapes(synth.hifigan_cfg, FRAMES)
    cases = [(key, t, d_in, d_out, w, key) for key, t, d_in, d_out, w in ops]
    # one wide-window case with every epilogue operand
    wide = "rb0_2_c1_2"
    cases.append(("w13+res+acc+scale", 4 * FRAMES, 128, 128,
                  synth.fold_meta["widths"][wide], wide))
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    worst_err, bound_by = 0.0, set()
    for name, t, d_in, d_out, w, key in cases:
        W, b = synth.folded[key]
        assert W.shape == ((2 * w + 1) * d_in, d_out), (key, W.shape)
        x = torch.randn(t, d_in, generator=gen).to(dev)
        valid_rows = t - t // 16
        valid = torch.tensor([valid_rows], dtype=torch.int32, device=dev)
        extra = name.startswith("w13")
        res = torch.randn(t, d_out, generator=gen).to(dev) if extra else None
        acc = torch.randn(t, d_out, generator=gen).to(dev) if extra else None
        kw = dict(residual=res, accum=acc,
                  out_scale=1.0 / 3 if extra else None, pre_lrelu=True,
                  lrelu_slope=0.01 if key == "post" else 0.1)
        got = fm.folded_matmul(x, W, b, w, valid, **kw)
        want = fm.folded_matmul_plain(x, W, b, w, valid, **kw)
        torch.cuda.synchronize()
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            fail(f"{tag} {name}: non-finite output")
        if got[valid_rows:].any():
            fail(f"{tag} {name}: rows at or beyond valid are not zero")
        need = max(bar, K1_BF16_FLOOR_DB.get(name, 0.0)
                   if dt == torch.bfloat16 else 0.0)
        if snr < need:
            fail(f"{tag} {name}: SNR {snr:.1f} dB < {need} dB")
        win = fm.window(fm.leaky(x, kw["lrelu_slope"]), w).to(dt)
        ms, host_ms = time_ms(
            lambda: fm.folded_matmul(x, W, b, w, valid, **kw), 50)
        plain_ms, _ = time_ms(
            lambda: fm.folded_matmul_plain(x, W, b, w, valid, **kw), 10)
        lib_ms, _ = time_ms(lambda: torch.matmul(win, W), 50)
        flops = 2.0 * valid_rows * (2 * w + 1) * d_in * d_out
        nbytes = (x.numel() * 4 + W.numel() * W.element_size()
                  + b.numel() * 4
                  + t * d_out * 4 * (1 + (res is not None) + (acc is not None)))
        b_ms, by, ffma_ms = product_bound(flops, nbytes, dt)
        print(f"[{tag}] {name}: T {t} x {d_in} -> {d_out}, w {w} | SNR "
              f"{snr:.1f} dB (tol >= {need}) max_abs_err {err:.3g} "
              f"| kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{lib_ms:.4f} bound_ms {b_ms:.4f} ({by}){ffma_note(ffma_ms)} "
              f"| wrapper host_ms {host_ms:.4f} | {card}")
        if extra:
            continue  # not on the main path: kept out of the totals
        cold = time_ms_flushed(
            lambda: fm.folded_matmul(x, W, b, w, valid, **kw), 20)
        lib_cold = time_ms_flushed(lambda: torch.matmul(win, W), 20)
        print(f"[{tag}] {name}: L2 flushed before each call: kernel_ms "
              f"{cold:.4f} library_ms {lib_cold:.4f} | {card}")
        totals["flushed_ms"] = totals.get("flushed_ms", 0.0) + cold
        totals["flushed_library_ms"] = (
            totals.get("flushed_library_ms", 0.0) + lib_cold)
        if ffma_ms is not None:
            totals["ffma_bound_ms"] = totals.get("ffma_bound_ms", 0.0) + ffma_ms
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["library_ms"] += lib_ms
        totals["bound_ms"] += b_ms
        worst_err = max(worst_err, err)
        bound_by.add(by)
    print(f"[{tag}] per utterance ({len(ops)} ops): kernel_ms "
          f"{totals['ms']:.4f} library_ms {totals['library_ms']:.4f} "
          f"bound_ms {totals['bound_ms']:.4f}"
          f"{ffma_note(totals.pop('ffma_bound_ms', None))} | L2 flushed "
          f"before each call: kernel_ms {totals['flushed_ms']:.4f} "
          f"library_ms {totals['flushed_library_ms']:.4f} | {card}")
    return dict(totals, max_abs_err=worst_err,
                bound_by="operations" if "operations" in bound_by
                else "bytes")


def phase_k2(synth, card: str):
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        kernel_op_shapes)
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    dev = synth.device
    dt = synth.dtype
    tag, bar = "K2" + f32_suffix(dt), snr_bar(dt)
    nk = len(synth.hifigan_cfg.resblock_kernel_sizes)
    gen = torch.Generator(device="cpu").manual_seed(2)
    _, stages = kernel_op_shapes(synth.hifigan_cfg, FRAMES)
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    worst_err, bound_by = 0.0, set()
    for stage, t in stages:
        chains, W_all, b_all, H = synth.mrf[stage]
        x = torch.randn(t, 128, generator=gen).to(dev)
        valid_rows = t - t // 16
        valid = torch.tensor([valid_rows], dtype=torch.int32, device=dev)
        got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, nk)
        want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid,
                                         nk)
        torch.cuda.synchronize()
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all():
            fail(f"{tag} stage {stage}: non-finite output")
        if got[valid_rows:].any():
            fail(f"{tag} stage {stage}: rows at or beyond valid are not zero")
        need = bar if dt == torch.float32 else max(bar, K2_BF16_FLOOR_DB)
        if snr < need:
            fail(f"{tag} stage {stage}: SNR {snr:.1f} dB < {need} dB")
        ms, host_ms = time_ms(lambda: mrf_block.mrf_fused(
            x, chains, W_all, b_all, H, valid, nk), 20)
        plain_ms, _ = time_ms(lambda: mrf_block.mrf_fused_plain(
            x, chains, W_all, b_all, H, valid, nk), 3)
        flops = sum(2.0 * valid_rows * n_win * 128 * 128
                    for chain in chains for _, n_win, _, _ in chain)
        nbytes = (2 * t * 128 * 4 + W_all.numel() * W_all.element_size()
                  + b_all.numel() * 4)
        b_ms, by, ffma_ms = product_bound(flops, nbytes, dt)
        widths = mrf_block.chain_widths(chains)
        if dt == torch.float32:
            tile = f"tile {mrf_block.f32_plan(widths, t).tm}"
        else:
            pl = mrf_block.bf16_plan(widths, t)
            tile = (f"tile {pl.tm}, slots {pl.slots}, N chunks "
                    f"{'/'.join(','.join(map(str, c)) for c in pl.chunks)}")
        print(f"[{tag}] stage {stage}: T {t} x 128, halo {H}, {tile} "
              f"| {flops / 1e9:.1f} GFLOP | SNR {snr:.1f} dB (tol >= {need}) "
              f"max_abs_err {err:.3g} | kernel_ms {ms:.4f} plain_ms "
              f"{plain_ms:.4f} library_ms null bound_ms {b_ms:.4f} ({by})"
              f"{ffma_note(ffma_ms)} | achieved {flops / ms / 1e9:.1f} "
              f"TFLOP/s | wrapper host_ms {host_ms:.4f} | {card}")
        if ffma_ms is not None:
            totals["ffma_bound_ms"] = totals.get("ffma_bound_ms", 0.0) + ffma_ms
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += b_ms
        worst_err = max(worst_err, err)
        bound_by.add(by)
    print(f"[{tag}] per utterance ({len(stages)} stages): kernel_ms "
          f"{totals['ms']:.4f} bound_ms {totals['bound_ms']:.4f}"
          f"{ffma_note(totals.pop('ffma_bound_ms', None))} | {card}")
    return dict(totals, max_abs_err=worst_err, library_ms=None,
                bound_by="operations" if "operations" in bound_by
                else "bytes")


# HiFi-GAN V1 (jik876/hifi-gan config_v1.json) with EfficientSpeech base:
# its ops that LJ_V2 lacks, at V1_FRAMES frames of one row
V1_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "configs", "hifigan_v1.json")
V1_FRAMES = 4096
# floors about 6 dB under the card's readings (NVIDIA H100 80GB HBM3,
# 700 W): K2 wide 68 dB, K1 at up0 and post 55.7 / 54.4 dB
K2_WIDE_FLOOR_DB = 62.0
K1_V1_FLOOR_DB = {"up0": 49.0, "post": 48.0}
V1_BATCH_ROWS = 8


def phase_v1(card: str):
    """EfficientSpeech base with HiFi-GAN V1 in bf16: K1 at V1's first
    upsampler (D_in 512, x read from device memory) and post conv (4
    samples a row, padded to 16), K2's wide kernel at stage 0 (256 wide),
    each at one row of V1_FRAMES frames against its plain version (the
    wide kernel also has to beat the plain version's time); then a
    tts_batch of V1_BATCH_ROWS long texts on the kernel route, its
    launches counted (K1 5, K2 4 a row, one of them wide; every row
    under ``synth.vocoder.wide_rows``) and its first two rows held to a
    batch of two on the plain route.  Returns (K1 up0's row, K2 wide's
    row, their launches)."""
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.infer import build_synthesizer
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        kernel_op_shapes)
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block
    from efficientspeech_tpu_torch.utils import spans

    t0 = time.perf_counter()
    synth = build_synthesizer(preset="base", seed=0,
                              hifigan_cfg=HifiGanConfig.from_json(V1_CONFIG),
                              bench_duration_bias=6.0, dtype=torch.bfloat16,
                              vocoder_mode="folded_kernel")
    print(f"[setup] base + V1 synthesizer in {time.perf_counter() - t0:.1f}"
          f" s | {card}")
    dev, dt = synth.device, torch.bfloat16
    gen = torch.Generator(device="cpu").manual_seed(24)
    ops, stages = kernel_op_shapes(synth.hifigan_cfg, V1_FRAMES)
    rows = {}
    for key, t, d_in, _, w in ops:
        if key not in K1_V1_FLOOR_DB:
            continue
        W, b = synth.folded[key]
        d_out = W.shape[1]
        x = torch.randn(t, d_in, generator=gen).to(dev)
        valid_rows = t - t // 16
        valid = torch.tensor([valid_rows], dtype=torch.int32, device=dev)
        kw = dict(pre_lrelu=True, lrelu_slope=0.01 if key == "post" else 0.1)
        got = fm.folded_matmul(x, W, b, w, valid, **kw)
        want = fm.folded_matmul_plain(x, W, b, w, valid, **kw)
        torch.cuda.synchronize()
        snr = snr_db(want[:valid_rows], got[:valid_rows])
        need = max(KERNEL_SNR_DB, K1_V1_FLOOR_DB[key])
        if snr < need or got[valid_rows:].any():
            fail(f"K1 V1 {key}: SNR {snr:.1f} dB < {need} dB, or rows "
                 f"beyond valid not zero")
        ms, _ = time_ms(lambda: fm.folded_matmul(x, W, b, w, valid, **kw),
                        20)
        plain_ms, _ = time_ms(
            lambda: fm.folded_matmul_plain(x, W, b, w, valid, **kw), 5)
        win = fm.window(fm.leaky(x, kw["lrelu_slope"]), w).to(dt)
        lib_ms, _ = time_ms(lambda: torch.matmul(win, W), 20)
        del win
        flops = 2.0 * valid_rows * (2 * w + 1) * d_in * d_out
        nbytes = x.numel() * 4 + W.numel() * 2 + t * d_out * 4
        b_ms, by, _ = product_bound(flops, nbytes, dt)
        pl = fm.plan(t, d_in, d_out, w)
        print(f"[K1 V1] {key}: T {t} x {d_in} -> {d_out}, w {w}, x staged "
              f"{pl.x_bytes > 0}, W {'resident' if pl.resident else 'streamed'}"
              f", {pl.n_wg} warpgroup(s) | SNR {snr:.1f} dB (tol >= {need}) "
              f"| kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
              f"{lib_ms:.4f} bound_ms {b_ms:.4f} ({by}) | {card}")
        rows[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=by, library_ms=lib_ms,
                         max_abs_err=float((got - want).abs().max()))
    stage, t = stages[0]
    chains, W_all, b_all, H = synth.mrf[stage]
    d = W_all.shape[1]
    nk = len(synth.hifigan_cfg.resblock_kernel_sizes)
    x = torch.randn(t, d, generator=gen).to(dev)
    valid_rows = t - t // 16
    valid = torch.tensor([valid_rows], dtype=torch.int32, device=dev)
    got = mrf_block.mrf_fused(x, chains, W_all, b_all, H, valid, nk)
    want = mrf_block.mrf_fused_plain(x, chains, W_all, b_all, H, valid, nk)
    torch.cuda.synchronize()
    snr = snr_db(want[:valid_rows], got[:valid_rows])
    need = max(KERNEL_SNR_DB, K2_WIDE_FLOOR_DB)
    if d != mrf_block.WIDE_D or snr < need or got[valid_rows:].any():
        fail(f"K2 wide: width {d}, SNR {snr:.1f} dB < {need} dB, or rows "
             f"beyond valid not zero")
    ms, _ = time_ms(lambda: mrf_block.mrf_fused(
        x, chains, W_all, b_all, H, valid, nk), 10)
    plain_ms, _ = time_ms(lambda: mrf_block.mrf_fused_plain(
        x, chains, W_all, b_all, H, valid, nk), 3)
    # the bound counts the MRF's useful work, 2·C²·k a conv of kernel k
    # per sample (C channels, d // C samples a row); the kernel also
    # multiplies the fold's zero taps, every window of 2·w + 1 rows
    cfg = synth.hifigan_cfg
    ch = cfg.upsample_initial_channel // 2 ** (stage + 1)
    taps = 2 * sum(k * len(dil) for k, dil in zip(
        cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
    flops = 2.0 * valid_rows * (d // ch) * ch * ch * taps
    folded = sum(2.0 * valid_rows * n_win * d * d
                 for chain in chains for _, n_win, _, _ in chain)
    nbytes = 2 * t * d * 4 + W_all.numel() * 2 + b_all.numel() * 4
    b_ms, by, _ = product_bound(flops, nbytes, dt)
    pl = mrf_block.bf16_plan(mrf_block.chain_widths(chains), t, d=d)
    print(f"[K2 wide] stage {stage}: T {t} x {d}, halo {H}, tile {pl.tm}, "
          f"slots {pl.slots} | {flops / 1e9:.1f} GFLOP useful, "
          f"{folded / 1e9:.1f} with the fold's zero taps | SNR {snr:.1f} dB "
          f"(tol >= {need}) | kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"bound_ms {b_ms:.4f} ({by}) | achieved "
          f"{folded / ms / 1e9:.1f} TFLOP/s of the fold's products | {card}")
    if ms >= plain_ms:
        fail(f"K2 wide: {ms:.3f} ms, not faster than the plain version's "
             f"{plain_ms:.3f} ms")
    rows["wide"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=by, library_ms=None,
                        max_abs_err=float((got - want).abs().max()))

    texts = [LONG_TEXT] * V1_BATCH_ROWS
    synth.tts_batch(texts)  # warm-up
    torch.cuda.synchronize()
    _reset_counts(fm, mrf_block)
    before = (spans.counters(synth.span_id),
              spans.counters().get("k2.wide_launches", 0))
    t0 = time.perf_counter()
    got = synth.tts_batch(texts)
    wall = time.perf_counter() - t0
    c = spans.counters(synth.span_id)
    n = {k: c.get(k, 0) - before[0].get(k, 0) for k in (
        "synth.vocoder.kernel_rows", "synth.vocoder.wide_rows")}
    wide = spans.counters().get("k2.wide_launches", 0) - before[1]
    k1, k2 = fm.launches[dt], mrf_block.launches[dt]
    b_pad = n["synth.vocoder.kernel_rows"]
    print(f"[V1 batch] {len(texts)} rows (padded to {b_pad}) | wall "
          f"{wall * 1e3:.1f} ms, voice "
          f"{sum(i['voice_secs'] for _, i in got):.2f} s | launches K1 {k1} "
          f"K2 {k2} (wide {wide}) | wide rows "
          f"{n['synth.vocoder.wide_rows']} of {b_pad} | {card}")
    if (k1, k2, wide, n["synth.vocoder.wide_rows"]) != (
            5 * b_pad, 4 * b_pad, b_pad, b_pad) or b_pad < len(texts):
        fail(f"V1 batch: launches K1 {k1} K2 {k2} wide {wide}, wide rows "
             f"{n['synth.vocoder.wide_rows']} of {b_pad}")
    # the plain route's window tensors of 8 rows exceed the card's memory
    # at these frames (PERF.md §5): two rows of the batch suffice
    synth.vocoder_mode = "folded"
    want = synth.tts_batch(texts[:2])
    worst = min(snr_db(torch.from_numpy(w), torch.from_numpy(g))
                for (w, _), (g, _) in zip(want, got))
    print(f"[V1 batch] kernel route against the plain route (2 rows): "
          f"worst SNR {worst:.1f} dB (tol >= {KERNEL_SNR_DB}) | {card}")
    if worst < KERNEL_SNR_DB:
        fail(f"V1 batch: a row at {worst:.1f} dB of the plain route")
    del synth
    torch.cuda.empty_cache()
    return rows["up0"], rows["wide"], {"folded_matmul_v1": k1,
                                       "mrf_fused_wide": wide}


def _vocoder_shapes(synth):
    """Wrap ``synth._vocode_folded`` to list the (rows, frames) of each
    call; returns the list and the function that unwraps it."""
    seen, real = [], synth._vocode_folded

    def spy(mel, mel_len):
        seen.append(tuple(mel.shape[:2]))
        return real(mel, mel_len)

    synth._vocode_folded = spy
    return seen, lambda: delattr(synth, "_vocode_folded")


def _routes_agree(synth, run, tag: str, bar: float, card: str):
    """``run()`` (a list of waveforms) on the kernel route, then on the
    plain folded route: the same lengths and every waveform at >= ``bar``
    dB of the plain route's; returns the frames the vocoder ran at."""
    seen, unwrap = _vocoder_shapes(synth)
    try:
        got = run()
        synth.vocoder_mode = "folded"
        want = run()
    finally:
        synth.vocoder_mode = "folded_kernel"
        unwrap()
    if len(seen) != 2 or seen[0] != seen[1]:
        fail(f"{tag}: vocoder shapes {seen}; expected one call a route at "
             "the same shape")
    if [len(w) for w in got] != [len(w) for w in want]:
        fail(f"{tag}: kernel route lengths {[len(w) for w in got]} != "
             f"plain route {[len(w) for w in want]}")
    snr = min(snr_db(torch.from_numpy(w), torch.from_numpy(g))
              for w, g in zip(want, got))
    print(f"[{tag}] {seen[0][0]} x {seen[0][1]} frames, kernel route vs "
          f"plain route: worst SNR {snr:.1f} dB (tol >= {bar}) | {card}")
    if snr < bar:
        fail(f"{tag}: end-to-end SNR {snr:.1f} dB < {bar} dB")
    return seen[0][1]


def phase_slice(synth, card: str, texts=(LONG_TEXT,) + SHORT_TEXTS):
    """The serving main path: ``texts`` (the long request first) through
    ``synth.tts``, launch counts of the serving dtype's kernel variants
    from 0 just before and read just after (no other variant may run; K1
    5 and K2 4 every request, the short ones below 2,048 frames, where
    only the card's rule sends them to the kernels); then the kernel
    route against the plain folded route on the long request, the first
    short one (512 frames) and a ``SLICE_BATCH_ROWS``-row ``tts_batch``
    at 1,024 frames on the int16 wire (K1 5 and K2 4 a row)."""
    from efficientspeech_tpu_torch import infer
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    dt = synth.dtype
    tag0 = "slice" + f32_suffix(dt)
    e2e_bar = E2E_SNR_DB if dt == torch.bfloat16 else F32_E2E_SNR_DB
    seqs = [synth.phonemize(t) for t in texts]
    for seq in seqs:  # warm-up: first-call set-up stays out of the timings
        synth.synthesize_ids(seq)
    synth._obs_ratio = None
    synth._obs_recent.clear()

    # the main path: launch counts from 0, read right after
    for d in (fm.launches, mrf_block.launches):
        d.update(dict.fromkeys(d, 0))
    results = []
    seen, unwrap = _vocoder_shapes(synth)
    try:
        for text in texts:
            torch.cuda.synchronize()
            before = (fm.launches[dt], mrf_block.launches[dt], len(seen))
            wav, info = synth.tts(text)
            after = (fm.launches[dt], mrf_block.launches[dt])
            results.append((wav, info, after[0] - before[0],
                            after[1] - before[1], seen[before[2]:]))
    finally:
        unwrap()
    launches = {"folded_matmul" + f32_suffix(dt, "_"): fm.launches[dt],
                "mrf_fused" + f32_suffix(dt, "_"): mrf_block.launches[dt]}
    other = sum(n for d in (fm.launches, mrf_block.launches)
                for k, n in d.items() if k != dt)
    if other:
        fail(f"{tag0}: {other} launches of another dtype's kernel variant")

    for i, (wav, info, k1, k2, shapes) in enumerate(results):
        tag = "long" if i == 0 else f"short{i}"
        frames = [f for _, f in shapes]
        print(f"[{tag0}] {tag}: phonemes {info['phoneme_len']} mel_len "
              f"{info['mel_len']} | {info['total_secs'] * 1e3:.1f} ms RTF "
              f"{info['rtf']:.1f} | frames {frames} | launches K1 {k1} "
              f"K2 {k2} | {card}")
        if info["mel_len"] <= 0:
            fail(f"{tag}: mel_len {info['mel_len']}")
        if wav.shape != (info["mel_len"] * synth.hifigan_cfg.total_upsample,):
            fail(f"{tag}: wav shape {wav.shape}")
        if not np.isfinite(wav).all() or np.abs(wav).max() < 1e-4:
            fail(f"{tag}: waveform not finite or silent")
        if (k1, k2) != (5, 4) or len(frames) != 1:
            fail(f"{tag}: {len(frames)} vocoder calls launched K1 {k1} and "
                 f"K2 {k2} times; expected one call, 5 and 4")
        if i and not frames[0] < infer.KERNEL_MIN_FRAMES:
            fail(f"{tag}: {frames[0]} frames, not below the "
                 f"{infer.KERNEL_MIN_FRAMES} from which the kernel route "
                 "would run off the card")

    # the kernel route against the plain route on the same inputs
    for name, seq in (("long request", seqs[0]), ("short1", seqs[1])):
        frames = _routes_agree(
            synth, lambda: [synth.synthesize_ids(seq)[0]],
            f"{tag0} {name}", e2e_bar, card)
        if name == "short1" and frames != synth.spec_min_frames:
            fail(f"{tag0} short1: {frames} frames, not "
                 f"{synth.spec_min_frames}")
    batch = ([MEDIUM_TEXT, *SHORT_TEXTS] * SLICE_BATCH_ROWS)[
        :SLICE_BATCH_ROWS]
    transfer, synth.transfer = synth.transfer, "int16"
    try:
        synth.tts_batch(batch)  # warm-up, and the ratio observed
        _reset_counts(fm, mrf_block)
        synth.tts_batch(batch)
        k1, k2 = fm.launches[dt], mrf_block.launches[dt]
        if (k1, k2) != (5 * SLICE_BATCH_ROWS, 4 * SLICE_BATCH_ROWS):
            fail(f"{tag0} batch: launches K1 {k1} K2 {k2}; expected "
                 f"{5 * SLICE_BATCH_ROWS} and {4 * SLICE_BATCH_ROWS}")
        frames = _routes_agree(
            synth, lambda: [w for w, _ in synth.tts_batch(batch)],
            f"{tag0} batch of {SLICE_BATCH_ROWS}, int16 wire", e2e_bar, card)
    finally:
        synth.transfer = transfer
    if frames != 1024:
        fail(f"{tag0} batch: {frames} frames, not the server's 1,024")
    return launches


def trace(fn, label: str, card: str):
    """Trace one call of ``fn`` (after one untraced call): device time by
    kernel and the idle share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel entries only: an op's own entry repeats its
    # kernels' time, and a user annotation (the optimizer's step and
    # zero_grad ranges) spans kernels counted on their own
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms == 0:
        print(f"[profile] {label}: no device time in the trace: not "
              f"measured | {card}")
        return
    busy = busy_ms(prof)
    n_kernels = sum(e.count for e in events)
    print(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms (kernel time {device_ms:.2f} ms in "
          f"{n_kernels} kernels), idle share "
          f"{1 - busy / wall_ms:.3f} | {card}")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def phase_profile(synth, card: str, batch: bool = False):
    """Trace one long request and, with ``batch``, one batch of
    BATCH_ROWS long requests on the batch's wire."""
    seq = synth.phonemize(LONG_TEXT)
    trace(lambda: synth.synthesize_ids(seq),
          f"long request {dname(synth.dtype)}", card)
    if batch:
        transfer, synth.transfer = synth.transfer, BATCH_TRANSFER
        trace(lambda: synth.tts_batch([LONG_TEXT] * BATCH_ROWS),
              f"batch of {BATCH_ROWS} long requests, {BATCH_TRANSFER} wire, "
              f"{dname(synth.dtype)}", card)
        synth.transfer = transfer


def _reset_counts(*modules):
    for m in modules:
        m.launches.update(dict.fromkeys(m.launches, 0))


def phase_batch(synth, card: str, rows: int = BATCH_ROWS):
    """``tts_batch`` on the ADPCM3 wire: ``rows`` copies of the long text
    (the bench's batch) and a mixed batch of the long and short texts,
    with the launches of K1, K2 and the ADPCM encoder counted from 0 just
    before each batch and read just after (K1 5 and K2 4 a row of the
    padded batch, in the serving dtype; one encode a program); each row
    held to its text's single request on the same wire.  Returns the
    batch's launches and the speculative frames of its program."""
    from efficientspeech_tpu_torch.ops.kernels import adpcm
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    dt = synth.dtype
    tag = "batch" + f32_suffix(dt)
    up = synth.hifigan_cfg.total_upsample
    transfer, synth.transfer = synth.transfer, BATCH_TRANSFER
    cases = [(f"{rows} x long", [LONG_TEXT] * rows)]
    if dt == torch.bfloat16:
        cases.append(("mixed", [LONG_TEXT, *SHORT_TEXTS]))
    singles = {}
    for text in {t for _, texts in cases for t in texts}:
        synth.tts(text)  # warm-up, and the ratio observed
        singles[text] = synth.tts(text)[0]
    launches, spec = {}, None
    for name, texts in cases:
        synth.tts_batch(texts)  # warm-up: first-call set-up stays out
        seqs = [synth.phonemize(t) for t in texts]
        bucket = synth._pad_to_bucket(max(seqs, key=len))[2]
        frames = synth._spec_frames(max(len(q) for q in seqs), bucket)
        b_pad = 1 << (len(texts) - 1).bit_length()
        torch.cuda.synchronize()
        _reset_counts(fm, mrf_block, adpcm)
        t0 = time.perf_counter()
        outs = synth.tts_batch(texts)
        wall = time.perf_counter() - t0
        k1, k2, enc = (fm.launches[dt], mrf_block.launches[dt],
                       adpcm.launches[3])
        voice = sum(info["voice_secs"] for _, info in outs)
        print(f"[{tag}] {name}: {len(texts)} rows (padded to {b_pad}), "
              f"{frames} speculative frames, {BATCH_TRANSFER} wire | wall "
              f"{wall * 1e3:.1f} ms (the program and the copy to the host "
              f"{outs[0][1]['batch_secs'] * 1e3:.1f}, the rest the host's "
              f"decode), voice {voice:.2f} s, RTF {voice / wall:.1f} | "
              f"launches K1 {k1} K2 {k2} ADPCM {enc} | {card}")
        if (k1, k2, enc) != (5 * b_pad, 4 * b_pad, 1):
            fail(f"{tag} {name}: launches K1 {k1} K2 {k2} ADPCM {enc}; "
                 f"expected {5 * b_pad}, {4 * b_pad} and 1")
        other = sum(n for m in (fm, mrf_block) for k, n in m.launches.items()
                    if k != dt) + sum(adpcm.launches.values()) - enc
        if other:
            fail(f"{tag} {name}: {other} launches of another variant")
        worst, equal = float("inf"), 0
        for i, (text, (wav, info)) in enumerate(zip(texts, outs)):
            want = singles[text]
            if wav.shape != (info["mel_len"] * up,) or len(want) != len(wav):
                fail(f"{tag} {name} row {i}: {len(wav)} samples, the single "
                     f"request {len(want)}")
            if not np.isfinite(wav).all():
                fail(f"{tag} {name} row {i}: non-finite samples")
            equal += bool(np.array_equal(wav, want))
            worst = min(worst, snr_db(torch.from_numpy(want),
                                      torch.from_numpy(wav)))
        print(f"[{tag}] {name}: rows against their single requests: "
              f"{equal} of {len(texts)} bit-equal, worst SNR {worst:.1f} dB "
              f"(tol >= {BATCH_SNR_DB}) | {card}")
        if worst < BATCH_SNR_DB:
            fail(f"{tag} {name}: a row at {worst:.1f} dB < {BATCH_SNR_DB} dB "
                 f"of its single request")
        if name != "mixed":
            launches = {"folded_matmul" + f32_suffix(dt, "_"): k1,
                        "mrf_fused" + f32_suffix(dt, "_"): k2,
                        "adpcm_encode": enc}
            spec = frames
    synth.transfer = transfer
    return launches, spec


def phase_stream_chunked(synth, card: str):
    """``tts_stream`` of the long text (its segments, each finite), and
    the long request in ``vocoder_mode="chunked"`` (the conv generator
    over 128-frame chunks) held to the folded kernel route's waveform at
    the end-to-end bar."""
    seq = synth.phonemize(LONG_TEXT)
    max_len = synth.phoneme_buckets[-1] // 4
    want = len(synth._segment(seq, max_len))
    list(synth.tts_stream(LONG_TEXT))  # warm-up
    t0 = time.perf_counter()
    segs = list(synth.tts_stream(LONG_TEXT))
    wall = time.perf_counter() - t0
    if len(segs) != want or want < 2:
        fail(f"stream: {len(segs)} segments, expected {want} (>= 2)")
    for wav, info in segs:
        if (not np.isfinite(wav).all() or info["mel_len"] <= 0
                or len(wav) != info["mel_len"]
                * synth.hifigan_cfg.total_upsample):
            fail(f"stream: segment {info['segment']} is not a finite "
                 f"waveform of its mel length")
    print(f"[stream] long text: {len(segs)} segments of <= {max_len} "
          f"phonemes, first after {segs[0][1]['secs'] * 1e3:.1f} ms, all "
          f"in {wall * 1e3:.1f} ms | {card}")

    wav_f, mel_f, _ = synth.synthesize_ids(seq)
    synth.vocoder_mode = "chunked"
    synth.synthesize_ids(seq)  # warm-up
    t0 = time.perf_counter()
    wav_c, mel_c, _ = synth.synthesize_ids(seq)
    wall = time.perf_counter() - t0
    synth.vocoder_mode = "folded_kernel"
    if mel_c != mel_f:
        fail(f"chunked mode mel_len {mel_c} != folded route {mel_f}")
    snr = snr_db(torch.from_numpy(wav_f), torch.from_numpy(wav_c))
    print(f"[chunked] long request, chunked mode vs folded kernel route: SNR "
          f"{snr:.1f} dB (tol >= {E2E_SNR_DB}) | {wall * 1e3:.1f} ms | {card}")
    if not np.isfinite(wav_c).all() or snr < E2E_SNR_DB:
        fail(f"chunked mode: SNR {snr:.1f} dB < {E2E_SNR_DB} dB")


def http_get(port: int, path: str, timeout: float = 120.0):
    """GET from the local server: (status, headers, body, ms)."""
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            status, headers, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, headers, body = e.code, e.headers, e.read()
    return status, headers, body, (time.perf_counter() - t0) * 1e3


def http_stream(port: int, path: str, timeout: float = 120.0):
    """GET of a chunked response, read chunk by chunk off the socket:
    (status, headers, chunks, ms at which each chunk arrived)."""
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as sock:
        sock.sendall(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     f"Connection: close\r\n\r\n".encode())
        f = sock.makefile("rb")
        status = int(f.readline().split()[1])
        headers = {}
        while line := f.readline().strip():
            key, value = line.decode().split(":", 1)
            headers[key.strip().lower()] = value.strip()
        chunks, times = [], []
        while True:
            size = int(f.readline().strip(), 16)
            data = f.read(size)
            f.readline()
            if size == 0:
                break
            chunks.append(data)
            times.append((time.perf_counter() - t0) * 1e3)
    return status, headers, chunks, times


def wav_pcm(tag: str, body: bytes) -> np.ndarray:
    """The int16 samples of a served WAV; fails unless it is RIFF/WAVE
    with a data chunk of its length."""
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE" or body[36:40] != b"data":
        fail(f"{tag}: not a RIFF/WAVE payload")
    n = int.from_bytes(body[40:44], "little")
    if n != len(body) - 44 or n == 0 or n % 2:
        fail(f"{tag}: data chunk of {n} bytes in a {len(body)}-byte body")
    return np.frombuffer(body[44:], "<i2")


def pcm_snr(want: np.ndarray, got: np.ndarray) -> float:
    return snr_db(torch.from_numpy(want.astype(np.float64)),
                  torch.from_numpy(got.astype(np.float64)))


def tts_path(text: str) -> str:
    return "/tts?text=" + urllib.parse.quote(text)


def stall_stream(ms: float):
    """Enqueue a spin of about ``ms`` on the current stream (the one all
    synthesis runs on), calibrated by timing a shorter one."""
    cal = int(2e8)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cal)
    end.record()
    end.synchronize()
    per_ms = cal / start.elapsed_time(end)
    torch.cuda._sleep(int(per_ms * ms))


def phase_serve(synth, card: str):
    """The port's server (``efficientspeech_tpu_torch.serve``), built
    in-process on 127.0.0.1 through its own make_server and make_handler
    and warmed by the function main() runs: 503 until ready; a long /tts
    through the batcher and through the direct path (K1 and K2 counted
    inside the request, the PCM held to the single request's); 32 clients
    of 4 mixed requests each (every answer 200, a batch > 1, each PCM held
    to its text's single request); /tts_stream of the long text (chunks,
    the first audio's time); a long /tts on the adpcm4 wire through the
    C++ decoder; and the fetch deadline against a stalled stream: 503,
    the breaker's fast 503, the abandoned read counted, then recovery."""
    from efficientspeech_tpu_torch import serve
    from efficientspeech_tpu_torch.audio.adpcm import decode_lib
    from efficientspeech_tpu_torch.ops.kernels import adpcm
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    dt = synth.dtype
    max_wav = synth.preprocess_cfg.audio.max_wav_value
    lock = threading.Lock()
    servers = []

    def start(**kw):
        base = serve.make_handler(synth, lock=lock,
                                  stream_segment_phonemes=SERVE_SEGMENT, **kw)

        class Quiet(base):
            def log_message(self, fmt, *a):
                pass

        server = serve.make_server("127.0.0.1", 0, Quiet)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return server.server_port

    state = serve.ServeState()
    state.ready = False
    port = start(dynamic_batch=True, max_batch=SERVE_MAX_BATCH,
                 fetch_timeout_s=SERVE_FETCH_TIMEOUT_S,
                 queue_deadline_s=SERVE_QUEUE_DEADLINE_S, state=state)
    status, headers, _, _ = http_get(port, "/healthz")
    if status != 503 or not headers.get("Retry-After"):
        fail(f"serve: /healthz answered {status} before ready (expected "
             f"503 with Retry-After)")
    exits = []
    t0 = time.perf_counter()
    warm = threading.Thread(target=serve.init_and_warm, daemon=True, args=(
        synth, state, lock, serve.get_args([]).warmup_text,
        SERVE_BUCKETS, serve.warm_batch_sizes(True, SERVE_MAX_BATCH)),
        kwargs={"exit_fn": exits.append})
    warm.start()
    warm.join(300)
    ready_s = time.perf_counter() - t0
    if exits or not state.ready:
        fail(f"serve: the warm-up failed (exit {exits})")
    if http_get(port, "/healthz")[0] != 200:
        fail("serve: /healthz not 200 after ready")
    print(f"[serve] ready in {ready_s:.2f} s (warm-up text x2, buckets "
          f"{list(SERVE_BUCKETS)} at batch "
          f"{serve.warm_batch_sizes(True, SERVE_MAX_BATCH)}) | {card}")

    # single requests of each text, the yardstick of the served PCM
    texts = (LONG_TEXT,) + SHORT_TEXTS
    with lock:
        single = {t: np.frombuffer(serve.pcm16(synth.tts(t)[0], max_wav),
                                   "<i2") for t in texts}

    def check_pcm(tag, text, body, bar=BATCH_SNR_DB):
        pcm = wav_pcm(tag, body)
        if len(pcm) != len(single[text]):
            fail(f"{tag}: {len(pcm)} samples, the single request "
                 f"{len(single[text])}")
        snr = pcm_snr(single[text], pcm)
        if snr < bar:
            fail(f"{tag}: {snr:.1f} dB < {bar} dB of the single request")
        return pcm, snr

    direct = start(dynamic_batch=False,
                   fetch_timeout_s=SERVE_FETCH_TIMEOUT_S)
    long_int16 = None
    for name, p in (("batcher", port), ("direct", direct)):
        _reset_counts(fm, mrf_block)
        status, headers, body, ms = http_get(p, tts_path(LONG_TEXT))
        k1, k2 = fm.launches[dt], mrf_block.launches[dt]
        if status != 200:
            fail(f"serve: long /tts ({name}) answered {status}: {body[:200]}")
        pcm, snr = check_pcm(f"serve long /tts ({name})", LONG_TEXT, body)
        long_int16 = pcm if long_int16 is None else long_int16
        print(f"[serve] long /tts via the {name} path: {ms:.1f} ms, X-RTF "
              f"{headers['X-RTF']}, X-Batch-Size "
              f"{headers.get('X-Batch-Size', '-')} | launches K1 {k1} K2 "
              f"{k2} | {snr:.1f} dB against the single request (tol >= "
              f"{BATCH_SNR_DB}) | {card}")
        if k1 < 5 or k2 < 4:
            fail(f"serve long /tts ({name}): launches K1 {k1} K2 {k2}; "
                 f"expected >= 5 and >= 4")

    # concurrency: every client sends its requests one after another
    def client(c):
        out = []
        for i in range(SERVE_PER_CLIENT):
            text = texts[(c + i) % len(texts)]
            status, headers, body, ms = http_get(port, tts_path(text))
            out.append((text, status, headers.get("X-Batch-Size"), body,
                        ms))
        return out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
        runs = [r for rs in ex.map(client, range(SERVE_CLIENTS)) for r in rs]
    wall = time.perf_counter() - t0
    bad = [(s, b[:120]) for _, s, _, b, _ in runs if s != 200]
    if bad:
        fail(f"serve: {len(bad)} of {len(runs)} answers not 200: {bad[:3]}")
    sizes = collections.Counter(int(b) for _, _, b, _, _ in runs)
    if max(sizes) <= 1:
        fail(f"serve: no batch formed (X-Batch-Size {dict(sizes)})")
    worst = min(check_pcm(f"serve concurrent {text[:12]!r}", text, body)[1]
                for text, _, _, body, _ in runs)
    lat = np.array([ms for *_, ms in runs])
    voice = sum(len(single[t]) for t, *_ in runs) / synth.sampling_rate
    print(f"[serve] {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} mixed "
          f"requests: all 200 in {wall * 1e3:.1f} ms, latency p50 "
          f"{np.percentile(lat, 50):.1f} p95 {np.percentile(lat, 95):.1f} "
          f"p99 {np.percentile(lat, 99):.1f} ms, served RTF "
          f"{voice / wall:.1f} ({voice:.2f} s of voice), batch sizes "
          f"{dict(sorted(sizes.items()))} (size: answers), worst "
          f"{worst:.1f} dB against the single requests (tol >= "
          f"{BATCH_SNR_DB}) | {card}")

    # the stream: chunked framing, the header then a chunk a segment
    status, headers, chunks, times = http_stream(
        port, "/tts_stream?text=" + urllib.parse.quote(LONG_TEXT))
    if status != 200 or headers.get("transfer-encoding") != "chunked":
        fail(f"serve /tts_stream: status {status}, headers {headers}")
    if len(chunks) < 3 or chunks[0][:4] != b"RIFF" or len(chunks[0]) != 44:
        fail(f"serve /tts_stream: {len(chunks)} chunks (a 44-byte header "
             f"and >= 2 PCM chunks expected)")
    with lock:
        want = np.concatenate([w for w, _ in synth.tts_stream(
            LONG_TEXT, segment_phonemes=SERVE_SEGMENT)])
    want = np.frombuffer(serve.pcm16(want, max_wav), "<i2")
    got = np.frombuffer(b"".join(chunks[1:]), "<i2")
    if len(got) != len(want):
        fail(f"serve /tts_stream: {len(got)} samples, tts_stream "
             f"{len(want)}")
    snr = pcm_snr(want, got)
    print(f"[serve] /tts_stream long text: {len(chunks) - 1} PCM chunks, "
          f"first audio after {times[1]:.1f} ms, all after {times[-1]:.1f} "
          f"ms | {snr:.1f} dB against tts_stream's segments (tol >= "
          f"{BATCH_SNR_DB}) | {card}")
    if snr < BATCH_SNR_DB:
        fail(f"serve /tts_stream: {snr:.1f} dB < {BATCH_SNR_DB} dB")

    # the adpcm4 wire: encoded on the card, decoded by the C++ library
    # (the port has no other host decoder)
    with lock:
        transfer, synth.transfer = synth.transfer, "adpcm4"
    _reset_counts(adpcm)
    status, _, body, ms = http_get(direct, tts_path(LONG_TEXT))
    with lock:
        synth.transfer = transfer
    if status != 200:
        fail(f"serve adpcm4 /tts answered {status}")
    pcm = wav_pcm("serve adpcm4 /tts", body)
    snr = pcm_snr(long_int16, pcm) if len(pcm) == len(long_int16) else -1.0
    print(f"[serve] long /tts on the adpcm4 wire: {ms:.1f} ms, encoder "
          f"launches {adpcm.launches[4]}, host decoder "
          f"{os.path.basename(decode_lib()._name)} | {snr:.1f} dB against "
          f"the int16 answer (tol >= {ADPCM_SNR_DB['adpcm4']}) | {card}")
    if adpcm.launches[4] < 1 or snr < ADPCM_SNR_DB["adpcm4"]:
        fail(f"serve adpcm4 /tts: encoder launches {adpcm.launches[4]}, "
             f"{snr:.1f} dB")

    # the deadline on the card: a stalled stream, no hook
    stalled = start(dynamic_batch=False, fetch_timeout_s=SERVE_STALL_FETCH_S,
                    breaker_cooldown_s=SERVE_STALL_COOLDOWN_S)
    t_stall = time.perf_counter()
    stall_stream(SERVE_STALL_MS)
    status, headers, body, ms1 = http_get(stalled, tts_path(SHORT_TEXTS[0]))
    t_trip = time.perf_counter()
    if status != 503 or not headers.get("Retry-After") or ms1 > 2000:
        fail(f"serve deadline: /tts behind a stalled stream answered "
             f"{status} in {ms1:.0f} ms (expected 503 with Retry-After "
             f"within 2 s): {body[:200]}")
    status2, _, _, ms2 = http_get(stalled, tts_path(SHORT_TEXTS[1]))
    pending = synth.pending_fetches()
    if status2 != 503 or ms2 > 500:
        fail(f"serve deadline: the breaker's answer {status2} in "
             f"{ms2:.0f} ms (expected 503 within 0.5 s)")
    if pending < 1:
        fail("serve deadline: pending_fetches() 0 while the stream stalls")
    torch.cuda.synchronize()
    stall_ms = (time.perf_counter() - t_stall) * 1e3
    time.sleep(max(0.0, t_trip + SERVE_STALL_COOLDOWN_S
                   - time.perf_counter()) + 0.05)
    status3, _, body, ms3 = http_get(stalled, tts_path(SHORT_TEXTS[0]))
    after = synth.pending_fetches()
    print(f"[serve] deadline {SERVE_STALL_FETCH_S} s behind a "
          f"{SERVE_STALL_MS:.0f} ms stall (ended after {stall_ms:.0f} ms): "
          f"503 in {ms1:.1f} ms (Retry-After {headers['Retry-After']}), "
          f"breaker 503 in {ms2:.1f} ms, pending reads {pending}; after "
          f"the cooldown {status3} in {ms3:.1f} ms, pending reads {after} "
          f"| {card}")
    if status3 != 200 or after != 0:
        fail(f"serve deadline: recovery answered {status3}, "
             f"pending_fetches() {after}")
    check_pcm("serve deadline recovery", SHORT_TEXTS[0], body)
    synth.fetch_timeout_s = None
    for server in servers:
        server.shutdown()
        server.server_close()


def speechlike(n: int, seed: int = 0) -> np.ndarray:
    """A harmonic stack under an amplitude envelope and breath noise (the
    JAX package's codec tests' signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    f0 = 140 + 40 * np.sin(2 * np.pi * 2.1 * t)
    phase = np.cumsum(2 * np.pi * f0 / 22050.0)
    x = (0.5 * np.sin(phase) + 0.25 * np.sin(2 * phase)
         + 0.12 * np.sin(3 * phase))
    env = 0.3 + 0.7 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.7 * t)) ** 2
    x = x * env + 0.01 * rng.normal(size=n)
    return (0.8 * x / np.abs(x).max()).astype(np.float32)


def phase_adpcm(card: str, batch_frames: int):
    """The ADPCM encoder against its plain version, bit-equal, for each
    width at the long request's shape (1 x 4,096 frames) and the batch's
    (BATCH_ROWS x its speculative frames), with constant, full-scale and
    clipped blocks among random ones; times by CUDA events, the bound the
    bytes read and written over the memory rate.  Then the decoded
    waveform of a speech-like signal at the codec's SNR bar."""
    from efficientspeech_tpu_torch.audio.transfer import decode_host
    from efficientspeech_tpu_torch.ops.kernels import adpcm

    gen = torch.Generator(device="cpu").manual_seed(3)
    shapes = (("long", 1, 4096 * 256),
              ("batch", BATCH_ROWS, batch_frames * 256))
    row = None
    for name, b, t in shapes:
        x = torch.rand(b, t, generator=gen) * 2.4 - 1.2
        lanes = x.view(-1, 256)
        lanes[0::16] = 0.3
        lanes[1::16] = torch.where(lanes[1::16] > 0, 1.0, -1.0)
        lanes[2::16] *= 3.0
        x = x.cuda()
        for bits in adpcm.BITS:
            got = adpcm.adpcm_encode(x, bits)
            want = adpcm.adpcm_encode_plain(x, bits)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"ADPCM{bits} {name}: {int((got != want).sum())} bytes "
                     f"differ from the plain version")
            ms, host_ms = time_ms(lambda: adpcm.adpcm_encode(x, bits), 20)
            plain_ms, _ = time_ms(lambda: adpcm.adpcm_encode_plain(x, bits),
                                  2)
            b_ms, by = bound(0.0, x.numel() * 4 + got.numel())
            print(f"[ADPCM{bits}] {name}: {b} x {t} samples -> {got.numel()} "
                  f"bytes | bit-equal | kernel_ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms null bound_ms {b_ms:.4f} "
                  f"({by}) | wrapper host_ms {host_ms:.4f} | {card}")
            if (name, bits) == ("batch", 3):
                row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=by, max_abs_err=0.0, library_ms=None)
        del x, got, want
    n = 64 * 256
    sig = speechlike(n)
    for fmt, bar in ADPCM_SNR_DB.items():
        bits = int(fmt[-1])
        wire = adpcm.adpcm_encode(torch.from_numpy(sig[None]).cuda(), bits)
        y = decode_host(wire.cpu().numpy()[0], fmt)
        snr = 10 * np.log10((sig ** 2).sum() / ((sig - y) ** 2).sum())
        print(f"[ADPCM{bits}] speech-like signal through the wire: SNR "
              f"{snr:.1f} dB (tol > {bar}) | {card}")
        if len(y) != n or not snr > bar:
            fail(f"{fmt}: decoded SNR {snr:.1f} dB <= {bar} dB")
    return row


def phase_bench(card: str):
    """The bench entry point once, in a process of its own, at a small
    size, its lines printed as they come; then a short run of its
    single-stream metric with --profile, which checks the profile's line
    (the device's busy ms and idle share over the timed runs) and whose
    numbers, taken under the profiler, are not kept."""
    here = os.path.dirname(os.path.abspath(__file__))
    bench = [sys.executable, "-m", "efficientspeech_tpu_torch.bench"]

    def run(args):
        out = subprocess.run(bench + args, capture_output=True, text=True,
                             timeout=600, cwd=here)
        if out.returncode != 0:
            fail(f"bench {' '.join(args)} exited {out.returncode}:\n"
                 f"{out.stderr[-4000:]}")
        return out.stdout.splitlines()

    t0 = time.perf_counter()
    lines = run(["--iter", "5", "--warmup", "2", "--batch", "16"])
    for line in lines:
        print(f"[bench] {line}")
    last = json.loads(lines[-1])
    if last["metric"] != "text_to_wav_rtf" or not last["value"] > 0:
        fail(f"bench: the last line is not a text_to_wav_rtf: {last}")
    print(f"[bench] {time.perf_counter() - t0:.1f} s | {card}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as prof:
        lines = run(["--metric", "rtf", "--iter", "2", "--warmup", "1",
                     "--profile", prof])
        trace_bytes = os.path.getsize(os.path.join(prof, "bench_trace.json"))
    summary = json.loads(lines[0])
    if not (isinstance(summary.get("device_busy_ms"), float)
            and 0 < summary["idle_share"] < 1 and trace_bytes > 0):
        fail(f"bench --profile: {summary}, trace {trace_bytes} bytes")
    print(f"[bench] --metric rtf --iter 2 --profile: {lines[0]}; trace "
          f"{trace_bytes / 1e6:.1f} MB; {time.perf_counter() - t0:.1f} s "
          f"(profiled, not a bench number) | {card}")


def _snr_check(tag: str, pairs, card: str, bar: float = KERNEL_SNR_DB,
               floors=None):
    """Fail unless every (name, kernel, plain) output is finite and holds
    its plain version at ``bar`` dB, and at its regression floor
    ``floors[name]`` where ``floors`` names one; returns the worst
    max-abs error."""
    worst = 0.0
    for name, got, want in pairs:
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{tag} {name}: {got.dtype} {tuple(got.shape)} vs plain "
                 f"{want.dtype} {tuple(want.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{tag} {name}: non-finite output")
        snr = snr_db(want, got)
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        floor = (floors or {}).get(name, 0.0)
        floor_note = f", floor {floor}" if floor else ""
        print(f"[{tag}] {name}: SNR {snr:.1f} dB (tol >= {bar}"
              f"{floor_note}) max_abs_err {err:.3g} | {card}")
        if snr < max(bar, floor):
            fail(f"{tag} {name}: SNR {snr:.1f} dB < {max(bar, floor)} dB")
    return worst


def _row(tag: str, fn, plain, library, flops, f32_flops, nbytes,
         per_step: int, card: str, iters: int = 20,
         f32_products: float = 0.0):
    """Time one direction of a training kernel at its main-path shape and
    scale to the launches of one train step.  ``f32_products``: float32
    product FLOP, bound at the faster of FFMA and 3xTF32 (the FFMA-route
    bound is printed beside)."""
    ms, host_ms = time_ms(fn, iters)
    plain_ms, _ = time_ms(plain, 3)
    lib_ms = time_ms(library, iters)[0] if library is not None else None
    b_ms, by = bound(flops, nbytes, f32_flops, f32_products=f32_products)
    ffma_ms = (bound(flops, nbytes, f32_flops + f32_products)[0]
               if f32_products else None)
    print(f"[{tag}] per launch: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {'null' if lib_ms is None else f'{lib_ms:.4f}'} "
          f"bound_ms {b_ms:.4f} ({by}){ffma_note(ffma_ms)} | "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP bf16 + "
          f"{(f32_flops + f32_products) / 1e9:.2f} GFLOP f32 | achieved "
          f"{nbytes / ms / 1e6:.0f} GB/s | wrapper host_ms {host_ms:.4f} "
          f"| {card}")
    return dict(ms=ms * per_step, plain_ms=plain_ms * per_step,
                library_ms=None if lib_ms is None else lib_ms * per_step,
                bound_ms=b_ms * per_step, bound_by=by)


def phase_k3(card: str, c: int, per_step: int, dt=torch.bfloat16):
    """K3 at the training shape of a decoder of width ``c`` in ``dt``: its
    frame-rate LayerNorms over 128 × 1,024 frames; the times scale to
    ``per_step`` launches a train step."""
    import torch.nn.functional as F

    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3

    dev = torch.device("cuda")
    rows = TRAIN_BATCH * TRAIN_FRAMES
    tag = f"K3 C={c}" + f32_suffix(dt)
    bar, size = snr_bar(dt), torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.randn(rows, c, generator=gen) * 2 + 0.5).to(dev, dt)
    s = (torch.randn(c, generator=gen) * 0.5 + 1).to(dev)
    b = (torch.randn(c, generator=gen) * 0.1).to(dev)
    dy = torch.randn(rows, c, generator=gen).to(dev, dt)
    floors = K3_BF16_FLOOR_DB[c] if dt == torch.bfloat16 else None
    err_f = _snr_check(f"{tag} fwd", [("y", k3.layer_norm_fwd(x, s, b),
                                       k3.layer_norm_fwd_plain(x, s, b))],
                       card, bar, floors)
    err_b = _snr_check(f"{tag} bwd", zip(
        ("dx", "dscale", "dbias"), k3.layer_norm_bwd(x, s, dy),
        k3.layer_norm_bwd_plain(x, s, dy)), card, bar, floors)
    torch.cuda.synchronize()

    xs = x.clone().requires_grad_()
    sb, bb = s.to(dt).requires_grad_(), b.to(dt).requires_grad_()
    y_lib = F.layer_norm(xs, (c,), sb, bb)
    elems = rows * c
    # float32 FLOP per element: forward ~8 (two sums, centre, square,
    # scale, shift), backward ~14
    fwd = _row(f"{tag} fwd", lambda: k3.layer_norm_fwd(x, s, b),
               lambda: k3.layer_norm_fwd_plain(x, s, b),
               lambda: F.layer_norm(x, (c,), sb.detach(), bb.detach()),
               0.0, 8.0 * elems, 2 * elems * size + 2 * c * 4, per_step,
               card)
    bwd = _row(f"{tag} bwd", lambda: k3.layer_norm_bwd(x, s, dy),
               lambda: k3.layer_norm_bwd_plain(x, s, dy),
               lambda: torch.autograd.grad(y_lib, (xs, sb, bb), dy,
                                           retain_graph=True),
               0.0, 14.0 * elems, 3 * elems * size + 3 * c * 4, per_step,
               card)
    return dict(fwd, max_abs_err=err_f), dict(bwd, max_abs_err=err_b)


def phase_k4(card: str, c: int, per_step: int, dt=torch.bfloat16):
    """K4 at the training shape of a decoder of width ``c`` in ``dt``,
    with per-utterance padded tails that mask about 1/6 of the frames; the
    times scale to ``per_step`` launches a train step."""
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4

    dev = torch.device("cuda")
    b, m, k = TRAIN_BATCH, TRAIN_FRAMES, 5
    tag = f"K4 C={c}" + f32_suffix(dt)
    bar, size = snr_bar(dt), torch.finfo(dt).bits // 8
    gen = torch.Generator(device="cpu").manual_seed(4)
    f = lambda *shape, sd=1.0: (torch.randn(*shape, generator=gen) * sd
                                ).to(dev)
    x = f(b, m, c).to(dt)
    lengths = torch.randint(2 * m // 3, m + 1, (b,), generator=gen)
    keep = (torch.arange(m)[None, :] < lengths[:, None]).float().to(dev)
    weights = [f(c, 1, k, sd=0.4), f(c, sd=0.1),
               f(c, c, 1, sd=0.09 * (128 / c) ** 0.5), f(c, sd=0.1),
               1 + f(c, sd=0.2), f(c, sd=0.1)]
    dy = f(b, m, c).to(dt)
    print(f"[{tag}] (B, M, C) ({b}, {m}, {c}), masked frames "
          f"{1 - float(keep.mean()):.3f} | {card}")
    f32 = dt == torch.float32
    plan = k4.f32_fwd_plan(c) if f32 else k4.bf16_fwd_plan(c)
    print(f"[{tag} fwd] {plan} | {card}")
    plan = k4.f32_bwd_plan(c) if f32 else k4.bf16_bwd_plan(c)
    print(f"[{tag} bwd] {plan} | {card}")
    err_f = _snr_check(f"{tag} fwd", [(
        "y", k4.decoder_block_fwd(x, keep, *weights),
        k4.decoder_block_fwd_plain(x, keep, *weights))], card, bar,
        None if f32 else {"y": K4_BF16_FWD_FLOOR_DB[c]})
    grads = k4.decoder_block_bwd(x, keep, *weights[:5], dy)
    err_b = _snr_check(f"{tag} bwd", zip(
        ("dx", "d_dw_w", "d_dw_b", "d_pw_w", "d_pw_b", "d_ln_s", "d_ln_b"),
        grads, k4.decoder_block_bwd_plain(x, keep, *weights[:5], dy)), card,
        bar, None if dt == torch.float32 else K4_BF16_BWD_FLOOR_DB[c])
    torch.cuda.synchronize()
    if grads[0][keep == 0].any():
        fail(f"{tag} bwd: dx is not zero on masked frames")

    elems = b * m * c
    w_bytes = sum(w.numel() for w in weights) * 4
    mm = 2.0 * b * m * c * c  # one C x C pointwise product
    # the products run on the tensor cores in bf16, and in float32 at the
    # faster of FFMA and 3xTF32; float32 FLOP per element outside them:
    # forward ~22 (mask, 5 taps, biases, tanh, LayerNorm), backward ~60
    # (the recomputed forward, the LayerNorm and tanh gradients, 5-tap dx
    # and tap sums)
    tc = 1.0 if dt == torch.bfloat16 else 0.0
    fwd = _row(f"{tag} fwd",
               lambda: k4.decoder_block_fwd(x, keep, *weights),
               lambda: k4.decoder_block_fwd_plain(x, keep, *weights), None,
               tc * mm, 22.0 * elems,
               2 * elems * size + b * m * 4 + w_bytes, per_step, card,
               f32_products=(1 - tc) * mm)
    bwd = _row(f"{tag} bwd",
               lambda: k4.decoder_block_bwd(x, keep, *weights[:5], dy),
               lambda: k4.decoder_block_bwd_plain(x, keep, *weights[:5], dy),
               None, tc * 3 * mm, 60.0 * elems,
               3 * elems * size + b * m * 4 + 2 * w_bytes, per_step, card,
               f32_products=(1 - tc) * 3 * mm)
    return dict(fwd, max_abs_err=err_f), dict(bwd, max_abs_err=err_b)


def phase_k5(card: str):
    """K5 at the int8 probe's shape, both variants against the plain
    version; then the probe entry point once, K5's main path, with the
    launches counted from 0 just before and read just after."""
    from efficientspeech_tpu_torch.ops.kernels import int8_window as k5
    from efficientspeech_tpu_torch.probes import int8_window as probe

    dev = torch.device("cuda")
    t, d_in, d_out, n_win, tm = probe.SHAPE
    xb, xi, w = probe.probe_inputs(t, d_in, d_out, n_win, tm, dev)
    t_pad = k5.layout(t, tm, n_win)[0]
    w_col = w.t().contiguous().t()  # the library product's B layout
    stats = {}
    for name, x in (("bf16", xb), ("int8", xi)):
        tag = f"K5 {name}-in"
        got = k5.int8_window_matmul(x, w, n_win, tm)
        want = k5.int8_window_matmul_plain(x, w, n_win, tm)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{tag}: {tuple(got.shape)} vs plain {tuple(want.shape)}, "
                 "or not finite")
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        print(f"[{tag}] out {tuple(got.shape)} | max_abs_err {err:.3g}, "
              f"relative {rel:.3g} (tol <= {K5_REL_ERR}) | {card}")
        if rel > K5_REL_ERR:
            fail(f"{tag}: relative error {rel:.3g} > {K5_REL_ERR}")
        xq, _ = k5.quantized_slices(x, n_win, tm)
        win8 = k5.window(xq, n_win, tm).to(torch.int8).reshape(t_pad, -1)
        ms, host_ms = time_ms(lambda: k5.int8_window_matmul(x, w, n_win, tm),
                              50)
        plain_ms, _ = time_ms(
            lambda: k5.int8_window_matmul_plain(x, w, n_win, tm), 3)
        lib_ms, _ = time_ms(lambda: torch._int_mm(win8, w_col), 50)
        ops = 2.0 * t_pad * n_win * d_in * d_out
        nbytes = x.numel() * x.element_size() + w.numel() + t_pad * d_out * 4
        b_ms, by = bound(0.0, nbytes, int8_ops=ops)
        print(f"[{tag}] kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} (torch._int_mm on the window) "
              f"bound_ms {b_ms:.4f} ({by}) | {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GOP int8 | achieved {ops / ms / 1e9:.0f} "
              f"TOP/s, {nbytes / ms / 1e6:.0f} GB/s | wrapper host_ms "
              f"{host_ms:.4f} | {card}")
        cold = time_ms_flushed(
            lambda: k5.int8_window_matmul(x, w, n_win, tm), 20)
        lib_cold = time_ms_flushed(lambda: torch._int_mm(win8, w_col), 20)
        print(f"[{tag}] L2 flushed before each call: kernel_ms {cold:.4f} "
              f"library_ms {lib_cold:.4f} | {card}")
        stats[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=by, max_abs_err=err)

    # the main path: the probe entry point
    k5.launches_quant = k5.launches_int8 = 0
    probe.run(iters=20)
    launches = {"k5_bf16": k5.launches_quant, "k5_int8": k5.launches_int8}
    print(f"[K5] probe entry point: launches {launches} | {card}")
    return stats, launches


def write_corpus(root: str, n_train: int = 256, n_val: int = 16,
                 seed: int = 0):
    """A synthetic preprocessed corpus in LJSpeechDataset's layout:
    {mel,pitch,energy,duration}/*.npy, train.txt, val.txt, stats.json.
    Utterances of 32-128 ARPAbet phones, 1-8 frames each (at most 1,024
    frames), random mel frames and normalised pitch and energy."""
    from efficientspeech_tpu_torch.text.cmudict_phones import (
        ARPABET_SYMBOLS)

    rng = np.random.default_rng(seed)
    for kind in ("mel", "pitch", "energy", "duration"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
    lines, scalars = [], {"pitch": [], "energy": []}
    for u in range(n_train + n_val):
        n_ph = int(rng.integers(32, TRAIN_PHONEMES + 1))
        duration = rng.integers(1, 9, n_ph).astype(np.int64)
        arrays = {
            "duration": duration,
            "mel": (rng.standard_normal((int(duration.sum()), 80)) - 4.0
                    ).astype(np.float32),
            "pitch": rng.standard_normal(n_ph).astype(np.float32),
            "energy": rng.standard_normal(n_ph).astype(np.float32)}
        base = f"SYN-{u:05d}"
        for kind, arr in arrays.items():
            np.save(os.path.join(root, kind, f"LJSpeech-{kind}-{base}.npy"),
                    arr)
        for kind in scalars:
            scalars[kind].append(arrays[kind])
        phones = " ".join(rng.choice(ARPABET_SYMBOLS, n_ph))
        lines.append(f"{base}|LJSpeech|{{{phones}}}|synthetic {u}")
    with open(os.path.join(root, "val.txt"), "w") as fh:
        fh.write("\n".join(lines[:n_val]) + "\n")
    with open(os.path.join(root, "train.txt"), "w") as fh:
        fh.write("\n".join(lines[n_val:]) + "\n")
    stats = {}
    for kind, vals in scalars.items():
        v = np.concatenate(vals)
        stats[kind] = [float(v.min()), float(v.max()), float(v.mean()),
                       float(v.std())]
    with open(os.path.join(root, "stats.json"), "w") as fh:
        json.dump(stats, fh)


def phase_train(card: str, preset: str, data: str, out: str,
                profile: bool, dt=torch.bfloat16):
    """The training main path of one preset in ``dt``: Trainer.fit for
    TRAIN_EPOCHS epochs of EPOCH_STEPS steps on the card over the corpus in
    ``data``, kernel launches counted from 0 just before and read just
    after (only the ``dt`` variants may run).  Then the loss on one
    repeated batch, and the kernel route against the plain route on one
    batch."""
    from efficientspeech_tpu_torch.config import (
        ModelConfig, PreprocessConfig, TrainConfig)
    from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3
    from efficientspeech_tpu_torch.training.loop import (
        Trainer, batch_to_device)
    from efficientspeech_tpu_torch.training.step import forward_losses

    tag = f"train {preset}" + f32_suffix(dt)
    sfx = f32_suffix(dt, "_")
    loss_rtol, grad_cos = ((F32_ROUTE_LOSS_RTOL, F32_ROUTE_GRAD_COS)
                           if dt == torch.float32
                           else (ROUTE_LOSS_RTOL, ROUTE_GRAD_COS))
    t0 = time.perf_counter()
    preprocess_cfg = PreprocessConfig(preprocessed_path=data)
    stats = preprocess_cfg.load_stats()
    model_cfg = ModelConfig.preset(
        preset, pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]),
        max_phoneme_len=TRAIN_PHONEMES, max_mel_len=TRAIN_FRAMES)
    train_cfg = TrainConfig(
        batch_size=TRAIN_BATCH, warmup_epochs=0, seed=0,
        checkpoint_dir=os.path.join(out, "ckpt"),
        log_dir=os.path.join(out, "logs"))
    trainer = Trainer(model_cfg, train_cfg, preprocess_cfg, dtype=dt)
    dec = trainer.model.decoder
    width = dec.proj_norm.weight.shape[0]
    nb, bd = model_cfg.n_blocks, model_cfg.block_depth
    # K3: proj_norm and each block's skip norm; K4: every block body
    expect = (1 + nb, 1 + nb, nb * bd, nb * bd)
    counters = (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
                k4.launches_bwd)
    counts = lambda: tuple(d[width, dt] for d in counters)
    print(f"[{tag}] trainer in {time.perf_counter() - t0:.1f} s: "
          f"{len(trainer.train_ds)} train + {len(trainer.val_ds)} val "
          f"utterances, {trainer.steps_per_epoch} steps per epoch, decoder "
          f"width {width}, {nb} blocks x depth {bd}, fused norm "
          f"{dec.fused_norm} block {dec.fused_block} | {card}")
    if not (dec.fused_norm and dec.fused_block):
        fail("the trainer on the card did not take the kernel routes")
    if trainer.steps_per_epoch != EPOCH_STEPS:
        fail(f"{trainer.steps_per_epoch} steps per epoch, not "
             f"{EPOCH_STEPS}")
    total = EPOCH_STEPS * TRAIN_EPOCHS

    # the main path: launch counts from 0, read right after
    stamps, per_step = [], []
    for d in counters:
        d.update(dict.fromkeys(d, 0))

    def on_step(step, metrics):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        per_step.append(counts())

    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    per_step.append(counts())
    last = trainer.fit(max_steps=total, on_step=on_step)
    launches = dict(zip((f"k3_fwd_{width}{sfx}", f"k3_bwd_{width}{sfx}",
                         f"k4_fwd_{width}{sfx}", f"k4_bwd_{width}{sfx}"),
                        counts()))
    other = sum(d[v] for d in counters for v in d if v != (width, dt))
    if last != total:
        fail(f"fit stopped at step {last}, not {total}")
    # step_ms[i] ends at step i + 1; the gap of step EPOCH_STEPS + 1 also
    # holds the first epoch's end (metric fetch, metrics.jsonl) and the
    # loader's restart
    step_ms = np.diff(stamps) * 1e3
    step_launches = {tuple(b - a for a, b in zip(per_step[i],
                                                  per_step[i + 1]))
                     for i in range(len(per_step) - 1)}
    print(f"[{tag}] {total} steps, batch {TRAIN_BATCH} x {TRAIN_PHONEMES} "
          f"phonemes x {TRAIN_FRAMES} frames, first step "
          f"{step_ms[0]:.1f} ms | {card}")
    inside = {}
    for epoch, lo in ((0, WARMUP_STEPS), (1, EPOCH_STEPS + 1)):
        gaps = step_ms[lo:(epoch + 1) * EPOCH_STEPS]
        inside[epoch] = float(np.median(gaps))
        print(f"[{tag}] epoch {epoch}, steps {lo + 1}-"
              f"{(epoch + 1) * EPOCH_STEPS}: median step "
              f"{inside[epoch]:.2f} ms (min {gaps.min():.2f}, max "
              f"{gaps.max():.2f}), "
              f"{TRAIN_BATCH * TRAIN_FRAMES / inside[epoch] * 1e3:.0f} "
              f"frames/s | {card}")
    boundary = float(step_ms[EPOCH_STEPS])
    print(f"[{tag}] step {EPOCH_STEPS + 1}, across the epoch boundary: "
          f"{boundary:.2f} ms, {boundary - inside[1]:.2f} ms over the "
          f"second epoch's median | {card}")
    print(f"[{tag}] launches per step (K3 and K4 at C={width} "
          f"{dname(dt)}, fwd, bwd, fwd, bwd): {sorted(step_launches)}; over "
          f"the run {launches} | {card}")
    if step_launches != {expect} or other:
        fail(f"a train step launched {sorted(step_launches)} (and {other} "
             f"K3 or K4 launches of another width or dtype); expected K3 "
             f"{expect[0]} + {expect[1]} and K4 C={width} {expect[2]} + "
             f"{expect[3]}")
    logged = [json.loads(line) for line in open(
        os.path.join(train_cfg.log_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in logged if "loss" in r]
    print(f"[{tag}] epoch losses {[round(v, 4) for v in losses]}, val "
          f"{[r for r in logged if 'val_loss' in r]} | {card}")
    if len(losses) != TRAIN_EPOCHS or not np.isfinite(losses).all():
        fail(f"epoch losses missing or not finite: {losses}")

    # the loss falls over repeated steps on one batch
    batch = batch_to_device(next(iter(trainer.train_loader)),
                            trainer.device)
    repeat = []
    for _ in range(8):
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        repeat.append(float(metrics["loss"]))
    print(f"[{tag}] one batch, 8 steps: loss {repeat[0]:.4f} -> "
          f"{repeat[-1]:.4f} | {card}")
    if not np.isfinite(repeat).all() or repeat[-1] >= repeat[0]:
        fail(f"the loss did not fall on one batch: {repeat}")

    # the kernel route against the plain route on one batch
    plain = Phoneme2Mel(trainer.model_cfg).to(trainer.device)
    plain.load_state_dict(trainer.model.state_dict())
    results, route_launches = [], []
    for model in (trainer.model, plain):
        for p in model.parameters():
            p.grad = None
        before = counts()
        loss = forward_losses(model, batch, dt)["loss"]
        loss.backward()
        route_launches.append(tuple(
            n - m for m, n in zip(before, counts())))
        results.append((float(loss.detach()), {
            n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}))
    if route_launches != [expect, (0, 0, 0, 0)]:
        fail(f"the route comparison launched {route_launches} (kernel, "
             f"plain route); expected {[expect, (0, 0, 0, 0)]}")
    (loss_k, grads_k), (loss_p, grads_p) = results
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cos = {}
    for name, gp in grads_p.items():
        if not gp.any():
            continue
        gk = grads_k[name].double().flatten()
        gp = gp.double().flatten()
        cos[name] = float(gk @ gp / (gk.norm() * gp.norm()))
    worst = min(cos, key=cos.get)
    print(f"[{tag}] kernel vs plain route, one batch: loss {loss_k:.5f} vs "
          f"{loss_p:.5f} (rel {rel:.2e}, tol <= {loss_rtol}); "
          f"gradient cosine min {cos[worst]:.7f} (1 - cos "
          f"{1 - cos[worst]:.2e}) at {worst} over {len(cos)} leaves (tol "
          f">= {grad_cos}) | {card}")
    if rel > loss_rtol or cos[worst] < grad_cos:
        fail("the kernel route's train step does not hold the plain "
             "route's")

    if profile:
        trace(lambda: trainer.train_step(trainer.state, batch),
              f"{preset} {dname(dt)} train step", card)
    trainer.logger.jsonl.close()
    return launches


def phase_reference(synth, card: str, root: str):
    """Reference checkpoints: the port's writers save the parameters of
    ``synth`` (the tiny model from seed 0 with duration bias 6.0, and
    its LJ_V2-width generator) as a Lightning ``.ckpt`` and a
    ``{"generator": ...}`` file with ``weight_g``/``weight_v`` and a
    config.json beside it; ``build_synthesizer`` builds a synthesizer
    from the files on the card, which serves the long request through K1
    and K2 (launches counted from 0).  Its waveform is held at >=
    REFERENCE_SNR_DB to a synthesizer built directly from the trees the
    loaders read from the files, and its mel_len equals ``synth``'s,
    whose waveform it holds at >= E2E_SNR_DB in bf16 and at
    F32_E2E_SNR_DB for a float32 ``synth``.  Returns the generator file's
    path."""
    from efficientspeech_tpu_torch.config import ModelConfig
    from efficientspeech_tpu_torch.convert.from_torch import (
        load_efficientspeech_checkpoint, load_hifigan_checkpoint)
    from efficientspeech_tpu_torch.convert.to_torch import (
        save_hifigan_checkpoint, save_reference_checkpoint)
    from efficientspeech_tpu_torch.infer import build_synthesizer
    from efficientspeech_tpu_torch.models.efficientspeech import (
        EfficientSpeech)
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block
    from efficientspeech_tpu_torch.weights import (
        init_params, set_duration_bias, to_jax_params)

    t0 = time.perf_counter()
    cfg = ModelConfig.preset("tiny")
    model = set_duration_bias(init_params(
        EfficientSpeech(cfg, synth.hifigan_cfg), 0), 6.0)
    tree = to_jax_params(model)
    ckpt = os.path.join(root, "tiny_seed0.ckpt")
    save_reference_checkpoint(ckpt, {"phoneme2mel": tree["phoneme2mel"]},
                              depth=cfg.depth, n_blocks=cfg.n_blocks,
                              block_depth=cfg.block_depth,
                              pitch_stats=cfg.pitch_stats,
                              energy_stats=cfg.energy_stats,
                              hyper_parameters={"preset": "tiny"})
    os.makedirs(os.path.join(root, "LJ_V2"))
    gen = os.path.join(root, "LJ_V2", "generator_v2")
    save_hifigan_checkpoint(gen, tree["hifigan"], synth.hifigan_cfg)
    ref = build_synthesizer(preset="tiny", checkpoint=ckpt,
                            hifigan_checkpoint=gen, dtype=synth.dtype,
                            vocoder_mode="folded_kernel")
    setup_s = time.perf_counter() - t0
    if ref.hifigan_cfg != synth.hifigan_cfg:
        fail(f"reference: config.json gave {ref.hifigan_cfg}")
    seq = ref.phonemize(LONG_TEXT)
    ref.synthesize_ids(seq)  # warm-up
    _reset_counts(fm, mrf_block)
    torch.cuda.synchronize()
    wav, info = ref.tts(LONG_TEXT)
    k1, k2 = fm.launches[synth.dtype], mrf_block.launches[synth.dtype]
    direct = build_synthesizer(
        preset="tiny", params={
            **load_efficientspeech_checkpoint(
                ckpt, depth=cfg.depth, n_blocks=cfg.n_blocks,
                block_depth=cfg.block_depth),
            "hifigan": load_hifigan_checkpoint(gen)},
        hifigan_cfg=synth.hifigan_cfg, dtype=synth.dtype,
        vocoder_mode="folded_kernel")
    same, same_info = direct.tts(LONG_TEXT)
    seed, seed_info = synth.tts(LONG_TEXT)
    snr_same = snr_db(torch.from_numpy(same), torch.from_numpy(wav))
    snr_seed = snr_db(torch.from_numpy(seed), torch.from_numpy(wav))
    seed_bar = (F32_E2E_SNR_DB if synth.dtype == torch.float32
                else E2E_SNR_DB)
    print(f"[reference] {dname(synth.dtype)}: .ckpt "
          f"{os.path.getsize(ckpt) / 1e6:.2f} MB and generator "
          f"{os.path.getsize(gen) / 1e6:.2f} MB written and built in "
          f"{setup_s:.1f} s; long request mel_len {info['mel_len']} "
          f"(direct build of the loaded trees {same_info['mel_len']}, seed "
          f"build {seed_info['mel_len']}), launches K1 {k1} K2 {k2}, "
          f"{info['total_secs'] * 1e3:.1f} ms RTF {info['rtf']:.1f}; "
          f"waveform SNR vs the direct build {snr_same:.1f} dB (tol >= "
          f"{REFERENCE_SNR_DB}), vs the seed build {snr_seed:.1f} dB (tol "
          f">= {seed_bar}) | {card}")
    if (k1, k2) != (5, 4):
        fail(f"reference: the long request launched K1 {k1} and K2 {k2} "
             "times; expected 5 and 4")
    if not (info["mel_len"] == same_info["mel_len"] == seed_info["mel_len"]
            > 0):
        fail(f"reference: mel_len {info['mel_len']}, direct build "
             f"{same_info['mel_len']}, seed build {seed_info['mel_len']}")
    if (not np.isfinite(wav).all() or snr_same < REFERENCE_SNR_DB
            or snr_seed < seed_bar):
        fail(f"reference: waveform SNR {snr_same:.1f} / {snr_seed:.1f} dB")
    del ref, direct
    return gen


RAW_PHONES = ("AA1", "AE1", "AH0", "AO1", "B", "D", "EH1", "ER0", "IY1",
              "K", "L", "M", "N", "P", "R", "S", "T", "UW1", "V", "Z")
RAW_WORDS = ("the", "voice", "of", "a", "speaker", "reads", "this", "line",
             "aloud", "slowly", "and", "clearly")


def _textgrid(path: str, intervals):
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"',
             "xmin = 0", f"xmax = {intervals[-1][1]}", "tiers? <exists>",
             "size = 1", "item []:", "    item [1]:",
             '        class = "IntervalTier"', '        name = "phones"',
             "        xmin = 0", f"        xmax = {intervals[-1][1]}",
             f"        intervals: size = {len(intervals)}"]
    for i, (s, e, t) in enumerate(intervals):
        lines += [f"        intervals [{i + 1}]:", f"            xmin = {s}",
                  f"            xmax = {e}", f'            text = "{t}"']
    with open(path, "w") as f:
        f.write("\n".join(lines))


def write_raw_corpus(root: str, textgrid_dirs, n: int,
                     seed: int = 0) -> float:
    """A synthetic raw corpus in the layout the preprocessor reads:
    ``root/LJSpeech/*.wav`` (22,050 Hz int16) and ``*.lab``, and a
    TextGrid of each under every directory of ``textgrid_dirs``.  Each
    utterance lasts 1-10 s (uniform): 0.1 s of silence, 80 ms phones on
    average, 0.1 s of pause; its voice a glide of 120-220 Hz with a
    little noise (the generator of scripts/scale_corpus.py).  Returns
    the seconds of audio written."""
    from scipy.io import wavfile

    sr = 22050
    rng = np.random.default_rng(seed)
    raw = os.path.join(root, "LJSpeech")
    os.makedirs(raw, exist_ok=True)
    for d in textgrid_dirs:
        os.makedirs(os.path.join(d, "LJSpeech"), exist_ok=True)
    total_secs = 0.0
    for u in range(n):
        target = rng.uniform(*RAW_SECONDS)
        n_ph = max(4, int((target - 0.2) / 0.08))
        intervals, t = [(0.0, 0.1, "sil")], 0.1
        for d in rng.uniform(0.05, 0.11, size=n_ph):
            p = RAW_PHONES[rng.integers(len(RAW_PHONES))]
            intervals.append((round(t, 4), round(t + d, 4), p))
            t += d
        intervals.append((round(t, 4), round(t + 0.1, 4), "sp"))
        secs = t + 0.1
        total_secs += secs
        tt = np.arange(int(secs * sr)) / sr
        f0 = 170 + 50 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * tt
                               + rng.uniform(0, 6))
        wav = 0.4 * np.sin(2 * np.pi * np.cumsum(f0) / sr)
        wav += 0.02 * rng.standard_normal(len(wav))
        base = f"LJ{u // 1000:03d}-{u % 1000:04d}"
        wavfile.write(os.path.join(raw, f"{base}.wav"), sr,
                      (wav * 32000).astype(np.int16))
        with open(os.path.join(raw, f"{base}.lab"), "w") as f:
            f.write(" ".join(rng.choice(RAW_WORDS, size=max(2, n_ph // 6))))
        for d in textgrid_dirs:
            _textgrid(os.path.join(d, "LJSpeech", f"{base}.TextGrid"),
                      intervals)
    return total_secs


def _corpus_features(out: str):
    return {kind: {f: np.load(os.path.join(out, kind, f))
                   for f in sorted(os.listdir(os.path.join(out, kind)))}
            for kind in ("mel", "pitch", "energy", "duration")}


def phase_preprocess(card: str, root: str) -> str:
    """The preprocessing pipeline on the card: a raw corpus of
    RAW_UTTERANCES utterances through ``Preprocessor(device=card)
    .build_from_path(num_workers=PREPROCESS_WORKERS)`` (the workers do
    the wav, TextGrid and DIO pitch on the host; this process each mel
    and energy on the card), then the same with ``device="cpu"``: the
    text files byte-equal, durations and pitch bit-equal, the mel and
    energy and stats.json within their bars.  Returns the card run's
    preprocessed directory."""
    import random

    from efficientspeech_tpu_torch.config import PreprocessConfig
    from efficientspeech_tpu_torch.data.preprocessor import Preprocessor

    outs = {d: os.path.join(root, f"preprocessed_{d}")
            for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    audio_secs = write_raw_corpus(
        os.path.join(root, "raw"),
        [os.path.join(o, "TextGrid") for o in outs.values()], RAW_UTTERANCES)
    print(f"[preprocess] raw corpus: {RAW_UTTERANCES} utterances, "
          f"{audio_secs:.1f} s of audio at 22,050 Hz ({RAW_SECONDS[0]:.0f}-"
          f"{RAW_SECONDS[1]:.0f} s each), written in "
          f"{time.perf_counter() - t0:.1f} s | {card}")
    walls, lines = {}, {}
    for dev, out in outs.items():
        cfg = PreprocessConfig(dataset="LJSpeech", corpus_path=root,
                               raw_path=os.path.join(root, "raw"),
                               preprocessed_path=out, val_size=RAW_VAL)
        pre = Preprocessor(cfg, device=dev if dev == "cpu" else None)
        random.seed(0)  # the train/val shuffle
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines[dev] = pre.build_from_path(verbose=False,
                                         num_workers=PREPROCESS_WORKERS)
        walls[dev] = time.perf_counter() - t0
        print(f"[preprocess] {pre.stft.device}, {PREPROCESS_WORKERS} "
              f"workers: {len(lines[dev])} utterances in {walls[dev]:.2f} s, "
              f"{len(lines[dev]) / walls[dev]:.1f} utterances/s, "
              f"{audio_secs / walls[dev]:.1f} audio s per wall s | {card}")
    if len(lines["cuda"]) != RAW_UTTERANCES or lines["cuda"] != lines["cpu"]:
        fail(f"preprocess: {len(lines['cuda'])} utterances on the card, "
             f"{len(lines['cpu'])} on the CPU (of {RAW_UTTERANCES}), or "
             "their lines differ")
    for name in ("train.txt", "val.txt", "speakers.json"):
        with open(os.path.join(outs["cuda"], name), "rb") as a, \
                open(os.path.join(outs["cpu"], name), "rb") as b:
            if a.read() != b.read():
                fail(f"preprocess: {name} differs between card and CPU")
    stats = {}
    for dev, out in outs.items():
        with open(os.path.join(out, "stats.json")) as f:
            stats[dev] = json.load(f)
    feats = {dev: _corpus_features(out) for dev, out in outs.items()}
    for kind in ("duration", "pitch"):
        for name, want in feats["cpu"][kind].items():
            if not np.array_equal(feats["cuda"][kind][name], want):
                fail(f"preprocess: {kind} {name} not bit-equal")
    mel_err = max(float(np.abs(feats["cuda"]["mel"][k] - v).max())
                  for k, v in feats["cpu"]["mel"].items())
    # the energy files hold z-scores: each run's own stats undo them
    raw_energy = {dev: {k: v * stats[dev]["energy"][3]
                        + stats[dev]["energy"][2]
                        for k, v in feats[dev]["energy"].items()}
                  for dev in outs}
    energy_err = max(float(np.abs(raw_energy["cuda"][k] / v - 1).max())
                     for k, v in raw_energy["cpu"].items())
    (lo_c, hi_c, mean_c, std_c), (lo, hi, mean, std) = (
        stats["cuda"]["energy"], stats["cpu"]["energy"])
    spread = PREPROCESS_ENERGY_RTOL * abs(mean) / std
    mean_err = abs(mean_c / mean - 1)
    std_err = abs(std_c / std - 1)
    minmax_err = max(abs(lo_c - lo), abs(hi_c - hi))
    print(f"[preprocess] card vs CPU: text files byte-equal, durations and "
          f"pitch bit-equal; log-mel max |diff| {mel_err:.3g} (tol <= "
          f"{PREPROCESS_LOG_MEL_ATOL}); energy max rel diff "
          f"{energy_err:.3g} (tol <= {PREPROCESS_ENERGY_RTOL}); stats.json "
          f"pitch {'equal' if stats['cuda']['pitch'] == stats['cpu']['pitch'] else 'DIFFERENT'}, "
          f"energy mean rel diff {mean_err:.3g} (tol <= "
          f"{PREPROCESS_STATS_RTOL}), std rel diff {std_err:.3g} and "
          f"min/max |diff| {minmax_err:.3g} (tol <= {spread:.3g}, the "
          f"energy's tolerance x mean / std); extractor "
          f"{stats['cuda']['pitch_extractor']} | {card}")
    if (mel_err > PREPROCESS_LOG_MEL_ATOL
            or energy_err > PREPROCESS_ENERGY_RTOL
            or stats["cuda"]["pitch"] != stats["cpu"]["pitch"]
            or mean_err > PREPROCESS_STATS_RTOL or std_err > spread
            or minmax_err > spread):
        fail("preprocess: the card's features or stats.json do not hold "
             "the CPU's")
    return outs["cuda"]


def phase_validate(card: str, data: str, gen: str, root: str):
    """Training on the preprocessed corpus, then the validation audio:
    the tiny preset in bf16 takes VALIDATE_STEPS steps (K3 and K4
    launches counted from 0), then ``Trainer.validate_audio`` is called
    directly, outside fit's catch, with the seeded LJ_V2-width generator
    file of the reference phase: once as trained, and once with the
    duration head's bias at 6.0 (a few steps leave the free-running
    durations near 0 frames, so the mels would be empty) for the full
    metrics.  Prints the val_* metrics, the wav files written and the
    wall times."""
    from efficientspeech_tpu_torch.config import (
        ModelConfig, PreprocessConfig, TrainConfig)
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3
    from efficientspeech_tpu_torch.train import load_vocoder
    from efficientspeech_tpu_torch.training.loop import Trainer

    dt = torch.bfloat16
    preprocess_cfg = PreprocessConfig(preprocessed_path=data)
    stats = preprocess_cfg.load_stats()
    model_cfg = ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]),
        max_phoneme_len=TRAIN_PHONEMES, max_mel_len=TRAIN_FRAMES)
    wav_path = os.path.join(root, "wavs")
    train_cfg = TrainConfig(
        batch_size=VALIDATE_BATCH, warmup_epochs=0, seed=0,
        checkpoint_dir=os.path.join(root, "ckpt"),
        log_dir=os.path.join(root, "logs"), wav_path=wav_path)
    hifigan_cfg, hifigan_params = load_vocoder(gen)
    trainer = Trainer(model_cfg, train_cfg, preprocess_cfg,
                      hifigan_cfg=hifigan_cfg, hifigan_params=hifigan_params,
                      dtype=dt)
    counters = (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
                k4.launches_bwd)
    for d in counters:
        d.update(dict.fromkeys(d, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = trainer.fit(max_steps=VALIDATE_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = tuple(d[128, dt] for d in counters)
    logged = [json.loads(line) for line in open(
        os.path.join(train_cfg.log_dir, "metrics.jsonl"))]
    losses = [r["loss"] for r in logged if "loss" in r]
    print(f"[validate] tiny bf16 on the preprocessed corpus: "
          f"{len(trainer.train_ds)} train + {len(trainer.val_ds)} val "
          f"utterances, {last} steps of batch {VALIDATE_BATCH} in "
          f"{train_s:.1f} s, epoch losses {[round(v, 4) for v in losses]}, "
          f"launches K3 C=128 {counts[:2]} K4 C=128 {counts[2:]} | {card}")
    if last != VALIDATE_STEPS or not np.isfinite(losses).all():
        fail(f"validate: fit stopped at step {last} or losses not finite: "
             f"{losses}")
    if min(counts) < VALIDATE_STEPS:
        fail(f"validate: K3/K4 launched {counts} times in {last} steps")
    for label, bias in (("as trained", None), ("duration bias 6.0", 6.0)):
        if bias is not None:
            with torch.no_grad():
                trainer.model.encoder.duration_decoder.linear.bias.fill_(bias)
        shutil.rmtree(wav_path, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.validate_audio(epoch=0)
        secs = time.perf_counter() - t0
        written = sorted(os.listdir(wav_path))
        n_pred = sum(f.startswith("prediction-") for f in written)
        n_rec = sum(f.startswith("reconstruction-") for f in written)
        shown = {k: round(v, 4) for k, v in sorted(metrics.items())}
        print(f"[validate] validate_audio ({label}): {secs:.2f} s wall; "
              f"val_* {shown}; wrote {n_pred} prediction and {n_rec} "
              f"reconstruction wavs, prediction.txt "
              f"{'prediction.txt' in written} | {card}")
        if n_pred != VALIDATE_BATCH or n_rec != VALIDATE_BATCH or \
                "prediction.txt" not in written:
            fail(f"validate: wrote {written}")
        # F0 RMSE is NaN where no frame is voiced in both, as in JAX
        bad = [k for k, v in metrics.items()
               if not np.isfinite(v) and k != "f0_rmse_hz"]
        if bad or "duration_mae_frames" not in metrics:
            fail(f"validate: metrics not finite: {metrics}")
    if "mcd_db" not in metrics or "voicing_f1" not in metrics:
        fail(f"validate: the biased model gave no MCD or F0 metrics: "
             f"{metrics}")
    trainer.logger.jsonl.close()


def phase_vocoder(card: str, root: str, data: str):
    """Vocoder training on the card, float32 with TF32 off: the LJ_V2-width
    generator and the full MPD and MSD from seed 0 at train_vocoder's
    defaults (batch VOCODER_BATCH of VOCODER_SEGMENT samples).  The first
    step at batch 1 against the same step on the CPU; VOCODER_STEPS steps
    on synthetic speech-like crops (median of the last VOCODER_TIMED,
    peak memory, finite metrics) and a trace of two of them; then
    ``train_vocoder --from-acoustic`` on the preprocessed corpus from the
    validate phase's checkpoint, with a holdout, after the pairs' forward
    (K3 and K4 float32 forward, counted) is held to the plain route's."""
    from efficientspeech_tpu_torch import train_vocoder
    from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3
    from efficientspeech_tpu_torch.training.vocoder import (
        create_vocoder_trainer, make_mel_fn)

    audio, cfg = AudioConfig(), HifiGanConfig()
    frames = VOCODER_SEGMENT // audio.hop_length
    wavs = np.stack([speechlike(VOCODER_SEGMENT * (VOCODER_STEPS + 1),
                                seed=i) for i in range(VOCODER_BATCH)])
    crops = [torch.from_numpy(np.ascontiguousarray(
        wavs[:, i * VOCODER_SEGMENT:(i + 1) * VOCODER_SEGMENT]))
        for i in range(VOCODER_STEPS + 1)]

    # the card against the CPU: the same first step at batch 1, from the
    # same seeded weights and the same mel
    t0 = time.perf_counter()
    cpu_mel_of = make_mel_fn(audio, "cpu")
    with torch.no_grad():
        mel1 = cpu_mel_of(crops[0][:1])[:, :frames]
    _, cpu_init, cpu_step = create_vocoder_trainer(cfg, audio, device="cpu")
    _, cpu_m = cpu_step(cpu_init(seed=0), mel1, crops[0][:1])
    cpu_s = time.perf_counter() - t0
    gen, init, step = create_vocoder_trainer(cfg, audio)
    n_gen = sum(p.numel() for p in gen.parameters())
    state = init(seed=0)
    n_disc = sum(p.numel() for m in (state.mpd, state.msd)
                 for p in m.parameters())
    _, card_m = step(state, mel1.cuda(), crops[0][:1].cuda())
    card_m = {k: float(v) for k, v in card_m.items()}
    rel = {k: abs(card_m[k] - float(v)) / abs(float(v))
           for k, v in cpu_m.items()}
    worst = max(rel, key=rel.get)
    print(f"[vocoder] generator {n_gen:,} + discriminators {n_disc:,} "
          f"float32 parameters; first step at batch 1, card vs CPU ("
          f"{cpu_s:.1f} s there): "
          + ", ".join(f"{k} {card_m[k]:.5f}" for k in sorted(card_m))
          + f"; max rel diff {rel[worst]:.2e} at {worst} (tol <= "
          f"{VOCODER_CPU_RTOL}) | {card}")
    if rel[worst] > VOCODER_CPU_RTOL or not np.isfinite(
            list(card_m.values())).all():
        fail("vocoder: the card's GAN step does not hold the CPU's")

    # VOCODER_STEPS steps at batch VOCODER_BATCH
    mel_of = make_mel_fn(audio)
    state = init(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps, logged = [time.perf_counter()], []
    for i in range(VOCODER_STEPS):
        wav = crops[i].cuda()
        with torch.no_grad():
            mel = mel_of(wav)[:, :frames]
        state, metrics = step(state, mel, wav)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        logged.append(metrics)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = np.diff(stamps) * 1e3
    timed = step_ms[-VOCODER_TIMED:]
    keys = sorted(logged[0])
    values = torch.stack([torch.stack([m[k] for k in keys])
                          for m in logged]).cpu().numpy()
    print(f"[vocoder] {VOCODER_STEPS} GAN steps, batch {VOCODER_BATCH} x "
          f"{VOCODER_SEGMENT} samples, float32: first {step_ms[0]:.1f} ms, "
          f"median of the last {VOCODER_TIMED} {np.median(timed):.2f} ms "
          f"(min {timed.min():.2f}, max {timed.max():.2f}), "
          f"{VOCODER_BATCH * VOCODER_SEGMENT / np.median(timed) * 1e3:.0f} "
          f"samples/s; peak memory {peak_gb:.2f} GiB; last step "
          + ", ".join(f"{k} {v:.4f}" for k, v in zip(keys, values[-1]))
          + f" | {card}")
    if not np.isfinite(values).all() or not np.isfinite(step_ms).all():
        fail(f"vocoder: metrics not finite: {values}")
    wav = crops[VOCODER_STEPS].cuda()
    with torch.no_grad():
        mel = mel_of(wav)[:, :frames]
    trace(lambda: [step(state, mel, wav) for _ in range(2)],
          f"two vocoder GAN steps, batch {VOCODER_BATCH} x "
          f"{VOCODER_SEGMENT}, float32", card)
    del state, gen, init, step
    torch.cuda.empty_cache()

    # --from-acoustic on the preprocessed corpus
    cfg_yaml = os.path.join(root, "vocoder.yaml")
    with open(cfg_yaml, "w") as f:
        f.write(f"path:\n  corpus_path: {root}\n  raw_path: "
                f"{os.path.join(root, 'raw')}\n  preprocessed_path: "
                f"{data}\npreprocessing:\n  audio:\n    sampling_rate: "
                "22050\n")
    ckpt = os.path.join(root, "ckpt")
    counters = (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
                k4.launches_bwd)
    counts = lambda: tuple(d[128, torch.float32] for d in counters)  # noqa
    mels = {}
    for fused in (True, False):
        for d in counters:
            d.update(dict.fromkeys(d, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs, _, _ = train_vocoder.build_acoustic_pairs(
            ckpt, "tiny", cfg_yaml, FROM_ACOUSTIC_UTTERANCES, 0,
            fused=fused, mel_dtype=np.float32)
        secs = time.perf_counter() - t0
        mels[fused] = (torch.from_numpy(np.concatenate([m for m, _ in
                                                        pairs])), counts(),
                       secs, len(pairs))
    (mel_k, launches, secs_k, n_pairs), (mel_p, plain_launches, secs_p, _) \
        = mels[True], mels[False]
    snr = snr_db(mel_p, mel_k) if mel_k.shape == mel_p.shape else -1.0
    print(f"[vocoder] --from-acoustic pairs: {n_pairs} utterances, "
          f"{mel_k.shape[0]} frames, teacher-forced float32 forward in "
          f"{secs_k:.2f} s (plain route {secs_p:.2f} s); launches K3 C=128 "
          f"f32 fwd, bwd, K4 fwd, bwd {launches} (plain route "
          f"{plain_launches}); mels vs the plain route SNR {snr:.1f} dB "
          f"(tol >= {F32_KERNEL_SNR_DB}) | {card}")
    if launches[0] == 0 or launches[2] == 0 or any(plain_launches) \
            or launches[1] or launches[3]:
        fail(f"vocoder: the pairs' forward launched {launches} (plain "
             f"route {plain_launches})")
    if snr < F32_KERNEL_SNR_DB:
        fail(f"vocoder: teacher-forced mels at {snr:.1f} dB")
    for d in counters:
        d.update(dict.fromkeys(d, 0))
    t0 = time.perf_counter()
    out = train_vocoder.main([
        "--preprocess-config", cfg_yaml, "--from-acoustic", ckpt,
        "--max-utterances", str(FROM_ACOUSTIC_UTTERANCES),
        "--holdout-frac", str(FROM_ACOUSTIC_HOLDOUT),
        "--steps", str(FROM_ACOUSTIC_STEPS), "--log-every", "1",
        "--checkpoint-dir", os.path.join(root, "vocoder_ckpt"),
        "--log-dir", os.path.join(root, "vocoder_logs")])
    wall = time.perf_counter() - t0
    run_launches = counts()
    before, after = out["before"], out["after"]
    shown = ("mel_l1", "mr_stft", "sc_1024", "logmag_1024")
    print(f"[vocoder] train_vocoder --from-acoustic, {FROM_ACOUSTIC_STEPS} "
          f"steps, holdout {int(before['n_utterances'])} utterances: "
          f"{wall:.1f} s wall; holdout before "
          + ", ".join(f"{k} {before[k]}" for k in shown) + "; after "
          + ", ".join(f"{k} {after[k]}" for k in shown)
          + f"; each eval {out['eval_secs'][0]:.2f} / "
          f"{out['eval_secs'][1]:.2f} s wall; launches in the run "
          f"{run_launches} | {card}")
    if out["step"] != FROM_ACOUSTIC_STEPS or not all(
            np.isfinite(m[k]) for m in (before, after) for k in shown):
        fail(f"vocoder: --from-acoustic gave {out}")
    if run_launches[0] == 0 or run_launches[2] == 0:
        fail(f"vocoder: train_vocoder's pair forward launched "
             f"{run_launches}")


def phase_device_data(card: str, data: str, out: str):
    """The device-resident corpus on the train phase's synthetic corpus,
    tiny preset in bf16: one epoch (EPOCH_STEPS steps) of Trainer.fit with
    --device-data, and with --device-data-scan-steps DEVICE_DATA_SCAN, and
    the loader's path over the same rows (the cache's permutation through
    the loader's assembly).  Each step's losses are held to the loader
    path's same step at DEVICE_DATA_STEP_RTOL; a planted fault, the cache
    gathering each index's next row, must read apart by more.  K3 and K4
    counted, step times and idle shares of both paths."""
    from efficientspeech_tpu_torch.config import (
        ModelConfig, PreprocessConfig, TrainConfig)
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3
    from efficientspeech_tpu_torch.training.loop import (
        Trainer, batch_to_device)

    dt = torch.bfloat16
    preprocess_cfg = PreprocessConfig(preprocessed_path=data)
    stats = preprocess_cfg.load_stats()
    model_cfg = ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]),
        max_phoneme_len=TRAIN_PHONEMES, max_mel_len=TRAIN_FRAMES)

    def trainer(tag, **kw):
        return Trainer(model_cfg, TrainConfig(
            batch_size=TRAIN_BATCH, warmup_epochs=0, seed=0,
            checkpoint_dir=os.path.join(out, tag, "ckpt"),
            log_dir=os.path.join(out, tag, "logs"), **kw),
            preprocess_cfg, dtype=dt)

    def stacked(step_metrics):
        """{key: (steps,) float64 array} of per-step metric dicts."""
        return {k: torch.stack([m[k] for m in step_metrics]).double()
                .cpu().numpy() for k in step_metrics[0]}

    counters = (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
                k4.launches_bwd)
    counts = lambda: tuple(d[128, dt] for d in counters)  # noqa: E731
    results = {}
    for tag, scan in (("single", 1), ("scan", DEVICE_DATA_SCAN),
                      ("planted", 1)):
        t0 = time.perf_counter()
        tr = trainer(tag, device_data=True, device_data_scan_steps=scan)
        setup_s = time.perf_counter() - t0
        if tag == "planted":
            # the fault: every index gathers the corpus's next row
            rows_of, n_rows = (tr.device_cache.epoch_batches,
                               tr.device_cache.num_samples)
            tr.device_cache.epoch_batches = (
                lambda *a, **kw: (rows_of(*a, **kw) + 1) % n_rows)
        stamps, step_metrics = [], []

        def on_step(step, metrics, stamps=stamps, step_metrics=step_metrics):
            step_metrics.append(metrics)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        for d in counters:
            d.update(dict.fromkeys(d, 0))
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        last = tr.fit(max_steps=EPOCH_STEPS, on_step=on_step)
        launches = counts()
        gaps = np.diff(stamps)[WARMUP_STEPS:] * 1e3
        results[tag] = dict(trainer=tr, steps=stacked(step_metrics),
                            launches=launches, ms=float(np.median(gaps)))
        mb = (tr.device_cache.nbytes + tr.val_device_cache.nbytes) / 2 ** 20
        print(f"[device-data] {tag} (--device-data-scan-steps {scan}): "
              f"cache of {tr.device_cache.num_samples} + "
              f"{tr.val_device_cache.num_samples} utterances, {mb:.0f} "
              f"MB on the card, trainer built in {setup_s:.1f} s; {last} "
              f"steps, median step {results[tag]['ms']:.2f} ms; launches "
              f"K3 C=128 bf16 fwd, bwd, K4 fwd, bwd {launches}; epoch "
              f"loss {results[tag]['steps']['loss'].mean():.5f} | {card}")
        if last != EPOCH_STEPS or launches != (3 * EPOCH_STEPS,
                                               3 * EPOCH_STEPS,
                                               4 * EPOCH_STEPS,
                                               4 * EPOCH_STEPS):
            fail(f"device-data: {tag} ran {last} steps with launches "
                 f"{launches}")
    cached = results["single"]["trainer"]

    # the loader's path over the same rows, each batch assembled on the
    # host first (the loader's prefetch threads do that beside the steps)
    loader = trainer("loader")
    rows = cached.device_cache.epoch_batches(TRAIN_BATCH, 0, seed=0)
    host_batches = [loader.train_loader._assemble(r) for r in rows]
    step_metrics, stamps = [], []
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    for host_batch in host_batches:
        batch = batch_to_device(host_batch, loader.device)
        loader.state, m = loader.train_step(loader.state, batch)
        step_metrics.append(m)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    want = stacked(step_metrics)
    loader_ms = float(np.median(np.diff(stamps)[WARMUP_STEPS:] * 1e3))

    def worst_gap(tag):
        """(largest relative gap over steps and losses, its step, key)."""
        got = results[tag]["steps"]
        return max((float(abs(got[k][i] - v[i]) / abs(v[i])), i + 1, k)
                   for k, v in want.items() for i in range(len(v)))

    gap = {tag: worst_gap(tag) for tag in results}
    first = {tag: max(float(abs(results[tag]["steps"][k][0] - v[0])
                            / abs(v[0])) for k, v in want.items())
             for tag in results}
    print(f"[device-data] loader path over the same rows (each batch "
          f"assembled on the host first; its upload in the step): median "
          f"step {loader_ms:.2f} ms, epoch loss {want['loss'].mean():.5f}; "
          f"per-step losses, largest relative gap to the loader path "
          f"(step, loss): "
          + "; ".join(f"{tag} {g:.2e} at {i}, {k}"
                      for tag, (g, i, k) in gap.items())
          + f" (tol <= {DEVICE_DATA_STEP_RTOL}; the planted next-row "
          f"gather must exceed it); at the first step "
          + ", ".join(f"{tag} {g:.2e}" for tag, g in first.items())
          + f" | {card}")
    if max(gap["single"][0], gap["scan"][0]) > DEVICE_DATA_STEP_RTOL:
        fail("device-data: the cached steps do not hold the loader's")
    if gap["planted"][0] <= DEVICE_DATA_STEP_RTOL:
        fail("device-data: a next-row gather reads within the bar")
    idx = torch.from_numpy(rows[0].astype(np.int64)).cuda()
    trace(lambda: cached._cached_step(cached.state,
                                      cached.device_cache.arrays, idx),
          "tiny bf16 step on the device-resident corpus", card)
    trace(lambda: loader.train_step(loader.state, batch_to_device(
        host_batches[0], loader.device)), "tiny bf16 step fed by the "
          "loader (the batch's upload included)", card)
    for tr in [r["trainer"] for r in results.values()] + [loader]:
        tr.logger.jsonl.close()


# --- the parallel phase: ranks that share the card over gloo -----------------

def _counters():
    from efficientspeech_tpu_torch.ops.kernels import decoder_block as k4
    from efficientspeech_tpu_torch.ops.kernels import layer_norm as k3

    return (k3.launches_fwd, k3.launches_bwd, k4.launches_fwd,
            k4.launches_bwd)


def _median_ms(fn, n: int, device) -> float:
    """The median of ``n`` timed calls of ``fn`` after one untimed one,
    each ended by a synchronize of ``device`` (host clock: a step's host
    work counts)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    gaps = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        gaps.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(gaps))


def _allreduce_ms(params, group, timed: int, device) -> tuple:
    """(median ms of summing ``params``' gradients over ``group`` in one
    flat all-reduce, its bytes); (None, bytes) without a group."""
    from efficientspeech_tpu_torch.parallel.comm import sum_gradients

    params = list(params)
    nbytes = 4 * sum(p.numel() for p in params)
    if group is None:
        return None, nbytes
    saved = [p.grad.clone() for p in params]
    ms = _median_ms(lambda: sum_gradients(params, group), timed, device)
    for p, g in zip(params, saved):
        p.grad.copy_(g)
    return ms, nbytes


def _train_run(device, mesh, sizes: dict, out: str, dt, device_data: bool):
    """One tiny acoustic Trainer at ``sizes["shape"]`` (batch, phonemes,
    frames) on ``mesh`` (None: one process) over the corpus in
    ``sizes["data"]``: its first step through ``fit`` (metrics, the summed
    float32 gradients, K3/K4 launches counted from 0), then the median of
    ``sizes["timed"]`` steps on one batch and of the gradient all-reduce
    alone."""
    from efficientspeech_tpu_torch.config import (
        ModelConfig, PreprocessConfig, TrainConfig)
    from efficientspeech_tpu_torch.training.loop import Trainer

    batch, phonemes, frames = sizes["shape"]
    pre = PreprocessConfig(preprocessed_path=sizes["data"])
    stats = pre.load_stats()
    model_cfg = ModelConfig.preset(
        "tiny", pitch_stats=tuple(stats["pitch"][:2]),
        energy_stats=tuple(stats["energy"][:2]),
        max_phoneme_len=phonemes, max_mel_len=frames)
    tr = Trainer(model_cfg, TrainConfig(
        batch_size=batch, warmup_epochs=0, seed=0,
        device_data=device_data, checkpoint_dir=os.path.join(out, "ckpt"),
        log_dir=os.path.join(out, "logs")), pre, dtype=dt, device=device,
        mesh=mesh)
    counters = _counters()
    for d in counters:
        d.update(dict.fromkeys(d, 0))
    logged = []
    tr.fit(max_steps=1, on_step=lambda step, m: logged.append(
        {k: float(v) for k, v in m.items()}))
    launches = tuple(d[128, dt] for d in counters)
    other = sum(sum(d.values()) for d in counters) - sum(launches)
    grads = {n: p.grad.float().cpu().numpy()
             for n, p in tr.model.named_parameters()}
    steps = tr._epoch_steps(0)
    step_fn, args = next(steps)
    steps.close()

    def one():
        tr.state, _ = step_fn(tr.state, *args)

    step_ms = _median_ms(one, sizes["timed"], device)
    ar_ms, ar_bytes = _allreduce_ms(
        tr.model.parameters(), None if mesh is None else mesh.group("data"),
        sizes["timed"], device)
    return dict(metrics=logged[0], grads=grads, launches=launches,
                other=other, step_ms=step_ms, allreduce_ms=ar_ms,
                allreduce_bytes=ar_bytes)


def _gan_run(device, mesh, mel: np.ndarray, wav: np.ndarray, timed: int):
    """The LJ_V2 generator with the full MPD and MSD from seed 0, float32:
    the first GAN step on this rank's rows of (mel, wav) (metrics), then
    the median of ``timed`` more and of the gradient all-reduce."""
    from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
    from efficientspeech_tpu_torch.parallel.mesh import shard_batch
    from efficientspeech_tpu_torch.training.vocoder import (
        create_vocoder_trainer)

    rows = shard_batch({"mel": mel, "wav": wav}, mesh)
    mel_t = torch.from_numpy(rows["mel"]).to(device)
    wav_t = torch.from_numpy(rows["wav"]).to(device)
    _, init, step = create_vocoder_trainer(HifiGanConfig(), AudioConfig(),
                                           device=device, mesh=mesh)
    state = init(seed=0)
    state, m = step(state, mel_t, wav_t)
    metrics = {k: float(v) for k, v in m.items()}
    box = [state]

    def one():
        box[0], _ = step(box[0], mel_t, wav_t)

    step_ms = _median_ms(one, timed, device)
    params = [p for part in (state.gen, state.mpd, state.msd)
              for p in part.parameters()]
    ar_ms, ar_bytes = _allreduce_ms(
        params, None if mesh is None else mesh.group("data"), timed, device)
    return dict(metrics=metrics, step_ms=step_ms, allreduce_ms=ar_ms,
                allreduce_bytes=ar_bytes)


def _seq_run(device, mesh, mel: np.ndarray, valid: int, dt):
    """``seq_parallel_vocode`` of the LJ_V2-width generator (seed 0) on
    ``mesh``'s "sp" axis: this rank's block and its ms."""
    from efficientspeech_tpu_torch.config import HifiGanConfig
    from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
    from efficientspeech_tpu_torch.models.hifigan_folded import fold_hifigan
    from efficientspeech_tpu_torch.parallel.seq_vocoder import (
        seq_parallel_vocode)
    from efficientspeech_tpu_torch.weights import init_params

    cfg = HifiGanConfig()
    arrays, meta = fold_hifigan(init_params(HifiGanGenerator(cfg), 0).to(
        device), dtype=dt)
    mel_t = torch.from_numpy(mel).to(device)
    vl = torch.tensor([valid], device=device)

    def run():
        with torch.no_grad():
            return seq_parallel_vocode(arrays, meta, cfg, mel_t, mesh,
                                       valid_len=vl, dtype=dt)

    wav = run()
    return dict(wav=wav.cpu().numpy(), index=mesh.index("sp"),
                ms=_median_ms(run, 3, device))


def _tp_batch(sizes: dict):
    """The first batch of the corpus's seeded loader at the training
    shape (numpy)."""
    from efficientspeech_tpu_torch.config import PreprocessConfig
    from efficientspeech_tpu_torch.data.dataset import (
        BucketedLoader, LJSpeechDataset)

    batch, phonemes, frames = sizes["shape"]
    loader = BucketedLoader(
        LJSpeechDataset("train.txt", PreprocessConfig(
            preprocessed_path=sizes["data"])),
        batch, shuffle=True, seed=0, max_phoneme_len=phonemes,
        max_mel_len=frames, drop_last=True, fixed_shape=True, prefetch=0)
    batch = next(iter(loader))
    batch.pop("text")
    return batch


def _tp_run(device, mesh, sizes: dict, tensor_parallel: bool):
    """One float32 tiny step (seed 0, the decoder on K3/K4) on the first
    loader batch: tensor-parallel over ``mesh``'s "model" axis and data
    parallel over its "data" axis when asked, else one process.  Returns
    the metrics, the unsharded gradients, the launches and the ms."""
    from efficientspeech_tpu_torch.config import ModelConfig, TrainConfig
    from efficientspeech_tpu_torch.models.phoneme2mel import Phoneme2Mel
    from efficientspeech_tpu_torch.parallel.mesh import shard_batch
    from efficientspeech_tpu_torch.parallel.sharding import (
        gather_params, shard_tensor_parallel)
    from efficientspeech_tpu_torch.training.schedule import (
        warmup_cosine_schedule)
    from efficientspeech_tpu_torch.training.state import create_train_state
    from efficientspeech_tpu_torch.training.step import make_train_step
    from efficientspeech_tpu_torch.weights import init_params

    _, phonemes, frames = sizes["shape"]
    model = init_params(Phoneme2Mel(
        ModelConfig.preset("tiny", max_phoneme_len=phonemes,
                           max_mel_len=frames),
        fused_decoder_norm=True, fused_decoder_block=True), 0).to(device)
    if tensor_parallel:
        shard_tensor_parallel(model, mesh)
    state = create_train_state(model, TrainConfig(warmup_epochs=0),
                               warmup_cosine_schedule(1e-3, 0, 10, 4))
    step = make_train_step(torch.float32, mesh if tensor_parallel else None)
    batch = {k: torch.from_numpy(v).to(device) for k, v in shard_batch(
        _tp_batch(sizes), mesh if tensor_parallel else None).items()}
    counters = _counters()
    for d in counters:
        d.update(dict.fromkeys(d, 0))
    state, m = step(state, batch)
    launches = tuple(d[128, torch.float32] for d in counters)
    grads = gather_params(model, {n: p.grad for n, p in
                                  model.named_parameters()})
    box = [state]

    def one():
        box[0], _ = step(box[0], batch)

    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={k: v.cpu().numpy() for k, v in grads.items()},
                launches=launches,
                step_ms=_median_ms(one, sizes["timed"], device))


def _nccl_run(device, sizes: dict, backend: str):
    """One float32 tiny step whose data group is the process group of
    this one rank (``backend``: NCCL, so every collective of the step goes
    through NCCL), against the same step with no group."""
    import torch.distributed as dist

    from efficientspeech_tpu_torch.parallel.mesh import Mesh

    if dist.get_backend() != backend:
        raise RuntimeError(f"the group runs {dist.get_backend()}, not "
                           f"{backend}")
    alone = _tp_run(device, None, sizes, False)
    mesh = Mesh({"data": 1, "model": 1},
                groups={"data": dist.group.WORLD})
    through = _tp_run(device, mesh, sizes, True)
    return dict(alone=alone, through=through)


def parallel_rank(device, case):
    """The body of each rank of the parallel phase (spawned by
    ``parallel.launch``): the cases named in ``case``, TF32 off as in the
    parent (a per-process setting)."""
    from efficientspeech_tpu_torch.device import set_full_f32
    from efficientspeech_tpu_torch.parallel.mesh import Mesh, make_mesh

    set_full_f32()
    sizes = case["sizes"]
    if "nccl" in case:
        return {"nccl": _nccl_run(device, sizes, case["nccl"])}
    if "tp" in case:
        mesh = make_mesh(data_parallel=2, model_parallel=2)
        return {"tp": _tp_run(device, mesh, sizes, True)}
    mesh = make_mesh()
    rank = mesh.rank
    out = {}
    for dt, device_data in PARALLEL_TRAIN_CASES:
        key = (dname(dt), device_data)
        out[key] = _train_run(device, mesh, sizes, os.path.join(
            case["root"], f"rank{rank}_{dname(dt)}_{int(device_data)}"),
            dt, device_data)
    out["gan"] = _gan_run(device, mesh, *case["gan"], sizes["timed"])
    seq_mesh = Mesh.create({"sp": mesh.size})
    for dt in (torch.float32, torch.bfloat16):
        out["seq", dname(dt)] = _seq_run(device, seq_mesh, *case["seq"], dt)
    return out


def _grad_gap(got: dict, want: dict) -> tuple:
    """(largest gradient gap over leaves, as a share of each leaf's
    largest, its leaf; least gradient cosine, its leaf)."""
    gap, cos = {}, {}
    for name, w in want.items():
        g = got[name].astype(np.float64).ravel()
        w = w.astype(np.float64).ravel()
        scale = np.abs(w).max()
        if scale == 0:
            continue
        gap[name] = float(np.abs(g - w).max() / scale)
        cos[name] = float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
    worst_gap = max(gap, key=gap.get)
    worst_cos = min(cos, key=cos.get)
    return gap[worst_gap], worst_gap, cos[worst_cos], worst_cos


def phase_parallel(card: str, root: str):
    """Data, sequence and tensor parallelism on the card: ranks that share
    cuda:0 over gloo (NCCL refuses two ranks on one device), each part
    held against one process on the same global work, and one step
    through an NCCL group of one rank.  (a) the tiny acoustic Trainer at
    train.py's defaults, float32 (TF32 off) and bf16, by the loader and
    on the device-resident corpus, 2 ranks: losses and summed gradients,
    K3/K4 launches per rank; (b) the GAN step of the LJ_V2 generator with
    the full MPD and MSD at batch VOCODER_BATCH x VOCODER_SEGMENT, 2
    ranks; (c) seq_parallel_vocode of the LJ_V2-width folded generator on
    SEQ_FRAMES frames whose valid length ends in shard 0, float32 and
    bf16, 2 ranks; (d) a 2 x 2 data x tensor parallel float32 step, 4
    ranks; (e) NCCL at world size 1.  Per-rank step ms, all-reduce ms and
    bytes, launches."""
    from efficientspeech_tpu_torch.config import AudioConfig, HifiGanConfig
    from efficientspeech_tpu_torch.models.hifigan import HifiGanGenerator
    from efficientspeech_tpu_torch.models.hifigan_folded import (
        fold_hifigan, folded_plan_apply)
    from efficientspeech_tpu_torch.parallel import launch
    from efficientspeech_tpu_torch.training.vocoder import make_mel_fn
    from efficientspeech_tpu_torch.weights import init_params

    t_phase = time.perf_counter()
    data = os.path.join(root, "parallel_data")
    write_corpus(data, n_train=2 * TRAIN_BATCH)
    sizes = dict(data=data, shape=(TRAIN_BATCH, TRAIN_PHONEMES, TRAIN_FRAMES),
                 timed=PARALLEL_TIMED)
    dev = torch.device(PARALLEL_DEVICE)
    # the one-process references, each on the whole global work
    ref = {}
    for dt, device_data in PARALLEL_TRAIN_CASES:
        ref[dname(dt), device_data] = _train_run(
            dev, None, sizes, os.path.join(
                root, "parallel_one", f"{dname(dt)}_{int(device_data)}"),
            dt, device_data)
    audio = AudioConfig()
    wav = np.stack([speechlike(VOCODER_SEGMENT, seed=20 + i)
                    for i in range(VOCODER_BATCH)])
    with torch.no_grad():
        mel = make_mel_fn(audio, dev)(torch.from_numpy(wav).to(dev))[
            :, :VOCODER_SEGMENT // audio.hop_length].cpu().numpy()
    ref["gan"] = _gan_run(dev, None, mel, wav, PARALLEL_TIMED)
    seq_mel = np.random.default_rng(5).normal(
        -4, 2, (1, SEQ_FRAMES, 80)).astype(np.float32)
    seq_mel[0, SEQ_VALID:] = 0
    cfg = HifiGanConfig()
    gen = init_params(HifiGanGenerator(cfg), 0).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        arrays, meta = fold_hifigan(gen, dtype=dt)
        with torch.no_grad():
            ref["seq", dname(dt)] = folded_plan_apply(
                arrays, meta, cfg, torch.from_numpy(seq_mel).to(dev),
                torch.tensor([SEQ_VALID], device=dev), dtype=dt).cpu()
    ref["tp"] = _tp_run(dev, None, sizes, False)
    del gen, arrays
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = launch(parallel_rank, 2, [dev, dev], backend="gloo",
                 args=(dict(sizes=sizes, root=os.path.join(root, "parallel"),
                            gan=(mel, wav), seq=(seq_mel, SEQ_VALID)),))
    spawn_s = time.perf_counter() - t0

    # (a) data-parallel acoustic training
    for dt, device_data in PARALLEL_TRAIN_CASES:
        key = (dname(dt), device_data)
        want = ref[key]
        feed = "device-resident corpus" if device_data else "loader"
        loss_rtol, grad_atol, grad_cos = (
            (PARALLEL_LOSS_RTOL, PARALLEL_GRAD_ATOL, F32_ROUTE_GRAD_COS)
            if dt == torch.float32 else (ROUTE_LOSS_RTOL, None,
                                         ROUTE_GRAD_COS))
        for rank, r in enumerate(g[key] for g in got):
            rel = max(abs(r["metrics"][k] - v) / abs(v)
                      for k, v in want["metrics"].items())
            gap, gap_at, cos, cos_at = _grad_gap(r["grads"], want["grads"])
            print(f"[parallel] (a) tiny {dname(dt)} by the {feed}, rank "
                  f"{rank} of 2 on {dev} (gloo): loss "
                  f"{r['metrics']['loss']:.6f} vs one process "
                  f"{want['metrics']['loss']:.6f}, largest loss rel diff "
                  f"{rel:.2e} (tol <= {loss_rtol}); gradient gap "
                  f"{gap:.2e} of the leaf's largest at {gap_at}"
                  + (f" (tol <= {grad_atol})" if grad_atol else "")
                  + f", least cosine {cos:.7f} at {cos_at} (tol >= "
                  f"{grad_cos}); K3 fwd, bwd, K4 fwd, bwd launches "
                  f"{r['launches']} (one process {want['launches']}); step "
                  f"{r['step_ms']:.2f} ms (one process "
                  f"{want['step_ms']:.2f}), gradient all-reduce "
                  f"{r['allreduce_ms']:.2f} ms for {r['allreduce_bytes']:,} "
                  f"bytes | {card}")
            if rel > loss_rtol or cos < grad_cos or (
                    grad_atol is not None and gap > grad_atol):
                fail(f"parallel: rank {rank}'s {dname(dt)} step by the "
                     f"{feed} does not hold the one-process step")
            if r["launches"] != (3, 3, 4, 4) or r["other"]:
                fail(f"parallel: rank {rank} launched K3/K4 "
                     f"{r['launches']} (+{r['other']} of another variant) "
                     "in its step; expected (3, 3, 4, 4)")
    # (b) the GAN step
    want = ref["gan"]
    for rank, r in enumerate(g["gan"] for g in got):
        # allclose's measure: |diff| / (atol + rtol |want|), at most 1
        rel = {k: abs(r["metrics"][k] - v) / (GAN_TOL + GAN_TOL * abs(v))
               for k, v in want["metrics"].items()}
        worst = max(rel, key=rel.get)
        print(f"[parallel] (b) GAN step, LJ_V2 + MPD + MSD, float32, batch "
              f"{VOCODER_BATCH} x {VOCODER_SEGMENT} ({VOCODER_BATCH // 2} "
              f"on rank {rank} of 2): "
              + ", ".join(f"{k} {r['metrics'][k]:.6f}"
                          for k in sorted(r["metrics"]))
              + f"; against one process, |diff| / (atol + rtol |want|) at "
              f"rtol = atol = {GAN_TOL}: {rel[worst]:.3f} at {worst} (tol "
              f"<= 1); step "
              f"{r['step_ms']:.2f} ms (one process {want['step_ms']:.2f}), "
              f"gradient all-reduce {r['allreduce_ms']:.2f} ms for "
              f"{r['allreduce_bytes']:,} bytes | {card}")
        if rel[worst] > 1.0:
            fail(f"parallel: rank {rank}'s GAN step does not hold the "
                 "one-process step")
    # (c) the sequence-parallel vocoder
    for dt in (torch.float32, torch.bfloat16):
        want = ref["seq", dname(dt)].numpy()
        blocks = sorted((g["seq", dname(dt)]["index"],
                         g["seq", dname(dt)]["wav"]) for g in got)
        wav_sp = np.concatenate([b for _, b in blocks], axis=1)
        err = np.abs(wav_sp - want)
        over = float((err / (SEQ_ATOL + SEQ_RTOL * np.abs(want))).max())
        snr = float(snr_db(torch.from_numpy(want), torch.from_numpy(wav_sp)))
        tail = float(np.abs(wav_sp[:, SEQ_VALID * 256:]).max())
        ms = [g["seq", dname(dt)]["ms"] for g in got]
        print(f"[parallel] (c) seq_parallel_vocode {dname(dt)}, LJ_V2 width, "
              f"{SEQ_FRAMES} frames over 2 ranks, valid {SEQ_VALID} (in "
              f"shard 0): max abs diff from the one-process folded route "
              f"{err.max():.2e}, SNR {snr:.1f} dB, samples past valid max "
              f"{tail:.1e}; ms per rank {[round(v, 2) for v in ms]} | "
              f"{card}")
        bad = (over > 1.0 if dt == torch.float32 else snr < E2E_SNR_DB)
        if bad or tail != 0.0 or not np.isfinite(wav_sp).all():
            fail(f"parallel: seq_parallel_vocode {dname(dt)} does not hold "
                 "the one-process route (f32 at rtol 1e-5, bf16 at "
                 f"{E2E_SNR_DB} dB, zeros past valid)")

    # (d) data x tensor parallelism, 4 ranks
    t1 = time.perf_counter()
    tp = launch(parallel_rank, 4, [dev] * 4, backend="gloo",
                args=(dict(tp=True, sizes=sizes),))
    want = ref["tp"]
    for rank, r in enumerate(g["tp"] for g in tp):
        rel = max(abs(r["metrics"][k] - v) / abs(v)
                  for k, v in want["metrics"].items())
        gap, gap_at, cos, cos_at = _grad_gap(r["grads"], want["grads"])
        print(f"[parallel] (d) 2 x 2 data x tensor parallel tiny float32, "
              f"rank {rank} of 4: loss rel diff {rel:.2e} (tol <= "
              f"{PARALLEL_LOSS_RTOL}), gradient gap {gap:.2e} at {gap_at} "
              f"(tol <= {PARALLEL_GRAD_ATOL}); K3/K4 {r['launches']}; step "
              f"{r['step_ms']:.2f} ms (replicated, one process "
              f"{want['step_ms']:.2f}) | {card}")
        if rel > PARALLEL_LOSS_RTOL or gap > PARALLEL_GRAD_ATOL or \
                r["launches"] != (3, 3, 4, 4):
            fail(f"parallel: rank {rank}'s tensor-parallel step does not "
                 "hold the replicated step")
    # (e) NCCL at world size 1
    nccl = launch(parallel_rank, 1, [dev], backend=PARALLEL_NCCL,
                  args=(dict(nccl=PARALLEL_NCCL, sizes=sizes),))[0]["nccl"]
    a, b = nccl["alone"], nccl["through"]
    rel = max(abs(b["metrics"][k] - v) / abs(v)
              for k, v in a["metrics"].items())
    gap = _grad_gap(b["grads"], a["grads"])[0]
    print(f"[parallel] (e) NCCL group of one rank: a float32 step whose "
          f"collectives go through it {b['step_ms']:.2f} ms, without a "
          f"group {a['step_ms']:.2f} ms; loss rel diff {rel:.1e} (tol <= "
          f"{PARALLEL_LOSS_RTOL}), gradient gap {gap:.1e} (tol <= "
          f"{PARALLEL_GRAD_ATOL}); K3/K4 {b['launches']} | {card}")
    if rel > PARALLEL_LOSS_RTOL or gap > PARALLEL_GRAD_ATOL:
        fail("parallel: a step through a one-rank NCCL group does not "
             "hold the step without one")
    print(f"[parallel] spawned launches {spawn_s:.1f} s (2 ranks), "
          f"{time.perf_counter() - t1:.1f} s (4 ranks, then 1 over NCCL); "
          f"phase {time.perf_counter() - t_phase:.1f} s | {card}")


def phase_g2p(card: str):
    """python -m efficientspeech_tpu_torch.train_g2p on the card at its
    defaults for G2P_STEPS steps into a temp dir (its lines printed: the
    pairs count and the eval lines), the median step at batch 256 and a
    traced step's idle share, G2P_HELD dropout-0 steps held to the CPU's
    (losses, the first step's gradients, and AdamW's moves from the same
    gradients), and
    the written .npz decoded through NeuralG2p to the logged
    accuracy."""
    import contextlib
    import io

    from efficientspeech_tpu_torch import train_g2p
    from efficientspeech_tpu_torch.text import g2p_data
    from efficientspeech_tpu_torch.text import g2p_model as M
    from efficientspeech_tpu_torch.text.g2p_eval import load_eval_lexicon
    from efficientspeech_tpu_torch.text.neural_g2p import NeuralG2p

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out, log = os.path.join(root, "g2p.npz"), os.path.join(root,
                                                              "g2p.jsonl")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            best = train_g2p.main(["--steps", str(G2P_STEPS), "--eval-every",
                                   str(G2P_EVAL_EVERY), "--out", out,
                                   "--log", log])
        cli_s = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            print(f"[g2p] {line}")
        lines = [json.loads(x) for x in open(log).read().splitlines()]
        pairs = int(re.search(r"training pairs: (\d+) rows",
                              buf.getvalue()).group(1))
        if [x["step"] for x in lines] != list(range(
                G2P_EVAL_EVERY, G2P_STEPS + 1, G2P_EVAL_EVERY)):
            fail(f"g2p: eval lines at steps {[x['step'] for x in lines]}")
        if not all(np.isfinite(x["loss"]) and 0 <= x["val_per"]
                   for x in lines):
            fail(f"g2p: eval lines {lines}")
        neural = NeuralG2p(out, beam=1)
        val_lex = load_eval_lexicon(
            train_g2p.repo_path(train_g2p.DEFAULT_EVAL_SET))
        per, acc, _ = train_g2p.evaluate_neural(neural.params_list[0],
                                                val_lex)
        word = next(iter(val_lex))
        print(f"[g2p] CLI {G2P_STEPS} steps in {cli_s:.1f} s; {pairs} pairs; "
              f"best step {best['step']} val_acc {best['acc']:.4f}; the "
              f".npz ({os.path.getsize(out) / 1e6:.2f} MB) through "
              f"NeuralG2p: acc {acc:.4f} per {per:.4f}, {word!r} -> "
              f"{neural(word)[0]} | {card}")
        if (round(acc, 4) != neural.meta["val_acc"]
                or acc != best["acc"] or round(per, 4)
                != neural.meta["val_per"]):
            fail(f"g2p: the .npz decodes to acc {acc} per {per}, logged "
                 f"{best} / meta {neural.meta}")

    pairs_list = g2p_data.build_pairs()
    src, tgt = g2p_data.encode_pairs(pairs_list)
    order = np.random.default_rng(0).permutation(len(src))
    batches = [order[i * 256:(i + 1) * 256] for i in range(G2P_TIMED + 6)]
    params = M.init_params(0)
    trainer = train_g2p.G2pTrainer(params, 6000, dropout=0.2,
                                   label_smoothing=0.1,
                                   device="cuda")
    for idx in batches[:5]:
        trainer.step(src[idx], tgt[idx])
    rows = iter(batches[5:])

    def step():
        idx = next(rows)
        return trainer.step(src[idx], tgt[idx])

    step_ms = _median_ms(step, G2P_TIMED, torch.device("cuda"))
    print(f"[g2p] train step at batch 256 (dropout 0.2, float32, TF32 "
          f"off): median {step_ms:.2f} ms over {G2P_TIMED} steps, each "
          f"ended by a synchronise | {card}")
    last = batches[-1]
    trace(lambda: trainer.step(src[last], tgt[last]),
          "G2P train step at batch 256", card)

    held = {dev: train_g2p.G2pTrainer(params, 6000, warmup=1,
                                      dropout=0.0, label_smoothing=0.1,
                                      device=dev)
            for dev in ("cuda", "cpu")}
    card_t, cpu_t = held["cuda"], held["cpu"]
    loss_rel = update_gap = 0.0
    rates, grad_gaps, f64_gaps = [], [], []
    for b in batches[:G2P_HELD]:
        before = {dev: t.numpy_params() for dev, t in held.items()}
        lc, lh = float(card_t.backward(src[b], tgt[b])), float(
            cpu_t.backward(src[b], tgt[b]))
        loss_rel = max(loss_rel, abs(lc - lh) / abs(lh))
        p64 = {k: p.detach().double().requires_grad_()
               for k, p in cpu_t.params.items()}
        train_g2p.g2p_loss(p64, torch.from_numpy(src[b].astype(np.int64)),
                           torch.from_numpy(tgt[b].astype(np.int64)),
                           cpu_t.xp, label_smoothing=0.1).backward()
        grad_gaps.append(0.0)
        f64_gaps.append(0.0)
        for k, p in cpu_t.params.items():
            gh = p.grad.numpy()
            gc = card_t.params[k].grad.cpu().numpy()
            scale = max(np.abs(gh).max(), 1e-30)
            grad_gaps[-1] = max(grad_gaps[-1],
                                float(np.abs(gc - gh).max() / scale))
            f64_gaps[-1] = max(f64_gaps[-1], float(
                np.abs(gh - p64[k].grad.numpy()).max() / scale))
            card_t.params[k].grad.copy_(p.grad)
        rates.append(cpu_t.lr(cpu_t.count))
        card_t.update()
        cpu_t.update()
        after = {dev: t.numpy_params() for dev, t in held.items()}
        for k in params:
            dh = after["cpu"][k] - before["cpu"][k]
            dc = after["cuda"][k] - before["cuda"][k]
            if np.abs(dh).max() > 0:
                update_gap = max(update_gap, float(
                    np.abs(dc - dh).max() / np.abs(dh).max()))
            elif np.abs(dc).max() > 0:
                fail(f"g2p: {k} moved on the card at rate {rates[-1]}")
    if not rates[-1] > 0:
        fail(f"g2p: the held steps' rates {rates} reach no update")
    print(f"[g2p] dropout-0 steps 1-{G2P_HELD} (rates {rates}) on the card "
          f"vs the CPU: loss rel diff {loss_rel:.1e} (tol <= "
          f"{G2P_LOSS_RTOL}), first step's gradients {grad_gaps[0]:.1e} of "
          f"a leaf's largest (tol <= {G2P_GRAD_ATOL}); gradients a step "
          f"{', '.join(f'{x:.1e}' for x in grad_gaps)} (the CPU's float32 "
          f"from float64: {', '.join(f'{x:.1e}' for x in f64_gaps)}); "
          f"AdamW's move from the same gradients {update_gap:.1e} of a "
          f"leaf's largest (tol <= {G2P_UPDATE_RTOL}); phase "
          f"{time.perf_counter() - t_phase:.1f} s | {card}")
    if (loss_rel > G2P_LOSS_RTOL or grad_gaps[0] > G2P_GRAD_ATOL
            or update_gap > G2P_UPDATE_RTOL):
        fail("g2p: the card's step does not hold the CPU's")


def phase_export(card: str, root: str):
    """The convert CLI on the card from the reference phase's files in
    ``root`` (the tiny model from seed 0 and its LJ_V2-width generator),
    in bf16 (--export) and float32 (--export, --torchscript, --onnx,
    --output), at --insize EXPORT_INSIZE; the programs loaded back on the
    card and held to eager predict there, in float32 also to the CPU's
    eager predict, and the exported float32 waveform to the serving
    kernel route's on the same padded phonemes."""
    from efficientspeech_tpu_torch.convert import __main__ as convert_cli
    from efficientspeech_tpu_torch.convert.export import (
        fixed_size_model, load_exported)
    from efficientspeech_tpu_torch.infer import build_model, build_synthesizer
    from efficientspeech_tpu_torch.ops.kernels import folded_matmul as fm
    from efficientspeech_tpu_torch.ops.kernels import mrf_block

    t_phase = time.perf_counter()
    ckpt = os.path.join(root, "tiny_seed0.ckpt")
    gen = os.path.join(root, "LJ_V2", "generator_v2")
    out = os.path.join(root, "export")
    files = {"bf16": {"export": os.path.join(out, "tiny_bf16.pt2")},
             "f32": {"export": os.path.join(out, "tiny_f32.pt2"),
                     "torchscript": os.path.join(out, "tiny.ts"),
                     "onnx": os.path.join(out, "tiny.onnx"),
                     "output": os.path.join(out, "tiny_native.pt")}}
    os.makedirs(out)
    for precision, want in files.items():
        flags = [f"--{k}={v}" for k, v in want.items()]
        t0 = time.perf_counter()
        written = convert_cli.main(["--checkpoint", ckpt,
                                    "--hifigan-checkpoint", gen,
                                    "--precision", precision, "--insize",
                                    str(EXPORT_INSIZE)] + flags)
        if written != want:
            fail(f"export: the convert CLI wrote {written}")
        print(f"[export] convert --precision {precision} "
              f"{' '.join(k for k in want)}: {time.perf_counter() - t0:.1f}"
              f" s; " + ", ".join(f"{os.path.basename(v)} "
                                 f"{os.path.getsize(v) / 1e6:.2f} MB"
                                 for v in want.values()) + f" | {card}")
    onnx = open(files["f32"]["onnx"], "rb").read()
    names = [n for n in (b"inputs", b"wav", b"lengths", b"duration")
             if n in onnx]
    producer = "pytorch" if b"pytorch" in onnx[:64] else "?"
    print(f"[export] ONNX: {len(onnx)} bytes, ModelProto tag "
          f"0x{onnx[0]:02x}, producer {producer}, names "
          f"{[n.decode() for n in names]}, no searchsorted "
          f"{b'searchsorted' not in onnx.lower()} (onnxruntime absent: "
          f"not run) | {card}")
    if (onnx[0] != 0x08 or b"pytorch" not in onnx[:64] or len(names) != 4
            or b"searchsorted" in onnx.lower()):
        fail("export: the .onnx file's structure")

    model = build_model(preset="tiny", checkpoint=ckpt,
                        hifigan_checkpoint=gen)
    cfg, hcfg = model.cfg, model.hifigan_cfg
    # the f32 wire: the exported program returns float32 samples
    ref = build_synthesizer(preset="tiny", checkpoint=ckpt,
                            hifigan_checkpoint=gen, dtype=torch.float32,
                            vocoder_mode="folded_kernel", transfer="f32")
    seq = ref.phonemize(LONG_TEXT)[:EXPORT_INSIZE - 8]
    phoneme = np.zeros((1, EXPORT_INSIZE), np.int32)
    phoneme[0, :len(seq)] = seq
    ph_cpu = torch.from_numpy(phoneme)
    pad_cpu = ph_cpu == 0
    cuda = torch.device("cuda")
    ph, pad = ph_cpu.to(cuda), pad_cpu.to(cuda)
    cuda_model = model.to(cuda)
    wav32 = None
    for precision, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fixed = fixed_size_model(cfg, hcfg, cuda_model, EXPORT_INSIZE, 16, dt)
        with torch.no_grad():
            eager = fixed.predict(ph, pad)
        run = load_exported(files[precision]["export"])
        progs = {"torch.export": run(ph, pad)}
        timings = {"eager predict": _median_ms(
            lambda: fixed.predict(ph, pad), EXPORT_TIMED, cuda),
            "torch.export": _median_ms(lambda: run(ph, pad), EXPORT_TIMED,
                                       cuda)}
        if precision == "f32":
            ts = torch.jit.load(files["f32"]["torchscript"],
                                map_location="cuda")
            with torch.no_grad():
                w, ml, d = ts(ph)
            progs["TorchScript"] = (w, None, ml, d)
            timings["TorchScript"] = _median_ms(lambda: ts(ph),
                                                EXPORT_TIMED, cuda)
        bar = F32_E2E_SNR_DB if dt == torch.float32 else KERNEL_SNR_DB
        mel_len = int(eager[2][0])
        n = int(eager[1][0])
        for name, got in progs.items():
            snr = snr_db(eager[0][0, :n].float(), got[0][0, :n].float())
            print(f"[export] {precision} {name} on the card vs eager "
                  f"predict: mel_len {int(got[2][0])} / {mel_len}, SNR "
                  f"{snr:.1f} dB (tol >= {bar}) | {card}")
            if int(got[2][0]) != mel_len or not snr >= bar:
                fail(f"export: {precision} {name} does not hold eager "
                     "predict")
        if precision == "f32":
            with torch.no_grad():
                cpu_out = fixed_size_model(cfg, hcfg, model.to("cpu"),
                                           EXPORT_INSIZE, 16,
                                           torch.float32).predict(
                                               ph_cpu, pad_cpu)
            model.to("cuda")
            for name, got in progs.items():
                snr = snr_db(cpu_out[0][0, :n], got[0][0, :n].float().cpu())
                print(f"[export] f32 {name} on the card vs eager predict on "
                      f"the CPU: mel_len {int(cpu_out[2][0])}, SNR "
                      f"{snr:.1f} dB (tol >= {F32_E2E_SNR_DB}) | {card}")
                if int(cpu_out[2][0]) != mel_len or not snr >= \
                        F32_E2E_SNR_DB:
                    fail(f"export: f32 {name} does not hold the CPU")
            wav32 = progs["torch.export"][0][0, :n].float().cpu()
        print(f"[export] {precision} ms a call, {EXPORT_INSIZE} phonemes "
              f"({len(seq)} real), {mel_len} of {EXPORT_INSIZE * 16} "
              "frames: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     timings.items()) + f" | {card}")

    # the serving kernel route on the same padded phonemes: the mel buffer
    # at the export's EXPORT_INSIZE x 16 frames
    ref.spec_min_frames = EXPORT_INSIZE * 16
    ref.synthesize_ids(seq)
    _reset_counts(fm, mrf_block)
    wav_s, mel_s, _ = ref.synthesize_ids(seq)
    k1, k2 = fm.launches[torch.float32], mrf_block.launches[torch.float32]
    serve_ms = _median_ms(lambda: ref.synthesize_ids(seq), EXPORT_TIMED,
                          cuda)
    if mel_s * hcfg.total_upsample != len(wav32):
        fail(f"export: the serving route's mel_len {mel_s}, the exported "
             f"program's {len(wav32) // hcfg.total_upsample}")
    snr = snr_db(torch.from_numpy(wav_s), wav32)
    print(f"[export] f32 torch.export program vs the serving kernel route "
          f"(K1 {k1}, K2 {k2} launches): mel_len {mel_s}, SNR {snr:.1f} dB "
          f"(tol >= {F32_E2E_SNR_DB}); serving synthesize_ids "
          f"{serve_ms:.2f} ms a call; phase "
          f"{time.perf_counter() - t_phase:.1f} s | {card}")
    if (k1, k2) != (5, 4) or not snr >= F32_E2E_SNR_DB:
        fail("export: the exported float32 waveform does not hold the "
             "serving kernel route's")
    del ref, model, cuda_model


def main():
    parser = argparse.ArgumentParser(description="Smoke run of the port "
                                     "on one CUDA card.")
    parser.add_argument("--profile", action="store_true",
                        help="also trace one long request and one train "
                             "step of each preset with torch.profiler")
    args = parser.parse_args()
    card = phase_device()
    phase_build(card)

    from efficientspeech_tpu_torch.infer import build_synthesizer

    t0 = time.perf_counter()
    synth = build_synthesizer(preset="tiny", seed=0, bench_duration_bias=6.0,
                              dtype=torch.bfloat16,
                              vocoder_mode="folded_kernel")
    print(f"[setup] synthesizer on {synth.device} in "
          f"{time.perf_counter() - t0:.1f} s | {card}")

    k1 = {"bf16": phase_k1(synth, card)}
    k2 = {"bf16": phase_k2(synth, card)}
    k1_v1, k2_wide, v1_launches = phase_v1(card)
    launches = phase_slice(synth, card)
    launches.update(v1_launches)
    batch_launches, batch_frames = phase_batch(synth, card)
    launches["adpcm_encode"] = batch_launches["adpcm_encode"]
    phase_stream_chunked(synth, card)
    phase_serve(synth, card)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        gen = phase_reference(synth, card, work)
        if args.profile:
            phase_profile(synth, card, batch=True)
        del synth
        torch.cuda.empty_cache()
        data = phase_preprocess(card, work)
        phase_validate(card, data, gen, work)
        phase_vocoder(card, work, data)
        phase_export(card, work)
        phase_g2p(card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()

    # serving at --precision f32: the same model folded in float32, through
    # the kernels' float32 variants
    t0 = time.perf_counter()
    synth = build_synthesizer(preset="tiny", seed=0, bench_duration_bias=6.0,
                              dtype=torch.float32,
                              vocoder_mode="folded_kernel")
    print(f"[setup] float32 synthesizer on {synth.device} in "
          f"{time.perf_counter() - t0:.1f} s | {card}")
    with tempfile.TemporaryDirectory() as ref_root:
        phase_reference(synth, card, ref_root)
    k1["f32"] = phase_k1(synth, card)
    k2["f32"] = phase_k2(synth, card)
    launches.update(phase_slice(synth, card,
                                texts=(LONG_TEXT, SHORT_TEXTS[0])))
    phase_batch(synth, card, rows=4)
    if args.profile:
        phase_profile(synth, card)
    del synth
    torch.cuda.empty_cache()

    # launches a train step: K3 1 + blocks (tiny 3, small 4), K4 blocks x
    # depth (tiny 2 x 2, small 3 x 2)
    k3, k4 = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        for c, per_step in ((128, 3), (256, 4)):
            k3[c, dname(dt)] = phase_k3(card, c, per_step, dt)
        for c, per_step in ((128, 4), (256, 6)):
            k4[c, dname(dt)] = phase_k4(card, c, per_step, dt)
    adpcm_row = phase_adpcm(card, batch_frames)
    k5, k5_launches = phase_k5(card)
    launches.update(k5_launches)
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        t0 = time.perf_counter()
        write_corpus(data, n_train=EPOCH_STEPS * TRAIN_BATCH)
        print(f"[train] synthetic corpus of {EPOCH_STEPS * TRAIN_BATCH} + 16 "
              f"utterances in {time.perf_counter() - t0:.1f} s | {card}")
        for dt in (torch.bfloat16, torch.float32):
            for preset in ("tiny", "small"):
                launches.update(phase_train(
                    card, preset, data,
                    os.path.join(root, f"{preset}_{dname(dt)}"),
                    args.profile, dt))
        phase_device_data(card, data, os.path.join(root, "device_data"))
        torch.cuda.empty_cache()
        phase_parallel(card, root)

    phase_bench(card)

    csrc = "efficientspeech_tpu_torch/csrc/"
    pallas = "efficientspeech_tpu/ops/pallas/"
    probe = "benchmarks/int8_pallas_probe.py:27"
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        dn, sfx, key = dname(dt), f32_suffix(dt), f32_suffix(dt, "_")
        rows += [
            ("folded_matmul" + sfx, "folded_matmul" + key, dn,
             csrc + "folded_matmul.cu", pallas + "folded_matmul.py:231",
             k1[dn]),
            ("mrf_fused" + sfx, "mrf_fused" + key, dn, csrc + "mrf_block.cu",
             pallas + "mrf_block.py:176", k2[dn])]
        for kn, fn, stats, lines in (
                ("k3", "layer_norm", k3, (67, 90)),
                ("k4", "decoder_block", k4, (198, 237))):
            for c in (128, 256):
                wsfx = "" if c == 128 else f" C={c}"
                for i, direction in enumerate(("fwd", "bwd")):
                    rows.append((f"{fn}_fused {direction}{wsfx}{sfx}",
                                 f"{kn}_{direction}_{c}{key}", dn,
                                 csrc + f"{fn}.cu",
                                 pallas + f"{fn}.py:{lines[i]}",
                                 stats[c, dn][i]))
        if dn == "bf16":
            rows += [
                ("folded_matmul up0 V1", "folded_matmul_v1", dn,
                 csrc + "folded_matmul.cu", pallas + "folded_matmul.py:231",
                 k1_v1),
                ("mrf_fused wide (D = 256)", "mrf_fused_wide", dn,
                 csrc + "mrf_block.cu", pallas + "mrf_block.py:176",
                 k2_wide),
                ("int8_window_matmul bf16-in", "k5_bf16", "bf16",
                 csrc + "int8_window.cu", probe, k5["bf16"]),
                ("int8_window_matmul int8-in", "k5_int8", "int8",
                 csrc + "int8_window.cu", probe, k5["int8"])]
    # not a Pallas kernel: the JAX package's lax.scan encoder, one launch
    rows.append(("adpcm_encode adpcm3", "adpcm_encode", "f32 in, uint8 out",
                 csrc + "adpcm_encode.cu", "efficientspeech_tpu/audio/"
                 "adpcm.py:59", adpcm_row))
    table = []
    for name, key, dn, src, replaces, stats in rows:
        if launches[key] == 0:
            fail(f"{name} was not launched on the main path")
        row = {"name": name, "route": "cuda", "dtype": dn,
               "source": src, "replaces": replaces,
               "launches": launches[key],
               "max_abs_err": stats["max_abs_err"],
               "ms": stats["ms"], "plain_ms": stats["plain_ms"],
               "bound_ms": stats["bound_ms"],
               "bound_by": stats["bound_by"],
               "library_ms": stats["library_ms"]}
        if key in DESIGNS:
            row["design"] = DESIGNS[key]
        table.append(row)
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
