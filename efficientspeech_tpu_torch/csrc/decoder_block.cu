// One mel-decoder block body, forward and backward (kernel K4).
//
// Replaces: efficientspeech_tpu/ops/pallas/decoder_block.py::
// decoder_block_fused (_recompute_to_t, _fwd_kernel, _bwd_kernel and the
// custom VJP).  For x (B, M, C) bf16, C = 128 or 256, and keep (B, M)
// float32:
//
//   xm = bf16(x * keep)                         masked input
//   u  = sum_tap xm[m + tap - 2] * dw[tap]      k = 5, taps summed in bf16,
//        + dw_b                                 in tap order
//   v  = bf16(u @ W  | float32 accumulate) + pw_b   (C x C pointwise conv)
//   t  = tanh(v)                                (bf16)
//   y  = LayerNorm(t; float32 statistics) * ln_s + ln_b   -> bf16
//
// and its gradient: dx (masked by keep) and float32 partial sums of the
// seven weight gradients, one set per block (or block pair), summed by the
// caller.  The gradient with respect to keep is zero.  A float32 variant of
// both kernels (x, y, dx, dy float32, every step in float32) follows the
// bf16 ones below, with its own note.
//
// What bounds it on an H100: bytes.  At B = 128, M = 1024 the forward reads
// x and writes y (67 MB at C = 256); the backward reads x and dy and writes
// dx (101 MB at C = 256).  The pointwise product is 17.2 GFLOP a pass at
// C = 256, 17 us of tensor-core time.  Both kernels keep every
// intermediate (the masked input, u, v, t, the LayerNorm statistics, dv,
// du) in shared memory and registers: the backward recomputes u and t from
// x instead of reading any saved activation.  The C x C bf16 weight (32 KB
// at C = 128, 135 KB at C = 256) is loaded into shared memory once per
// block: the grids are persistent and each block walks over row tiles.
// The products run on the tensor cores (WMMA, bf16 operands, float32
// accumulation).  The backward keeps its weight-gradient sum in
// accumulator fragments across all its tiles and its per-column sums in
// registers, and writes one float32 partial of each per block: no float
// atomics, so every run gives the same sums.
//
// Tiles: a tile computes u and t for R consecutive frames of one sequence
// (R = 64 at C = 128; R = 32 at C = 256, where the weight alone takes 135 of
// a block's 227 KB).  The depthwise conv needs 2 more input rows on each
// side.  In the backward, dx of a frame needs du of its 2 neighbours on
// each side, so a tile owns only its inner R - 4 rows and recomputes the
// outer 2 on each side (rows outside [0, M) read as zero, as the TPU
// kernel's padding does).
//
// Column halves: every backward block owns 128 columns.  At C = 256 the
// 256 x 256 float32 weight gradient would take 128 accumulator registers a
// thread, so blocks come in pairs that walk the same tiles: both recompute
// u, t and the full rows of dv (the LayerNorm backward and du = dv W^T need
// them), and block p of a pair computes du, dx and the depthwise gradients
// of input columns [128p, 128p + 128) and accumulates the weight gradient's
// output columns [128p, 128p + 128) and the pointwise-bias and LayerNorm
// gradients of those columns.  The two blocks of a pair run side by side,
// so the second reads of x and dy come from L2.
//
// Numerics: the depthwise taps are rounded to bf16 after every product
// and every sum, exactly as the bf16 arithmetic of _recompute_to_t (a
// product of two bf16 values is exact in float32, and float32 rounding
// before bf16 rounding of a sum of two bf16 values gives the same bits).
// tanhf, and the order of the float32 sums, differ from XLA's, so the
// kernel is held to its plain version by SNR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "tf32x3.cuh"

using namespace nvcuda;

namespace {

constexpr int K = 5;
constexpr int PAD = K / 2;
constexpr int HALF = 128;     // columns a backward block owns
constexpr int BWD_WARPS = 16;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// The geometry of one width.
template <int C_>
struct Geo {
  static constexpr int C = C_;
  static constexpr int R = C == 128 ? 64 : 32;  // rows of u and t per tile
  static constexpr int FWD_WARPS = C == 128 ? 8 : 16;
  static constexpr int FWD_BLOCKS = C == 128 ? 2 : 1;  // forward blocks/SM
  static constexpr int SPLIT = C / HALF;  // backward blocks per tile
  static constexpr int LDB = C + 8;  // bf16 row stride in shared memory
  static constexpr int LDF = C + 4;  // float32 row stride in shared memory
  static constexpr int XROWS = R + 2 * PAD;
  static constexpr int FWD_OWN = R;            // every row is an output row
  static constexpr int BWD_OWN = R - 2 * PAD;  // the inner rows
  static constexpr size_t WS_BYTES = align128((size_t)C * LDB * 2);
  static constexpr size_t XS_BYTES = align128((size_t)XROWS * LDB * 2);
  static constexpr size_t US_BYTES = align128((size_t)R * LDB * 2);
  static constexpr size_t ST_BYTES = align128((size_t)R * LDF * 4);
  static constexpr size_t FWD_SMEM = WS_BYTES + XS_BYTES + US_BYTES + ST_BYTES;
  static constexpr size_t BWD_SMEM = FWD_SMEM + US_BYTES;  // + dv in bf16
  static constexpr int BGROUPS = BWD_WARPS * 32 / HALF;   // dx row groups
  static_assert(C % HALF == 0 && R % 16 == 0, "tile shape");
  static_assert(FWD_SMEM * FWD_BLOCKS <= SMEM_LIMIT, "forward smem");
  static_assert(BWD_SMEM <= SMEM_LIMIT, "backward smem");
  static_assert(BWD_OWN % BGROUPS == 0, "owned rows split evenly");
  // the backward's final reductions reuse xs, us and dv
  static_assert(((K + 1) * BGROUPS + 3 * BWD_WARPS) * HALF * 4 <=
                    XS_BYTES + 2 * US_BYTES,
                "reduction scratch does not fit");
};

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<unsigned*>(&a);
  q.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// W (C_in, C_out) bf16 -> shared memory, row stride LDB
template <class G>
__device__ void load_weight(const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* ws) {
  constexpr int CH = G::C / 8;
  for (int i = threadIdx.x; i < G::C * CH; i += blockDim.x) {
    const int r = i / CH, c8 = i - r * CH;
    *reinterpret_cast<uint4*>(ws + r * G::LDB + c8 * 8) =
        reinterpret_cast<const uint4*>(w)[i];
  }
}

// xs row i <- bf16(x[b, u0 - PAD + i] * keep), zero outside [0, M)
template <class G>
__device__ void load_x(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ keep, int b, int u0, int M,
                       __nv_bfloat16* xs) {
  constexpr int CH = G::C / 8;
  for (int i = threadIdx.x; i < G::XROWS * CH; i += blockDim.x) {
    const int r = i / CH, c8 = i - r * CH;
    const int g = u0 - PAD + r;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < M) {
      const size_t row = (size_t)b * M + g;
      q = *reinterpret_cast<const uint4*>(x + row * G::C + c8 * 8);
      const float kp = keep[row];
      if (kp != 1.f) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(f.x * kp, f.y * kp);
        }
      }
    }
    *reinterpret_cast<uint4*>(xs + r * G::LDB + c8 * 8) = q;
  }
}

// u rows [r0, r1) of column c: the depthwise conv in bf16 arithmetic, with
// the taps and the bias rounded to bf16.
template <class G>
__device__ void depthwise(const __nv_bfloat16* xs, __nv_bfloat16* us,
                          const float* __restrict__ dww,
                          const float* __restrict__ dwb, int c, int r0,
                          int r1) {
  float wb[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) wb[tap] = bfr(dww[tap * G::C + c]);
  const float bb = bfr(dwb[c]);
  for (int r = r0; r < r1; ++r) {
    float acc = bfr(__fmul_rn(__bfloat162float(xs[r * G::LDB + c]), wb[0]));
#pragma unroll
    for (int tap = 1; tap < K; ++tap)
      acc = bfr(__fadd_rn(
          acc, bfr(__fmul_rn(__bfloat162float(xs[(r + tap) * G::LDB + c]),
                             wb[tap]))));
    us[r * G::LDB + c] = __float2bfloat16_rn(__fadd_rn(acc, bb));
  }
}

// st[:, 0 : 16 NCB] (R rows, float32) <- a (R x C, bf16) @ B, with
// B = W[:, col0 : col0 + 16 NCB] (TRANS = false: v = u @ W) or
// B = W[col0 : col0 + 16 NCB, :]^T (TRANS = true: du = dv @ W^T); ws holds
// W as (C_in, C_out).  The R/16 x NCB output tiles are dealt to the NW
// warps in column-major order, so a warp's tiles share their B fragments.
template <class G, int NW, bool TRANS, int NCB>
__device__ void mma_rows(const __nv_bfloat16* a, const __nv_bfloat16* ws,
                         float* st, int col0, int warp) {
  constexpr int RB = G::R / 16, KB = G::C / 16;
  constexpr int PER = RB * NCB / NW;           // tiles per warp
  constexpr int NRB = PER < RB ? PER : RB;     // row blocks per warp
  constexpr int NCBW = PER / NRB;              // column blocks per warp
  static_assert(RB * NCB % NW == 0 && (RB % PER == 0 || PER % RB == 0),
                "tiles split evenly over the warps");
  const int t0 = warp * PER;
  const int rb0 = t0 % RB, cb0 = t0 / RB;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NCBW][NRB];
#pragma unroll
  for (int j = 0; j < NCBW; ++j)
#pragma unroll
    for (int i = 0; i < NRB; ++i) wmma::fill_fragment(acc[j][i], 0.f);
  using BLayout =
      typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        af[NRB];
#pragma unroll
    for (int i = 0; i < NRB; ++i)
      wmma::load_matrix_sync(af[i], a + (rb0 + i) * 16 * G::LDB + kb * 16,
                             G::LDB);
#pragma unroll
    for (int j = 0; j < NCBW; ++j) {
      const int col = col0 + (cb0 + j) * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      wmma::load_matrix_sync(
          bf, TRANS ? ws + col * G::LDB + kb * 16 : ws + kb * 16 * G::LDB + col,
          G::LDB);
#pragma unroll
      for (int i = 0; i < NRB; ++i) wmma::mma_sync(acc[j][i], af[i], bf, acc[j][i]);
    }
  }
#pragma unroll
  for (int j = 0; j < NCBW; ++j)
#pragma unroll
    for (int i = 0; i < NRB; ++i)
      wmma::store_matrix_sync(st + (rb0 + i) * 16 * G::LDF + (cb0 + j) * 16,
                              acc[j][i], G::LDF, wmma::mem_row_major);
}

// The lane's C/32 columns: 4 consecutive ones in each 128-column chunk,
// chunk h's at 128 h + 4 lane.  v[h * 4 + i] <- p[128 h + 4 lane + i].
template <class G>
__device__ __forceinline__ void lane_cols(const float* __restrict__ p,
                                          int lane, float* v) {
#pragma unroll
  for (int h = 0; h < G::C / 128; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[h * 4 + i] = p[h * 128 + lane * 4 + i];
}

// t of one row from v, and its LayerNorm statistics, over the lane's
// columns: t = tanh(bf16(v) + pb) in bf16, pb the pointwise bias rounded
// to bf16.
template <class G>
__device__ __forceinline__ void row_t(const float* st_row, int lane,
                                      const float* pb, float* t, float eps,
                                      float& mean, float& rstd) {
  constexpr int CH = G::C / 128;
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const float4 v =
        *reinterpret_cast<const float4*>(st_row + h * 128 + lane * 4);
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[h * 4 + i] = bfr(tanhf(bfr(__fadd_rn(bfr(vv[i]), pb[h * 4 + i]))));
      s += t[h * 4 + i];
    }
  }
  mean = warp_sum(s) / G::C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) {
    const float d = t[i] - mean;
    q += d * d;
  }
  rstd = 1.f / sqrtf(warp_sum(q) / G::C + eps);
}

template <int C>
__global__ void __launch_bounds__(Geo<C>::FWD_WARPS * 32, Geo<C>::FWD_BLOCKS)
    decoder_block_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                             const float* __restrict__ keep,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ dww,
                             const float* __restrict__ dwb,
                             const float* __restrict__ pwb,
                             const float* __restrict__ lns,
                             const float* __restrict__ lnb,
                             __nv_bfloat16* __restrict__ y, int B, int M,
                             float eps) {
  using G = Geo<C>;
  constexpr int NW = G::FWD_WARPS, CH = C / 128;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + G::WS_BYTES);
  __nv_bfloat16* us =
      reinterpret_cast<__nv_bfloat16*>(smem + G::WS_BYTES + G::XS_BYTES);
  float* st = reinterpret_cast<float*>(smem + G::WS_BYTES + G::XS_BYTES +
                                       G::US_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // depthwise: column c, one of NT/C row groups
  constexpr int GROUPS = NW * 32 / C;
  constexpr int GROWS = G::R / GROUPS;
  const int c = tid % C, grp = tid / C;
  // epilogue constants of the lane's columns, held in registers
  float pb[4 * CH], s[4 * CH], sb[4 * CH];
  lane_cols<G>(pwb, lane, pb);
  lane_cols<G>(lns, lane, s);
  lane_cols<G>(lnb, lane, sb);
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) pb[i] = bfr(pb[i]);
  load_weight<G>(w, ws);

  const int tiles_m = (M + G::FWD_OWN - 1) / G::FWD_OWN;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int u0 = (tile - b * tiles_m) * G::FWD_OWN;
    load_x<G>(x, keep, b, u0, M, xs);
    __syncthreads();
    depthwise<G>(xs, us, dww, dwb, c, grp * GROWS, (grp + 1) * GROWS);
    __syncthreads();
    mma_rows<G, NW, false, C / 16>(us, ws, st, 0, warp);
    __syncthreads();
    for (int r = warp; r < G::R && u0 + r < M; r += NW) {
      float t[4 * CH], mean, rstd;
      row_t<G>(st + r * G::LDF, lane, pb, t, eps, mean, rstd);
#pragma unroll
      for (int i = 0; i < 4 * CH; ++i) t[i] = (t[i] - mean) * rstd * s[i] + sb[i];
#pragma unroll
      for (int h = 0; h < CH; ++h)
        store4(y + ((size_t)b * M + u0 + r) * C + h * 128 + lane * 4, t + h * 4);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
    decoder_block_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                             const float* __restrict__ keep,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ dww,
                             const float* __restrict__ dwb,
                             const float* __restrict__ pwb,
                             const float* __restrict__ lns,
                             const __nv_bfloat16* __restrict__ dy,
                             __nv_bfloat16* __restrict__ dx,
                             float* __restrict__ part_pw,
                             float* __restrict__ part_vec, int B, int M,
                             float eps) {
  using G = Geo<C>;
  constexpr int NT = BWD_WARPS * 32, CH = C / 128, R = G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + G::WS_BYTES);
  __nv_bfloat16* us =
      reinterpret_cast<__nv_bfloat16*>(smem + G::WS_BYTES + G::XS_BYTES);
  __nv_bfloat16* dvs = reinterpret_cast<__nv_bfloat16*>(
      smem + G::WS_BYTES + G::XS_BYTES + G::US_BYTES);
  float* st = reinterpret_cast<float*>(smem + G::WS_BYTES + G::XS_BYTES +
                                       2 * G::US_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the column half this block owns, and the pair that shares its tiles
  const int part = blockIdx.x % G::SPLIT;
  const int pair = blockIdx.x / G::SPLIT, npairs = gridDim.x / G::SPLIT;
  const int h0 = part * HALF;
  // the recomputed depthwise conv: column cf, one of NT/C row groups
  constexpr int FGROUPS = NT / C;
  constexpr int FGROWS = R / FGROUPS;
  const int cf = tid % C, fg = tid / C;
  // the gradient: owned column cg = h0 + cl, one of BGROUPS row groups
  constexpr int OROWS = G::BWD_OWN / G::BGROUPS;
  const int cl = tid % HALF, cg = h0 + cl, bg = tid / HALF;
  float wf[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) wf[tap] = dww[tap * C + cg];
  // per-thread partial sums: column cg (taps, dw bias), the lane's 4
  // columns of the owned chunk (pw bias, LayerNorm scale and bias)
  float p_dw[K], p_dwb = 0.f, p_pwb[4], p_lns[4], p_lnb[4];
#pragma unroll
  for (int i = 0; i < K; ++i) p_dw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) p_pwb[i] = p_lns[i] = p_lnb[i] = 0.f;
  // the owned (C_in x HALF) part of the pointwise-weight gradient: warp
  // owns input-row block ib and PW_PER output-column blocks from ob0
  constexpr int PW_PER = (C / 16) * (HALF / 16) / BWD_WARPS;
  constexpr int OBW = HALF / 16 / PW_PER;  // warps per input-row block
  const int ib = warp / OBW, ob0 = (warp % OBW) * PW_PER;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_pw[PW_PER];
#pragma unroll
  for (int j = 0; j < PW_PER; ++j) wmma::fill_fragment(acc_pw[j], 0.f);
  load_weight<G>(w, ws);

  const int tiles_m = (M + G::BWD_OWN - 1) / G::BWD_OWN;
  for (int tile = pair; tile < B * tiles_m; tile += npairs) {
    const int b = tile / tiles_m;
    const int m0 = (tile - b * tiles_m) * G::BWD_OWN;
    const int u0 = m0 - PAD;  // global row of u row 0
    load_x<G>(x, keep, b, u0, M, xs);
    __syncthreads();
    depthwise<G>(xs, us, dww, dwb, cf, fg * FGROWS, (fg + 1) * FGROWS);
    __syncthreads();
    mma_rows<G, BWD_WARPS, false, C / 16>(us, ws, st, 0, warp);
    __syncthreads();
    // recompute t and its LayerNorm, then dv = dLN * (1 - t^2), full rows
    for (int r = warp; r < R; r += BWD_WARPS) {
      const int g = u0 + r;
      if (g < 0 || g >= M) {
        const float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < CH; ++h) store4(dvs + r * G::LDB + h * 128 + lane * 4, z);
        continue;
      }
      // (loaded per row: registers are short in the backward)
      float t[4 * CH], mean, rstd, d[4 * CH], pb[4 * CH];
      lane_cols<G>(pwb, lane, pb);
#pragma unroll
      for (int i = 0; i < 4 * CH; ++i) pb[i] = bfr(pb[i]);
      row_t<G>(st + r * G::LDF, lane, pb, t, eps, mean, rstd);
      float gs = 0.f, gx = 0.f;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int col = h * 128 + lane * 4;
        load4(dy + ((size_t)b * M + g) * C + col, d + h * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gg = d[h * 4 + i] * lns[col + i];
          gs += gg;
          gx += gg * ((t[h * 4 + i] - mean) * rstd);
        }
      }
      const float gm = warp_sum(gs) / C, gxm = warp_sum(gx) / C;
      const bool owned_row = r >= PAD && r < R - PAD;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int col = h * 128 + lane * 4;
        float dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float tt = t[h * 4 + i];
          const float that = (tt - mean) * rstd;
          dv[i] = rstd * (d[h * 4 + i] * lns[col + i] - gm - that * gxm) *
                  (1.f - tt * tt);
          if (owned_row && h == part) {
            p_pwb[i] += dv[i];
            p_lns[i] += d[h * 4 + i] * that;
            p_lnb[i] += d[h * 4 + i];
          }
        }
        store4(dvs + r * G::LDB + col, dv);
      }
    }
    __syncthreads();
    // du of the owned input columns, st[:, 0 : HALF] = dv @ W[h0 : h0 +
    // HALF, :]^T, for all R rows (rows outside [0, M) have dv = 0)
    mma_rows<G, BWD_WARPS, true, HALF / 16>(dvs, ws, st, h0, warp);
    __syncthreads();
    // only owned rows enter the pointwise-weight gradient
    for (int i = tid; i < 2 * PAD * C; i += NT) {
      const int r = i / C < PAD ? i / C : R - 2 * PAD + i / C;
      dvs[r * G::LDB + i % C] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    // d_pw[:, h0 : h0 + HALF] += u^T @ dv[:, h0 : h0 + HALF]
#pragma unroll
    for (int kb = 0; kb < R / 16; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> af;
      wmma::load_matrix_sync(af, us + kb * 16 * G::LDB + ib * 16, G::LDB);
#pragma unroll
      for (int j = 0; j < PW_PER; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(
            bf, dvs + kb * 16 * G::LDB + h0 + (ob0 + j) * 16, G::LDB);
        wmma::mma_sync(acc_pw[j], af, bf, acc_pw[j]);
      }
    }
    // owned rows of column cg: depthwise gradients and dx
    for (int r = PAD + bg * OROWS; r < PAD + (bg + 1) * OROWS; ++r) {
      const int g = u0 + r;
      if (g >= M) break;
      const float du = st[r * G::LDF + cl];
      p_dwb += du;
#pragma unroll
      for (int tap = 0; tap < K; ++tap)
        p_dw[tap] += __bfloat162float(xs[(r + tap) * G::LDB + cg]) * du;
      float acc = st[(r - PAD) * G::LDF + cl] * wf[K - 1];
#pragma unroll
      for (int sh = 1; sh < K; ++sh)
        acc += st[(r - PAD + sh) * G::LDF + cl] * wf[K - 1 - sh];
      dx[((size_t)b * M + g) * C + cg] =
          __float2bfloat16_rn(acc * keep[(size_t)b * M + g]);
    }
    __syncthreads();
  }

  // per-block partials of the owned columns, summed over threads in a
  // fixed order
  float* red_col = reinterpret_cast<float*>(xs);  // [BGROUPS][K + 1][HALF]
  float* red_row = red_col + G::BGROUPS * (K + 1) * HALF;  // [NW][3][HALF]
#pragma unroll
  for (int tap = 0; tap < K; ++tap)
    red_col[(bg * (K + 1) + tap) * HALF + cl] = p_dw[tap];
  red_col[(bg * (K + 1) + K) * HALF + cl] = p_dwb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red_row[(warp * 3 + 0) * HALF + lane * 4 + i] = p_pwb[i];
    red_row[(warp * 3 + 1) * HALF + lane * 4 + i] = p_lns[i];
    red_row[(warp * 3 + 2) * HALF + lane * 4 + i] = p_lnb[i];
  }
  __syncthreads();
  // part_vec rows: 0..K-1 dw taps, K dw bias, K+1 pw bias, K+2 LN scale,
  // K+3 LN bias; this block writes their columns [h0, h0 + HALF)
  for (int i = tid; i < (K + 4) * HALF; i += NT) {
    const int which = i / HALF, cc = i - which * HALF;
    float acc = 0.f;
    if (which <= K) {
      for (int q = 0; q < G::BGROUPS; ++q)
        acc += red_col[(q * (K + 1) + which) * HALF + cc];
    } else {
      for (int wp = 0; wp < BWD_WARPS; ++wp)
        acc += red_row[(wp * 3 + which - K - 1) * HALF + cc];
    }
    part_vec[((size_t)pair * (K + 4) + which) * C + h0 + cc] = acc;
  }
  float* pw_out = part_pw + (size_t)pair * C * C;
#pragma unroll
  for (int j = 0; j < PW_PER; ++j)
    wmma::store_matrix_sync(pw_out + ib * 16 * C + h0 + (ob0 + j) * 16,
                            acc_pw[j], C, wmma::mem_row_major);
}

// ---------------------------------------------------------------------------
// The float32 variant (x, y, dx, dy float32).  Nothing is rounded to bf16.
//
// The forward takes float32 operands into float32 sums on the CUDA cores
// (FFMA), as the TPU kernel's Precision.HIGHEST float32 route does.  What
// bounds it: operations, 2 N C^2 FLOP a pass (N = B M rows), 4.3 GFLOP at
// C = 128 and 17.2 at C = 256, against 67 TFLOP/s of float32.  The float32
// W is 64 KB at C = 128 and 256 KB at C = 256, more than a block has, so
// the product streams W from L2 through shared memory in panels of 2,048
// floats (16 rows at C = 128, 8 at C = 256), double-buffered through
// registers.  Tiles are R = 64 rows: the block holds the masked input
// (then v) and u.  Each thread owns RM x 8 outputs of the R x C product
// (rows 4 apart, two runs of 4 columns 32 apart), so a warp's operand
// reads are broadcasts or conflict-free 128-byte rows.  The backward
// (GeoB, below) runs its three products on the tensor cores.
//
// Numerics: the depthwise taps are summed in tap order with separate
// multiplies and adds (__fmul_rn, __fadd_rn), exactly as _recompute_to_t's
// float32 arithmetic; the products' summation order and tanhf differ from
// the plain version's, so the kernel is held to it by SNR.

template <int C_>
struct GeoF {
  static constexpr int C = C_;
  static constexpr int R = 64;                 // rows of u per tile
  static constexpr int NT = 256, NW = NT / 32;
  static constexpr int LD = C + 4;             // float32 row stride
  static constexpr int XROWS = R + 2 * PAD;
  static constexpr int FWD_OWN = R;
  static constexpr int KP = 2048 / C;          // weight rows per panel
  // R x C products: RM rows x 8 columns a thread, warps of 4 x 8 threads
  static constexpr int RM = C == 128 ? 4 : 8;
  static constexpr int WCOLS = C / 64;         // warps along the columns
  static constexpr int GROUPS = NT / C;        // row groups of a column
  static constexpr size_t XS_BYTES = align128((size_t)XROWS * LD * 4);
  static constexpr size_t RS_BYTES = align128((size_t)R * LD * 4);
  static constexpr size_t PANEL_BYTES = 2 * (size_t)KP * C * 4;
  static constexpr size_t FWD_SMEM = XS_BYTES + RS_BYTES + PANEL_BYTES;
  static constexpr int FWD_BLOCKS = C == 128 ? 2 : 1;
  static_assert(NW / WCOLS * 4 * RM == R, "product rows split over warps");
  static_assert(R % GROUPS == 0, "rows split evenly");
  static_assert(FWD_SMEM * FWD_BLOCKS <= SMEM_LIMIT, "forward smem");
};

// xs row i <- x[b, u0 - PAD + i] * keep, zero outside [0, M)
template <class G>
__device__ void load_x_f32(const float* __restrict__ x,
                           const float* __restrict__ keep, int b, int u0,
                           int M, float* xs) {
  constexpr int CH = G::C / 4;
  for (int i = threadIdx.x; i < G::XROWS * CH; i += blockDim.x) {
    const int r = i / CH, c4 = i - r * CH;
    const int g = u0 - PAD + r;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < M) {
      const size_t row = (size_t)b * M + g;
      q = reinterpret_cast<const float4*>(x + row * G::C)[c4];
      const float kp = keep[row];
      q.x *= kp; q.y *= kp; q.z *= kp; q.w *= kp;
    }
    *reinterpret_cast<float4*>(xs + r * G::LD + c4 * 4) = q;
  }
}

// u rows [r0, r1) of column c, the taps summed in tap order
template <class G>
__device__ void depthwise_f32(const float* xs, float* us,
                              const float* __restrict__ dww,
                              const float* __restrict__ dwb, int c, int r0,
                              int r1) {
  float wt[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) wt[tap] = dww[tap * G::C + c];
  const float bb = dwb[c];
  for (int r = r0; r < r1; ++r) {
    float acc = __fmul_rn(xs[r * G::LD + c], wt[0]);
#pragma unroll
    for (int tap = 1; tap < K; ++tap)
      acc = __fadd_rn(acc, __fmul_rn(xs[(r + tap) * G::LD + c], wt[tap]));
    us[r * G::LD + c] = __fadd_rn(acc, bb);
  }
}

// The thread's place in an R x C product: rows row0 + 4 i (i < RM),
// columns col0 + 32 g + j (g < 2, j < 4).
template <class G>
__device__ __forceinline__ void mm_place(int& row0, int& col0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  row0 = (warp / G::WCOLS) * 4 * G::RM + (lane >> 3);
  col0 = (warp % G::WCOLS) * 64 + 4 * (lane & 7);
}

// acc <- a (R x C, shared, stride LD) @ bm (C x C row-major, device
// memory), bm streamed through `panel` (2 x KP x C floats).  Starts and
// ends with a barrier: the caller's writes of `a` are visible, and every
// thread is done with the panels (and with whatever it read before the
// call) when it returns.
template <class G>
__device__ void mm_f32(const float* a, const float* __restrict__ bm,
                       float* panel, float (&acc)[G::RM][8]) {
  constexpr int C = G::C, KP = G::KP, NP = C / KP;
  constexpr int PER = KP * C / 4 / G::NT;  // float4 a thread per panel
  static_assert(PER * 4 * G::NT == KP * C, "panel split over threads");
  const int tid = threadIdx.x;
  int row0, col0;
  mm_place<G>(row0, col0);
#pragma unroll
  for (int i = 0; i < G::RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float4* b4 = reinterpret_cast<const float4*>(bm);
  float4* p4 = reinterpret_cast<float4*>(panel);
  float4 pf[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) p4[tid + q * G::NT] = b4[tid + q * G::NT];
  __syncthreads();
  for (int p = 0; p < NP; ++p) {
    const float* cur = panel + (p & 1) * KP * C;
    if (p + 1 < NP) {
#pragma unroll
      for (int q = 0; q < PER; ++q)
        pf[q] = b4[(p + 1) * (KP * C / 4) + tid + q * G::NT];
    }
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(cur + kk * C + col0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(cur + kk * C + col0 + 32);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < G::RM; ++i) {
        const float av = a[(row0 + 4 * i) * G::LD + p * KP + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
    if (p + 1 < NP) {
      float4* nxt = p4 + ((p + 1) & 1) * (KP * C / 4);
#pragma unroll
      for (int q = 0; q < PER; ++q) nxt[tid + q * G::NT] = pf[q];
    }
    __syncthreads();
  }
}

// out (R x C, shared, stride LD) <- the thread's part of a product
template <class G>
__device__ __forceinline__ void store_rows(const float (&acc)[G::RM][8],
                                           float* out) {
  int row0, col0;
  mm_place<G>(row0, col0);
#pragma unroll
  for (int i = 0; i < G::RM; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(out + (row0 + 4 * i) * G::LD + col0 +
                                 32 * g) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
}

// t of one row from v, and its LayerNorm statistics, over the lane's
// columns: t = tanh(v + pb)
template <int C>
__device__ __forceinline__ void row_t_f32(const float* v_row, int lane,
                                          const float* pb, float* t,
                                          float eps, float& mean,
                                          float& rstd) {
  constexpr int CH = C / 128;
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const float4 v =
        *reinterpret_cast<const float4*>(v_row + h * 128 + lane * 4);
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[h * 4 + i] = tanhf(vv[i] + pb[h * 4 + i]);
      s += t[h * 4 + i];
    }
  }
  mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) {
    const float d = t[i] - mean;
    q += d * d;
  }
  rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
}

template <int C>
__global__ void __launch_bounds__(GeoF<C>::NT, GeoF<C>::FWD_BLOCKS)
    decoder_block_fwd_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ keep,
                                 const float* __restrict__ w,
                                 const float* __restrict__ dww,
                                 const float* __restrict__ dwb,
                                 const float* __restrict__ pwb,
                                 const float* __restrict__ lns,
                                 const float* __restrict__ lnb,
                                 float* __restrict__ y, int B, int M,
                                 float eps) {
  using G = GeoF<C>;
  constexpr int NW = G::NW, CH = C / 128;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // masked input, then v
  float* us = reinterpret_cast<float*>(smem + G::XS_BYTES);
  float* panel = reinterpret_cast<float*>(smem + G::XS_BYTES + G::RS_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int GROWS = G::R / G::GROUPS;
  const int c = tid % C, grp = tid / C;
  float pb[4 * CH], s[4 * CH], sb[4 * CH];
  lane_cols<G>(pwb, lane, pb);
  lane_cols<G>(lns, lane, s);
  lane_cols<G>(lnb, lane, sb);

  const int tiles_m = (M + G::FWD_OWN - 1) / G::FWD_OWN;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int u0 = (tile - b * tiles_m) * G::FWD_OWN;
    load_x_f32<G>(x, keep, b, u0, M, xs);
    __syncthreads();
    depthwise_f32<G>(xs, us, dww, dwb, c, grp * GROWS, (grp + 1) * GROWS);
    {
      float acc[G::RM][8];
      mm_f32<G>(us, w, panel, acc);
      store_rows<G>(acc, xs);  // xs is past its last read
    }
    __syncthreads();
    for (int r = warp; r < G::R && u0 + r < M; r += NW) {
      float t[4 * CH], mean, rstd;
      row_t_f32<C>(xs + r * G::LD, lane, pb, t, eps, mean, rstd);
#pragma unroll
      for (int i = 0; i < 4 * CH; ++i)
        t[i] = (t[i] - mean) * rstd * s[i] + sb[i];
#pragma unroll
      for (int h = 0; h < CH; ++h)
        *reinterpret_cast<float4*>(y + ((size_t)b * M + u0 + r) * C +
                                   h * 128 + lane * 4) =
            make_float4(t[h * 4], t[h * 4 + 1], t[h * 4 + 2], t[h * 4 + 3]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The float32 backward on the tensor cores.
//
// What bounds it: operations.  Three C x C products a row, v = u W (the
// recomputed forward), the weight gradient u^T dv and du = dv W^T: 6 N C^2
// FLOP a pass, 51.5 GFLOP at N = 131,072 and C = 256.  Each runs by 3xTF32
// split products (csrc/tf32x3.cuh: three TF32 products a float32 one,
// about 21 bits each, nothing rounded to plain TF32), 1.88 ms of
// tensor-core time at C = 256 against 4.80 of FFMA.
//
// Per tile of R rows (R = 16384 / C: 128 at C = 128, 64 at C = 256), of
// which the inner OWN = R - 4 are the tile's own:
// - v and du run transposed, as K1/K2 f32 do: v^T = W^T u^T and du^T =
//   W dv^T on wgmma.m64nRk8, M the output channels (64 a warpgroup per
//   m-block), N the tile's rows in one instruction, K the input channels.
//   A is the weights from L2 through registers, split there
//   (tf32x3::k_loop, 7 k-steps of loads in flight); the wrapper passes W
//   and W^T in A's fragment order, so a lane's four values of a k-step
//   are one 16-byte load, and at C = 256 each block starts its k loop at
//   its own step, so the SMs do not all ask L2 for the same lines at
//   once.  B is u, later dv, split once into hi and lo copies in the
//   no-swizzle K-major layout of tf32x3.cuh (the split buffer S).
// - The weight gradient has the rows as K, and TF32 wgmma takes B K-major
//   only, so S (channels as K) cannot be its B.  It runs on warp-level
//   mma.sync.m16n8k8 (TF32, 3xTF32 as above) with both operands loaded
//   from shared memory: u's hi and lo from S, already split (a chunk is R +
//   4 rows of 16 bytes, 64 mod 128 bytes, so a fragment's 32 lanes meet 32
//   banks), dv from its float32 rows, split in registers.  A warp owns a
//   64 x 32 block of the gradient per pass (C^2 / 16384 passes): it reads
//   the block's float32 partial of it from device memory (L2) into its
//   accumulators, adds the tile's products and writes it back, in the
//   accumulators' order (16-byte accesses).  One partial per block, summed
//   by the caller; no float atomics, so two launches give the same bits.
//   (wgmma over an in-place transposed u measured slower: the transpose
//   cost more than the products saved.)
// - Shared memory (decoder_block.py::f32_bwd_plan holds the same plan): S
//   (hi at 0, lo at LO_OFF; 132 or 136 KB), the float32 rows V (stride
//   C + 8) at V_OFF, the keep values of this tile's and the next tile's x
//   rows, and the weight vectors the passes read.  Per tile: x's R + 4
//   rows (prefetched into L2 a tile ahead, then cp.async), masked, over V
//   -> u, split into S -> v into V -> dv (the LayerNorm and tanh
//   gradients, two rows a warp) in place in V, u's halo rows zeroed in S
//   -> the weight gradient from S and V -> dv split into S -> du into V
//   -> x's rows again (from L2) over S -> dx and the depthwise gradients.
// - Two warpgroups, one block an SM (210 or 219 KB), persistent over the
//   tiles.
//
// Where the time goes (probes/k4_f32_bwd_phases.py) is written down in
// PERF.md: at C = 256 the weight gradient's mma.sync and its partial's
// traffic first, then the two products' A loads from L2.
//
// Numerics: the depthwise taps as the forward's; the row pass is the
// forward's tanh and LayerNorm with their gradients in float32; products
// by 3xTF32, the small terms first.  Held to the plain version at SNR >=
// 90 dB.

template <int C_>
struct GeoB {
  static constexpr int C = C_;
  static constexpr int R = 16384 / C;         // rows of u per tile (wgmma N)
  static constexpr int OWN = R - 2 * PAD;     // the inner rows a tile owns
  static constexpr int NT = 256, NW = NT / 32;
  static constexpr int MB = C / 128;          // 64-channel m-blocks a warpgroup
  static constexpr int R_ALLOC = R + 4;       // rows of a channel chunk of S
  static constexpr int CHUNK = R_ALLOC * 16;  // its bytes
  static constexpr int LO_OFF = C / 4 * CHUNK;
  static constexpr int V_OFF = 2 * LO_OFF;
  static constexpr int LDV = C + 8;           // V's float32 row stride
  static constexpr int LD = C + 4;            // the x rows' stride
  static constexpr int XROWS = R + 2 * PAD;
  static constexpr int V_BYTES = R * LDV * 4;
  static constexpr int X_BYTES = XROWS * LD * 4;
  // the keep values of x's rows, two tiles' (this one's, the next one's)
  static constexpr int KP_OFF = V_OFF + (V_BYTES > X_BYTES ? V_BYTES : X_BYTES);
  static constexpr int KP_STRIDE = (XROWS + 3) / 4 * 4;
  // the vectors the passes read: dw taps (K x C), dw bias, pw bias, LN scale
  static constexpr int PAR_OFF = KP_OFF + 2 * KP_STRIDE * 4;
  // the products' k loop (tf32x3::k_loop): A's loads PD steps ahead in a
  // ring of RING register slots
  static constexpr int KL_PD = 7, KL_RING = 8;
  // the products start each block's k loop at its own step (C = 256): 132
  // blocks reading the same lines of W at once contend for them in L2
  // (C = 128 runs out of registers with it, and gains nothing)
  static constexpr bool ROTATE = C == 256;
  static constexpr int SMEM = PAR_OFF + (K + 3) * C * 4;
  static constexpr int GROUPS = NT / C;       // row groups of a column
  static constexpr int DW_PASSES = C * C / (64 * 32 * NW);
  static_assert(R == 64 || R == 128, "one wgmma N of tf32x3::mma3");
  static_assert(R_ALLOC % 8 == 4, "a chunk is 64 mod 128 bytes");
  static_assert(SMEM <= (int)SMEM_LIMIT, "backward smem");
  static_assert(X_BYTES <= V_OFF, "x's rows fit over S");
  static_assert(OWN % GROUPS == 0, "owned rows split evenly");
  static_assert(DW_PASSES * 64 * 32 * NW == C * C, "gradient blocks per warp");
  static_assert(((K + 1) * GROUPS + 3 * NW) * C * 4 <= V_OFF,
                "reduction scratch does not fit");
};

__device__ __forceinline__ float4 tap_add(float4 acc, float4 x, float4 w) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(x.x, w.x)),
                     __fadd_rn(acc.y, __fmul_rn(x.y, w.y)),
                     __fadd_rn(acc.z, __fmul_rn(x.z, w.z)),
                     __fadd_rn(acc.w, __fmul_rn(x.w, w.w)));
}

// `bytes` (a multiple of 16, from a 16-byte aligned address) of device
// memory into L2, by the TMA unit, ahead of their loads
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               ::"l"(p), "r"(bytes) : "memory");
}

// rows [g0, g0 + n) of sequence b (M rows of C floats), cut to [0, M),
// into L2
template <int C>
__device__ __forceinline__ void prefetch_rows(const float* base, int b,
                                              int M, int g0, int n) {
  const int lo = max(g0, 0), hi = min(g0 + n, M);
  if (hi > lo)
    prefetch_l2(base + ((size_t)b * M + lo) * C, (uint32_t)(hi - lo) * C * 4);
}

// keep of x row u0 - PAD + i of sequence b, 0 outside [0, M)
__device__ __forceinline__ float keep_of(const float* __restrict__ keep,
                                         int b, int u0, int M, int i) {
  const int g = u0 - PAD + i;
  return g >= 0 && g < M ? __ldg(keep + (size_t)b * M + g) : 0.f;
}

// xs row i <- x row u0 - PAD + i of sequence b times its keep kp[i]: rows
// whose keep is 1 by asynchronous 16-byte copies (cp.async; the caller
// waits), rows whose keep is 0 as zeros, any other by a load and a
// multiply.
template <class G>
__device__ void load_x_async(const float* __restrict__ x, int b, int u0,
                             int M, const float* kp, float* xs) {
  constexpr int CH = G::C / 4;
  for (int i = threadIdx.x; i < G::XROWS * CH; i += G::NT) {
    const int r = i / CH, c4 = i - r * CH;
    const float k = kp[r];
    float* dst = xs + r * G::LD + c4 * 4;
    const float* src = x + ((size_t)b * M + u0 - PAD + r) * G::C + c4 * 4;
    if (k == 1.f) {
      sm90::cp_async16(dst, src);
    } else {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k != 0.f) {
        q = __ldg(reinterpret_cast<const float4*>(src));
        q.x *= k; q.y *= k; q.z *= k; q.w *= k;
      }
      *reinterpret_cast<float4*>(dst) = q;
    }
  }
}

// Phase stamps for probes/k4_f32_bwd_phases.py: built with
// -DDECODER_BLOCK_STAMPS, thread 0 of every block adds the %globaltimer
// time between consecutive stamps to db_stamps[phase]; compiled out
// otherwise.
#ifdef DECODER_BLOCK_STAMPS
constexpr int N_STAMPS = 10;
__device__ unsigned long long db_stamps[N_STAMPS];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define DB_STAMP(i)                                   \
  if (threadIdx.x == 0) {                             \
    const unsigned long long now_ = global_ns();      \
    stamp_ns[i] += now_ - stamp_last;                 \
    stamp_last = now_;                                \
  }
#else
#define DB_STAMP(i)
#endif

// S at (row r, channels 4 c4 ..) <- the split of v
template <class G>
__device__ __forceinline__ void put_split(unsigned char* smem, int r, int c4,
                                          float4 v) {
  float4 lo;
  const float4 hi = tf32x3::split4(v, lo);
  unsigned char* dst = smem + c4 * G::CHUNK + r * 16;
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + G::LO_OFF) = lo;
}

// u of the tile's R rows from the masked x rows xs (stride LD), the taps
// summed in tap order as depthwise_f32, split into S.  A lane takes a row
// and 4 channels; a warp's lanes take consecutive rows, so its 16-byte
// stores into S meet every bank.
template <class G>
__device__ void depthwise_split(const float* xs, const float* par,
                                unsigned char* smem) {
  constexpr int C4 = G::C / 4;
  const float4* w4 = reinterpret_cast<const float4*>(par);  // a warp's lanes
                                                           // read one float4
#pragma unroll 2
  for (int i = threadIdx.x; i < G::R * C4; i += G::NT) {
    const int r = i % G::R, c4 = i / G::R;
    const float* xr = xs + r * G::LD + 4 * c4;
    const float4 x0 = *reinterpret_cast<const float4*>(xr);
    const float4 w0 = w4[c4];
    float4 acc = make_float4(__fmul_rn(x0.x, w0.x), __fmul_rn(x0.y, w0.y),
                             __fmul_rn(x0.z, w0.z), __fmul_rn(x0.w, w0.w));
#pragma unroll
    for (int tap = 1; tap < K; ++tap)
      acc = tap_add(acc, *reinterpret_cast<const float4*>(xr + tap * G::LD),
                    w4[tap * C4 + c4]);
    const float4 bb = w4[K * C4 + c4];
    put_split<G>(smem, r, c4,
                 make_float4(__fadd_rn(acc.x, bb.x), __fadd_rn(acc.y, bb.y),
                             __fadd_rn(acc.z, bb.z), __fadd_rn(acc.w, bb.w)));
  }
}

// V[r, c] <- sum_k S[r, k] w_op[k, c] over the tile's R rows: w_op is W
// (C_in, C_out) for v and W^T (C_out, C_in) for du.  Runs transposed on
// wgmma, this warpgroup's MB m-blocks of 64 output channels in turn; A
// (w_op^T) from L2 through registers, split there; B the split rows of S.
// w_op comes in A's fragment order (decoder_block.py::a_fragments): for
// m-block m, warp q, k-step s, lane 4 g + t, the four values w_op[8 s + t,
// c], w_op[8 s + t, c + 1], w_op[8 s + t + 4, c], w_op[8 s + t + 4, c + 1]
// (c = 64 m + 16 q + 2 g) are one 16-byte load.  Returns with this
// warpgroup's products complete and stored.
template <class G>
__device__ void product_to_v(const float* __restrict__ w_op,
                             unsigned char* smem) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int NS = G::C / 8;  // k-steps
  const uint32_t b_hi = sm90::smem_u32(smem);
  const uint64_t d_hi = tf32x3::desc(b_hi, G::CHUNK),
                 d_lo = tf32x3::desc(b_hi + G::LO_OFF, G::CHUNK);
  float* V = reinterpret_cast<float*>(smem + G::V_OFF);
  const int rot = G::ROTATE ? (blockIdx.x * 5) % NS : 0;
#pragma unroll 1
  for (int mb = 0; mb < G::MB; ++mb) {
    // A's rows g and g + 8 of the warp's 16 are output channels ca and
    // ca + 1
    const int ca = 64 * (wg * G::MB + mb) + 16 * warp + 2 * g;
    const float4* wa = reinterpret_cast<const float4*>(w_op) +
                       (size_t)((wg * G::MB + mb) * 4 + warp) * NS * 32 + lane;
    float acc[G::R / 2];
#pragma unroll
    for (int i = 0; i < G::R / 2; ++i) acc[i] = 0.f;
    tf32x3::k_loop<G::KL_PD, G::KL_RING>(
        NS,
        [&](int s, float (&r)[4]) {  // k rows 8 s + t, 8 s + t + 4
          const float4 a = __ldg(wa + 32 * ((s + rot) % NS));
          r[0] = a.x;
          r[1] = a.y;
          r[2] = a.z;
          r[3] = a.w;
        },
        [&](int s, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
          s = (s + rot) % NS;
          // channels 8 s .. 8 s + 7: chunk 2 s, in 16-byte units
          const uint32_t k = 2 * s * G::R_ALLOC;
          tf32x3::mma3<G::R>(acc, hi, lo, d_hi + k, d_lo + k, 1);
        });
#pragma unroll
    for (int i = 0; i < G::R / 2; ++i) sm90::reg_fence(acc[i]);
    // acc[4 j + 2 h + e] is channel ca + h of row 8 j + 2 t + e
#pragma unroll
    for (int j = 0; j < G::R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(V + (8 * j + 2 * t + e) * G::LDV + ca) =
            make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
  }
}

// D (16 x 8, float32) += A (16 x 8, TF32) B (8 x 8, TF32) for one warp:
// lane 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B
// (t, g), (t + 4, g) and D (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8,
// 2 t + 1)
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's weight-gradient partial (+)= the sum over the tile's rows r
// of u[r, i] dv[r, o] (= when `first`): u from S (its halo rows zero), dv
// from V.  A warp owns a 64 x 32 block (i0 .., o0 ..) per pass, in 4 x 4
// mma tiles; the three split products of a tile in turn.  The partial
// keeps the blocks in the accumulators' order, so that a lane's four
// values are one 16-byte access: block q = pass NW + warp at 2,048 q, its
// tile (mt, nt) at 128 (4 mt + nt), lane l's D at 4 l
// (decoder_block.py::f32_bwd_partial_index maps it back to (i, o)).
template <class G>
__device__ void weight_grad(const unsigned char* smem,
                            float* __restrict__ part, bool first) {
  constexpr int C = G::C, CW = G::CHUNK / 4;  // a chunk's 32-bit words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* s_hi = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t* s_lo = reinterpret_cast<const uint32_t*>(smem + G::LO_OFF);
  const float* V = reinterpret_cast<const float*>(smem + G::V_OFF);
#pragma unroll 1
  for (int pass = 0; pass < G::DW_PASSES; ++pass) {
    const int q = pass * G::NW + warp;
    const int i0 = 64 * (q / (C / 32)) + g, o0 = 32 * (q % (C / 32));
    float4* pq = reinterpret_cast<float4*>(part + (size_t)q * 2048) + lane;
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 v = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : pq[32 * (4 * mt + nt)];
        acc[mt][nt][0] = v.x;
        acc[mt][nt][1] = v.y;
        acc[mt][nt][2] = v.z;
        acc[mt][nt][3] = v.w;
      }
#pragma unroll 2
    for (int ks = 0; ks < G::R / 8; ++ks) {
      const int r = 8 * ks + t;
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tf32x3::split(V[(r + 4 * h) * G::LDV + o0 + 8 * nt + g], bhi[nt][h],
                        blo[nt][h]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // (i, r), (i + 8, r), (i, r + 4), (i + 8, r + 4) of u, i = i0 + 16 mt
        const int w0 = ((i0 + 16 * mt) >> 2) * CW + r * 4 + (g & 3);
        const int wa[4] = {w0, w0 + 2 * CW, w0 + 16, w0 + 2 * CW + 16};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ahi[k] = s_hi[wa[k]];
          alo[k] = s_lo[wa[k]];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_m16n8k8(acc[mt][nt], alo, bhi[nt]);
          mma_m16n8k8(acc[mt][nt], ahi, blo[nt]);
          mma_m16n8k8(acc[mt][nt], ahi, bhi[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        pq[32 * (4 * mt + nt)] = make_float4(acc[mt][nt][0], acc[mt][nt][1],
                                             acc[mt][nt][2], acc[mt][nt][3]);
  }
}

template <int C>
__global__ void __launch_bounds__(GeoB<C>::NT, 1)
    decoder_block_bwd_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ keep,
                                 const float* __restrict__ w,
                                 const float* __restrict__ wt,
                                 const float* __restrict__ dww,
                                 const float* __restrict__ dwb,
                                 const float* __restrict__ pwb,
                                 const float* __restrict__ lns,
                                 const float* __restrict__ dy,
                                 float* __restrict__ dx,
                                 float* __restrict__ part_pw,
                                 float* __restrict__ part_vec, int B, int M,
                                 float eps) {
  using G = GeoB<C>;
  constexpr int NT = G::NT, NW = G::NW, CH = C / 128, R = G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* V = reinterpret_cast<float*>(smem + G::V_OFF);
  float* xs = reinterpret_cast<float*>(smem);  // x's rows for dx, over S
  float* kp_s = reinterpret_cast<float*>(smem + G::KP_OFF);  // their keep
  // dw taps (K x C), dw bias, pw bias, LN scale
  float* par = reinterpret_cast<float*>(smem + G::PAR_OFF);
  const float* pb_s = par + (K + 1) * C;
  const float* lns_s = par + (K + 2) * C;
#ifdef DECODER_BLOCK_STAMPS
  unsigned long long stamp_ns[N_STAMPS] = {}, stamp_last = global_ns();
#endif

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < K * C; i += NT) par[i] = dww[i];
  for (int i = tid; i < C; i += NT) {
    par[K * C + i] = dwb[i];
    par[(K + 1) * C + i] = pwb[i];
    par[(K + 2) * C + i] = lns[i];
  }
  // the depthwise gradient and dx: column cf, one of GROUPS row groups
  constexpr int OROWS = G::OWN / G::GROUPS;
  const int cf = tid % C, fg = tid / C;
  // per-thread partial sums: column cf (taps, dw bias), the lane's
  // columns (pw bias, LayerNorm scale and bias)
  float p_dw[K], p_dwb = 0.f, p_pwb[4 * CH], p_lns[4 * CH], p_lnb[4 * CH];
#pragma unroll
  for (int i = 0; i < K; ++i) p_dw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) p_pwb[i] = p_lns[i] = p_lnb[i] = 0.f;
  float* pw_out = part_pw + (size_t)blockIdx.x * C * C;
  bool first = true;

  const int tiles_m = (M + G::OWN - 1) / G::OWN;
  // the keep values of a tile's x rows: the first tile's now, each next
  // tile's while this one runs (kp_s holds two tiles')
  auto tile_u0 = [&](int tl, int& tb) {
    tb = tl / tiles_m;
    return (tl - tb * tiles_m) * G::OWN - PAD;
  };
  if (tid < G::XROWS && blockIdx.x < B * tiles_m) {
    int tb;
    const int tu0 = tile_u0(blockIdx.x, tb);
    kp_s[tid] = keep_of(keep, tb, tu0, M, tid);
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int m0 = (tile - b * tiles_m) * G::OWN;
    const int u0 = m0 - PAD;  // global row of u row 0
    const size_t row0 = (size_t)b * M;
    float* kp = kp_s + buf * G::KP_STRIDE;
    float kp_next = 0.f;
    if (tid < G::XROWS && tile + (int)gridDim.x < B * tiles_m) {
      int nb;
      const int nu0 = tile_u0(tile + gridDim.x, nb);
      kp_next = keep_of(keep, nb, nu0, M, tid);
    }
    if (tid == 0) {
      // dy's rows of this tile, for the row pass, and x's rows of the
      // block's next tile into L2
      prefetch_rows<C>(dy, b, M, u0, R);
      const int nt = tile + gridDim.x;
      if (nt < B * tiles_m) {
        const int nb = nt / tiles_m;
        prefetch_rows<C>(x, nb, M, (nt - nb * tiles_m) * G::OWN - 2 * PAD,
                         G::XROWS);
      }
    }
    __syncthreads();  // kp, and the last tile's reads of V
    load_x_async<G>(x, b, u0, M, kp, V);  // x's rows over V
    sm90::cp_async_wait_all();
    __syncthreads();
    DB_STAMP(0);
    depthwise_split<G>(V, par, smem);
    sm90::fence_proxy_async();
    __syncthreads();
    DB_STAMP(1);
    product_to_v<G>(w, smem);  // v = u W
    __syncthreads();
    DB_STAMP(2);
    // u's halo rows leave the weight gradient
    for (int i = tid; i < C; i += NT) {
      const int q = i & 3, r = q < 2 ? q : R - 4 + q;
      unsigned char* z = smem + (i >> 2) * G::CHUNK + r * 16;
      *reinterpret_cast<float4*>(z) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(z + G::LO_OFF) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // recompute t and its LayerNorm, then dv = dLN * (1 - t^2) over v, two
    // rows a warp at once (their chains of warp sums interleave).  A row
    // outside [0, M) takes dy = 0, so its dv is 0 and it adds 0 to the
    // sums.
    for (int r0 = warp; r0 < R; r0 += 2 * NW) {
      float t[2][4 * CH], d[2][4 * CH], mean[2], rstd[2], gm[2], gxm[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int g = u0 + r0 + q * NW;
        const bool in = g >= 0 && g < M;
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in)
            v4 = __ldg(reinterpret_cast<const float4*>(
                dy + (row0 + g) * C + h * 128 + lane * 4));
          d[q][h * 4] = v4.x; d[q][h * 4 + 1] = v4.y;
          d[q][h * 4 + 2] = v4.z; d[q][h * 4 + 3] = v4.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float pb[4 * CH];
        lane_cols<G>(pb_s, lane, pb);
        row_t_f32<C>(V + (r0 + q * NW) * G::LDV, lane, pb, t[q], eps,
                     mean[q], rstd[q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float gs = 0.f, gx = 0.f;
#pragma unroll
        for (int h = 0; h < CH; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gg = d[q][h * 4 + i] * lns_s[h * 128 + lane * 4 + i];
            gs += gg;
            gx += gg * ((t[q][h * 4 + i] - mean[q]) * rstd[q]);
          }
        gm[q] = warp_sum(gs) / C;
        gxm[q] = warp_sum(gx) / C;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = r0 + q * NW;
        const bool owned_row = r >= PAD && r < R - PAD;
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          const int col = h * 128 + lane * 4;
          float dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float tt = t[q][h * 4 + i], dd = d[q][h * 4 + i];
            const float that = (tt - mean[q]) * rstd[q];
            dv[i] = rstd[q] * (dd * lns_s[col + i] - gm[q] - that * gxm[q]) *
                    (1.f - tt * tt);
            if (owned_row) {
              p_pwb[h * 4 + i] += dv[i];
              p_lns[h * 4 + i] += dd * that;
              p_lnb[h * 4 + i] += dd;
            }
          }
          *reinterpret_cast<float4*>(V + r * G::LDV + col) =
              make_float4(dv[0], dv[1], dv[2], dv[3]);
        }
      }
    }
    __syncthreads();
    DB_STAMP(3);
    weight_grad<G>(smem, pw_out, first);
    first = false;
    __syncthreads();
    DB_STAMP(4);
    // dv, split into S (a lane a row: its 16-byte stores meet every bank)
#pragma unroll 4
    for (int i = tid; i < R * (C / 4); i += NT) {
      const int r = i % R, c4 = i / R;
      put_split<G>(smem, r, c4,
                   *reinterpret_cast<const float4*>(V + r * G::LDV + 4 * c4));
    }
    sm90::fence_proxy_async();
    __syncthreads();
    DB_STAMP(5);
    product_to_v<G>(wt, smem);  // du = dv W^T, over all R rows
    DB_STAMP(6);
    __syncthreads();  // every warpgroup is done with S
    load_x_async<G>(x, b, u0, M, kp, xs);  // again, from L2
    sm90::cp_async_wait_all();
    __syncthreads();
    DB_STAMP(7);
    // owned rows of column cf: depthwise gradients and dx, du and x's rows
    // in windows of K
    {
      const int r_beg = PAD + fg * OROWS;
      const int r_end = min(r_beg + OROWS, M - u0);
      float wf[K], dw[K], xw[K];
#pragma unroll
      for (int tap = 0; tap < K; ++tap) wf[tap] = par[tap * C + cf];
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        dw[j] = V[(r_beg - PAD + j) * G::LDV + cf];  // du rows r - 2 ..
        xw[j] = xs[(r_beg + j) * G::LD + cf];         // x rows r - 2 ..
      }
      for (int r = r_beg; r < r_end; ++r) {
        dw[K - 1] = V[(r + PAD) * G::LDV + cf];
        xw[K - 1] = xs[(r + K - 1) * G::LD + cf];
        const float du = dw[PAD];
        p_dwb += du;
#pragma unroll
        for (int tap = 0; tap < K; ++tap) p_dw[tap] += xw[tap] * du;
        float acc = dw[0] * wf[K - 1];
#pragma unroll
        for (int sh = 1; sh < K; ++sh) acc += dw[sh] * wf[K - 1 - sh];
        dx[(row0 + u0 + r) * C + cf] = acc * kp[r + PAD];
#pragma unroll
        for (int j = 0; j < K - 1; ++j) {
          dw[j] = dw[j + 1];
          xw[j] = xw[j + 1];
        }
      }
    }
    if (tid < G::XROWS) kp_s[(buf ^ 1) * G::KP_STRIDE + tid] = kp_next;
    buf ^= 1;
    __syncthreads();
    DB_STAMP(8);
  }
  if (first)  // a block without a tile still writes its partial
    for (int i = tid; i < C * C; i += NT) pw_out[i] = 0.f;

  // per-block partials of the vectors, summed over threads in a fixed
  // order
  float* red_col = reinterpret_cast<float*>(smem);     // [GROUPS][K + 1][C]
  float* red_row = red_col + G::GROUPS * (K + 1) * C;  // [NW][3][C]
#pragma unroll
  for (int tap = 0; tap < K; ++tap)
    red_col[(fg * (K + 1) + tap) * C + cf] = p_dw[tap];
  red_col[(fg * (K + 1) + K) * C + cf] = p_dwb;
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = h * 128 + lane * 4 + i;
      red_row[(warp * 3 + 0) * C + col] = p_pwb[h * 4 + i];
      red_row[(warp * 3 + 1) * C + col] = p_lns[h * 4 + i];
      red_row[(warp * 3 + 2) * C + col] = p_lnb[h * 4 + i];
    }
  __syncthreads();
  for (int i = tid; i < (K + 4) * C; i += NT) {
    const int which = i / C, cc = i - which * C;
    float acc = 0.f;
    if (which <= K) {
      for (int q = 0; q < G::GROUPS; ++q)
        acc += red_col[(q * (K + 1) + which) * C + cc];
    } else {
      for (int wp = 0; wp < NW; ++wp)
        acc += red_row[(wp * 3 + which - K - 1) * C + cc];
    }
    part_vec[((size_t)blockIdx.x * (K + 4) + which) * C + cc] = acc;
  }
#ifdef DECODER_BLOCK_STAMPS
  DB_STAMP(9);
  if (threadIdx.x == 0)
    for (int i = 0; i < N_STAMPS; ++i) atomicAdd(&db_stamps[i], stamp_ns[i]);
#endif
}

template <int C>
int fwd_launch(const void* x, const void* keep, const void* w,
               const void* dww, const void* dwb, const void* pwb,
               const void* lns, const void* lnb, void* y, int B, int M,
               float eps, int grid, cudaStream_t stream) {
  using G = Geo<C>;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::FWD_SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_fwd_kernel<C><<<grid, G::FWD_WARPS * 32, G::FWD_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(keep),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<__nv_bfloat16*>(y), B, M, eps);
  return cudaGetLastError();
}

template <int C>
int bwd_launch(const void* x, const void* keep, const void* w,
               const void* dww, const void* dwb, const void* pwb,
               const void* lns, const void* dy, void* dx, void* part_pw,
               void* part_vec, int B, int M, float eps, int grid,
               cudaStream_t stream) {
  using G = Geo<C>;
  if (grid % G::SPLIT) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::BWD_SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_bwd_kernel<C><<<grid, BWD_WARPS * 32, G::BWD_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(keep),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part_pw),
      static_cast<float*>(part_vec), B, M, eps);
  return cudaGetLastError();
}

template <int C>
int fwd_launch_f32(const void* x, const void* keep, const void* w,
                   const void* dww, const void* dwb, const void* pwb,
                   const void* lns, const void* lnb, void* y, int B, int M,
                   float eps, int grid, cudaStream_t stream) {
  using G = GeoF<C>;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_fwd_f32_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::FWD_SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_fwd_f32_kernel<C><<<grid, G::NT, G::FWD_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(keep),
      static_cast<const float*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<float*>(y), B, M, eps);
  return cudaGetLastError();
}

template <int C>
int bwd_launch_f32(const void* x, const void* keep, const void* w,
                   const void* wt, const void* dww, const void* dwb,
                   const void* pwb, const void* lns, const void* dy,
                   void* dx, void* part_pw, void* part_vec, int B, int M,
                   float eps, int grid, cudaStream_t stream) {
  using G = GeoB<C>;
  if (wt == nullptr || grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_bwd_f32_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_bwd_f32_kernel<C><<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(keep),
      static_cast<const float*>(w), static_cast<const float*>(wt),
      static_cast<const float*>(dww), static_cast<const float*>(dwb),
      static_cast<const float*>(pwb), static_cast<const float*>(lns),
      static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(part_pw), static_cast<float*>(part_vec), B, M, eps);
  return cudaGetLastError();
}

// The one list of the variants the kernels are built for (the Python
// wrapper's WIDTHS, in bf16 and float32): calls f with the width and the
// dtype (true: float32) as compile-time constants, or returns fallback for
// any other width.
template <class F>
int with_variant(int channels, int f32, int fallback, F f) {
  using T = std::true_type;
  using N = std::false_type;
  switch (channels) {
    case 128:
      return f32 ? f(std::integral_constant<int, 128>(), T())
                 : f(std::integral_constant<int, 128>(), N());
    case 256:
      return f32 ? f(std::integral_constant<int, 256>(), T())
                 : f(std::integral_constant<int, 256>(), N());
    default: return fallback;
  }
}

// The geometry of one variant
template <int C, bool F32>
using GeoOf = typename std::conditional<F32, GeoF<C>, Geo<C>>::type;

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows of x a tile covers (forward: all R; backward: the inner R - 4), or
// 0 for a width the kernels are not built for.  f32: the float32 variant.
int decoder_block_tile_rows(int channels, int backward, int f32) {
  return with_variant(channels, f32, 0, [&](auto c, auto f) {
    constexpr int C = decltype(c)::value;
    if (decltype(f)::value) return backward ? GeoB<C>::OWN : GeoF<C>::FWD_OWN;
    return backward ? Geo<C>::BWD_OWN : Geo<C>::FWD_OWN;
  });
}

// Forward blocks that fit on one SM (the backward fits one), or 0.
int decoder_block_fwd_blocks_per_sm(int channels, int f32) {
  return with_variant(channels, f32, 0, [](auto c, auto f) {
    return GeoOf<decltype(c)::value, decltype(f)::value>::FWD_BLOCKS;
  });
}

// Backward blocks that share a tile (bf16: one per 128 columns; float32:
// one), or 0.
int decoder_block_split(int channels, int f32) {
  return with_variant(channels, f32, 0, [](auto c, auto f) {
    return decltype(f)::value ? 1 : Geo<decltype(c)::value>::SPLIT;
  });
}

// The float32 backward's plan, decoder_block.py::f32_bwd_plan's fields in
// its order: 0 tile rows, 1 owned rows, 2 warpgroups, 3 rows of a channel
// chunk of the split buffer, 4 the lo copy's byte offset, 5 the float32
// rows' byte offset, 6 their float32 stride, 7 the x rows' stride, 8 the
// byte offset of the rows' keep values, 9 that of the weight vectors, 10
// shared-memory bytes; -1 for another field or width.
int decoder_block_f32_bwd_plan(int channels, int field) {
  return with_variant(channels, 1, -1, [&](auto c, auto) {
    using G = GeoB<decltype(c)::value>;
    const int v[] = {G::R,      G::OWN, G::NT / 128, G::R_ALLOC,
                     G::LO_OFF, G::V_OFF, G::LDV,    G::LD,
                     G::KP_OFF, G::PAR_OFF, G::SMEM};
    return field >= 0 && field < 11 ? v[field] : -1;
  });
}

int decoder_block_taps() { return K; }

#ifdef DECODER_BLOCK_STAMPS
// The float32 backward's phase sums (ns, over every block's thread 0) into
// out[0 .. N_STAMPS), then set to 0; the probe's build only.
int decoder_block_stamps(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, db_stamps, sizeof(db_stamps));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[N_STAMPS] = {};
  return cudaMemcpyToSymbol(db_stamps, zero, sizeof(zero));
}
#endif

// x, y: (B, M, C) bf16 (f32 = 0) or float32 (f32 = 1); keep (B, M) f32; w
// (C_in, C_out) in x's dtype; dww (K, C) f32; dwb, pwb, lns, lnb (C,) f32.
// grid: blocks (they stride over the tiles).
int decoder_block_fwd_launch(const void* x, const void* keep, const void* w,
                             const void* dww, const void* dwb,
                             const void* pwb, const void* lns,
                             const void* lnb, void* y, int B, int M,
                             int channels, int f32, float eps, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(channels, f32, cudaErrorInvalidValue,
                      [&](auto c, auto f) {
    constexpr int C = decltype(c)::value;
    if (decltype(f)::value)
      return fwd_launch_f32<C>(x, keep, w, dww, dwb, pwb, lns, lnb, y, B, M,
                               eps, grid, s);
    return fwd_launch<C>(x, keep, w, dww, dwb, pwb, lns, lnb, y, B, M, eps,
                         grid, s);
  });
}

// dy, dx: (B, M, C) in x's dtype; the float32 variant takes W and W^T
// (wt, C_out x C_in; may be null in bf16) in wgmma's A-fragment order
// (decoder_block.py::a_fragments); part_pw (grid / split, C_in,
// C_out) f32 (the float32 variant's in its accumulators' order, see
// weight_grad); part_vec (grid / split, K + 4, C) f32: dw taps, dw bias, pw
// bias, LN scale, LN bias.  grid is a multiple of decoder_block_split(C).
int decoder_block_bwd_launch(const void* x, const void* keep, const void* w,
                             const void* wt, const void* dww,
                             const void* dwb, const void* pwb,
                             const void* lns, const void* dy, void* dx,
                             void* part_pw, void* part_vec, int B, int M,
                             int channels, int f32, float eps, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(channels, f32, cudaErrorInvalidValue,
                      [&](auto c, auto f) {
    constexpr int C = decltype(c)::value;
    if (decltype(f)::value)
      return bwd_launch_f32<C>(x, keep, w, wt, dww, dwb, pwb, lns, dy, dx,
                               part_pw, part_vec, B, M, eps, grid, s);
    return bwd_launch<C>(x, keep, w, dww, dwb, pwb, lns, dy, dx, part_pw,
                         part_vec, B, M, eps, grid, s);
  });
}

}  // extern "C"
