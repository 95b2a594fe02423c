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
// caller.  The gradient with respect to keep is zero.
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

#include <type_traits>

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

// The one list of the widths the kernels are built for (the Python
// wrapper's WIDTHS): calls f with the width as a compile-time constant, or
// returns fallback for any other width.
template <class F>
int with_width(int channels, int fallback, F f) {
  switch (channels) {
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return fallback;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows of x a tile covers (forward: all R; backward: the inner R - 4), or
// 0 for a width the kernels are not built for.
int decoder_block_tile_rows(int channels, int backward) {
  return with_width(channels, 0, [&](auto c) {
    using G = Geo<decltype(c)::value>;
    return backward ? G::BWD_OWN : G::FWD_OWN;
  });
}

// Forward blocks that fit on one SM (the backward fits one), or 0.
int decoder_block_fwd_blocks_per_sm(int channels) {
  return with_width(channels, 0, [](auto c) {
    return Geo<decltype(c)::value>::FWD_BLOCKS;
  });
}

// Backward blocks that share a tile, one per 128 columns, or 0.
int decoder_block_split(int channels) {
  return with_width(channels, 0, [](auto c) {
    return Geo<decltype(c)::value>::SPLIT;
  });
}

int decoder_block_taps() { return K; }

// x, y: (B, M, C) bf16; keep (B, M) f32; w (C_in, C_out) bf16; dww (K, C)
// f32; dwb, pwb, lns, lnb (C,) f32.  grid: blocks (they stride over the
// tiles).
int decoder_block_fwd_launch(const void* x, const void* keep, const void* w,
                             const void* dww, const void* dwb,
                             const void* pwb, const void* lns,
                             const void* lnb, void* y, int B, int M,
                             int channels, float eps, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(channels, cudaErrorInvalidValue, [&](auto c) {
    return fwd_launch<decltype(c)::value>(x, keep, w, dww, dwb, pwb, lns,
                                          lnb, y, B, M, eps, grid, s);
  });
}

// dy, dx: (B, M, C) bf16; part_pw (grid / split, C_in, C_out) f32;
// part_vec (grid / split, K + 4, C) f32: dw taps, dw bias, pw bias, LN
// scale, LN bias.  grid is a multiple of decoder_block_split(C).
int decoder_block_bwd_launch(const void* x, const void* keep, const void* w,
                             const void* dww, const void* dwb,
                             const void* pwb, const void* lns,
                             const void* dy, void* dx, void* part_pw,
                             void* part_vec, int B, int M, int channels,
                             float eps, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_width(channels, cudaErrorInvalidValue, [&](auto c) {
    return bwd_launch<decltype(c)::value>(x, keep, w, dww, dwb, pwb, lns, dy,
                                          dx, part_pw, part_vec, B, M, eps,
                                          grid, s);
  });
}

}  // extern "C"
