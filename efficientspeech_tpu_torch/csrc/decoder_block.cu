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

// ---------------------------------------------------------------------------
// The float32 variant (x, y, dx, dy float32).  Every product takes float32
// operands into float32 sums on the CUDA cores (FFMA), as the TPU kernel's
// Precision.HIGHEST float32 route does; nothing is rounded to bf16 or TF32.
//
// What bounds it: operations.  The pointwise products are 2 N C^2 FLOP a
// pass (N = B M rows), 4.3 GFLOP forward at C = 128 and 17.2 at C = 256,
// and three such products backward, against 67 TFLOP/s of float32.  The
// float32 W is 64 KB at C = 128 and 256 KB at C = 256, more than a block
// has, so every product streams its B operand (W, or W^T for du) from L2
// through shared memory in panels of 2,048 floats (16 rows at C = 128, 8 at
// C = 256), double-buffered through registers.  Tiles are R = 64 rows at
// both widths: the forward holds the masked input (then v) and u; the
// backward the masked input, u (then du) and v (then dv in place), 217 KB
// at C = 256.  Each thread owns RM x 8 outputs of an R x C product (rows
// 4 apart, two runs of 4 columns 32 apart), so a warp's operand reads are
// broadcasts or conflict-free 128-byte rows.
//
// The C x C weight gradient does not fit one block's registers at C = 256
// (256 values a thread), so each block keeps its own float32 partial in
// device memory (L2-resident: 34 MB over 132 blocks at C = 256) and adds
// each tile's u^T dv into it in passes of 64 accumulators a thread; the
// caller sums the per-block partials.  No block duplicates another's work
// and there are no float atomics, so every run gives the same sums.
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
  static constexpr int BWD_OWN = R - 2 * PAD;
  static constexpr int KP = 2048 / C;          // weight rows per panel
  // R x C products: RM rows x 8 columns a thread, warps of 4 x 8 threads
  static constexpr int RM = C == 128 ? 4 : 8;
  static constexpr int WCOLS = C / 64;         // warps along the columns
  // the C x C weight gradient in passes of PR rows, 8 x 8 a thread
  static constexpr int PR = NT * 64 / C;
  static constexpr int GROUPS = NT / C;        // row groups of a column
  static constexpr size_t XS_BYTES = align128((size_t)XROWS * LD * 4);
  static constexpr size_t RS_BYTES = align128((size_t)R * LD * 4);
  static constexpr size_t PANEL_BYTES = 2 * (size_t)KP * C * 4;
  static constexpr size_t FWD_SMEM = XS_BYTES + RS_BYTES + PANEL_BYTES;
  static constexpr size_t BWD_SMEM = XS_BYTES + 2 * RS_BYTES + PANEL_BYTES;
  static constexpr int FWD_BLOCKS = C == 128 ? 2 : 1;
  static constexpr int SPLIT = 1;            // backward blocks per tile
  static_assert(NW / WCOLS * 4 * RM == R, "product rows split over warps");
  static_assert(PR % 32 == 0 && C % PR == 0 && (PR / 32) * (C / 64) == NW,
                "weight-gradient pass split over warps");
  static_assert(BWD_OWN % GROUPS == 0, "owned rows split evenly");
  static_assert(FWD_SMEM * FWD_BLOCKS <= SMEM_LIMIT, "forward smem");
  static_assert(BWD_SMEM <= SMEM_LIMIT, "backward smem");
  static_assert(((K + 1) * GROUPS + 3 * NW) * C * 4 <= XS_BYTES,
                "reduction scratch does not fit");
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

// part[i0 + i, :] (+)= sum over the owned rows r of us[r, i0 + i] dv[r, :]
// for one pass of PR rows of the C x C weight gradient (first: store
// instead of add).  Thread: rows rb + i (i < 8), columns col0 + 32 g + j.
template <class G>
__device__ void dw_pass(const float* us, const float* dv,
                        float* __restrict__ part, int i0, bool first) {
  constexpr int C = G::C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = i0 + (warp / G::WCOLS) * 32 + (lane >> 3) * 8;
  const int col0 = (warp % G::WCOLS) * 64 + 4 * (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int r = PAD; r < G::R - PAD; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(us + r * G::LD + rb);
    const float4 a1 =
        *reinterpret_cast<const float4*>(us + r * G::LD + rb + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(dv + r * G::LD + col0);
    const float4 b1 =
        *reinterpret_cast<const float4*>(dv + r * G::LD + col0 + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      float4* p = reinterpret_cast<float4*>(part + (size_t)(rb + i) * C +
                                            col0 + 32 * g);
      float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                             acc[i][4 * g + 2], acc[i][4 * g + 3]);
      if (!first) {
        const float4 o = *p;
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      *p = v;
    }
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

template <int C>
__global__ void __launch_bounds__(GeoF<C>::NT, 1)
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
  using G = GeoF<C>;
  constexpr int NT = G::NT, NW = G::NW, CH = C / 128, R = G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* us = reinterpret_cast<float*>(smem + G::XS_BYTES);  // u, then du
  float* vs = reinterpret_cast<float*>(smem + G::XS_BYTES +
                                       G::RS_BYTES);  // v, then dv
  float* panel =
      reinterpret_cast<float*>(smem + G::XS_BYTES + 2 * G::RS_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the depthwise conv and its gradient: column cf, one of GROUPS row
  // groups
  constexpr int FROWS = R / G::GROUPS;
  constexpr int OROWS = G::BWD_OWN / G::GROUPS;
  const int cf = tid % C, fg = tid / C;
  float wf[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) wf[tap] = dww[tap * C + cf];
  // per-thread partial sums: column cf (taps, dw bias), the lane's
  // columns (pw bias, LayerNorm scale and bias)
  float p_dw[K], p_dwb = 0.f, p_pwb[4 * CH], p_lns[4 * CH], p_lnb[4 * CH];
#pragma unroll
  for (int i = 0; i < K; ++i) p_dw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) p_pwb[i] = p_lns[i] = p_lnb[i] = 0.f;
  float* pw_out = part_pw + (size_t)blockIdx.x * C * C;
  bool first = true;

  const int tiles_m = (M + G::BWD_OWN - 1) / G::BWD_OWN;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int m0 = (tile - b * tiles_m) * G::BWD_OWN;
    const int u0 = m0 - PAD;  // global row of u row 0
    load_x_f32<G>(x, keep, b, u0, M, xs);
    __syncthreads();
    depthwise_f32<G>(xs, us, dww, dwb, cf, fg * FROWS, (fg + 1) * FROWS);
    {
      float acc[G::RM][8];
      mm_f32<G>(us, w, panel, acc);
      store_rows<G>(acc, vs);
    }
    __syncthreads();
    // recompute t and its LayerNorm, then dv = dLN * (1 - t^2) over v
    for (int r = warp; r < R; r += NW) {
      const int g = u0 + r;
      float* row = vs + r * G::LD;
      if (g < 0 || g >= M) {
#pragma unroll
        for (int h = 0; h < CH; ++h)
          *reinterpret_cast<float4*>(row + h * 128 + lane * 4) =
              make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      float t[4 * CH], mean, rstd, d[4 * CH], pb[4 * CH];
      lane_cols<G>(pwb, lane, pb);
      row_t_f32<C>(row, lane, pb, t, eps, mean, rstd);
      float gs = 0.f, gx = 0.f;
#pragma unroll
      for (int h = 0; h < CH; ++h) {
        const int col = h * 128 + lane * 4;
        const float4 q = *reinterpret_cast<const float4*>(
            dy + ((size_t)b * M + g) * C + col);
        d[h * 4] = q.x; d[h * 4 + 1] = q.y; d[h * 4 + 2] = q.z;
        d[h * 4 + 3] = q.w;
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
          if (owned_row) {
            p_pwb[h * 4 + i] += dv[i];
            p_lns[h * 4 + i] += d[h * 4 + i] * that;
            p_lnb[h * 4 + i] += d[h * 4 + i];
          }
        }
        *reinterpret_cast<float4*>(row + col) =
            make_float4(dv[0], dv[1], dv[2], dv[3]);
      }
    }
    __syncthreads();
    // the block's weight-gradient partial += u^T dv over the owned rows
    for (int i0 = 0; i0 < C; i0 += G::PR) dw_pass<G>(us, vs, pw_out, i0, first);
    first = false;
    // du = dv W^T over all R rows, into us (mm_f32's first barrier orders
    // it after every read of u above)
    {
      float acc[G::RM][8];
      mm_f32<G>(vs, wt, panel, acc);
      store_rows<G>(acc, us);
    }
    __syncthreads();
    // owned rows of column cf: depthwise gradients and dx
    for (int r = PAD + fg * OROWS; r < PAD + (fg + 1) * OROWS; ++r) {
      const int g = u0 + r;
      if (g >= M) break;
      const float du = us[r * G::LD + cf];
      p_dwb += du;
#pragma unroll
      for (int tap = 0; tap < K; ++tap)
        p_dw[tap] += xs[(r + tap) * G::LD + cf] * du;
      float acc = us[(r - PAD) * G::LD + cf] * wf[K - 1];
#pragma unroll
      for (int sh = 1; sh < K; ++sh)
        acc += us[(r - PAD + sh) * G::LD + cf] * wf[K - 1 - sh];
      dx[((size_t)b * M + g) * C + cf] = acc * keep[(size_t)b * M + g];
    }
    __syncthreads();
  }
  if (first)  // a block without a tile still writes its partial
    for (int i = tid; i < C * C; i += NT) pw_out[i] = 0.f;

  // per-block partials of the vectors, summed over threads in a fixed
  // order
  float* red_col = xs;                                // [GROUPS][K + 1][C]
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
  using G = GeoF<C>;
  if (wt == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_bwd_f32_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::BWD_SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_bwd_f32_kernel<C><<<grid, G::NT, G::BWD_SMEM, stream>>>(
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
    using G = GeoOf<decltype(c)::value, decltype(f)::value>;
    return backward ? G::BWD_OWN : G::FWD_OWN;
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
    return GeoOf<decltype(c)::value, decltype(f)::value>::SPLIT;
  });
}

int decoder_block_taps() { return K; }

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

// dy, dx: (B, M, C) in x's dtype; wt: W^T (C_out, C_in) float32 (the
// float32 variant only; may be null in bf16); part_pw (grid / split, C_in,
// C_out) f32; part_vec (grid / split, K + 4, C) f32: dw taps, dw bias, pw
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
