// One mel-decoder block body, forward and backward (kernel K4).
//
// Replaces: efficientspeech_tpu/ops/pallas/decoder_block.py::
// decoder_block_fused (_recompute_to_t, _fwd_kernel, _bwd_kernel and the
// custom VJP).  For x (B, M, C = 128) bf16 and keep (B, M) float32:
//
//   xm = bf16(x * keep)                         masked input
//   u  = sum_tap xm[m + tap - 2] * dw[tap]      k = 5, taps summed in bf16,
//        + dw_b                                 in tap order
//   v  = bf16(u @ W  | float32 accumulate) + pw_b   (C x C pointwise conv)
//   t  = tanh(v)                                (bf16)
//   y  = LayerNorm(t; float32 statistics) * ln_s + ln_b   -> bf16
//
// and its gradient: dx (masked by keep) and float32 partial sums of the
// seven weight gradients, one set per block, summed by the caller.  The
// gradient with respect to keep is zero.
//
// What bounds it on an H100: bytes.  The forward reads x (33.6 MB at
// B = 128, M = 1024) and writes y (33.6 MB); the backward reads x and dy
// and writes dx (101 MB).  The pointwise product is 4.3 GFLOP a pass,
// 4 us of tensor-core time.  Both kernels keep every intermediate (the
// masked input, u, v, t, the LayerNorm statistics, dv, du) in shared
// memory and registers: the backward recomputes u and t from x instead of
// reading any saved activation.  The 128 x 128 bf16 weight (32 KB) is
// loaded into shared memory once per block: the grids are persistent
// (one or two blocks per SM) and each block walks over row tiles.  The
// products run on the tensor cores (WMMA, bf16 operands, float32
// accumulation).  The backward keeps its C x C weight-gradient sum in
// accumulator fragments across all its tiles and its per-column sums in
// registers, and writes one float32 partial of each per block: no float
// atomics, so every run gives the same sums.
//
// Tiles: a tile computes u and t for R = 64 consecutive frames of one
// sequence.  The depthwise conv needs 2 more input rows on each side.  In
// the backward, dx of a frame needs du of its 2 neighbours on each side,
// so a tile owns only its inner 60 rows and recomputes the outer 2 on
// each side (rows outside [0, M) read as zero, as the TPU kernel's padding
// does).
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

constexpr int C = 128;
constexpr int K = 5;
constexpr int PAD = K / 2;
constexpr int LDB = C + 8;  // bf16 row stride in shared memory (272 bytes)
constexpr int LDF = C + 4;  // float32 row stride in shared memory
constexpr int R = 64;       // rows of u and t per tile
constexpr int RB = R / 16;
constexpr int CB = C / 16;
constexpr int XROWS = R + 2 * PAD;
constexpr int FWD_WARPS = 8;
constexpr int BWD_WARPS = 16;
constexpr int FWD_OWN = R;            // forward: every row is an output row
constexpr int BWD_OWN = R - 2 * PAD;  // backward: the inner 60 rows

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
constexpr size_t WS_BYTES = align128((size_t)C * LDB * 2);
constexpr size_t XS_BYTES = align128((size_t)XROWS * LDB * 2);
constexpr size_t US_BYTES = align128((size_t)R * LDB * 2);
constexpr size_t ST_BYTES = align128((size_t)R * LDF * 4);
constexpr size_t FWD_SMEM = WS_BYTES + XS_BYTES + US_BYTES + ST_BYTES;
constexpr size_t BWD_SMEM = FWD_SMEM + US_BYTES;  // + dv in bf16
// the backward's final reductions reuse xs, us and dv
static_assert((4 * 6 + BWD_WARPS * 3) * C * 4 <= XS_BYTES + 2 * US_BYTES,
              "reduction scratch does not fit");

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<unsigned*>(&a);
  q.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

// W (C_in, C_out) bf16 -> shared memory, row stride LDB
__device__ void load_weight(const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* ws) {
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < C * CH; i += blockDim.x) {
    const int r = i / CH, c8 = i - r * CH;
    *reinterpret_cast<uint4*>(ws + r * LDB + c8 * 8) =
        reinterpret_cast<const uint4*>(w)[i];
  }
}

// xs row i <- bf16(x[b, u0 - PAD + i] * keep), zero outside [0, M)
__device__ void load_x(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ keep, int b, int u0, int M,
                       __nv_bfloat16* xs) {
  constexpr int CH = C / 8;
  for (int i = threadIdx.x; i < XROWS * CH; i += blockDim.x) {
    const int r = i / CH, c8 = i - r * CH;
    const int g = u0 - PAD + r;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < M) {
      const size_t row = (size_t)b * M + g;
      q = *reinterpret_cast<const uint4*>(x + row * C + c8 * 8);
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
    *reinterpret_cast<uint4*>(xs + r * LDB + c8 * 8) = q;
  }
}

// u rows [r0, r1) of column c: the depthwise conv in bf16 arithmetic.
// wb: the taps rounded to bf16; bb: the bias rounded to bf16.
__device__ __forceinline__ void depthwise(const __nv_bfloat16* xs,
                                          __nv_bfloat16* us, int c, int r0,
                                          int r1, const float (&wb)[K],
                                          float bb) {
  for (int r = r0; r < r1; ++r) {
    float acc = bfr(__fmul_rn(__bfloat162float(xs[r * LDB + c]), wb[0]));
#pragma unroll
    for (int tap = 1; tap < K; ++tap)
      acc = bfr(__fadd_rn(acc, bfr(__fmul_rn(
                                   __bfloat162float(xs[(r + tap) * LDB + c]),
                                   wb[tap]))));
    us[r * LDB + c] = __float2bfloat16_rn(__fadd_rn(acc, bb));
  }
}

// st (R x C, float32) <- a (R x C, bf16) @ B, with B = W (TRANS = false:
// v = u @ W) or B = W^T (TRANS = true: du = dv @ W^T); ws holds W as
// (C_in, C_out).  Each warp owns one 16-column block and R/16 * CB / NW
// row blocks.
template <int NW, bool TRANS>
__device__ void mma_rows(const __nv_bfloat16* a, const __nv_bfloat16* ws,
                         float* st, int warp) {
  constexpr int PER = RB * CB / NW;
  const int cb = warp % CB, rb0 = (warp / CB) * PER;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) wmma::fill_fragment(acc[j], 0.f);
  using BLayout =
      typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int kb = 0; kb < CB; ++kb) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
    wmma::load_matrix_sync(
        bf, TRANS ? ws + cb * 16 * LDB + kb * 16 : ws + kb * 16 * LDB + cb * 16,
        LDB);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, a + (rb0 + j) * 16 * LDB + kb * 16, LDB);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    wmma::store_matrix_sync(st + (rb0 + j) * 16 * LDF + cb * 16, acc[j], LDF,
                            wmma::mem_row_major);
}

// t of one row from v (4 columns per lane): bf16(v) + pw_b, tanh, in bf16
__device__ __forceinline__ void row_t(const float* st_row, int col,
                                      const float (&pwb)[4], float (&t)[4],
                                      float eps, float& mean, float& rstd) {
  const float4 v = *reinterpret_cast<const float4*>(st_row + col);
  const float vv[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[i] = bfr(tanhf(bfr(__fadd_rn(bfr(vv[i]), pwb[i]))));
    s += t[i];
  }
  mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = t[i] - mean;
    q += d * d;
  }
  rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
}

__global__ void __launch_bounds__(FWD_WARPS * 32, 2)
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
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + WS_BYTES);
  __nv_bfloat16* us =
      reinterpret_cast<__nv_bfloat16*>(smem + WS_BYTES + XS_BYTES);
  float* st = reinterpret_cast<float*>(smem + WS_BYTES + XS_BYTES + US_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // depthwise: column c, one of NT/C row groups
  constexpr int GROUPS = FWD_WARPS * 32 / C;
  constexpr int GROWS = R / GROUPS;
  const int c = tid % C, grp = tid / C;
  float wb[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) wb[tap] = bfr(dww[tap * C + c]);
  const float bb = bfr(dwb[c]);
  // epilogue: lane owns columns [col, col + 4)
  const int col = lane * 4;
  float pb[4], s[4], sb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pb[i] = bfr(pwb[col + i]);
    s[i] = lns[col + i];
    sb[i] = lnb[col + i];
  }
  load_weight(w, ws);

  const int tiles_m = (M + FWD_OWN - 1) / FWD_OWN;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int u0 = (tile - b * tiles_m) * FWD_OWN;
    load_x(x, keep, b, u0, M, xs);
    __syncthreads();
    depthwise(xs, us, c, grp * GROWS, (grp + 1) * GROWS, wb, bb);
    __syncthreads();
    mma_rows<FWD_WARPS, false>(us, ws, st, warp);
    __syncthreads();
    for (int r = warp; r < R && u0 + r < M; r += FWD_WARPS) {
      float t[4], mean, rstd;
      row_t(st + r * LDF, col, pb, t, eps, mean, rstd);
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = (t[i] - mean) * rstd * s[i] + sb[i];
      store4(y + ((size_t)b * M + u0 + r) * C + col, t);
    }
  }
}

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
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + WS_BYTES);
  __nv_bfloat16* us =
      reinterpret_cast<__nv_bfloat16*>(smem + WS_BYTES + XS_BYTES);
  __nv_bfloat16* dvs =
      reinterpret_cast<__nv_bfloat16*>(smem + WS_BYTES + XS_BYTES + US_BYTES);
  float* st = reinterpret_cast<float*>(smem + WS_BYTES + XS_BYTES +
                                       2 * US_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int GROUPS = BWD_WARPS * 32 / C;
  constexpr int GROWS = R / GROUPS;          // depthwise rows per group
  constexpr int OROWS = BWD_OWN / GROUPS;    // owned rows per group
  static_assert(BWD_OWN % GROUPS == 0, "owned rows split evenly");
  const int c = tid % C, grp = tid / C;
  float wb[K], wf[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) {
    wf[tap] = dww[tap * C + c];
    wb[tap] = bfr(wf[tap]);
  }
  const float bb = bfr(dwb[c]);
  const int col = lane * 4;
  float pb[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pb[i] = bfr(pwb[col + i]);
    s[i] = lns[col + i];
  }
  // per-thread partial sums: column c (taps, dw bias), lane columns (pw
  // bias, LayerNorm scale and bias)
  float p_dw[K], p_dwb = 0.f, p_pwb[4], p_lns[4], p_lnb[4];
#pragma unroll
  for (int i = 0; i < K; ++i) p_dw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) p_pwb[i] = p_lns[i] = p_lnb[i] = 0.f;
  // the C x C pointwise-weight gradient: warp owns input-row block
  // warp / 2 and four output-column blocks
  constexpr int PW_PER = CB * CB / BWD_WARPS;
  const int ib = warp / (CB / PW_PER), ob0 = (warp % (CB / PW_PER)) * PW_PER;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_pw[PW_PER];
#pragma unroll
  for (int j = 0; j < PW_PER; ++j) wmma::fill_fragment(acc_pw[j], 0.f);
  load_weight(w, ws);

  const int tiles_m = (M + BWD_OWN - 1) / BWD_OWN;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int m0 = (tile - b * tiles_m) * BWD_OWN;
    const int u0 = m0 - PAD;  // global row of u row 0
    load_x(x, keep, b, u0, M, xs);
    __syncthreads();
    depthwise(xs, us, c, grp * GROWS, (grp + 1) * GROWS, wb, bb);
    __syncthreads();
    mma_rows<BWD_WARPS, false>(us, ws, st, warp);
    __syncthreads();
    // recompute t and its LayerNorm, then dv = dLN * (1 - t^2)
    for (int r = warp; r < R; r += BWD_WARPS) {
      const int g = u0 + r;
      if (g < 0 || g >= M) {
        const float z[4] = {0.f, 0.f, 0.f, 0.f};
        store4(dvs + r * LDB + col, z);
        continue;
      }
      float t[4], mean, rstd, d[4];
      row_t(st + r * LDF, col, pb, t, eps, mean, rstd);
      load4(dy + ((size_t)b * M + g) * C + col, d);
      float that[4], gg[4], gs = 0.f, gx = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        that[i] = (t[i] - mean) * rstd;
        gg[i] = d[i] * s[i];
        gs += gg[i];
        gx += gg[i] * that[i];
      }
      const float gm = warp_sum(gs) / C, gxm = warp_sum(gx) / C;
      float dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dv[i] = rstd * (gg[i] - gm - that[i] * gxm) * (1.f - t[i] * t[i]);
      store4(dvs + r * LDB + col, dv);
      if (r >= PAD && r < R - PAD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p_pwb[i] += dv[i];
          p_lns[i] += d[i] * that[i];
          p_lnb[i] += d[i];
        }
      }
    }
    __syncthreads();
    // du = dv @ W^T for all R rows (rows outside [0, M) have dv = 0)
    mma_rows<BWD_WARPS, true>(dvs, ws, st, warp);
    __syncthreads();
    // only owned rows enter the pointwise-weight gradient
    for (int i = tid; i < 2 * PAD * C; i += blockDim.x) {
      const int r = i / C < PAD ? i / C : R - 2 * PAD + i / C;
      dvs[r * LDB + i % C] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    // d_pw += u^T @ dv
#pragma unroll
    for (int kb = 0; kb < RB; ++kb) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> af;
      wmma::load_matrix_sync(af, us + kb * 16 * LDB + ib * 16, LDB);
#pragma unroll
      for (int j = 0; j < PW_PER; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, dvs + kb * 16 * LDB + (ob0 + j) * 16, LDB);
        wmma::mma_sync(acc_pw[j], af, bf, acc_pw[j]);
      }
    }
    // owned rows of column c: depthwise gradients and dx
    for (int r = PAD + grp * OROWS; r < PAD + (grp + 1) * OROWS; ++r) {
      const int g = u0 + r;
      if (g >= M) break;
      const float du = st[r * LDF + c];
      p_dwb += du;
#pragma unroll
      for (int tap = 0; tap < K; ++tap)
        p_dw[tap] += __bfloat162float(xs[(r + tap) * LDB + c]) * du;
      float acc = st[(r - PAD) * LDF + c] * wf[K - 1];
#pragma unroll
      for (int sh = 1; sh < K; ++sh)
        acc += st[(r - PAD + sh) * LDF + c] * wf[K - 1 - sh];
      dx[((size_t)b * M + g) * C + c] =
          __float2bfloat16_rn(acc * keep[(size_t)b * M + g]);
    }
    __syncthreads();
  }

  // per-block partials, summed over threads in a fixed order
  float* red_col = reinterpret_cast<float*>(xs);      // [GROUPS][K + 1][C]
  float* red_row = red_col + GROUPS * (K + 1) * C;    // [BWD_WARPS][3][C]
#pragma unroll
  for (int tap = 0; tap < K; ++tap)
    red_col[(grp * (K + 1) + tap) * C + c] = p_dw[tap];
  red_col[(grp * (K + 1) + K) * C + c] = p_dwb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red_row[(warp * 3 + 0) * C + col + i] = p_pwb[i];
    red_row[(warp * 3 + 1) * C + col + i] = p_lns[i];
    red_row[(warp * 3 + 2) * C + col + i] = p_lnb[i];
  }
  __syncthreads();
  // part_vec rows: 0..K-1 dw taps, K dw bias, K+1 pw bias, K+2 LN scale,
  // K+3 LN bias
  for (int i = tid; i < (K + 4) * C; i += blockDim.x) {
    const int which = i / C, cc = i - which * C;
    float acc = 0.f;
    if (which <= K) {
      for (int q = 0; q < GROUPS; ++q)
        acc += red_col[(q * (K + 1) + which) * C + cc];
    } else {
      for (int wp = 0; wp < BWD_WARPS; ++wp)
        acc += red_row[(wp * 3 + which - K - 1) * C + cc];
    }
    part_vec[((size_t)blockIdx.x * (K + 4) + which) * C + cc] = acc;
  }
  float* pw_out = part_pw + (size_t)blockIdx.x * C * C;
#pragma unroll
  for (int j = 0; j < PW_PER; ++j)
    wmma::store_matrix_sync(pw_out + ib * 16 * C + (ob0 + j) * 16, acc_pw[j],
                            C, wmma::mem_row_major);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows of x a tile covers: 64 in the forward, 60 in the backward
int decoder_block_tile_rows(int backward) {
  return backward ? BWD_OWN : FWD_OWN;
}

int decoder_block_channels() { return C; }
int decoder_block_taps() { return K; }

// x, y: (B, M, C) bf16; keep (B, M) f32; w (C_in, C_out) bf16; dww (K, C)
// f32; dwb, pwb, lns, lnb (C,) f32.  grid: blocks (they stride over the
// tiles; two fit on an SM).
int decoder_block_fwd_launch(const void* x, const void* keep, const void* w,
                             const void* dww, const void* dwb,
                             const void* pwb, const void* lns,
                             const void* lnb, void* y, int B, int M,
                             float eps, int grid, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FWD_SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_fwd_kernel<<<grid, FWD_WARPS * 32, FWD_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(keep),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<__nv_bfloat16*>(y), B, M, eps);
  return cudaGetLastError();
}

// dy, dx: (B, M, C) bf16; part_pw (grid, C_in, C_out) f32; part_vec
// (grid, K + 4, C) f32: dw taps, dw bias, pw bias, LN scale, LN bias.
int decoder_block_bwd_launch(const void* x, const void* keep, const void* w,
                             const void* dww, const void* dwb,
                             const void* pwb, const void* lns,
                             const void* dy, void* dx, void* part_pw,
                             void* part_vec, int B, int M, float eps,
                             int grid, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_bwd_kernel<<<grid, BWD_WARPS * 32, BWD_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(keep),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part_pw),
      static_cast<float*>(part_vec), B, M, eps);
  return cudaGetLastError();
}

}  // extern "C"
