// One vocoder stage's whole multi-receptive-field block (kernel K2).
//
// Replaces: efficientspeech_tpu/ops/pallas/mrf_block.py::mrf_fused (kernel
// body _make_mrf_kernel).  For x (T, 128) float32 and the stage's folded
// convs (one chain of (conv1, conv2) pairs per resblock), it computes
//
//   x = x masked to rows [0, valid)
//   for each resblock j:  v = x
//     for each pair m:    t = mask(conv1(lrelu(v)));  v = mask(conv2(lrelu(t)) + v)
//     xs = xs + v
//   out = mask(xs * (1 / num_kernels))
//
// where conv(a)[t] = sum_{i<2w+1} a[t-w+i] @ W[i] + b and mask zeroes every
// row outside [0, valid).
//
// What bounds it on an H100: arithmetic.  At 2,048 mel frames the four
// stages do ~268 GFLOP against ~16 MB of activations read and written per
// stage, thousands of FLOP per byte, far right of the bf16 ridge.  The
// Pallas version keeps all 18 folded weight matrices resident in VMEM (up
// to 4.7 MB); a block here has at most 227 KB of shared memory, less than
// even one op's weights (27 taps x 32 KB).  So:
//   * weights stream from L2 one tap slice at a time: each warp loads the
//     8 bf16 WMMA B fragments of its 16 columns for one tap (4 KB), then
//     reuses them across every row block of the tile;
//   * shared memory holds only the chain state of one tile with its halo:
//     v in float32 (the residual stream keeps full precision) and one bf16
//     buffer with the next conv's activated input, (tm + 2H + 16) rows each;
//   * the conv output stays in the warps' accumulator fragments until every
//     warp has finished reading the activation buffer, so the buffer is
//     rewritten in place (no second activation buffer);
//   * x is re-read from device memory (L2-resident) at the start of each
//     resblock chain, and the resblock sum accumulates in the block's own
//     output tile in device memory.
// Each chain recomputes a halo of M rows per side (M = the sum of its
// window half-widths, H = max M); the tile height is chosen per stage by
// the wrapper (see mrf_block.py).  `valid` is read from device memory; a
// tile whose rows all lie at or beyond it (the speculative buffer's tail)
// only writes zeros.
//
// Numerics: bf16 x bf16 products with f32 accumulation (the TPU's MXU
// arithmetic), f32 residual stream.  Held to the plain float32 version at
// SNR >= 35 dB.
//
// The float32 variant (W_all float32, the serving dtype of --precision
// f32) keeps float32 accuracy on the tensor cores by 3xTF32 split
// products (csrc/tf32x3.cuh): 3 x ~252 GFLOP at 2,048 frames against
// 494.7 TFLOP/s of TF32, 1.53 ms, where float32 FFMA would need 3.76 ms.
// wgmma takes TF32 operands K-major only, so each conv runs transposed,
// conv^T = W^T act^T:
//   * A is W^T from registers: each warp loads its 16 output channels x 8
//     k rows of the op's W straight from L2 (row-major, 32-byte runs),
//     four k-steps ahead of their use, and splits them in registers; the
//     block's two warpgroups take 64 output channels each, so the block
//     reads each weight once per tile and per op, and no warp fetches
//     another's; two commit groups stay in flight (tf32x3::k_loop).
//     What bounds it: those loads, 4 KB of W a k-step and SM against
//     3 x 2 x 64 x N x 8 products; the same k loop reaches nearly the
//     TF32 rate with A held in registers and falls well below it with A
//     from L2 at N = 64 rows (probes/tf32_wgmma.py), so a tall tile is
//     worth its halo;
//   * B is the activation buffer, kept split (a hi and a lo copy) in the
//     layout of tf32x3.cuh: rows 16 bytes apart within each chunk of 4
//     channels, so tap j is the same descriptor started j rows further,
//     and wgmma's N is the conv's output rows, in chunks of 64 and 16
//     (16-row granularity: a conv computes at most 15 rows past its
//     extent, which are never kept);
//   * v, the residual stream, stays float32 in shared memory; the
//     epilogue of each conv (bias, residual, the valid-row mask, v, and
//     the activation split into its two copies) works from the
//     accumulator registers once both warpgroups have finished reading
//     the buffer, which is then rewritten in place;
//   * the tile height per stage, the buffers' rows and offsets come from
//     mrf_block.py::f32_plan (rows of a chunk = 1 mod 8, so the epilogue's
//     stores meet 32 banks).
// Two designs that share W through shared memory measured slower on the
// H100 at every tile height tried: rows as wgmma's M with W^T split once
// per block into a slot ring and a block barrier each k-step, and the
// same with a producer warp and full/empty mbarriers (ptxas serialised
// its wgmmas).
// Held to the plain version at SNR >= 90 dB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 128;          // folded width of every stage
constexpr int NWARP = D / 16;   // one warp per 16 output columns
constexpr int MAX_RB = 12;      // row blocks per conv output: tm + 2H <= 192
constexpr int LDV = D + 8;      // f32 stride (544 B, 32-byte aligned rows)
constexpr int LDA = D + 16;     // bf16 stride (288 B, 32-byte aligned rows)
constexpr int MAX_CHAINS = 4;
constexpr int MAX_OPS = 8;

struct MrfOps {
  int n_chains;
  int n_ops[MAX_CHAINS];
  int w[MAX_CHAINS][MAX_OPS];      // window half-width of each op
  int woff[MAX_CHAINS][MAX_OPS];   // first row of the op's W in W_all
  int bidx[MAX_CHAINS][MAX_OPS];   // the op's row in b_all
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// One folded conv over the activation rows [a, b) of `act`, writing rows
// [a+w, b-w).  SECOND: the output is v's residual update (v += conv), and
// v's new activation replaces `act`; otherwise the activated output itself
// replaces `act`.
template <bool SECOND>
__device__ void conv_op(float* V, __nv_bfloat16* act, float* staging,
                        const __nv_bfloat16* __restrict__ Wop,
                        const float* __restrict__ bias, int w, int a, int b,
                        int base, int valid, float slope) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = warp * 16;
  const int o0 = a + w;
  const int olen = (b - a) - 2 * w;
  const int nrb = (olen + 15) >> 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_RB];
#pragma unroll
  for (int rb = 0; rb < MAX_RB; ++rb) {
    if (rb < nrb) {
      if (SECOND)
        wmma::load_matrix_sync(acc[rb], V + (size_t)(o0 + rb * 16) * LDV + col,
                               LDV, wmma::mem_row_major);
      else
        wmma::fill_fragment(acc[rb], 0.f);
    }
  }

  const int n_win = 2 * w + 1;
  for (int tap = 0; tap < n_win; ++tap) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        bf[D / 16];
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wmma::load_matrix_sync(bf[k], Wop + (size_t)(tap * D + k * 16) * D + col,
                             D);
#pragma unroll
    for (int rb = 0; rb < MAX_RB; ++rb) {
      if (rb < nrb) {
        const __nv_bfloat16* arow = act + (size_t)(a + rb * 16 + tap) * LDA;
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> af;
          wmma::load_matrix_sync(af, arow + k * 16, LDA);
          wmma::mma_sync(acc[rb], af, bf[k], acc[rb]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done reading `act`

  float* st = staging + warp * 256;
  const int end = b - w;
#pragma unroll
  for (int rb = 0; rb < MAX_RB; ++rb) {
    if (rb < nrb) {
      wmma::store_matrix_sync(st, acc[rb], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = o0 + rb * 16 + (e >> 4), c = col + (e & 15);
        if (r >= end) continue;
        const int g = base + r;
        float v = st[e] + bias[c];
        v = (g >= 0 && g < valid) ? v : 0.f;
        if (SECOND) V[(size_t)r * LDV + c] = v;
        act[(size_t)r * LDA + c] = __float2bfloat16_rn(lrelu(v, slope));
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NWARP * 32, 1)
mrf_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ W,
           const float* __restrict__ b_all, float* __restrict__ out,
           const int* __restrict__ valid_ptr, int T, int H, int tm,
           MrfOps ops, float inv_nk, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = tm + 2 * H + 16;
  float* V = reinterpret_cast<float*>(smem);
  __nv_bfloat16* act =
      reinterpret_cast<__nv_bfloat16*>(smem + (size_t)rows * LDV * 4);
  float* staging = reinterpret_cast<float*>(
      smem + (size_t)rows * LDV * 4 + (size_t)rows * LDA * 2);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * tm;
  const int base = row0 - H;  // global row of buffer row 0
  const int valid = *valid_ptr;

  if (row0 >= valid) {  // every row of the tile is masked: write zeros only
    for (int i = tid; i < tm * D; i += blockDim.x)
      if (row0 + i / D < T) out[(size_t)row0 * D + i] = 0.f;
    return;
  }

  // rows past a chain's extent are read (never kept) by the last partial
  // row block: start them at zero so they stay finite
  for (int i = tid; i < rows * LDV; i += blockDim.x) V[i] = 0.f;
  for (int i = tid; i < rows * LDA; i += blockDim.x)
    act[i] = __float2bfloat16_rn(0.f);
  __syncthreads();

  for (int j = 0; j < ops.n_chains; ++j) {
    int M = 0;
    for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
    int a = H - M, b = H + tm + M;

    // v := x (masked) over the chain's extent, and its activation
    for (int i = tid; i < (b - a) * (D / 4); i += blockDim.x) {
      const int r = a + i / (D / 4), c4 = i % (D / 4);
      const int g = base + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T && g < valid)
        v = reinterpret_cast<const float4*>(x + (size_t)g * D)[c4];
      reinterpret_cast<float4*>(V + (size_t)r * LDV)[c4] = v;
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(act + (size_t)r * LDA + c4 * 4);
      dst[0] = __floats2bfloat162_rn(lrelu(v.x, slope), lrelu(v.y, slope));
      dst[1] = __floats2bfloat162_rn(lrelu(v.z, slope), lrelu(v.w, slope));
    }
    __syncthreads();

    for (int m = 0; m + 1 < ops.n_ops[j]; m += 2) {
      const int w1 = ops.w[j][m], w2 = ops.w[j][m + 1];
      conv_op<false>(V, act, staging, W + (size_t)ops.woff[j][m] * D,
                     b_all + (size_t)ops.bidx[j][m] * D, w1, a, b, base, valid,
                     slope);
      a += w1;
      b -= w1;
      conv_op<true>(V, act, staging, W + (size_t)ops.woff[j][m + 1] * D,
                    b_all + (size_t)ops.bidx[j][m + 1] * D, w2, a, b, base,
                    valid, slope);
      a += w2;
      b -= w2;
    }

    // a == H and b == H + tm: fold the chain's centre rows into the sum
    const bool first = j == 0, last = j == ops.n_chains - 1;
    for (int i = tid; i < tm * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const int g = row0 + r;
      if (g >= T) continue;
      const size_t o = (size_t)g * D + c;
      float s = V[(size_t)(H + r) * LDV + c];
      if (!first) s = out[o] + s;
      if (last) s = g < valid ? s * inv_nk : 0.f;
      out[o] = s;
    }
    __syncthreads();
  }
}

namespace f32v {

constexpr int NT = 256;       // two warpgroups, 64 output channels each
constexpr int LDV = D + 4;    // v's float32 stride: the epilogue meets 32 banks
constexpr int MAX_N = 176;    // rows of a conv output: two 64-row and three
                              // 16-row chunks

// the plan (mrf_block.py::f32_plan): tile rows, the halo, rows of a
// channel chunk of the activation buffer (its stride r_alloc * 16 bytes),
// byte offsets of the lo copy and of v
struct Plan {
  int tm, H, r_alloc, lo_off, v_off;
};

// the activation of value v, split, at buffer row r and channel c
__device__ __forceinline__ void put_act(unsigned char* smem, const Plan& pl,
                                        int r, int c, float v) {
  uint32_t hi, lo;
  tf32x3::split(v, hi, lo);
  const int o = (c >> 2) * pl.r_alloc * 16 + r * 16 + (c & 3) * 4;
  *reinterpret_cast<uint32_t*>(smem + o) = hi;
  *reinterpret_cast<uint32_t*>(smem + pl.lo_off + o) = lo;
}

// One folded conv over the activation rows [a, b), writing rows
// [a + w, b - w), as the bf16 conv_op.  SECOND: the output is v's
// residual update (v += conv), and v's new activation replaces the
// buffer's; otherwise the activated output itself replaces it.
template <bool SECOND>
__device__ void conv_op(unsigned char* smem, const Plan& pl,
                        const float* __restrict__ Wop,
                        const float* __restrict__ bias, int w, int a, int b,
                        int base, int valid, float slope) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = a + w, end = b - w;
  const int npad = (end - o0 + 15) & ~15;
  const int n64 = min(npad >> 6, 2), n16 = (npad - 64 * n64) >> 4;
  // A's rows g and g + 8 of the warp's 16 are output channels ca and
  // ca + 1: each lane loads its two of a k row as 8 bytes
  const int ca = 64 * wg + 16 * warp + 2 * g;
  const float* wa = Wop + ca;

  float acc64[2][32], acc16[3][8];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc64[c][i] = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc16[c][i] = 0.f;
  const uint32_t b_hi = sm90::smem_u32(smem) + a * 16;
  const uint64_t d_hi = tf32x3::desc(b_hi, pl.r_alloc * 16),
                 d_lo = tf32x3::desc(b_hi + pl.lo_off, pl.r_alloc * 16);
  const float* wt = wa + (size_t)t * D;
  tf32x3::k_loop<4, 8>(
      (2 * w + 1) * (D / 8),
      [&](int s, float (&r)[4]) {  // k rows 8 s + t, 8 s + t + 4
        const float* q0 = wt + (size_t)(8 * s) * D;
        const float2 k0 = __ldg(reinterpret_cast<const float2*>(q0));
        const float2 k4 = __ldg(reinterpret_cast<const float2*>(q0 + 4 * D));
        r[0] = k0.x;
        r[1] = k0.y;
        r[2] = k4.x;
        r[3] = k4.y;
      },
      [&](int s, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
        // rows from tap s / 16, channels (s % 16) * 8 .., in 16-byte units
        const uint32_t k = (s & 15) * 2 * pl.r_alloc + (s >> 4);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (c < n64)
            tf32x3::mma3<64>(acc64[c], hi, lo, d_hi + k + 64 * c,
                             d_lo + k + 64 * c, 1);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (c < n16) {
            const uint32_t o = k + 64 * n64 + 16 * c;
            tf32x3::mma3<16>(acc16[c], hi, lo, d_hi + o, d_lo + o, 1);
          }
      });
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) sm90::reg_fence(acc64[c][i]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) sm90::reg_fence(acc16[c][i]);
  __syncthreads();  // both warpgroups are done reading the buffer

  // acc[4 j + 2 h + e] is output channel ca + h of row 8 j + 2 t + e of
  // its chunk
  float* V = reinterpret_cast<float*>(smem + pl.v_off);
  const float bv[2] = {bias[ca], bias[ca + 1]};
  auto put = [&](int n, int h, float acc) {
    const int r = o0 + n;
    if (r >= end) return;
    const int gr = base + r, c = ca + h;
    float v = acc + bv[h];
    if (SECOND) v += V[r * LDV + c];
    v = (gr >= 0 && gr < valid) ? v : 0.f;
    if (SECOND) V[r * LDV + c] = v;
    put_act(smem, pl, r, c, lrelu(v, slope));
  };
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (c < n64)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            put(64 * c + 8 * j + 2 * t + e, h, acc64[c][4 * j + 2 * h + e]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    if (c < n16)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            put(64 * n64 + 16 * c + 8 * j + 2 * t + e, h,
                acc16[c][4 * j + 2 * h + e]);
  sm90::fence_proxy_async();  // the new buffer, before wgmma reads it
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
mrf_kernel(const float* __restrict__ x, const float* __restrict__ W,
           const float* __restrict__ b_all, float* __restrict__ out,
           const int* __restrict__ valid_ptr, int T, const Plan pl,
           MrfOps ops, float inv_nk, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int tm = pl.tm, H = pl.H;
  const int row0 = blockIdx.x * tm;
  const int base = row0 - H;  // global row of buffer row 0
  const int valid = min(max(*valid_ptr, 0), T);
  float* V = reinterpret_cast<float*>(smem + pl.v_off);

  if (row0 >= valid) {  // every row of the tile is masked: write zeros only
    for (int i = tid; i < tm * D; i += NT)
      if (row0 + i / D < T) out[(size_t)row0 * D + i] = 0.f;
    return;
  }

  // rows past a conv's extent are read (never kept) by its last chunk:
  // start the buffer at zero so they stay finite
  for (int i = tid; i < 2 * pl.lo_off / 16; i += NT)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const uint32_t chunk = pl.r_alloc * 16;
  for (int j = 0; j < ops.n_chains; ++j) {
    int M = 0;
    for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
    int a = H - M, b = H + tm + M;

    // v := x (masked) over the chain's extent, and its activation, split
#pragma unroll 4
    for (int i = tid; i < (b - a) * (D / 4); i += NT) {
      const int r = a + i / (D / 4), c4 = i % (D / 4);
      const int gr = base + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < valid)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)gr * D) + c4);
      *reinterpret_cast<float4*>(V + r * LDV + c4 * 4) = v;
      float4 lo;
      const float4 hi = tf32x3::split4(
          make_float4(lrelu(v.x, slope), lrelu(v.y, slope),
                      lrelu(v.z, slope), lrelu(v.w, slope)), lo);
      unsigned char* dst = smem + c4 * chunk + r * 16;
      *reinterpret_cast<float4*>(dst) = hi;
      *reinterpret_cast<float4*>(dst + pl.lo_off) = lo;
    }
    sm90::fence_proxy_async();
    __syncthreads();

    for (int m = 0; m + 1 < ops.n_ops[j]; m += 2) {
      const int w1 = ops.w[j][m], w2 = ops.w[j][m + 1];
      conv_op<false>(smem, pl, W + (size_t)ops.woff[j][m] * D,
                     b_all + (size_t)ops.bidx[j][m] * D, w1, a, b, base,
                     valid, slope);
      a += w1;
      b -= w1;
      conv_op<true>(smem, pl, W + (size_t)ops.woff[j][m + 1] * D,
                    b_all + (size_t)ops.bidx[j][m + 1] * D, w2, a, b, base,
                    valid, slope);
      a += w2;
      b -= w2;
    }

    // a == H and b == H + tm: fold the chain's centre rows into the sum
    const bool first = j == 0, last = j == ops.n_chains - 1;
#pragma unroll 4
    for (int i = tid; i < tm * (D / 4); i += NT) {
      const int r = i / (D / 4), c4 = i % (D / 4);
      const int gr = row0 + r;
      if (gr >= T) continue;
      float4* o = reinterpret_cast<float4*>(out + (size_t)gr * D) + c4;
      float4 s = *reinterpret_cast<const float4*>(V + (H + r) * LDV + c4 * 4);
      if (!first) {
        const float4 u = *o;
        s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
      }
      if (last) {
        const float k = gr < valid ? inv_nk : 0.f;
        s.x *= k; s.y *= k; s.z *= k; s.w *= k;
      }
      *o = s;
    }
    __syncthreads();
  }
}

}  // namespace f32v

}  // namespace

namespace {

// spec: n_chains, then per chain n_ops followed by (w, woff, bidx) per op
bool parse_spec(const int* spec, MrfOps& ops) {
  ops = {};
  int p = 0;
  ops.n_chains = spec[p++];
  if (ops.n_chains < 1 || ops.n_chains > MAX_CHAINS) return false;
  for (int j = 0; j < ops.n_chains; ++j) {
    ops.n_ops[j] = spec[p++];
    if (ops.n_ops[j] < 2 || ops.n_ops[j] > MAX_OPS || ops.n_ops[j] % 2)
      return false;
    for (int m = 0; m < ops.n_ops[j]; ++m) {
      ops.w[j][m] = spec[p++];
      ops.woff[j][m] = spec[p++];
      ops.bidx[j][m] = spec[p++];
    }
  }
  return true;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows a bf16 tile with both halos may span.
int mrf_max_rows() { return MAX_RB * 16; }

int mrf_smem_bytes(int tm, int H) {
  const size_t rows = tm + 2 * H + 16;
  return static_cast<int>(rows * LDV * 4 + rows * LDA * 2 +
                          NWARP * 256 * sizeof(float));
}

// bf16 W_all; x, b_all and out float32.
int mrf_launch(const void* x, const void* W, const void* b_all, void* out,
               const void* valid, int T, int H, int tm, const int* spec,
               int num_kernels, float slope, void* stream) {
  MrfOps ops;
  if (!parse_spec(spec, ops)) return cudaErrorInvalidValue;
  if (tm % 16 || tm + 2 * H > mrf_max_rows()) return cudaErrorInvalidValue;
  const int smem = mrf_smem_bytes(tm, H);
  cudaError_t e = cudaFuncSetAttribute(
      mrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mrf_kernel<<<(T + tm - 1) / tm, NWARP * 32, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(W),
      static_cast<const float*>(b_all), static_cast<float*>(out),
      static_cast<const int*>(valid), T, H, tm, ops, 1.0f / num_kernels,
      slope);
  return cudaGetLastError();
}

// float32 W_all; x, b_all and out float32.  The plan (tile rows tm, rows
// of a channel chunk, the lo copy's and v's byte offsets, shared memory)
// comes from mrf_block.py::f32_plan.
int mrf_f32_launch(const void* x, const void* W, const void* b_all,
                   void* out, const void* valid, int T, int H, int tm,
                   int r_alloc, int lo_off, int v_off, int smem,
                   const int* spec, int num_kernels, float slope,
                   void* stream) {
  MrfOps ops;
  if (!parse_spec(spec, ops)) return cudaErrorInvalidValue;
  const f32v::Plan pl{tm, H, r_alloc, lo_off, v_off};
  if (tm % 16 || tm + 2 * H - 2 > f32v::MAX_N ||
      r_alloc < tm + 2 * H + 15 || lo_off < (D / 4) * r_alloc * 16 ||
      v_off < 2 * lo_off || v_off % 16 ||
      smem < v_off + (tm + 2 * H) * f32v::LDV * 4)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      f32v::mrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  f32v::mrf_kernel<<<(T + tm - 1) / tm, f32v::NT, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const float*>(b_all), static_cast<float*>(out),
      static_cast<const int*>(valid), T, pl, ops, 1.0f / num_kernels, slope);
  return cudaGetLastError();
}

}  // extern "C"
