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
// f32) multiplies float32 operands into float32 sums on the CUDA cores
// (FFMA), nothing rounded to bf16 or TF32: at 2,048 frames ~252 GFLOP
// against 67 TFLOP/s of float32, so operations bound it.  Its activation
// buffer is float32 too, so a tile holds at most 176 rows with its halos
// (192-row buffers: v and the activation, 101 KB each): every stage keeps
// the bf16 variant's tile height (stage 0: 64, H = 33; stages 1-3: 128).
// Each op's weights stream from L2 through shared memory in panels of 16
// rows (8 KB), double-buffered through registers; each of 256 threads
// accumulates up to 11 row groups (rows ty + 16 i) x 8 columns (4 tx +
// 64 g) of the conv output in registers, reading its rows' activations as
// float4 along k, until every thread has read the activation buffer,
// which is then rewritten in place, as in the bf16 variant.  The number
// of row groups is a template constant (one instantiation per count), so
// the inner loop carries no predicates.  Held to the plain version at
// SNR >= 90 dB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

constexpr int MAX_RG = 11;    // 16-row groups of a conv output: tm + 2H <= 176
constexpr int LD = D + 4;     // float32 stride (528 B rows, 16-byte aligned)
constexpr int KP = 16;        // weight rows per streamed panel
constexpr int NT = 256;
constexpr int PER = KP * D / 4 / NT;  // float4 a thread per panel

__host__ __device__ constexpr size_t buf_bytes(int tm, int H) {
  return (size_t)(tm + 2 * H + 16) * LD * 4;
}

// acc[i] (i < NRG) += the conv of the activation rows from a, for the
// thread's output rows a + w + 16 i + ty and columns 4 tx + 64 h: the
// op's weights stream through `panel` (2 x KP x D floats) from L2, one
// panel ahead in registers.  NRG, the conv's 16-row groups, is a
// compile-time constant so the row loop carries no predicates; each
// thread reads its rows' activations as float4 along k (4 steps of k a
// load).  Starts and ends with a barrier: every thread is done reading
// `act` when it returns.
template <int NRG>
__device__ __forceinline__ void conv_acc(const float* act, float* panel,
                                         const float* __restrict__ Wop,
                                         int w, int a,
                                         float (&acc)[MAX_RG][8]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  // panel p holds the op's W rows [p KP, p KP + KP): tap p / (D / KP)
  const int np = (2 * w + 1) * (D / KP);
  const float4* w4 = reinterpret_cast<const float4*>(Wop);
  float4* p4 = reinterpret_cast<float4*>(panel);
  float4 pf[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) p4[tid + q * NT] = w4[tid + q * NT];
  __syncthreads();
  for (int p = 0; p < np; ++p) {
    const int tap = p / (D / KP), k0 = (p % (D / KP)) * KP;
    const float* cur = panel + (p & 1) * KP * D;
    if (p + 1 < np) {
#pragma unroll
      for (int q = 0; q < PER; ++q)
        pf[q] = w4[(size_t)(p + 1) * (KP * D / 4) + tid + q * NT];
    }
    const float* arow = act + (size_t)(a + ty + tap) * LD + k0;
#pragma unroll
    for (int k4 = 0; k4 < KP; k4 += 4) {
      float4 av[NRG];
#pragma unroll
      for (int i = 0; i < NRG; ++i)
        av[i] = *reinterpret_cast<const float4*>(arow + i * 16 * LD + k4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = cur + (k4 + q) * D + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < NRG; ++i) {
          const float x = q == 0 ? av[i].x : q == 1 ? av[i].y
                        : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
    if (p + 1 < np) {
      float4* nxt = p4 + ((p + 1) & 1) * (KP * D / 4);
#pragma unroll
      for (int q = 0; q < PER; ++q) nxt[tid + q * NT] = pf[q];
    }
    __syncthreads();  // (the last one: every thread is done reading `act`)
  }
}

// One folded conv over the activation rows [a, b) of `act`, writing rows
// [a+w, b-w), as the bf16 conv_op.  second: the output is v's residual
// update (v += conv), and v's new activation replaces `act`; otherwise the
// activated output itself replaces `act`.
__device__ void conv_op(bool second, float* V, float* act, float* panel,
                        const float* __restrict__ Wop,
                        const float* __restrict__ bias, int w, int a, int b,
                        int base, int valid, float slope) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int o0 = a + w;
  const int olen = (b - a) - 2 * w;
  const int nrg = (olen + 15) >> 4;

  float acc[MAX_RG][8];
#pragma unroll
  for (int i = 0; i < MAX_RG; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  switch (nrg) {
#define MRF_CASE(n) \
    case n: conv_acc<n>(act, panel, Wop, w, a, acc); break;
    MRF_CASE(1) MRF_CASE(2) MRF_CASE(3) MRF_CASE(4) MRF_CASE(5)
    MRF_CASE(6) MRF_CASE(7) MRF_CASE(8) MRF_CASE(9) MRF_CASE(10)
    MRF_CASE(11)
#undef MRF_CASE
  }
  static_assert(MAX_RG == 11, "one case per row-group count");

  const int end = b - w;
#pragma unroll
  for (int i = 0; i < MAX_RG; ++i) {
    const int r = o0 + i * 16 + ty;
    if (i >= nrg || r >= end) continue;
    const int g = base + r;
    const bool keep = g >= 0 && g < valid;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * h + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * h + j] + bias[c + j];
        if (second) v[j] += V[(size_t)r * LD + c + j];
        v[j] = keep ? v[j] : 0.f;
      }
      if (second)
        *reinterpret_cast<float4*>(V + (size_t)r * LD + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(act + (size_t)r * LD + c) =
          make_float4(lrelu(v[0], slope), lrelu(v[1], slope),
                      lrelu(v[2], slope), lrelu(v[3], slope));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
mrf_kernel(const float* __restrict__ x, const float* __restrict__ W,
           const float* __restrict__ b_all, float* __restrict__ out,
           const int* __restrict__ valid_ptr, int T, int H, int tm,
           MrfOps ops, float inv_nk, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = tm + 2 * H + 16;
  float* V = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem + buf_bytes(tm, H));
  float* panel = reinterpret_cast<float*>(smem + 2 * buf_bytes(tm, H));

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * tm;
  const int base = row0 - H;  // global row of buffer row 0
  const int valid = *valid_ptr;

  if (row0 >= valid) {  // every row of the tile is masked: write zeros only
    for (int i = tid; i < tm * D; i += NT)
      if (row0 + i / D < T) out[(size_t)row0 * D + i] = 0.f;
    return;
  }

  // rows past a chain's extent are read (never kept) by the last partial
  // row group: start them at zero so they stay finite
  for (int i = tid; i < rows * LD; i += NT) V[i] = act[i] = 0.f;
  __syncthreads();

  for (int j = 0; j < ops.n_chains; ++j) {
    int M = 0;
    for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
    int a = H - M, b = H + tm + M;

    // v := x (masked) over the chain's extent, and its activation
    for (int i = tid; i < (b - a) * (D / 4); i += NT) {
      const int r = a + i / (D / 4), c4 = i % (D / 4);
      const int g = base + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T && g < valid)
        v = reinterpret_cast<const float4*>(x + (size_t)g * D)[c4];
      reinterpret_cast<float4*>(V + (size_t)r * LD)[c4] = v;
      reinterpret_cast<float4*>(act + (size_t)r * LD)[c4] =
          make_float4(lrelu(v.x, slope), lrelu(v.y, slope),
                      lrelu(v.z, slope), lrelu(v.w, slope));
    }
    __syncthreads();

    for (int m = 0; m + 1 < ops.n_ops[j]; m += 2) {
      const int w1 = ops.w[j][m], w2 = ops.w[j][m + 1];
      conv_op(false, V, act, panel, W + (size_t)ops.woff[j][m] * D,
              b_all + (size_t)ops.bidx[j][m] * D, w1, a, b, base, valid,
              slope);
      a += w1;
      b -= w1;
      conv_op(true, V, act, panel, W + (size_t)ops.woff[j][m + 1] * D,
              b_all + (size_t)ops.bidx[j][m + 1] * D, w2, a, b, base, valid,
              slope);
      a += w2;
      b -= w2;
    }

    // a == H and b == H + tm: fold the chain's centre rows into the sum
    const bool first = j == 0, last = j == ops.n_chains - 1;
    for (int i = tid; i < tm * D; i += NT) {
      const int r = i / D, c = i % D;
      const int g = row0 + r;
      if (g >= T) continue;
      const size_t o = (size_t)g * D + c;
      float s = V[(size_t)(H + r) * LD + c];
      if (!first) s = out[o] + s;
      if (last) s = g < valid ? s * inv_nk : 0.f;
      out[o] = s;
    }
    __syncthreads();
  }
}

}  // namespace f32v

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows a tile with both halos may span: bf16 (f32 = 0) 192, float32 176.
int mrf_max_rows(int f32) { return (f32 ? f32v::MAX_RG : MAX_RB) * 16; }

int mrf_smem_bytes(int tm, int H, int f32) {
  if (f32)
    return static_cast<int>(2 * f32v::buf_bytes(tm, H) +
                            2 * f32v::KP * D * sizeof(float));
  const size_t rows = tm + 2 * H + 16;
  return static_cast<int>(rows * LDV * 4 + rows * LDA * 2 +
                          NWARP * 256 * sizeof(float));
}

// spec: n_chains, then per chain n_ops followed by (w, woff, bidx) per op.
// W: bf16 (f32 = 0) or float32 (f32 = 1); x, b_all and out float32.
int mrf_launch(const void* x, const void* W, const void* b_all, void* out,
               const void* valid, int T, int H, int tm, const int* spec,
               int num_kernels, float slope, int f32, void* stream) {
  MrfOps ops = {};
  int p = 0;
  ops.n_chains = spec[p++];
  if (ops.n_chains < 1 || ops.n_chains > MAX_CHAINS)
    return cudaErrorInvalidValue;
  for (int j = 0; j < ops.n_chains; ++j) {
    ops.n_ops[j] = spec[p++];
    if (ops.n_ops[j] < 2 || ops.n_ops[j] > MAX_OPS || ops.n_ops[j] % 2)
      return cudaErrorInvalidValue;
    for (int m = 0; m < ops.n_ops[j]; ++m) {
      ops.w[j][m] = spec[p++];
      ops.woff[j][m] = spec[p++];
      ops.bidx[j][m] = spec[p++];
    }
  }
  if (tm % 16 || tm + 2 * H > mrf_max_rows(f32)) return cudaErrorInvalidValue;
  const int smem = mrf_smem_bytes(tm, H, f32);
  dim3 grid((T + tm - 1) / tm);
  if (f32) {
    cudaError_t e = cudaFuncSetAttribute(
        f32v::mrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    f32v::mrf_kernel<<<grid, f32v::NT, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(W),
        static_cast<const float*>(b_all), static_cast<float*>(out),
        static_cast<const int*>(valid), T, H, tm, ops, 1.0f / num_kernels,
        slope);
    return cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(
      mrf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mrf_kernel<<<grid, NWARP * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(W),
      static_cast<const float*>(b_all), static_cast<float*>(out),
      static_cast<const int*>(valid), T, H, tm, ops, 1.0f / num_kernels,
      slope);
  return cudaGetLastError();
}

}  // extern "C"
