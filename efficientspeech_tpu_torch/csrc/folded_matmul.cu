// Windowed matmul of the polyphase-folded HiFi-GAN (kernel K1).
//
// Replaces: efficientspeech_tpu/ops/pallas/folded_matmul.py::folded_matmul
// (kernel body _make_kernel).  It computes, for x (T, D_in) float32,
//
//   y[t] = sum_{j<2w+1} act(x[t-w+j]) @ W[j*D_in:(j+1)*D_in] + b
//          (+ residual[t]) (+ accum[t]), then * out_scale,
//   y[t] = 0 for t >= valid,
//
// with act an optional leaky-relu and rows outside [0, T) reading as zero.
//
// What bounds it on an H100: at the vocoder's shapes (D_in = 128, 2w+1 = 3
// taps, D_out 16..512) each output element takes 2*3*128 = 768 FLOP
// against 4 bytes written, 4 read per input element and 4 per residual: the
// up-sampler ops sit near the bf16 ridge (~295 FLOP/byte), the post conv
// (D_out = 16) far below it.  The design reads each x tile ONCE from
// device memory with its 2w halo rows into shared memory (the Pallas
// version's padded copy of x is not needed: rows outside [0, T) are
// zero-filled on load), applies the leaky-relu there once, and converts it
// to bf16 for the tensor cores.  Each warp owns a 16-column slice of a
// 128-column tile and accumulates all taps over D_in in WMMA fragments
// (bf16 x bf16 -> f32, as the TPU's MXU does), so the window is never
// materialised.  Bias, residual, accumulator, scale and the valid-row mask
// are fused into the epilogue; `valid` is read from device memory, so the
// host never waits for the acoustic model's mel length, and a tile whose
// rows all lie at or beyond it (the speculative buffer's tail) only writes
// zeros.
//
// Numerics: the products take bf16 operands (the weights are bf16 values,
// the activations are rounded to bf16) and accumulate in f32.  Against the
// plain float32 version this is held to SNR >= 35 dB.
//
// The float32 variant (W float32, the serving dtype of --precision f32)
// multiplies float32 operands into float32 sums on the CUDA cores (FFMA):
// nothing is rounded to bf16 or TF32.  It is bound by operations (2 * 3 *
// 128 FLOP an output element against 67 TFLOP/s of float32).  The x tile
// with its halo is staged once as float32 (activation applied); W streams
// from L2 through shared memory in chunks of 16 rows, double-buffered
// through registers.  A block computes 64 rows x 128 columns, each thread 4
// rows x 8 columns (D_out a multiple of 128), or 64 rows x 16 columns, each
// thread 1 row x 4 columns (other multiples of 16: the post conv's 16).
// The epilogue is the bf16 kernel's.  Held to the plain version at SNR >=
// 90 dB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;        // rows per block (4 WMMA row blocks)
constexpr int TN = 128;       // columns per block (8 warps x 16)
constexpr int RB = TM / 16;
constexpr int APAD = 16;      // bf16 row padding: stride stays 32-byte aligned

__global__ void folded_matmul_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ residual,
    const float* __restrict__ accum, float* __restrict__ out,
    const int* __restrict__ valid_ptr, int T, int d_in, int d_out, int w,
    int pre_lrelu, float slope, int has_scale, float out_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = TM + 2 * w;
  const int lda = d_in + APAD;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const size_t xs_bytes = ((size_t)rows * lda * 2 + 127) / 128 * 128;
  float* staging = reinterpret_cast<float*>(smem + xs_bytes);

  const int row0 = blockIdx.x * TM;
  const int col_tile = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int valid = *valid_ptr;

  if (row0 >= valid) {  // every row of the tile is masked: write zeros only
    const int ncols = min(TN, d_out - col_tile);
    for (int i = tid; i < TM * ncols; i += blockDim.x) {
      const int g = row0 + i / ncols;
      if (g < T) out[(size_t)g * d_out + col_tile + i % ncols] = 0.f;
    }
    return;
  }

  // x rows [row0 - w, row0 - w + rows) -> shared bf16, activation applied
  const int q = d_in / 4;
  for (int idx = tid; idx < rows * q; idx += blockDim.x) {
    const int r = idx / q, c4 = idx - r * q;
    const int g = row0 - w + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < T)
      v = reinterpret_cast<const float4*>(x + (size_t)g * d_in)[c4];
    if (pre_lrelu) {
      v.x = v.x >= 0.f ? v.x : v.x * slope;
      v.y = v.y >= 0.f ? v.y : v.y * slope;
      v.z = v.z >= 0.f ? v.z : v.z * slope;
      v.w = v.w >= 0.f ? v.w : v.w * slope;
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(xs + (size_t)r * lda + c4 * 4);
    dst[0] = __floats2bfloat162_rn(v.x, v.y);
    dst[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();

  const int col = col_tile + warp * 16;
  if (col >= d_out) return;  // warp-uniform; no barrier follows

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RB];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) wmma::fill_fragment(acc[rb], 0.f);

  const int n_win = 2 * w + 1;
  const int kc = d_in / 16;
  for (int tap = 0; tap < n_win; ++tap) {
    for (int k = 0; k < kc; ++k) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(
          bf, W + (size_t)(tap * d_in + k * 16) * d_out + col, d_out);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, xs + (size_t)(rb * 16 + tap) * lda + k * 16,
                               lda);
        wmma::mma_sync(acc[rb], af, bf, acc[rb]);
      }
    }
  }

  float* st = staging + warp * 256;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    wmma::store_matrix_sync(st, acc[rb], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e >> 4, c = e & 15;
      const int g = row0 + rb * 16 + r;
      if (g >= T) continue;
      const size_t o = (size_t)g * d_out + col + c;
      float v = st[e] + bias[col + c];
      if (residual) v += residual[o];
      if (accum) v += accum[o];
      if (has_scale) v *= out_scale;
      out[o] = g < valid ? v : 0.f;
    }
    __syncwarp();
  }
}

namespace f32v {

constexpr int TM = 64;      // rows per block
constexpr int NT = 256;     // threads per block
constexpr int KC = 16;      // W rows per streamed chunk
constexpr int XPAD = 4;     // float32 row padding of the x tile (banks)

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t x_bytes(int d_in, int w) {
  return align16((size_t)(TM + 2 * w) * (d_in + XPAD) * 4);
}

// TN columns per block; each thread RM rows (ty + TY i) x CG runs of 4
// columns (g * TN / CG + 4 tx).
template <int TN, int RM, int CG>
__global__ void __launch_bounds__(NT) folded_matmul_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ W,
    const float* __restrict__ bias, const float* __restrict__ residual,
    const float* __restrict__ accum, float* __restrict__ out,
    const int* __restrict__ valid_ptr, int T, int d_in, int d_out, int w,
    int pre_lrelu, float slope, int has_scale, float out_scale) {
  constexpr int TX = TN / (4 * CG);  // threads across the columns
  constexpr int TY = NT / TX;        // threads across the rows
  constexpr int V4 = KC * TN / 4;    // float4 in a W chunk
  constexpr int PER = (V4 + NT - 1) / NT;
  static_assert(TY * RM == TM, "rows split over threads");
  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = TM + 2 * w;
  const int ldx = d_in + XPAD;
  float* xs = reinterpret_cast<float*>(smem);
  float* ws = reinterpret_cast<float*>(smem + x_bytes(d_in, w));

  const int row0 = blockIdx.x * TM;
  const int col_tile = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int valid = *valid_ptr;

  if (row0 >= valid) {  // every row of the tile is masked: write zeros only
    for (int i = tid; i < TM * TN; i += NT) {
      const int g = row0 + i / TN;
      if (g < T) out[(size_t)g * d_out + col_tile + i % TN] = 0.f;
    }
    return;
  }

  // x rows [row0 - w, row0 - w + rows) -> shared float32, activation
  // applied
  const int q = d_in / 4;
  for (int idx = tid; idx < rows * q; idx += NT) {
    const int r = idx / q, c4 = idx - r * q;
    const int g = row0 - w + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < T)
      v = reinterpret_cast<const float4*>(x + (size_t)g * d_in)[c4];
    if (pre_lrelu) {
      v.x = v.x >= 0.f ? v.x : v.x * slope;
      v.y = v.y >= 0.f ? v.y : v.y * slope;
      v.z = v.z >= 0.f ? v.z : v.z * slope;
      v.w = v.w >= 0.f ? v.w : v.w * slope;
    }
    *reinterpret_cast<float4*>(xs + (size_t)r * ldx + c4 * 4) = v;
  }

  // chunk ch covers W rows [ch * KC, ch * KC + KC) (tap ch / (d_in / KC)),
  // columns [col_tile, col_tile + TN)
  const int nk = d_in / KC, nch = (2 * w + 1) * nk;
  float4 pf[PER];
  auto fetch = [&](int ch) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = tid + p * NT;
      if (i < V4) {
        const int r = i / (TN / 4), c4 = i - r * (TN / 4);
        pf[p] = *reinterpret_cast<const float4*>(
            W + (size_t)(ch * KC + r) * d_out + col_tile + c4 * 4);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = tid + p * NT;
      if (i < V4) reinterpret_cast<float4*>(ws + buf * KC * TN)[i] = pf[p];
    }
  };
  fetch(0);
  stash(0);
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  float acc[RM][4 * CG];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * CG; ++j) acc[i][j] = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    const int tap = ch / nk, k0 = (ch - tap * nk) * KC;
    const float* cur = ws + (ch & 1) * KC * TN;
    if (ch + 1 < nch) fetch(ch + 1);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float bv[4 * CG];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            cur + kk * TN + g * (TN / CG) + 4 * tx);
        bv[4 * g] = b4.x; bv[4 * g + 1] = b4.y;
        bv[4 * g + 2] = b4.z; bv[4 * g + 3] = b4.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float av = xs[(size_t)(ty + TY * i + tap) * ldx + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4 * CG; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
      }
    }
    if (ch + 1 < nch) stash((ch + 1) & 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int g = row0 + ty + TY * i;
    if (g >= T) continue;
#pragma unroll
    for (int gg = 0; gg < CG; ++gg) {
      const int col = col_tile + gg * (TN / CG) + 4 * tx;
      const size_t o = (size_t)g * d_out + col;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][4 * gg + j] + bias[col + j];
        if (residual) v[j] += residual[o + j];
        if (accum) v[j] += accum[o + j];
        if (has_scale) v[j] *= out_scale;
        if (g >= valid) v[j] = 0.f;
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// wide: 128 columns, 4 x 8 a thread; narrow: 16 columns, 1 x 4 a thread
constexpr int WIDE_TN = 128, NARROW_TN = 16;

constexpr size_t smem_bytes(int d_in, int w, int tn) {
  return x_bytes(d_in, w) + 2 * (size_t)KC * tn * 4;
}

template <int TN, int RM, int CG>
int launch(const void* x, const void* W, const void* bias,
           const void* residual, const void* accum, void* out,
           const void* valid, int T, int d_in, int d_out, int w,
           int pre_lrelu, float slope, int has_scale, float out_scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes(d_in, w, TN));
  cudaError_t e = cudaFuncSetAttribute(
      folded_matmul_f32_kernel<TN, RM, CG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((T + TM - 1) / TM, d_out / TN);
  folded_matmul_f32_kernel<TN, RM, CG><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(W),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<const float*>(accum), static_cast<float*>(out),
      static_cast<const int*>(valid), T, d_in, d_out, w, pre_lrelu, slope,
      has_scale, out_scale);
  return cudaGetLastError();
}

}  // namespace f32v

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory one block needs (bf16: the bf16 x tile plus per-warp
// staging; float32, f32 = 1: the float32 x tile plus two W chunks of the
// widest column tile).
int folded_matmul_smem_bytes(int d_in, int w, int f32) {
  if (f32)
    return static_cast<int>(f32v::smem_bytes(d_in, w, f32v::WIDE_TN));
  const size_t xs = ((size_t)(TM + 2 * w) * (d_in + APAD) * 2 + 127) / 128 *
                    128;
  return static_cast<int>(xs + 8 * 256 * sizeof(float));
}

// W: bf16 (f32 = 0) or float32 (f32 = 1); x, bias, residual, accum and
// out float32.  D_in and D_out multiples of 16.
int folded_matmul_launch(const void* x, const void* W, const void* bias,
                         const void* residual, const void* accum, void* out,
                         const void* valid, int T, int d_in, int d_out, int w,
                         int pre_lrelu, float slope, int has_scale,
                         float out_scale, int f32, void* stream) {
  if (f32) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (d_out % f32v::WIDE_TN == 0)
      return f32v::launch<f32v::WIDE_TN, 4, 2>(
          x, W, bias, residual, accum, out, valid, T, d_in, d_out, w,
          pre_lrelu, slope, has_scale, out_scale, s);
    return f32v::launch<f32v::NARROW_TN, 1, 1>(
        x, W, bias, residual, accum, out, valid, T, d_in, d_out, w,
        pre_lrelu, slope, has_scale, out_scale, s);
  }
  const int smem = folded_matmul_smem_bytes(d_in, w, 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        folded_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  const int tile_cols = d_out < TN ? d_out : TN;
  dim3 grid((T + TM - 1) / TM, (d_out + TN - 1) / TN);
  dim3 block(32 * ((tile_cols + 15) / 16));
  folded_matmul_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(W),
      static_cast<const float*>(bias), static_cast<const float*>(residual),
      static_cast<const float*>(accum), static_cast<float*>(out),
      static_cast<const int*>(valid), T, d_in, d_out, w, pre_lrelu, slope,
      has_scale, out_scale);
  return cudaGetLastError();
}

}  // extern "C"
