// LayerNorm over the last dim, forward and backward (kernel K3).
//
// Replaces: efficientspeech_tpu/ops/pallas/layer_norm.py::layer_norm_fused
// (_fwd_kernel, _bwd_kernel and the custom VJP).  For x (rows, C), C = 128
// or 256, bf16 or float32:
//
//   forward   y  = (x - mean) * rstd * scale + bias, cast to x's type,
//             mean and rstd = 1/sqrt(var + eps) in float32;
//   backward  the statistics are recomputed from x (nothing is saved but x
//             and scale), g = dy * scale,
//             dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//             and one float32 partial row of dscale = sum(dy * xhat) and
//             dbias = sum(dy) per block, summed over blocks by the caller.
//
// What bounds it on an H100: bytes.  At the training shape (131,072 rows
// of 128 bf16) the forward reads x and writes y (67 MB, 0.020 ms at
// 3.35 TB/s); the backward reads x and dy and writes dx (100 MB); the
// arithmetic is a few dozen FLOP per element.  The design touches each
// element once: one warp owns a row, each lane holds C/32 contiguous
// values in registers (one 8- or 16-byte load), the row statistics are
// warp-shuffle sums in float32, and no mean/rstd or float32 copy of x is
// ever written.  The backward runs a fixed grid of blocks that stride over
// the rows; each lane keeps its columns' dscale/dbias sums in registers,
// the block adds its warps' sums in a fixed order, and writes one partial
// row: no float atomics, so the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + i);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[i] = __low2float(a); v[i + 1] = __high2float(a);
    v[i + 2] = __low2float(b); v[i + 3] = __high2float(b);
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[i], v[i + 1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[i + 2], v[i + 3]);
    uint2 q;
    q.x = *reinterpret_cast<unsigned*>(&a);
    q.y = *reinterpret_cast<unsigned*>(&b);
    *reinterpret_cast<uint2*>(p + i) = q;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mean and rstd of one row held across the warp, N values per lane
template <int N>
__device__ __forceinline__ void row_stats(const float (&v)[N], int c,
                                          float eps, float& mean,
                                          float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += v[i];
  mean = warp_sum(s) / c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  rstd = 1.f / sqrtf(warp_sum(q) / c + eps);
}

template <typename T, int C>
__global__ void __launch_bounds__(WARPS * 32)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  int rows, float eps) {
  constexpr int N = C / 32;
  const int lane = threadIdx.x & 31;
  const int col = lane * N;
  float s[N], b[N];
  load_row<N>(scale + col, s);
  load_row<N>(bias + col, b);
  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += stride) {
    float v[N];
    load_row<N>(x + (size_t)row * C + col, v);
    float mean, rstd;
    row_stats<N>(v, C, eps, mean, rstd);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (v[i] - mean) * rstd * s[i] + b[i];
    store_row<N>(y + (size_t)row * C + col, v);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(WARPS * 32)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const T* __restrict__ dy, T* __restrict__ dx,
                  float* __restrict__ ds_part, float* __restrict__ db_part,
                  int rows, float eps) {
  constexpr int N = C / 32;
  __shared__ float red[2][WARPS][C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = lane * N;
  float s[N], ds[N], db[N];
  load_row<N>(scale + col, s);
#pragma unroll
  for (int i = 0; i < N; ++i) ds[i] = db[i] = 0.f;
  const int stride = gridDim.x * WARPS;
  for (int row = blockIdx.x * WARPS + warp; row < rows; row += stride) {
    float v[N], g[N];
    load_row<N>(x + (size_t)row * C + col, v);
    load_row<N>(dy + (size_t)row * C + col, g);
    float mean, rstd;
    row_stats<N>(v, C, eps, mean, rstd);
    float gs = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = (v[i] - mean) * rstd;   // xhat
      ds[i] += g[i] * v[i];
      db[i] += g[i];
      g[i] *= s[i];
      gs += g[i];
      gx += g[i] * v[i];
    }
    const float gm = warp_sum(gs) / C, gxm = warp_sum(gx) / C;
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = rstd * (g[i] - gm - v[i] * gxm);
    store_row<N>(dx + (size_t)row * C + col, g);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red[0][warp][col + i] = ds[i];
    red[1][warp][col + i] = db[i];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 2 * C; k += blockDim.x) {
    const int which = k / C, c = k - which * C;
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += red[which][w][c];
    (which ? db_part : ds_part)[(size_t)blockIdx.x * C + c] = acc;
  }
}

template <typename T>
int launch_fwd(const void* x, const void* s, const void* b, void* y,
               int rows, int c, float eps, int grid, cudaStream_t st) {
  if (c == 128)
    ln_fwd_kernel<T, 128><<<grid, WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(s),
        static_cast<const float*>(b), static_cast<T*>(y), rows, eps);
  else if (c == 256)
    ln_fwd_kernel<T, 256><<<grid, WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(s),
        static_cast<const float*>(b), static_cast<T*>(y), rows, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* s, const void* dy, void* dx,
               void* ds_part, void* db_part, int rows, int c, float eps,
               int grid, cudaStream_t st) {
  if (c == 128)
    ln_bwd_kernel<T, 128><<<grid, WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(s),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(ds_part), static_cast<float*>(db_part), rows,
        eps);
  else if (c == 256)
    ln_bwd_kernel<T, 256><<<grid, WARPS * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const float*>(s),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(ds_part), static_cast<float*>(db_part), rows,
        eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows per block of both kernels (one warp per row at a time)
int layer_norm_rows_per_block() { return WARPS; }

// is_bf16: 1 for bf16 x/y, 0 for float32.  grid: blocks (any count >= 1;
// the blocks stride over the rows).
int layer_norm_fwd_launch(const void* x, const void* scale, const void* bias,
                          void* y, int rows, int c, int is_bf16, float eps,
                          int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_fwd<__nv_bfloat16>(x, scale, bias, y, rows, c, eps,
                                         grid, st)
             : launch_fwd<float>(x, scale, bias, y, rows, c, eps, grid, st);
}

// ds_part, db_part: (grid, c) float32, one partial row per block.
int layer_norm_bwd_launch(const void* x, const void* scale, const void* dy,
                          void* dx, void* ds_part, void* db_part, int rows,
                          int c, int is_bf16, float eps, int grid,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(x, scale, dy, dx, ds_part,
                                             db_part, rows, c, eps, grid, st)
                 : launch_bwd<float>(x, scale, dy, dx, ds_part, db_part,
                                     rows, c, eps, grid, st);
}

}  // extern "C"
