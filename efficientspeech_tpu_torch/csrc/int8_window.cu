// int8 windowed deep-K matmul (kernel K5).
//
// Replaces: benchmarks/int8_pallas_probe.py::make_int8_kernel (the
// pl.pallas_call in run()).  Over x (t_pad + slice_rows, d_in), bf16 or
// int8, slice_rows = round_up(tm + n_win - 1, 8), and W (n_win d_in, d_out)
// int8, tile i of tm output rows is
//
//   slice   = x[i tm : i tm + slice_rows]
//   bf16 x: scale = max(max |slice|, 1e-6) * float32(1/127)
//           xq    = trunc_toward_zero(clip(slice / scale, -127, 127))
//   int8 x: scale = 1, xq = slice
//   out[i tm + r] = float(sum_j xq[r + j] . W[j d_in : (j + 1) d_in]) * scale
//
// with int8 x int8 products summed in int32.  The window is not centred
// (offsets 0 .. n_win - 1) and has no zero padding.  The maximum runs over
// the whole slice, the up to 7 rows past the window included, as the TPU
// kernel's does.
//
// Numerics: the scale is a multiply by float32(1/127), the quotient an
// IEEE division (__fdiv_rn) and the cast a truncation (__float2int_rz):
// the form in which XLA's CPU backend compiles the TPU kernel, so the plain
// version matches it bit for bit.  A different rounding anywhere moves an
// output by one quantisation step, about 6e-4 of its range.  The int32 sum
// is exact; the only rounding after it is the float32 multiply.
//
// What bounds it on an H100: bytes.  At the probe's shape (T 49,152,
// d_in = d_out = 128, n_win 5) the bf16 variant reads x (12.7 MB) and
// writes the float32 output (25.2 MB): 38.0 MB, 0.0113 ms at 3.35 TB/s,
// against 8.05 GOP, 0.0041 ms at 1,979 TOPS int8.  The TPU kernel builds
// the tm x n_win d_in window in VMEM (320 KB at the probe shape, more than
// a block has); here one block per tile holds the quantised slice
// (520 x 128 int8, 65 KB) and W transposed (128 x 640 int8, 80 KB) in
// shared memory and reads tap j of the window as a row offset of j into the
// slice.  The products run on the int8 tensor cores
// (mma.sync.m16n8k32.s8.s8.s32); shared-memory rows are padded by 16
// bytes, so each fragment load of a warp hits 32 distinct banks.  For bf16
// x the block reads its slice twice, once for the maximum and once to
// quantise, the second time from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int NT = WARPS * 32;
constexpr int WM = 32, WN = 64;  // output rows and columns of a warp tile
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int PADB = 16;         // bytes of padding per shared-memory row

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline size_t smem_bytes(int d_in, int d_out, int n_win,
                                             int slice_rows) {
  return align16((size_t)slice_rows * (d_in + PADB)) +
         (size_t)d_out * (n_win * d_in + PADB);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ signed char quantize(float v, float scale) {
  const float q = fminf(fmaxf(__fdiv_rn(v, scale), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rz(q));
}

template <bool QUANT>
__global__ void __launch_bounds__(NT, 1)
    int8_window_kernel(const void* __restrict__ x,
                       const signed char* __restrict__ w,
                       float* __restrict__ out, int d_in, int d_out,
                       int n_win, int tm, int slice_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];
  const int ldx = d_in + PADB, kdim = n_win * d_in, ldw = kdim + PADB;
  signed char* xq = reinterpret_cast<signed char*>(smem);
  signed char* wt = xq + align16((size_t)slice_rows * ldx);  // W^T
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)blockIdx.x * tm;

  // W^T into shared memory: wt[n][k] = W[k][n], four k per 32-bit store
  for (int i = tid; i < (kdim / 4) * d_out; i += NT) {
    const int k4 = i / d_out, n = i - k4 * d_out;
    const signed char* src = w + (size_t)k4 * 4 * d_out + n;
    const unsigned v = (unsigned)(unsigned char)src[0] |
                       ((unsigned)(unsigned char)src[d_out] << 8) |
                       ((unsigned)(unsigned char)src[2 * d_out] << 16) |
                       ((unsigned)(unsigned char)src[3 * d_out] << 24);
    *reinterpret_cast<unsigned*>(wt + n * ldw + k4 * 4) = v;
  }

  // the slice, quantised, into shared memory; eight values per step
  const int chunks = slice_rows * d_in / 8;
  float scale = 1.f;
  if (QUANT) {
    const __nv_bfloat16* xs =
        static_cast<const __nv_bfloat16*>(x) + row0 * d_in;
    float m = 0.f;
    for (int i = tid; i < chunks; i += NT) {
      const uint4 q = reinterpret_cast<const uint4*>(xs)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
    for (int i = 1; i < WARPS; ++i) m = fmaxf(m, red[i]);
    scale = __fmul_rn(fmaxf(m, 1e-6f), 1.0f / 127.0f);
    for (int i = tid; i < chunks; i += NT) {
      const int r = i * 8 / d_in, c = i * 8 - r * d_in;
      const uint4 q = reinterpret_cast<const uint4*>(xs)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
      unsigned packed[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        const unsigned lo = (unsigned char)quantize(f.x, scale);
        const unsigned hi = (unsigned char)quantize(f.y, scale);
        packed[j / 2] |= (lo | (hi << 8)) << (16 * (j % 2));
      }
      *reinterpret_cast<uint2*>(xq + r * ldx + c) =
          make_uint2(packed[0], packed[1]);
    }
  } else {
    const signed char* xs = static_cast<const signed char*>(x) + row0 * d_in;
    for (int i = tid; i < chunks; i += NT) {
      const int r = i * 8 / d_in, c = i * 8 - r * d_in;
      *reinterpret_cast<uint2*>(xq + r * ldx + c) =
          reinterpret_cast<const uint2*>(xs)[i];
    }
  }
  __syncthreads();

  // out tile (tm x d_out) in warp tiles of WM x WN; fragment layouts of
  // mma.m16n8k32 (PTX ISA): lane = 4 g + t
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = d_out / WN;
  for (int wt_i = warp; wt_i < (tm / WM) * tiles_n; wt_i += WARPS) {
    const int rm = (wt_i / tiles_n) * WM, cn = (wt_i % tiles_n) * WN;
    int acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;
    for (int j = 0; j < n_win; ++j) {
      for (int kc = 0; kc < d_in; kc += 32) {
        unsigned a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          // tap j reads the slice j rows further down
          const signed char* p = xq + (rm + mi * 16 + j + g) * ldx + kc + t * 4;
          a[mi][0] = *reinterpret_cast<const unsigned*>(p);
          a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * ldx);
          a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
          a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * ldx + 16);
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const signed char* p =
              wt + (cn + ni * 8 + g) * ldw + j * d_in + kc + t * 4;
          b[ni][0] = *reinterpret_cast<const unsigned*>(p);
          b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const size_t row = row0 + rm + mi * 16 + g + 8 * hr;
          const int col = cn + ni * 8 + t * 2;
          *reinterpret_cast<float2*>(out + row * d_out + col) = make_float2(
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * hr]), scale),
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * hr + 1]), scale));
        }
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block needs: the quantised slice and W^T.
int int8_window_smem_bytes(int d_in, int d_out, int n_win, int slice_rows) {
  return (int)smem_bytes(d_in, d_out, n_win, slice_rows);
}

// x (n_tiles tm + slice_rows, d_in): bf16 when quantize_in, else int8;
// w (n_win d_in, d_out) int8; out (n_tiles tm, d_out) float32.  d_in a
// multiple of 32, d_out of 64, tm of 32.  One block per tile.
int int8_window_launch(const void* x, const void* w, void* out,
                       int quantize_in, int d_in, int d_out, int n_win,
                       int tm, int slice_rows, int n_tiles, void* stream) {
  if (d_in % 32 || d_out % WN || tm % WM || n_tiles < 1)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(d_in, d_out, n_win, slice_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const signed char* wp = static_cast<const signed char*>(w);
  float* op = static_cast<float*>(out);
  cudaError_t e;
  if (quantize_in) {
    e = cudaFuncSetAttribute(int8_window_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    int8_window_kernel<true><<<n_tiles, NT, bytes, s>>>(
        x, wp, op, d_in, d_out, n_win, tm, slice_rows);
  } else {
    e = cudaFuncSetAttribute(int8_window_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    int8_window_kernel<false><<<n_tiles, NT, bytes, s>>>(
        x, wp, op, d_in, d_out, n_win, tm, slice_rows);
  }
  return cudaGetLastError();
}

}  // extern "C"
