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
// is exact, and the maximum is exact in any order; the only rounding after
// the sum is the float32 multiply.
//
// What bounds it on an H100: bytes.  At the probe's shape (T 49,152,
// d_in = d_out = 128, n_win 5, tm 512) the bf16 variant reads x (12.7 MB)
// and writes the float32 output (25.2 MB): 38.0 MB, 0.0113 ms at 3.35
// TB/s, against 8.05 GOP, 0.0041 ms at 1,979 TOPS int8.  One block per
// tile (the first port) gave 96 blocks on 132 SMs, each running its phases
// one after another; the design here spreads each tile over a cluster and
// overlaps the phases of two blocks on every SM:
//
// - Each tile of tm rows is split over a thread-block cluster of cs blocks
//   (4 of 128 rows at tm = 512: 384 blocks, two resident on each SM at
//   about 100 KB of shared memory each).  The plan (cs, rows per block,
//   shared-memory offsets) is made in Python (int8_window.py::plan).
// - Block r reads a disjoint share of the slice's rows from device memory
//   once, into registers, with 16-byte loads: rows [r rb, (r + 1) rb), the
//   last block up to slice_rows; the n_win - 1 halo rows below its output
//   rows (the next block's) come along, from L2.  It takes the maximum of
//   its share; the blocks exchange the partial maxima through distributed
//   shared memory across one cluster barrier, so every block derives the
//   same scale bit for bit, and quantise their rows into a padded int8
//   tile.  The quotient is v * (1 / scale), within 3e-5 of the IEEE
//   quotient, with the division made only where that lies within 1e-4 of
//   an integer, so the truncation is the division's.
// - W^T, the products' K-major B, is built once per call by a pre-pass
//   kernel that reads W as 32-bit words (16 k rows x 4 columns a thread)
//   and transposes them with __byte_perm (no byte gathers), straight into
//   wgmma's 128-byte-swizzled K-major layout in a scratch.  Each block
//   takes it with one bulk asynchronous copy (the TMA unit's non-tensor
//   mode), in flight while the block loads, reduces and quantises.
// - Products by wgmma.m64nNk32.s32.s8.s8 (N = 128, or 64), two warpgroups
//   a block, A from registers (ldmatrix of the int8 tile at row offset j
//   for tap j: one copy of the tile), B from the swizzled W^T.
// - The epilogue writes float32 rows straight from the accumulators, one
//   lane exchange making each store 16 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 256;          // two warpgroups
constexpr int PADB = 16;         // bytes of padding per int8-tile row
constexpr int MAXV = 16;         // 16-byte chunks of a share per thread
constexpr int MAXH = 2;          // 16-byte chunks of the halo per thread

struct Params {
  const void* x;
  float* out;
  const unsigned char* wt_g;  // W^T in the swizzled layout, from the pre-pass
  int d_in, d_out, n_win, tm, slice_rows;
  int cs, rb;                 // blocks a cluster (a tile), output rows a block
  // shared-memory byte offsets from the 1024-aligned base (W^T at 0): the
  // int8 tile, the partial maxima, W^T's mbarrier; W^T's bytes
  int xq_off, pmax_off, bar_off, wt_bytes;
};

// D (64 x 64, int32) += A (64 x 32 int8, registers) * B (32 x 64 int8,
// shared memory, descriptor `desc`, K-major); D = A * B when !accumulate
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D (64 x 128, int32) += A (64 x 32 int8, registers) * B (32 x 128 int8,
// shared memory, descriptor `desc`, K-major); D = A * B when !accumulate
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <int TN>
__device__ __forceinline__ void wgmma_s8(int (&d)[TN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  if constexpr (TN == 128) wgmma_s8_n128(d, a, desc, accumulate);
  else wgmma_s8_n64(d, a, desc, accumulate);
}

// Byte offset of W^T element (n, k) in wgmma's K-major layout with the
// 128-byte swizzle: atoms of 8 rows (n) x 128 bytes (k), 16-byte chunks
// XORed with the row, the d_out / 8 row groups of a 128-byte k block 1024
// bytes apart (the descriptor's stride byte offset), k blocks after one
// another.
__host__ __device__ __forceinline__ uint32_t wt_offset(int n, int k,
                                                       int d_out) {
  const int r = n & 7;
  return ((k >> 7) * (d_out >> 3) + (n >> 3)) * 1024 + r * 128 +
         ((((k & 127) >> 4) ^ r) << 4) + (k & 15);
}

// descriptor of the 32 (k) x TN (n) slice at k (a multiple of 32), n0
__device__ __forceinline__ uint64_t wt_desc(uint32_t base, int k, int n0,
                                            int d_out) {
  const uint32_t addr = base + wt_offset(n0, k, d_out);
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// trunc(clip(v / scale, -127, 127)) with v / scale the IEEE quotient.
// v * inv (inv = 1 / scale rounded) lies within 3e-5 of the quotient for
// |v / scale| <= 127, so it truncates alike unless it lies within 1e-4 of
// an integer: only then is the division made.
__device__ __forceinline__ unsigned quantize(float v, float scale,
                                             float inv) {
  float q = v * inv;
  if (fabsf(q - rintf(q)) < 1e-4f) q = __fdiv_rn(v, scale);
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (unsigned char)static_cast<signed char>(__float2int_rz(q));
}

// eight bf16 values -> eight int8 at `scale`
__device__ __forceinline__ uint2 quantize8(uint4 q, float scale, float inv) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  unsigned packed[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    packed[j / 2] |= (quantize(f.x, scale, inv) |
                      (quantize(f.y, scale, inv) << 8))
                     << (16 * (j % 2));
  }
  return make_uint2(packed[0], packed[1]);
}

__device__ __forceinline__ float absmax8(uint4 q) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
  }
  return m;
}

// W (kdim, d_out) -> W^T in the swizzled layout of wt_offset: a thread
// reads one unit of 16 k rows x 4 columns as 32-bit words and writes the
// 4 columns' 16-byte chunks, transposed with __byte_perm (no byte gathers)
__global__ void __launch_bounds__(256)
    wt_prepass(const signed char* __restrict__ w,
               unsigned char* __restrict__ wt, int kdim, int d_out) {
  const int n4s = d_out / 4;
  const int u = blockIdx.x * 256 + threadIdx.x;
  if (u >= (kdim / 16) * n4s) return;
  const int k16 = u / n4s, n4 = u - k16 * n4s;
  unsigned r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    r[i] = *reinterpret_cast<const unsigned*>(
        w + (size_t)(k16 * 16 + i) * d_out + n4 * 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // column n4 * 4 + j, k16 * 16 .. + 15
    const unsigned sel = j | ((4 + j) << 4);  // byte j of a, of b
    unsigned o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o[q] = __byte_perm(__byte_perm(r[4 * q], r[4 * q + 1], sel),
                         __byte_perm(r[4 * q + 2], r[4 * q + 3], sel),
                         0x5410);
    *reinterpret_cast<uint4*>(wt + wt_offset(n4 * 4 + j, k16 * 16, d_out)) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <bool QUANT, int TN>
__global__ void __launch_bounds__(NT, 2)
    int8_window_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  signed char* xq = reinterpret_cast<signed char*>(smem + p.xq_off);
  float* pmax = reinterpret_cast<float*>(smem + p.pmax_off);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d_in = p.d_in, d_out = p.d_out, n_win = p.n_win;
  const int ldx = d_in + PADB;
  const int rank = (int)sm90::cluster_rank();
  const size_t base = (size_t)(blockIdx.x / p.cs) * p.tm;  // slice row 0
  const int r0 = rank * p.rb;                  // this block's rows, in the
  const int r1 = min(r0 + p.rb, p.tm);         // tile: [r0, r1)
  const int s1 = rank == p.cs - 1 ? p.slice_rows : r0 + p.rb;  // share end
  const int q1 = r1 + n_win - 1;               // quantised rows [r0, q1)
  const int cpr = d_in / 8;                    // 8-value chunks a row

  // 1. W^T, one bulk copy in flight until the products; this block's
  // share of the slice and the halo rows past it into registers (bf16 x)
  if (tid == 0) {
    sm90::mbar_init(wbar, 1);
    sm90::fence_mbar_init();
    sm90::mbar_expect_tx(wbar, p.wt_bytes);
    sm90::bulk_g2s(smem, p.wt_g, p.wt_bytes, wbar);
  }
  uint4 v[MAXV], hv[MAXH];
  const int share = (s1 - r0) * cpr, halo = max(q1 - s1, 0) * cpr;
  float scale = 1.f;
  if (QUANT) {
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.x) + (base + r0) * d_in);
#pragma unroll
    for (int k = 0; k < MAXV; ++k)
      if (tid + k * NT < share) v[k] = src[tid + k * NT];
#pragma unroll
    for (int k = 0; k < MAXH; ++k)
      if (tid + k * NT < halo) hv[k] = src[share + tid + k * NT];

    // 2. the share's maximum, exchanged across the cluster
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < MAXV; ++k)
      if (tid + k * NT < share) m = fmaxf(m, absmax8(v[k]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) pmax[1 + warp] = m;
    __syncthreads();
    if (tid == 0) {
      for (int k = 1; k < NT / 32; ++k) m = fmaxf(m, pmax[1 + k]);
      pmax[0] = m;
    }
    sm90::cluster_sync();  // every block's partial maximum is out
    m = 0.f;
    for (int b = 0; b < p.cs; ++b)
      m = fmaxf(m, sm90::ld_cluster_f32(sm90::map_to_rank(pmax, b)));
    sm90::cluster_arrive_relaxed();  // done reading the other blocks
    scale = __fmul_rn(fmaxf(m, 1e-6f), 1.0f / 127.0f);
    const float inv = 1.0f / scale;

    // 3. rows [r0, q1), quantised, into the padded int8 tile
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int i = tid + k * NT;
      const int r = i / cpr, c = (i - r * cpr) * 8;
      if (i < share && r0 + r < q1)
        *reinterpret_cast<uint2*>(xq + r * ldx + c) =
            quantize8(v[k], scale, inv);
    }
#pragma unroll
    for (int k = 0; k < MAXH; ++k) {
      const int i = tid + k * NT;
      const int r = s1 - r0 + i / cpr, c = (i % cpr) * 8;
      if (i < halo)
        *reinterpret_cast<uint2*>(xq + r * ldx + c) =
            quantize8(hv[k], scale, inv);
    }
  } else {
    const int c16 = d_in / 16;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const signed char*>(p.x) + (base + r0) * d_in);
    for (int i = tid; i < (q1 - r0) * c16; i += NT) {
      const int r = i / c16, c = (i - r * c16) * 16;
      *reinterpret_cast<uint4*>(xq + r * ldx + c) = src[i];
    }
  }
  __syncthreads();
  sm90::mbar_wait(wbar, 0);

  // 4. the block's (r1 - r0) x d_out outputs in passes of 64 rows x TN
  // columns, alternate passes to the two warpgroups; tap j reads the int8
  // tile j rows further down
  const int wg = tid / 128, wwarp = warp & 3;
  const uint32_t wt_addr = sm90::smem_u32(smem);
  const int n_cb = d_out / TN, n_pass = ((r1 - r0 + 63) / 64) * n_cb;
  const int t4 = lane & 3, g8 = lane >> 2, odd = t4 & 1;
  const int ccol = odd * 8 + (t4 >> 1) * 4;
  for (int ps = wg; ps < n_pass; ps += 2) {
    const int m0 = (ps / n_cb) * 64, n0 = (ps % n_cb) * TN;
    int acc[TN / 2];
    int accumulate = 0;
    for (int j = 0; j < n_win; ++j) {
      for (int kc = 0; kc < d_in; kc += 128) {
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (kc + 32 * s < d_in)
            sm90::ldmatrix_x4(a[s], xq + (m0 + wwarp * 16 + j + (lane & 15)) *
                                             ldx + kc + 32 * s +
                                             (lane >> 4) * 16);
        sm90::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (kc + 32 * s < d_in) {
            wgmma_s8<TN>(acc, a[s],
                         wt_desc(wt_addr, j * d_in + kc + 32 * s, n0, d_out),
                         accumulate);
            accumulate = 1;
          }
        sm90::wgmma_commit();
      }
    }
    sm90::wgmma_wait_all();
#pragma unroll
    for (int e = 0; e < TN / 2; ++e) sm90::reg_fence(acc[e]);

    // epilogue (the accumulator layout of wgmma: lane 4g + t holds rows g
    // and g + 8, columns 8j + 2t, 8j + 2t + 1 of each 8-column block j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wwarp * 16 + g8 + 8 * h;
#pragma unroll
      for (int jj = 0; jj < TN / 16; ++jj) {
        const float a0 = __fmul_rn(__int2float_rn(acc[8 * jj + 2 * h]), scale);
        const float a1 =
            __fmul_rn(__int2float_rn(acc[8 * jj + 2 * h + 1]), scale);
        const float b0 =
            __fmul_rn(__int2float_rn(acc[8 * jj + 4 + 2 * h]), scale);
        const float b1 =
            __fmul_rn(__int2float_rn(acc[8 * jj + 4 + 2 * h + 1]), scale);
        const float r0v = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
        const float r1v = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
        if (r < r1 - r0)
          *reinterpret_cast<float4*>(
              p.out + (base + r0 + r) * d_out + n0 + 16 * jj + ccol) =
              odd ? make_float4(r0v, r1v, b0, b1) : make_float4(a0, a1, r0v, r1v);
      }
    }
  }
  if (QUANT) sm90::cluster_wait();  // the others are done reading this one
}

template <bool QUANT, int TN>
int launch(const Params& p, const signed char* w, unsigned char* wt_g,
           int n_tiles, int smem, cudaStream_t stream) {
  const int kdim = p.n_win * p.d_in;
  const int units = (kdim / 16) * (p.d_out / 4);
  wt_prepass<<<(units + 255) / 256, 256, 0, stream>>>(w, wt_g, kdim,
                                                       p.d_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_window_kernel<QUANT, TN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * p.cs);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, int8_window_kernel<QUANT, TN>, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n_tiles tm + slice_rows, d_in): bf16 when quantize_in, else int8;
// w (n_win d_in, d_out) int8; wt_g scratch of wt_bytes for W^T; out
// (n_tiles tm, d_out) float32.  Launches the W^T pre-pass, then the
// kernel.  The plan (cluster size cs, rows a block rb, shared-memory
// layout and size) comes from int8_window.py::plan.
int int8_window_launch(const void* x, const void* w, void* wt_g, void* out,
                       int quantize_in, int d_in, int d_out, int n_win,
                       int tm, int slice_rows, int n_tiles, int cs, int rb,
                       int xq_off, int pmax_off, int bar_off, int wt_bytes,
                       int smem, void* stream) {
  if (d_in % 32 || d_out % 64 || tm % 32 || rb % 32 || n_tiles < 1 ||
      cs < 1 || cs > 8 || (cs - 1) * rb >= tm || cs * rb < tm ||
      max(rb, slice_rows - (cs - 1) * rb) * d_in / 8 > MAXV * NT ||
      (n_win - 1) * d_in / 8 > MAXH * NT)
    return cudaErrorInvalidValue;
  unsigned char* wt = static_cast<unsigned char*>(wt_g);
  const Params p{x, static_cast<float*>(out), wt, d_in, d_out, n_win, tm,
                 slice_rows, cs, rb, xq_off, pmax_off, bar_off, wt_bytes};
  const signed char* wp = static_cast<const signed char*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_out % 128 == 0)
    return quantize_in ? launch<true, 128>(p, wp, wt, n_tiles, smem, s)
                       : launch<false, 128>(p, wp, wt, n_tiles, smem, s);
  return quantize_in ? launch<true, 64>(p, wp, wt, n_tiles, smem, s)
                     : launch<false, 64>(p, wp, wt, n_tiles, smem, s);
}

}  // extern "C"
