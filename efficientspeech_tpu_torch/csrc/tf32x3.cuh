// Float32 products on Hopper's tensor cores by 3xTF32 split products,
// shared by the float32 variants of folded_matmul (K1) and mrf_fused (K2).
//
// A TF32 tensor core reads the top 19 bits of a float32 (sign, exponent,
// 10 mantissa bits).  Each operand is split as x = hi + lo, hi = x rounded
// to TF32 (cvt.rna: to nearest, ties away from zero) with its low 13 bits
// zero, and lo = x - hi (exact in float32), itself rounded to TF32.  Then
//
//   x y ~= lo_x hi_y + hi_x lo_y + hi_x hi_y
//
// with float32 sums, the small terms first; lo_x lo_y (2^-22 of x y) is
// dropped.  Each product of two TF32 values is exact in float32, so the
// result carries about 21 bits per product against float32's 24: held to
// a plain float32 product at SNR >= 90 dB (TF32 alone lands near 65 dB).
//
// The layout both kernels use (wgmma takes .tf32 operands K-major only,
// with no transpose): A, the weights, comes from registers; B, the
// activations, from shared memory in the no-swizzle ("interleave") K-major
// layout with the rows (wgmma's N) 16 bytes apart, so a chunk of 4
// channels of R rows is one run of R * 16 bytes and chunk c starts at
// c * R * 16.  Core matrices (8 rows x 16 bytes) are then contiguous 128
// bytes, and a window tap j, which reads rows j, j + 1, ..., is the same
// descriptor started j * 16 bytes further: no shifted copies.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace tf32x3 {

// x rounded to TF32 (nearest, ties away), as float32 bits, low 13 bits zero
__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// x = hi + lo, both TF32 (lo rounded after hi is taken; its low bits,
// which the tensor core does not read, are left as cvt leaves them)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ float4 split4(float4 v, float4& lo) {
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// descriptor of B (8 channels x N rows from row 0 at `addr`, a 16-byte
// aligned shared address) in the layout above: core matrices of 8 rows
// 128 bytes apart (stride byte offset), the second 4 channels `chunk`
// bytes on (leading byte offset), no swizzle.  The address sits in the
// low bits in 16-byte units, so desc(addr + 16 k) = desc(addr) + k.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t chunk) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((chunk >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D (64 x 64, float32) += A (64 x 8 TF32, registers) * B (8 x 64 TF32,
// descriptor `d`, K-major); D = A * B when !accumulate.  A's register
// fragment: warp q of the warpgroup holds rows 16 q .. 16 q + 15, lane
// 4 g + t rows g (a[0], a[2]) and g + 8 (a[1], a[3]) at columns t (a[0],
// a[1]) and t + 4 (a[2], a[3]).  D's: lane 4 g + t holds, for each
// 8-column block j, rows g (d[4 j], d[4 j + 1]) and g + 8 (d[4 j + 2],
// d[4 j + 3]) at columns 8 j + 2 t and 8 j + 2 t + 1.
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same for B 8 x 128 and D 64 x 128
__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same for B 8 x 16 and D 64 x 16
__device__ __forceinline__ void mma_n16(float (&d)[8], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the three split products of one k-step into d, small terms first
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N / 2], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint64_t bhi,
                                     uint64_t blo, int accumulate) {
  if constexpr (N == 128) {
    mma_n128(d, alo, bhi, accumulate);
    mma_n128(d, ahi, blo, 1);
    mma_n128(d, ahi, bhi, 1);
  } else if constexpr (N == 64) {
    mma_n64(d, alo, bhi, accumulate);
    mma_n64(d, ahi, blo, 1);
    mma_n64(d, ahi, bhi, 1);
  } else {
    static_assert(N == 16, "N is 128, 64 or 16");
    mma_n16(d, alo, bhi, accumulate);
    mma_n16(d, ahi, blo, 1);
    mma_n16(d, ahi, bhi, 1);
  }
}

// A's fragment of one k-step, split: `raw` holds the weights at (row g,
// k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's 16 rows
__device__ __forceinline__ void split_a(const float (&raw)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(raw[i], hi[i], lo[i]);
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The k loop both kernels share, for a warpgroup: `nsteps` k-steps (a
// multiple of R) of 8 k rows.  load(s, raw) fetches step s's A fragment
// from L2 into a ring of R register slots, PD steps ahead of its use
// (PD < R); issue(s, hi, lo) issues step s's products.  A's split
// registers rotate through four sets; two commit groups stay in flight
// while the next step's fragment is split (three measured slower in
// mrf_fused, one slower in both).  Returns with every product complete.
template <int PD, int R, class Load, class Issue>
__device__ __forceinline__ void k_loop(int nsteps, Load&& load,
                                       Issue&& issue) {
  static_assert(PD < R && R % 4 == 0, "ring of R slots, PD ahead");
  float raw[R][4];
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int s = 0; s < PD; ++s) load(s, raw[s]);
  for (int s0 = 0; s0 < nsteps; s0 += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int s = s0 + u;
      if (s + PD < nsteps) load(s + PD, raw[(u + PD) % R]);
      split_a(raw[u], hi[u & 3], lo[u & 3]);
      sm90::wgmma_fence();
      issue(s, hi[u & 3], lo[u & 3]);
      sm90::wgmma_commit();
      wait_group<2>();  // step s - 2 is done
    }
  }
  sm90::wgmma_wait_all();
}

}  // namespace tf32x3
