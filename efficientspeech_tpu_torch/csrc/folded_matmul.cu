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
// bf16 variant (W bf16; the serving dtype of bf16 requests).
//
// What bounds it on an H100: bytes.  At the vocoder's shapes (D_in = 128,
// 2w+1 = 3 taps, D_out 16..512) an output element takes 2*3*128 = 768 FLOP
// against 4 bytes written and 4 read per input element: 33.7 MB and
// 0.034 ms per 2,048-frame utterance at 3.35 TB/s, against 0.006 ms of
// bf16 tensor-core work.  So the design moves each byte once and keeps the
// copies in flight while the tensor cores and the epilogue run:
//
// - Persistent blocks.  One block per SM owns a column panel of TN columns
//   (TN = 128, or D_out's largest power of two below it: 16 for the post
//   conv) and walks that panel's row tiles (64 rows, 128 where TN <= 32).
//   Its two warpgroups take alternate tiles, each with its own x stage and
//   A tile, so one converts or writes while the other multiplies: with
//   one warpgroup an SM's conversion and epilogue ran one after the other
//   and bounded every op (0.083 ms per utterance with no products at all).
//   The tile plan (TN, warpgroups, resident or streamed W, shared-memory
//   offsets, grid) is made in Python (ops/kernels/folded_matmul.py::plan)
//   and handed to the launch.
// - W is loaded once per block.  The whole panel of the window, (2w+1) *
//   D_in rows x TN bf16 (96 KB at w = 1, 160 KB at w = 2, which leaves room
//   for one warpgroup), goes into shared memory at the block's start with
//   cp.async, in flight while the first x tile lands and is converted
//   (an mbarrier counts the threads' copies in).  It lands in the layout
//   wgmma reads an MN-major B from with the widest swizzle a panel row
//   allows (128, 64 or 32 bytes), so W keeps its own row-major (K, N)
//   order in device memory and nothing is transposed; without the swizzle
//   the panel's 16-byte chunks sat 6 KB apart on the same banks, and the
//   load and the products ran 1.3x slower.  Where the panel does not fit
//   (the w = 13 resblock op: 864 KB), W streams one tap at a time through
//   one slot a warpgroup; that path is correct, not fast.  Where even one
//   warpgroup's x stage does not fit beside the slot and its A tile
//   (HiFi-GAN V1's first upsampler: D_in 512, a 135 KB stage), the plan
//   gives it no stage (x_bytes 0) and the converter reads x from device
//   memory.
// - x arrives by bulk asynchronous copies (the TMA unit's non-tensor mode,
//   completing on an mbarrier): a tile's rows and its 2w halo rows are
//   contiguous in device memory, so one copy fills a stage and no tensor
//   map is encoded on the host.  The copy takes the rows inside [0, T);
//   the converter writes zeros for the others.  A warpgroup issues its
//   next tile's copy as soon as its stage is converted, so the copy is in
//   flight during the products and the epilogue.
// - One converter pass applies the leaky-relu and rounds to bf16, once per
//   row of tile and halo, into a padded bf16 tile (row stride D_in + 8, so
//   ldmatrix is free of bank conflicts).  Tap j reads that one tile j rows
//   down: ldmatrix at row offset j gives wgmma's A in registers.  One copy
//   (18 KB at w = 1) rather than 2w+1 shifted copies in a swizzled layout
//   (54 KB), which would cost a warpgroup.
// - Products by wgmma.m64nTNk16 (bf16 x bf16 -> float32, A in registers, B
//   from shared memory), 4 k-steps of 16 per commit group.
// - The epilogue works from the accumulator registers: one exchange
//   between neighbouring lanes gives each lane 4 consecutive columns, so
//   every store is 16 bytes, with bias (held in registers for the block's
//   panel), residual, accumulator, scale and the valid-row mask fused.
//   `valid` is read from device memory (the host never waits for the
//   acoustic model's mel length); a tile whose rows all lie at or beyond
//   it (the speculative buffer's tail) loads nothing and writes zeros.
//
// Numerics: bf16 operands (W as given, the activations rounded once),
// float32 sums.  Against the plain float32 version this is held to SNR >=
// 35 dB.
//
// The float32 variant (W float32, the serving dtype of --precision f32)
// keeps float32 accuracy on the tensor cores by 3xTF32 split products
// (csrc/tf32x3.cuh): 3 x 2 * 3 * 128 TF32 FLOP an output element against
// 494.7 TFLOP/s, 10.19 GFLOP and 0.062 ms per 2,048-frame utterance,
// against 0.152 ms of float32 FFMA.  wgmma takes TF32 operands K-major
// only, so the product runs transposed, y^T = W^T act(x)^T:
// - A is W^T from registers: each warp loads its 16 output columns x 8
//   k rows of W straight from L2 (row-major W, 32-byte runs, no transpose
//   anywhere), two k-steps ahead of its use, and splits them in
//   registers (tf32x3::k_loop).  Each element of W is loaded once per
//   tile.
// - B is the activated x tile with its 2w halo rows, split once into a
//   hi and a lo copy in shared memory in the layout of tf32x3.cuh: rows
//   16 bytes apart within each chunk of 4 channels, so tap j's B is the
//   same descriptor started j rows further, and wgmma's N is the tile's
//   rows: 64 or 128 a warpgroup.
// - A block is two warpgroups: for D_out a multiple of 128 each takes 64
//   output columns of a 128-column panel over the same rows; for a
//   narrower D_out (the post conv's 16) both take the panel, padded to
//   wgmma's 64 (the padding loads zeros), over the two halves of the
//   tile's rows.  The tile plan comes from folded_matmul.py::f32_plan.
// - Per k-step, three wgmma.m64nNk8 (N = 64 or 128 rows; lo x hi, hi x
//   lo, hi x hi) into the same float32 accumulators; the A registers
//   rotate through four sets and two commit groups stay in flight.
// - The epilogue moves the accumulators through shared memory so that
//   every device-memory access is a 16-byte run of a row (scalar stores
//   straight from the accumulator layout took a third of the kernel's
//   time), with bias, residual, accum, scale and rows >= valid zero
//   (valid read from device memory); a tile whose rows all lie at or
//   beyond valid loads nothing and writes zeros.
// Held to the plain version at SNR >= 90 dB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

namespace bf16v {

constexpr int NT = 128;   // one warpgroup
constexpr int APAD = 8;   // bf16 padding of an A-tile row (16 bytes)

// D (64 x 16, float32) += A (64 x 16 bf16, registers) * B (16 x 16 bf16,
// shared memory, descriptor `desc`, MN-major); D = A * B when !accumulate
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D (64 x 32, float32) += A (64 x 16 bf16, registers) * B (16 x 32 bf16,
// shared memory, descriptor `desc`, MN-major); D = A * B when !accumulate
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16,
// shared memory, descriptor `desc`, MN-major); D = A * B when !accumulate
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16 bf16, registers) * B (16 x 128 bf16,
// shared memory, descriptor `desc`, MN-major); D = A * B when !accumulate
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

template <int TN>
__device__ __forceinline__ void wgmma_tn(float (&d)[TN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  if constexpr (TN == 128) wgmma_n128(d, a, desc, accumulate);
  else if constexpr (TN == 64) wgmma_n64(d, a, desc, accumulate);
  else if constexpr (TN == 32) wgmma_n32(d, a, desc, accumulate);
  else wgmma_n16(d, a, desc, accumulate);
}

// W's panel (k_rows x TN bf16) in wgmma's MN-major layout with the widest
// swizzle a row of the panel allows: atoms of 8 k rows x SW bytes
// (SW = 128, 64 or 32 B = 64, 32 or 16 columns), 16-byte chunks XORed
// with the row (Swizzle<3|2|1, 4, 3>), column atoms k_rows * SW bytes
// apart (the descriptor's leading byte offset), 8-row groups 8 * SW
// bytes apart (its stride byte offset).  Needs a 1024-byte aligned base.
template <int TN>
struct BLayout {
  static constexpr int SW = TN * 2 < 128 ? TN * 2 : 128;
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;

  // byte offset of the 16-byte chunk holding columns n .. n + 7 of row k
  static __device__ __forceinline__ uint32_t offset(int k, int n,
                                                    int k_rows) {
    const uint32_t o = k * SW + (n % (SW / 2)) * 2;
    return (n / (SW / 2)) * k_rows * SW + (o ^ (((o >> 7) & (SW / 16 - 1))
                                                << 4));
  }
  // descriptor of the 16 x TN slice starting at row k0 (a multiple of 16)
  static __device__ __forceinline__ uint64_t desc(uint32_t base, int k0,
                                                  int k_rows) {
    const uint32_t addr = base + k0 * SW;
    return (uint64_t)((addr >> 4) & 0x3FFF) |
           ((uint64_t)((k_rows * SW) >> 4 & 0x3FFF) << 16) |
           ((uint64_t)((8 * SW) >> 4) << 32) | (MODE << 62);
  }
};

struct Params {
  const float* x;
  const __nv_bfloat16* W;
  const float* bias;
  const float* residual;
  const float* accum;
  float* out;
  const int* valid;
  int T, d_in, d_out, w;
  int pre_lrelu;
  float slope;
  int has_scale;
  float out_scale;
  // the plan: warpgroups a block (each with its own x stage and A tile),
  // W resident (1) or streamed per tap (0, one slot a warpgroup), blocks
  // per column panel, panels; shared-memory byte offsets from the
  // 1024-aligned base (W at 0)
  int n_wg, resident, bpp, n_panels;
  int w_slot, x_off, x_bytes, a_off, a_bytes, bar_off;
};

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

template <int TN, int MT>
__global__ void __launch_bounds__(2 * NT, 1)
    folded_matmul_kernel(const __grid_constant__ Params p) {
  constexpr int TM = 64 * MT;   // rows a tile
  using BL = BLayout<TN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);

  const int tid = threadIdx.x, wg = tid / NT, wtid = tid % NT;
  const int warp = wtid >> 5, lane = tid & 31;
  const int T = p.T, d_in = p.d_in, d_out = p.d_out, w = p.w;
  const int rows = TM + 2 * w;   // x rows a tile reads
  const int lda = d_in + APAD;
  const int n_win = 2 * w + 1;
  const int k_rows = p.resident ? n_win * d_in : d_in;
  const int col0 = (blockIdx.x % p.n_panels) * TN;
  const int first = blockIdx.x / p.n_panels;  // tiles first, first + bpp, ..
  const int n_tiles = (T + TM - 1) / TM;
  const int valid = min(max(*p.valid, 0), T);
  const int n_live = (valid + TM - 1) / TM;   // tiles with a row below valid
  const int mine =
      first < n_tiles ? (n_tiles - first + p.bpp - 1) / p.bpp : 0;
  const int live = first < n_live ? (n_live - first + p.bpp - 1) / p.bpp : 0;
  // this warpgroup's x stage, A tile and (streamed) W slot
  unsigned char* xs_bytes = smem + p.x_off + (size_t)wg * p.x_bytes;
  __nv_bfloat16* as =
      reinterpret_cast<__nv_bfloat16*>(smem + p.a_off + (size_t)wg * p.a_bytes);
  unsigned char* ws = smem + (p.resident ? 0 : (size_t)wg * p.w_slot);
  const uint32_t ws_addr = sm90::smem_u32(ws);

  // W rows [k0, k0 + k_rows) of this panel into the B layout, by `n`
  // threads from thread `i0`
  auto load_w = [&](int k0, int i0, int n) {
    constexpr int C8 = TN / 8;
    for (int i = i0; i < k_rows * C8; i += n) {
      const int k = i / C8, c = (i - k * C8) * 8;
      sm90::cp_async16(ws + BL::offset(k, c, k_rows),
                       p.W + (size_t)(k0 + k) * d_out + col0 + c);
    }
  };
  // the rows inside [0, T) of tile i and its halo, into this
  // warpgroup's stage
  auto load_x = [&](int i) {
    const int top = (first + i * p.bpp) * TM - w;
    const int g0 = max(top, 0), g1 = min(top + rows, T);
    const uint32_t bytes = (uint32_t)(g1 - g0) * d_in * 4;
    sm90::mbar_expect_tx(&full[wg], bytes);
    sm90::bulk_g2s(xs_bytes + (size_t)(g0 - top) * d_in * 4,
                   p.x + (size_t)g0 * d_in, bytes, &full[wg]);
  };

  uint64_t* w_ready = full + p.n_wg;  // the resident panel has landed
  // no x stage (x_bytes 0): the converter reads x from device memory
  const bool staged = p.x_bytes > 0;
  if (tid == 0) {
    for (int g = 0; g < p.n_wg; ++g) sm90::mbar_init(&full[g], 1);
    sm90::mbar_init(w_ready, p.n_wg * NT);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (staged && wtid == 0 && wg < live) load_x(wg);
  if (p.resident && live > 0) {  // the whole panel, once, in flight
    load_w(0, tid, p.n_wg * NT);  // during the first tile's conversion
    sm90::cp_async_arrive_noinc(w_ready);
  }
  bool w_in = !p.resident;

  // the epilogue's columns: for each pair jj of 8-column blocks, lane
  // 4g + t writes 4 columns of rows g and g + 8 after one exchange with
  // lane t ^ 1 (t even: block 2jj, columns 2t ..; t odd: block 2jj + 1,
  // columns 2t - 2 ..)
  const int t4 = lane & 3, g8 = lane >> 2, odd = t4 & 1;
  const int ccol = odd * 8 + (t4 >> 1) * 4;
  float4 bias[TN / 16];
#pragma unroll
  for (int jj = 0; jj < TN / 16; ++jj)
    bias[jj] = *reinterpret_cast<const float4*>(p.bias + col0 + 16 * jj +
                                                ccol);

  float acc[MT][TN / 2] = {};
  for (int i = wg; i < mine; i += p.n_wg) {
    const int row0 = (first + i * p.bpp) * TM;
    if (i >= live) {  // every row at or beyond valid: zeros only
      for (int e = wtid; e < TM * (TN / 4); e += NT) {
        const int r = e / (TN / 4), c = (e - r * (TN / 4)) * 4;
        if (row0 + r < T)
          *reinterpret_cast<float4*>(p.out + (size_t)(row0 + r) * d_out +
                                     col0 + c) = make_float4(0.f, 0.f, 0.f,
                                                             0.f);
      }
      continue;
    }

    // converter: the tile and its halo -> bf16, activation applied once
    if (staged) sm90::mbar_wait(&full[wg], (i / p.n_wg) & 1);
    const float4* xs = reinterpret_cast<const float4*>(xs_bytes);
    const float4* xg = reinterpret_cast<const float4*>(p.x) +
                       (ptrdiff_t)(row0 - w) * (d_in / 4);
    const int q = d_in / 4;
#pragma unroll 4
    for (int e = wtid; e < rows * q; e += NT) {
      const int r = e / q, c4 = e - r * q;
      const int g = row0 - w + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T) v = staged ? xs[e] : __ldg(xg + e);
      if (p.pre_lrelu) {
        v.x = v.x >= 0.f ? v.x : v.x * p.slope;
        v.y = v.y >= 0.f ? v.y : v.y * p.slope;
        v.z = v.z >= 0.f ? v.z : v.z * p.slope;
        v.w = v.w >= 0.f ? v.w : v.w * p.slope;
      }
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(as + (size_t)r * lda + c4 * 4) = make_uint2(
          *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
    }
    wg_sync(wg);  // A tile complete, the stage free
    if (staged && wtid == 0 && i + p.n_wg < live) load_x(i + p.n_wg);

    if (!w_in) {
      sm90::mbar_wait(w_ready, 0);
      sm90::fence_proxy_async();
      w_in = true;
    }

    // products: tap j reads the A tile j rows further down
    int accumulate = 0;
    for (int j = 0; j < n_win; ++j) {
      if (!p.resident) {  // the tap's panel into this warpgroup's slot
        if (j > 0) {
          sm90::wgmma_wait_all();
          wg_sync(wg);
        }
        load_w(j * d_in, wtid, NT);
        sm90::cp_async_wait_all();
        sm90::fence_proxy_async();
        wg_sync(wg);
      }
      const int kb = p.resident ? j * d_in : 0;
      for (int c = 0; c < d_in; c += 64) {
        uint32_t a[MT][4][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            sm90::ldmatrix_x4(
                a[m][k], as + (size_t)(m * 64 + warp * 16 + j + (lane & 15)) *
                                  lda + c + k * 16 + (lane >> 4) * 8);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t desc = BL::desc(ws_addr, kb + c + k * 16, k_rows);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_tn<TN>(acc[m], a[m][k], desc, accumulate);
          accumulate = 1;
        }
        sm90::wgmma_commit();
      }
    }
    sm90::wgmma_wait_all();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < TN / 2; ++v) sm90::reg_fence(acc[m][v]);
    wg_sync(wg);  // every warp is done reading the A tile (and W slot)

    // epilogue from registers (wgmma's accumulator layout: lane 4g + t
    // holds rows g and g + 8, columns 8j + 2t and 8j + 2t + 1 of each
    // 8-column block j), 16-byte stores
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g, g + 8
        const int row = row0 + m * 64 + warp * 16 + g8 + 8 * h;
#pragma unroll
        for (int jj = 0; jj < TN / 16; ++jj) {
          // columns 2t, 2t + 1 of blocks 2jj and 2jj + 1
          const float a0 = acc[m][8 * jj + 2 * h];
          const float a1 = acc[m][8 * jj + 2 * h + 1];
          const float b0 = acc[m][8 * jj + 4 + 2 * h];
          const float b1 = acc[m][8 * jj + 4 + 2 * h + 1];
          const float s0 = odd ? a0 : b0, s1 = odd ? a1 : b1;
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          if (row >= T) continue;
          const int col = col0 + 16 * jj + ccol;
          const size_t o = (size_t)row * d_out + col;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row < valid) {
            v = odd ? make_float4(r0, r1, b0, b1)
                    : make_float4(a0, a1, r0, r1);
            v.x += bias[jj].x; v.y += bias[jj].y;
            v.z += bias[jj].z; v.w += bias[jj].w;
            if (p.residual) {
              const float4 u = *reinterpret_cast<const float4*>(p.residual + o);
              v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
            }
            if (p.accum) {
              const float4 u = *reinterpret_cast<const float4*>(p.accum + o);
              v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
            }
            if (p.has_scale) {
              v.x *= p.out_scale; v.y *= p.out_scale;
              v.z *= p.out_scale; v.w *= p.out_scale;
            }
          }
          *reinterpret_cast<float4*>(p.out + o) = v;
        }
      }
    }
  }
}

template <int TN, int MT>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      folded_matmul_kernel<TN, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  folded_matmul_kernel<TN, MT><<<grid, p.n_wg * NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bf16v

namespace f32v {

constexpr int NT = 256;   // two warpgroups

struct Params {
  const float* x;
  const float* W;
  const float* bias;
  const float* residual;
  const float* accum;
  float* out;
  const int* valid;
  int T, d_in, d_out, w;
  int pre_lrelu;
  float slope;
  int has_scale;
  float out_scale;
  // the plan: columns a block (tn < 128: both warpgroups take them, over
  // the two halves of the rows), rows a block, panels, rows of a channel
  // chunk in shared memory (its stride is r_alloc * 16 bytes), the lo
  // copy's byte offset
  int tn, tile_rows, n_panels, r_alloc, lo_off;
};

// 64 NC rows a warpgroup (wgmma's N)
template <int NC>
__global__ void __launch_bounds__(NT, 1)
    folded_matmul_f32_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int T = p.T, d_in = p.d_in, d_out = p.d_out, w = p.w;
  const int col0 = (blockIdx.x % p.n_panels) * p.tn;
  const int row0 = (blockIdx.x / p.n_panels) * p.tile_rows;
  const int row_end = min(row0 + p.tile_rows, T);
  const int valid = min(max(*p.valid, 0), T);

  if (row0 >= valid) {  // every row at or beyond valid: zeros only
    const int q = p.tn / 4;
    for (int e = tid; e < (row_end - row0) * q; e += NT) {
      const int r = e / q, c = (e - r * q) * 4;
      *reinterpret_cast<float4*>(p.out + (size_t)(row0 + r) * d_out + col0 +
                                 c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // B: rows [row0 - w, row0 + tile_rows + w) of act(x), split, rows
  // outside [0, T) zero
  const uint32_t chunk = p.r_alloc * 16;
  {
    const int rows = p.tile_rows + 2 * w, q = d_in / 4;
#pragma unroll 4
    for (int e = tid; e < rows * q; e += NT) {
      const int r = e / q, c4 = e - r * q;
      const int gr = row0 - w + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr >= 0 && gr < T)
        v = __ldg(reinterpret_cast<const float4*>(p.x + (size_t)gr * d_in) +
                  c4);
      if (p.pre_lrelu) {
        v.x = v.x >= 0.f ? v.x : v.x * p.slope;
        v.y = v.y >= 0.f ? v.y : v.y * p.slope;
        v.z = v.z >= 0.f ? v.z : v.z * p.slope;
        v.w = v.w >= 0.f ? v.w : v.w * p.slope;
      }
      float4 lo;
      const float4 hi = tf32x3::split4(v, lo);
      unsigned char* dst = smem + c4 * chunk + r * 16;
      *reinterpret_cast<float4*>(dst) = hi;
      *reinterpret_cast<float4*>(dst + p.lo_off) = lo;
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();

  // this warpgroup's columns and rows; this thread's A columns ca, ca + 8
  const bool split_rows = p.tn < 128;
  const int cg = split_rows ? 0 : 64 * wg;
  const int rg = split_rows ? 64 * NC * wg : 0;
  const int tn_w = split_rows ? p.tn : 64;
  const int ca = 16 * warp + g;
  const bool ok0 = ca < tn_w, ok1 = ca + 8 < tn_w;
  const float* wa = p.W + col0 + cg + ca;

  float acc[NC * 32];  // one 64 NC-row accumulator
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) acc[i] = 0.f;
  const uint32_t b_hi = sm90::smem_u32(smem) + rg * 16;
  const uint64_t d_hi = tf32x3::desc(b_hi, chunk),
                 d_lo = tf32x3::desc(b_hi + p.lo_off, chunk);
  const float* wt = wa + (size_t)t * d_out;
  int tap = 0, kc = 0;  // of the next step issued
  tf32x3::k_loop<2, 4>(
      (2 * w + 1) * d_in / 8,
      [&](int s, float (&r)[4]) {  // k rows 8 s + t, 8 s + t + 4
        const float* q0 = wt + (size_t)(8 * s) * d_out;
        const float* q1 = q0 + (size_t)4 * d_out;
        r[0] = ok0 ? __ldg(q0) : 0.f;
        r[1] = ok1 ? __ldg(q0 + 8) : 0.f;
        r[2] = ok0 ? __ldg(q1) : 0.f;
        r[3] = ok1 ? __ldg(q1 + 8) : 0.f;
      },
      [&](int, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
        // rows from tap, channels kc .. kc + 7, in 16-byte units
        const uint32_t k = (kc >> 2) * p.r_alloc + tap;
        tf32x3::mma3<64 * NC>(acc, hi, lo, d_hi + k, d_lo + k, 1);
        kc += 8;
        if (kc == d_in) kc = 0, ++tap;
      });
#pragma unroll
  for (int i = 0; i < NC * 32; ++i) sm90::reg_fence(acc[i]);
  __syncthreads();  // both warpgroups are done reading the x tile

  // epilogue: acc[4 j + 2 h + e] is output column ca + 8 h of row
  // 8 j + 2 t + e of this warpgroup's rows.  The tile goes through
  // shared memory (over the x tile, rows ldo = tn + 4 floats apart: the
  // lanes' stores meet 32 banks), then to device memory in 16-byte
  // stores with bias, residual, accum, scale and the valid-row mask.
  float* ot = reinterpret_cast<float*>(smem);
  const int ldo = p.tn + 4;
#pragma unroll
  for (int j = 0; j < 8 * NC; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (h ? ok1 : ok0)
          ot[(rg + 8 * j + 2 * t + e) * ldo + cg + ca + 8 * h] =
              acc[4 * j + 2 * h + e];
  __syncthreads();
  const int q = p.tn / 4;
  for (int e = tid; e < (row_end - row0) * q; e += NT) {
    const int r = e / q, c = (e - r * q) * 4;
    const int row = row0 + r;
    const size_t o = (size_t)row * d_out + col0 + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < valid) {
      v = *reinterpret_cast<const float4*>(ot + r * ldo + c);
      const float4 bb = __ldg(reinterpret_cast<const float4*>(p.bias + col0 + c));
      v.x += bb.x; v.y += bb.y; v.z += bb.z; v.w += bb.w;
      if (p.residual) {
        const float4 u = *reinterpret_cast<const float4*>(p.residual + o);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
      if (p.accum) {
        const float4 u = *reinterpret_cast<const float4*>(p.accum + o);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
      if (p.has_scale) {
        v.x *= p.out_scale; v.y *= p.out_scale;
        v.z *= p.out_scale; v.w *= p.out_scale;
      }
    }
    *reinterpret_cast<float4*>(p.out + o) = v;
  }
}

template <int NC>
int launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      folded_matmul_f32_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  folded_matmul_f32_kernel<NC><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32v

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bf16 W; x, bias, residual, accum and out float32.  The plan (tile rows
// tm, panel width tn, warpgroups, resident W, blocks per panel, panels,
// shared-memory layout and size) comes from folded_matmul.py::plan.
int folded_matmul_bf16_launch(
    const void* x, const void* W, const void* bias, const void* residual,
    const void* accum, void* out, const void* valid, int T, int d_in,
    int d_out, int w, int pre_lrelu, float slope, int has_scale,
    float out_scale, int tm, int tn, int n_wg, int resident, int bpp,
    int n_panels, int w_slot, int x_off, int x_bytes, int a_off,
    int a_bytes, int bar_off, int smem, void* stream) {
  bf16v::Params p{static_cast<const float*>(x),
                  static_cast<const __nv_bfloat16*>(W),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(residual),
                  static_cast<const float*>(accum), static_cast<float*>(out),
                  static_cast<const int*>(valid), T, d_in, d_out, w,
                  pre_lrelu, slope, has_scale, out_scale, n_wg, resident,
                  bpp, n_panels, w_slot, x_off, x_bytes, a_off, a_bytes,
                  bar_off};
  if (d_in % 64 || n_wg < 1 || n_wg > 2 || d_out != n_panels * tn)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = bpp * n_panels;
  if (tn == 128 && tm == 64) return bf16v::launch<128, 1>(p, grid, smem, s);
  if (tn == 64 && tm == 64) return bf16v::launch<64, 1>(p, grid, smem, s);
  if (tn == 32 && tm == 128) return bf16v::launch<32, 2>(p, grid, smem, s);
  if (tn == 16 && tm == 128) return bf16v::launch<16, 2>(p, grid, smem, s);
  return cudaErrorInvalidValue;
}

// float32 W; x, bias, residual, accum and out float32.  The plan (panel
// width tn, 64-row chunks a warpgroup nc, rows a block, rows of a channel
// chunk, the lo copy's offset, shared memory: the split x tile, then the
// output tile) comes from
// folded_matmul.py::f32_plan.
int folded_matmul_f32_launch(
    const void* x, const void* W, const void* bias, const void* residual,
    const void* accum, void* out, const void* valid, int T, int d_in,
    int d_out, int w, int pre_lrelu, float slope, int has_scale,
    float out_scale, int tn, int nc, int tile_rows, int r_alloc, int lo_off,
    int smem, void* stream) {
  f32v::Params p{static_cast<const float*>(x), static_cast<const float*>(W),
                 static_cast<const float*>(bias),
                 static_cast<const float*>(residual),
                 static_cast<const float*>(accum), static_cast<float*>(out),
                 static_cast<const int*>(valid), T, d_in, d_out, w,
                 pre_lrelu, slope, has_scale, out_scale, tn, tile_rows,
                 tn > 0 ? d_out / tn : 0, r_alloc, lo_off};
  if (d_in % 32 || (tn != 128 && tn != 64 && tn != 32 && tn != 16) ||
      d_out % tn || tile_rows != 64 * nc * (tn < 128 ? 2 : 1) ||
      r_alloc < tile_rows + 2 * w || lo_off < d_in / 4 * r_alloc * 16 ||
      smem < 2 * lo_off || smem < tile_rows * (tn + 4) * 4)
    return cudaErrorInvalidValue;
  const int grid = (T + tile_rows - 1) / tile_rows * p.n_panels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nc == 2) return f32v::launch<2>(p, grid, smem, s);
  if (nc == 1) return f32v::launch<1>(p, grid, smem, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
