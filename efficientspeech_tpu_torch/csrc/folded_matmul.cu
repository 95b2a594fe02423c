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
//   one slot a warpgroup; that path is correct, not fast.
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
// multiplies float32 operands into float32 sums on the CUDA cores (FFMA):
// nothing is rounded to bf16 or TF32.  It is bound by operations (2 * 3 *
// 128 FLOP an output element against 67 TFLOP/s of float32).  The x tile
// with its halo is staged once as float32 (activation applied); W streams
// from L2 through shared memory in chunks of 16 rows, double-buffered
// through registers.  A block computes 64 rows x 128 columns, each thread 4
// rows x 8 columns (D_out a multiple of 128), or 64 rows x 16 columns, each
// thread 1 row x 4 columns (other multiples of 16: the post conv's 16).
// The epilogue writes the same function.  Held to the plain version at
// SNR >= 90 dB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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
  if (tid == 0) {
    for (int g = 0; g < p.n_wg; ++g) sm90::mbar_init(&full[g], 1);
    sm90::mbar_init(w_ready, p.n_wg * NT);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (wtid == 0 && wg < live) load_x(wg);
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
    sm90::mbar_wait(&full[wg], (i / p.n_wg) & 1);
    const float4* xs = reinterpret_cast<const float4*>(xs_bytes);
    const int q = d_in / 4;
#pragma unroll 4
    for (int e = wtid; e < rows * q; e += NT) {
      const int r = e / q, c4 = e - r * q;
      const int g = row0 - w + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g >= 0 && g < T) v = xs[e];
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
    if (wtid == 0 && i + p.n_wg < live) load_x(i + p.n_wg);

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

// float32 W; D_in and D_out multiples of 16, shared memory
// f32v::smem_bytes(d_in, w, WIDE_TN) (folded_matmul.py::f32_smem_bytes).
int folded_matmul_f32_launch(const void* x, const void* W, const void* bias,
                             const void* residual, const void* accum,
                             void* out, const void* valid, int T, int d_in,
                             int d_out, int w, int pre_lrelu, float slope,
                             int has_scale, float out_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_out % f32v::WIDE_TN == 0)
    return f32v::launch<f32v::WIDE_TN, 4, 2>(
        x, W, bias, residual, accum, out, valid, T, d_in, d_out, w,
        pre_lrelu, slope, has_scale, out_scale, s);
  return f32v::launch<f32v::NARROW_TN, 1, 1>(
      x, W, bias, residual, accum, out, valid, T, d_in, d_out, w, pre_lrelu,
      slope, has_scale, out_scale, s);
}

}  // extern "C"
