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
// What bounds it on an H100: arithmetic, and the weights' bytes from L2.
// At 2,048 mel frames the four stages do ~252 GFLOP of useful products
// (0.25 ms at the bf16 peak) against ~16 MB of activations read and
// written per stage.  The Pallas version keeps all 18 folded weight
// matrices resident in VMEM (up to 4.7 MB); a block here has at most 227
// KB of shared memory, less than one op's weights (27 taps x 32 KB), so
// each block streams the stage's weights once per tile of rows, 32 KB a
// tap, while the tensor cores work on the taps before.
//
// bf16 variant (W_all bf16; the serving dtype of bf16 requests).  Each
// conv runs transposed, conv^T = W^T act^T, on wgmma (bf16 x bf16 ->
// float32, both operands from shared memory):
//   * M is the output channel: the block's two warpgroups take 64
//     channels each.  N is the conv's output rows, one instruction of
//     up to 192 rows rounded up to 16 (the extent shrinks by 2w a conv;
//     rows as M would round every extent up to 64).  K is the input
//     channel, 8 k-steps of 16 a tap.
//   * A is the tap's W slice, 128 x 128 bf16 = 32 KB, in W's own
//     row-major (k, n) order: wgmma reads it MN-major (its transpose
//     bit) from a ring of 2-4 slots in the 128-byte swizzle
//     (slice_offset; the TMA unit's own swizzle, so the tensor map and
//     the descriptor agree).  A ninth warp, the producer, loads each
//     slice by two TMA boxes as soon as the 8 consumer warps have
//     released the slice `slots` before it (an empty mbarrier a slot;
//     its full mbarrier counts the bytes in); with the loads issued by a
//     consumer thread, that thread's waits held up its warpgroup's next
//     wgmma and the kernel ran 9% slower.
//     The slices run in W_all's row order, which is the order the chains
//     execute, so the ring runs across ops: the next conv's first taps
//     are in flight during this conv's epilogue.  One commit group a tap
//     stays in flight while the next is issued.
//   * B is the activation buffer: bf16, leaky-relu applied, in the
//     no-swizzle K-major layout of tf32x3.cuh (chunks of 8 channels with
//     rows 16 bytes apart), so tap j is the same descriptor started j
//     rows further and no shifted copies are made; both warpgroups read
//     it once a tap.  A conv computes up to 15 rows past its extent,
//     which are never kept; the buffer starts at zero so they stay finite.
//   * v, the residual stream, stays float32 in shared memory, rows of
//     128 floats with 8-float groups XORed by the row (v_index), so both
//     the epilogue and the row-wise passes meet 32 banks.  The epilogue
//     (bias, residual, the [0, valid) row mask, v, and the activation)
//     works from the accumulators once both warpgroups have finished
//     reading the buffer, which is then rewritten in place, 8 channels of
//     a row at a time by stmatrix.
//   * x is re-read from device memory (L2-resident) at the start of each
//     resblock chain, and the resblock sum accumulates in the block's own
//     output tile in device memory; both passes issue all of a thread's
//     loads before its stores.
// Each chain recomputes a halo of M rows per side (M = the sum of its
// window half-widths, H = max M).  The tile height per stage, the ring's
// slots and the shared-memory offsets come from mrf_block.py::bf16_plan
// (one block a SM: 64-row tiles at stage 0 and 128 at stages 1-3 for
// 2,048 frames, each stage in whole waves).  `valid` is read from device
// memory; a tile whose rows all lie at or beyond it (the speculative
// buffer's tail) only writes zeros.
//
// At D = 256 (a stage of 256 channels, one sample a row) the bf16 variant
// has a kernel of its own, mrf_kernel_wide (namespace widev below): 128
// output channels a warpgroup, quarter-tap ring slices, v in device
// memory.
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


#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int D = 128;          // folded width (widev: 256)
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

namespace bf16v {

constexpr int NT = 256;            // two warpgroups, 64 output channels each
constexpr int NT_ALL = NT + 32;    // and the producer warp
constexpr int MAX_TM = 128;        // rows of a tile (taller measured slower)
constexpr int MAX_N = 192;         // rows of a conv output: MAX_TM with a
                                   // halo of 33 (stage 0)
constexpr int SLICE = D * D * 2;   // one tap's W slice: 32 KB of bf16
constexpr int MAX_SLOTS = 4;

// the plan (mrf_block.py::bf16_plan): tile rows, the halo, ring slots,
// rows of a channel chunk of the activation buffer (its stride r_alloc *
// 16 bytes), byte offsets of the buffer, of v and of the slots' full and
// empty mbarriers from the 1024-byte aligned base (the ring at 0)
struct Plan {
  int tm, H, slots, r_alloc, buf_off, v_off, bar_off;
};

// Byte offset, in a ring slot, of the 16-byte chunk holding W's columns
// n .. n + 7 of k row k: wgmma's MN-major layout with the 128-byte
// swizzle, atoms of 8 k rows x 64 columns, 16-byte chunks XORed with the
// row; the 64-column halves (one a warpgroup) 16 KB apart.  Needs a
// 1024-byte aligned slot.
__device__ __forceinline__ uint32_t slice_offset(int k, int n) {
  const uint32_t o = k * 128 + (n % 64) * 2;
  return (n / 64) * (D * 128) + (o ^ ((k & 7) << 4));
}

// descriptor of A (64 output channels from 64 wg x 16 k rows from k0, a
// multiple of 16) in a slot at shared address `slot`: column atoms 16 KB
// apart (leading byte offset), 8-row groups 1 KB apart (stride byte
// offset), 128-byte swizzle
__device__ __forceinline__ uint64_t slice_desc(uint32_t slot, int wg,
                                               int k0) {
  const uint32_t addr = slot + slice_offset(k0, 64 * wg);
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((D * 128) >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// D (64 x N, float32) += A (64 x 16 bf16, descriptor `da`, MN-major) * B
// (16 x N bf16, descriptor `db`, K-major); D = A * B when !accumulate.
// One overload per N (a multiple of 16), picked by the accumulator
// array's size N / 2.  D's layout: lane 4 g + t of warp q holds, for
// each 8-column block j, rows 16 q + g (d[4 j], d[4 j + 1]) and 16 q + g
// + 8 (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t and 8 j + 2 t + 1.
#define MRF_WGMMA(N, REGS, OUTS, IA, IB, IP)                                 \
  __device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,   \
                                           uint64_t db, int accumulate) {    \
    asm volatile("{\n.reg .pred p;\n"                                        \
                 "setp.ne.b32 p, " IP ", 0;\n"                               \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " \
                 "{" REGS "}, " IA ", " IB ", p, 1, 1, 1, 0;\n}\n"           \
                 : OUTS                                                      \
                 : "l"(da), "l"(db), "r"(accumulate));                       \
  }
#define MRF_O8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MRF_OUT_16 MRF_O8(0)
#define MRF_OUT_32 MRF_OUT_16, MRF_O8(8)
#define MRF_OUT_48 MRF_OUT_32, MRF_O8(16)
#define MRF_OUT_64 MRF_OUT_48, MRF_O8(24)
#define MRF_OUT_80 MRF_OUT_64, MRF_O8(32)
#define MRF_OUT_96 MRF_OUT_80, MRF_O8(40)
#define MRF_OUT_112 MRF_OUT_96, MRF_O8(48)
#define MRF_OUT_128 MRF_OUT_112, MRF_O8(56)
#define MRF_OUT_144 MRF_OUT_128, MRF_O8(64)
#define MRF_OUT_160 MRF_OUT_144, MRF_O8(72)
#define MRF_OUT_176 MRF_OUT_160, MRF_O8(80)
#define MRF_OUT_192 MRF_OUT_176, MRF_O8(88)
#define MRF_REGS_16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define MRF_REGS_32 MRF_REGS_16 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define MRF_REGS_48 MRF_REGS_32 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define MRF_REGS_64 MRF_REGS_48 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define MRF_REGS_80 MRF_REGS_64 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define MRF_REGS_96 MRF_REGS_80 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define MRF_REGS_112 MRF_REGS_96 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define MRF_REGS_128 MRF_REGS_112 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define MRF_REGS_144 MRF_REGS_128 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define MRF_REGS_160 MRF_REGS_144 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define MRF_REGS_176 MRF_REGS_160 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define MRF_REGS_192 MRF_REGS_176 ", %88, %89, %90, %91, %92, %93, %94, %95"
MRF_WGMMA(16, MRF_REGS_16, MRF_OUT_16, "%8", "%9", "%10")
MRF_WGMMA(32, MRF_REGS_32, MRF_OUT_32, "%16", "%17", "%18")
MRF_WGMMA(48, MRF_REGS_48, MRF_OUT_48, "%24", "%25", "%26")
MRF_WGMMA(64, MRF_REGS_64, MRF_OUT_64, "%32", "%33", "%34")
MRF_WGMMA(80, MRF_REGS_80, MRF_OUT_80, "%40", "%41", "%42")
MRF_WGMMA(96, MRF_REGS_96, MRF_OUT_96, "%48", "%49", "%50")
MRF_WGMMA(112, MRF_REGS_112, MRF_OUT_112, "%56", "%57", "%58")
MRF_WGMMA(128, MRF_REGS_128, MRF_OUT_128, "%64", "%65", "%66")
MRF_WGMMA(144, MRF_REGS_144, MRF_OUT_144, "%72", "%73", "%74")
MRF_WGMMA(160, MRF_REGS_160, MRF_OUT_160, "%80", "%81", "%82")
MRF_WGMMA(176, MRF_REGS_176, MRF_OUT_176, "%88", "%89", "%90")
MRF_WGMMA(192, MRF_REGS_192, MRF_OUT_192, "%96", "%97", "%98")

// The weight ring: W_all's tap slices in row order, slice q in slot
// q % slots.  Each slot has a full barrier (the producer's one arrival,
// expecting the slice's bytes) and an empty barrier (one arrival from
// each of the 8 consumer warps once its products have read the slot).
// The producer warp's first thread loads a slice by the TMA unit as two
// boxes of 64 columns in the 128-byte swizzle (the tensor map's, which is
// slice_offset's).
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap* tmap;
  int slots;

  // producer: slice q into its slot, once every consumer warp has
  // released the slice before it there
  __device__ __forceinline__ void load(int q) const {
    const int s = q % slots;
    if (q >= slots) sm90::mbar_wait(&empty[s], (q / slots - 1) & 1);
    sm90::mbar_expect_tx(&full[s], SLICE);
    unsigned char* slot = base + (size_t)s * SLICE;
    for (int h = 0; h < 2; ++h)
      sm90::tma_load_2d(slot + h * (SLICE / 2), tmap, 64 * h, q * D,
                        &full[s]);
  }

  // consumers: slice q has landed; its slot's shared address
  __device__ __forceinline__ uint32_t wait(int q) const {
    sm90::mbar_wait(&full[q % slots], (q / slots) & 1);
    return sm90::smem_u32(base) + (q % slots) * SLICE;
  }

  // consumers (lane 0 of each warp): this warp is done with slice q
  __device__ __forceinline__ void release(int q) const {
    sm90::mbar_arrive(&empty[q % slots]);
  }
};

// a barrier of the two consumer warpgroups (the producer warp runs apart)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
}

// v's element (r, c): rows of 128 floats, the 8-float groups of a row
// XORed with bits 1-2 of the row, so the epilogue's accesses (8
// channels at rows 2 apart) and the row-wise float4 passes meet 32 banks
__device__ __forceinline__ int v_index(int r, int c) {
  return r * D + (c ^ (((r >> 1) & 3) << 3));
}

// One folded conv of N padded output rows over the activation rows
// [a, b), writing rows [a + w, b - w); its taps are slices q, q + 1, ..
// of the ring (q advances past them).  second: the output is v's
// residual update (v += conv), and v's new activation replaces the
// buffer's; otherwise the activated output itself replaces it.
template <int N>
__device__ __forceinline__ void conv_op(unsigned char* smem, const Plan& pl,
                                        const Ring& ring, int& q,
                                        const float* __restrict__ bias,
                                        int w, int a, int b, int base,
                                        int valid, float slope, bool second) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = a + w, end = b - w;
  const uint32_t chunk = pl.r_alloc * 16;
  const int c0 = 64 * wg + 16 * warp + g;  // this lane's output channels
  const float bv[2] = {bias[c0], bias[c0 + 8]};   // c0 and c0 + 8

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // B of k-step 0, tap 0: channels 0-15, rows a ..; k-step k starts 2 k
  // chunks on, tap j j rows on (16-byte units in the descriptor)
  const uint64_t db =
      tf32x3::desc(sm90::smem_u32(smem + pl.buf_off) + a * 16, chunk);
  for (int j = 0; j <= 2 * w; ++j, ++q) {
    const uint32_t slot = ring.wait(q);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      wgmma_ss(acc, slice_desc(slot, wg, 16 * k),
               db + j + k * 2 * (chunk >> 4), 1);
    sm90::wgmma_commit();
    tf32x3::wait_group<1>();  // this warp is done with slice q - 1
    if (q > 0 && lane == 0) ring.release(q - 1);
  }
  sm90::wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sm90::reg_fence(acc[i]);
  consumers_sync();  // both warpgroups are done reading the buffer

  // acc[4 j + 2 h + e] is output channel c0 + 8 h of output row 8 j +
  // 2 t + e.  The activation goes out by stmatrix, transposed, 16 bytes
  // (8 channels) a buffer row: matrix 2 i + h of a pair of 8-row blocks
  // is channels 8 h .. of rows 8 i ..  Rows past the extent get zeros
  // (never read).
  float* V = reinterpret_cast<float*>(smem + pl.v_off);
  unsigned char* st = smem + pl.buf_off +
                      (8 * wg + 2 * warp + ((lane >> 3) & 1)) * chunk +
                      (o0 + 8 * (lane >> 4) + (lane & 7)) * 16;
#pragma unroll
  for (int j = 0; j < N / 8; j += 2) {
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r0 = o0 + 8 * (j + i) + 2 * t;
      bool keep[2], in[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        in[e] = r0 + e < end;
        keep[e] = in[e] && (unsigned)(base + r0 + e) < (unsigned)valid;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[4 * (j + i) + 2 * h + e] + bv[h];
          float* vp = V + v_index(r0 + e, c0 + 8 * h);
          if (second && in[e]) v += *vp;
          v = keep[e] ? v : 0.f;
          if (second && in[e]) *vp = v;
          y[e] = lrelu(v, slope);
        }
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(y[0], y[1]);
        packed[2 * i + h] = *reinterpret_cast<const uint32_t*>(&p2);
      }
    }
    sm90::stmatrix_x4_trans(st + 8 * j * 16, packed);
  }
  sm90::fence_proxy_async();  // the new buffer, before wgmma reads it
  consumers_sync();
}

// conv_op at the conv's output rows rounded up to 16
__device__ __forceinline__ void conv(unsigned char* smem, const Plan& pl,
                                     const Ring& ring, int& q,
                                     const float* __restrict__ bias, int w,
                                     int a, int b, int base, int valid,
                                     float slope, bool second) {
#define MRF_CONV(N)                                                   \
  case N / 16:                                                        \
    conv_op<N>(smem, pl, ring, q, bias, w, a, b, base, valid, slope, \
               second);                                               \
    break;
  switch ((b - a - 2 * w + 15) / 16) {
    MRF_CONV(16) MRF_CONV(32) MRF_CONV(48) MRF_CONV(64) MRF_CONV(80)
    MRF_CONV(96) MRF_CONV(112) MRF_CONV(128) MRF_CONV(144) MRF_CONV(160)
    MRF_CONV(176) MRF_CONV(192)
  }
#undef MRF_CONV
}

// float4s a thread moves at once in the row-wise passes (loads first)
constexpr int PASS = 16;

__global__ void __launch_bounds__(NT_ALL, 1)
mrf_kernel(const __grid_constant__ CUtensorMap tmap,
           const float* __restrict__ x, const float* __restrict__ b_all,
           float* __restrict__ out, const int* __restrict__ valid_ptr, int T,
           const Plan pl, MrfOps ops, int n_slices, float inv_nk,
           float slope) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int tm = pl.tm, H = pl.H;
  const int row0 = blockIdx.x * tm;
  const int base = row0 - H;  // global row of buffer row 0
  const int valid = min(max(*valid_ptr, 0), T);
  float* V = reinterpret_cast<float*>(smem + pl.v_off);
  unsigned char* act = smem + pl.buf_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + pl.bar_off);
  uint64_t* empty = full + pl.slots;

  if (row0 >= valid) {  // every row of the tile is masked: write zeros only
    for (int i = tid; i < tm * D; i += NT_ALL)
      if (row0 + i / D < T) out[(size_t)row0 * D + i] = 0.f;
    return;
  }

  const Ring ring{smem, full, empty, &tmap, pl.slots};
  if (tid == 0) {
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NT / 32);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid >= NT) {  // the producer warp: every slice, in order
    if (tid == NT)
      for (int q = 0; q < n_slices; ++q) ring.load(q);
    return;
  }
  // rows past a conv's extent are read (never kept) by its last 16 rows:
  // start the buffer at zero so they stay finite
  for (int i = tid; i < (D / 8) * pl.r_alloc; i += NT)
    reinterpret_cast<float4*>(act)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  consumers_sync();

  const uint32_t chunk = pl.r_alloc * 16;
  int q = 0;  // the ring's next slice: the next conv's first tap
  for (int j = 0; j < ops.n_chains; ++j) {
    int M = 0;
    for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
    int a = H - M, b = H + tm + M;

    // v := x (masked) over the chain's extent, and its activation
    const int n_in = (b - a) * (D / 4);
    for (int i0 = tid; i0 < n_in; i0 += PASS * NT) {
      float4 xv[PASS];
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        const int i = i0 + u * NT, gr = base + a + i / (D / 4);
        xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < n_in && gr >= 0 && gr < valid)
          xv[u] = __ldg(reinterpret_cast<const float4*>(x + (size_t)gr * D) +
                        i % (D / 4));
      }
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        const int i = i0 + u * NT, r = a + i / (D / 4), c4 = i % (D / 4);
        if (i >= n_in) break;
        const float4 v = xv[u];
        *reinterpret_cast<float4*>(V + v_index(r, 4 * c4)) = v;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(lrelu(v.x, slope),
                                                        lrelu(v.y, slope));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(lrelu(v.z, slope),
                                                        lrelu(v.w, slope));
        *reinterpret_cast<uint2*>(act + (c4 >> 1) * chunk + r * 16 +
                                  (c4 & 1) * 8) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
    sm90::fence_proxy_async();
    consumers_sync();

    for (int m = 0; m + 1 < ops.n_ops[j]; m += 2) {
      const int w1 = ops.w[j][m], w2 = ops.w[j][m + 1];
      conv(smem, pl, ring, q, b_all + (size_t)ops.bidx[j][m] * D, w1, a, b,
           base, valid, slope, false);
      a += w1;
      b -= w1;
      conv(smem, pl, ring, q, b_all + (size_t)ops.bidx[j][m + 1] * D, w2, a,
           b, base, valid, slope, true);
      a += w2;
      b -= w2;
    }

    // a == H and b == H + tm: fold the chain's centre rows into the sum
    const bool first = j == 0, last = j == ops.n_chains - 1;
    const int n_out = min(tm, T - row0) * (D / 4);
    for (int i0 = tid; i0 < n_out; i0 += PASS * NT) {
      float4 sum[PASS];
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        const int i = i0 + u * NT;
        sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!first && i < n_out)
          sum[u] = reinterpret_cast<const float4*>(out + (size_t)row0 * D)[i];
      }
#pragma unroll
      for (int u = 0; u < PASS; ++u) {
        const int i = i0 + u * NT, r = i / (D / 4), c4 = i % (D / 4);
        if (i >= n_out) break;
        float4 s = *reinterpret_cast<const float4*>(V + v_index(H + r, 4 * c4));
        s.x += sum[u].x; s.y += sum[u].y; s.z += sum[u].z; s.w += sum[u].w;
        if (last) {
          const float k = row0 + r < valid ? inv_nk : 0.f;
          s.x *= k; s.y *= k; s.z *= k; s.w *= k;
        }
        reinterpret_cast<float4*>(out + (size_t)row0 * D)[i] = s;
      }
    }
    consumers_sync();
  }
}

}  // namespace bf16v

// The bf16 variant at twice the width (D = 256: a stage of 256 channels
// at one sample a row, HiFi-GAN V1's first).  Its W slice a tap is 128
// KB and a 64-row tile's float32 v with its halo 188 KB, so the D = 128
// layout cannot hold it; this one keeps the same products (conv^T = W^T
// act^T on wgmma, A = W from a TMA ring, B = the bf16 activation buffer)
// with these changes:
//   * each of the two warpgroups takes 128 output channels as two halves
//     of 64 (two wgmma a k-step into two accumulator arrays), and K runs
//     over 16 k-steps a tap;
//   * a ring slice is a quarter of a tap (64 k rows x 256 columns, the
//     same 32 KB), loaded as four boxes of 64 x 64, one a half;
//   * v, the float32 residual stream, lives in device memory (one region
//     a block, L2-resident) instead of shared memory: a residual conv's
//     epilogue adds v (x itself for a chain's first pair) from there and
//     stores the new v back;
//   * no producer warp: a ninth warp would put three warps on one of the
//     SM's four register files and cut every thread to 168 registers,
//     below the accumulators of N = 176 rows x 128 channels; thread 0
//     loads the ring instead, slots - 1 slices ahead: after each slice's
//     products are issued and the slice before is released, every thread
//     waits (uniformly, outside any divergent path, which ptxas would
//     serialise the wgmmas for) until all eight warps have released it,
//     and thread 0 loads that slot's next slice, while the products run.
// The blocks are persistent (one an SM, walking tiles blockIdx.x,
// + gridDim.x, ...) so that the v regions are as many as the SMs and the
// ring runs on into a block's next tile.  The tile height follows from
// the halo, MAX_N and shared memory (mrf_block.py::bf16_plan at d = 256).
namespace widev {

constexpr int DW = 256;             // folded width
constexpr int NT = 256;             // two warpgroups
constexpr int MAX_TM = 80;
constexpr int MAX_N = 176;          // at 192 ptxas spills (255 registers)
constexpr int KS = 64;              // k rows of W a ring slice
constexpr int SLICE = KS * DW * 2;  // 32 KB
constexpr int SPT = DW / KS;        // slices a tap
constexpr int MAX_SLOTS = 4;

// the plan (mrf_block.py::bf16_plan at d = 256): tile rows, the halo,
// ring slots, rows of a channel chunk of the activation buffer, byte
// offsets of the buffer and of the slots' barriers (the ring at 0)
struct Plan {
  int tm, H, slots, r_alloc, buf_off, bar_off;
};

// descriptor of A (64 output channels from 64 qt x 16 k rows from k0) in
// a slot at shared address `slot`: the slot holds four boxes of 64 k rows
// x 64 columns, 8 KB apart, each in the 128-byte swizzle; 8-row groups
// 1 KB apart
__device__ __forceinline__ uint64_t slice_desc(uint32_t slot, int qt,
                                               int k0) {
  const uint32_t addr = slot + qt * (KS * 128) + k0 * 128;
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((KS * 128) >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// the ring of bf16v::Ring with quarter-tap slices: the block's slice q
// is W_all's k rows [64 p, 64 p + 64), p = q % per_tile (each of the
// block's live tiles streams all of W_all again), in slot q % slots;
// `total` slices in all
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  const CUtensorMap* tmap;
  int slots, total, per_tile;

  // thread 0: slice q into its slot (its slot free: see refill)
  __device__ __forceinline__ void load(int q) const {
    const int s = q % slots;
    sm90::mbar_expect_tx(&full[s], SLICE);
    unsigned char* slot = base + (size_t)s * SLICE;
    for (int h = 0; h < DW / 64; ++h)
      sm90::tma_load_2d(slot + h * (KS * 128), tmap, 64 * h,
                        (q % per_tile) * KS, &full[s]);
  }

  // every thread, after its warp released slice q: once all have, slice
  // q + slots goes into the slot
  __device__ __forceinline__ void refill(int q) const {
    const int n = q + slots;
    if (n >= total) return;
    sm90::mbar_wait(&empty[q % slots], (q / slots) & 1);
    if (threadIdx.x == 0) load(n);
  }

  __device__ __forceinline__ uint32_t wait(int q) const {
    sm90::mbar_wait(&full[q % slots], (q / slots) & 1);
    return sm90::smem_u32(base) + (q % slots) * SLICE;
  }

  __device__ __forceinline__ void release(int q) const {
    sm90::mbar_arrive(&empty[q % slots]);
  }
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NT) : "memory");
}

// Where a residual conv's v comes from: element (r, c) of buffer row r
// is src[(src_row0 + r) * DW + c] for src_row0 + r in [lo, hi), else 0
// (x over its valid rows for a chain's first pair, the block's v region
// after it).
struct Residual {
  const float* src;
  int src_row0, lo, hi;
};

// One folded conv of N padded output rows over the activation rows
// [a, b), writing rows [a + w, b - w), as bf16v::conv_op; `residual`:
// the output is v's residual update (v read from `res`), stored to the
// block's region `vs`.
template <int N>
__device__ __forceinline__ void conv_op(unsigned char* smem, const Plan& pl,
                                        const Ring& ring, int& q,
                                        const float* __restrict__ bias,
                                        bool residual, Residual res,
                                        float* __restrict__ vs, int w, int a,
                                        int b, int base, int valid,
                                        float slope) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int o0 = a + w, end = b - w;
  const uint32_t chunk = pl.r_alloc * 16;
  // this lane's output channels: c0 + 64 hf and c0 + 64 hf + 8
  const int c0 = 128 * wg + 16 * warp + g;

  // acc[hf][4 j + 2 h + e] is output channel c0 + 64 hf + 8 h of output
  // row 8 j + 2 t + e; it starts at the bias (v, loaded into it here,
  // made ptxas serialise the wgmmas)
  float acc[2][N / 2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float bv = bias[c0 + 64 * hf + 8 * h];
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[hf][4 * j + 2 * h + e] = bv;
    }
  // defined before the first wgmma's fence
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sm90::reg_fence(acc[hf][i]);

  const uint64_t db =
      tf32x3::desc(sm90::smem_u32(smem + pl.buf_off) + a * 16, chunk);
  for (int j = 0; j <= 2 * w; ++j) {
    for (int s = 0; s < SPT; ++s, ++q) {
      const uint32_t slot = ring.wait(q);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < KS / 16; ++k) {
        const uint64_t bk = db + j + (s * (KS / 16) + k) * 2 * (chunk >> 4);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          bf16v::wgmma_ss(acc[hf], slice_desc(slot, 2 * wg + hf, 16 * k), bk,
                          1);
      }
      sm90::wgmma_commit();
      tf32x3::wait_group<1>();  // this warp is done with slice q - 1
      if (q > 0) {
        if (lane == 0) ring.release(q - 1);
        ring.refill(q - 1);
      }
    }
  }
  sm90::wgmma_wait_all();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sm90::reg_fence(acc[hf][i]);
  consumers_sync();  // both warpgroups are done reading the buffer

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    unsigned char* st =
        smem + pl.buf_off +
        (16 * wg + 8 * hf + 2 * warp + ((lane >> 3) & 1)) * chunk +
        (o0 + 8 * (lane >> 4) + (lane & 7)) * 16;
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t packed[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = o0 + 8 * (j + i) + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool in = r0 + e < end;
            const bool keep =
                in && (unsigned)(base + r0 + e) < (unsigned)valid;
            const int c = c0 + 64 * hf + 8 * h, sr = res.src_row0 + r0 + e;
            float v = acc[hf][4 * (j + i) + 2 * h + e];
            if (residual && in && sr >= res.lo && sr < res.hi)
              v += res.src[(size_t)sr * DW + c];
            v = keep ? v : 0.f;
            if (residual && in) vs[(size_t)(r0 + e) * DW + c] = v;
            y[e] = lrelu(v, slope);
          }
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(y[0], y[1]);
          packed[2 * i + h] = *reinterpret_cast<const uint32_t*>(&p2);
        }
      }
      sm90::stmatrix_x4_trans(st + 8 * j * 16, packed);
    }
  }
  sm90::fence_proxy_async();  // the new buffer, before wgmma reads it
  consumers_sync();           // and v's stores, before they are read
}

__device__ __forceinline__ void conv(unsigned char* smem, const Plan& pl,
                                     const Ring& ring, int& q,
                                     const float* __restrict__ bias,
                                     bool residual, Residual res,
                                     float* vs, int w,
                                     int a, int b, int base, int valid,
                                     float slope) {
#define MRF_CONV(N)                                                      \
  case N / 16:                                                           \
    conv_op<N>(smem, pl, ring, q, bias, residual, res, vs, w, a, b, base, \
               valid, slope);                                             \
    break;
  switch ((b - a - 2 * w + 15) / 16) {
    MRF_CONV(16) MRF_CONV(32) MRF_CONV(48) MRF_CONV(64) MRF_CONV(80)
    MRF_CONV(96) MRF_CONV(112) MRF_CONV(128) MRF_CONV(144) MRF_CONV(160)
    MRF_CONV(176)
  }
#undef MRF_CONV
}

constexpr int PASS = 8;  // float4s a thread moves at once (loads first)

__global__ void __launch_bounds__(NT, 1)
mrf_kernel_wide(const __grid_constant__ CUtensorMap tmap,
                const float* __restrict__ x, const float* __restrict__ b_all,
                float* __restrict__ out, float* __restrict__ v_all,
                const int* __restrict__ valid_ptr, int T, const Plan pl,
                MrfOps ops, int n_slices, float inv_nk, float slope) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int tm = pl.tm, H = pl.H;
  const int n_tiles = (T + tm - 1) / tm;
  const int valid = min(max(*valid_ptr, 0), T);
  unsigned char* act = smem + pl.buf_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + pl.bar_off);
  uint64_t* empty = full + pl.slots;
  float* vs = v_all + (size_t)blockIdx.x * (tm + 2 * H) * DW;
  // this block's tiles with a row below valid, each n_slices slices
  const int live_tiles = (valid + tm - 1) / tm;
  const int mine = blockIdx.x < live_tiles
                       ? (live_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;

  const Ring ring{smem, full, empty, &tmap, pl.slots, mine * n_slices,
                  n_slices};
  if (tid == 0) {
    for (int s = 0; s < pl.slots; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NT / 32);
    }
    sm90::fence_mbar_init();
    for (int s = 0; s < pl.slots && s < ring.total; ++s) ring.load(s);
  }
  __syncthreads();
  // rows past a conv's extent are read (never kept): start the buffer at
  // zero so they stay finite
  for (int i = tid; i < (DW / 8) * pl.r_alloc; i += NT)
    reinterpret_cast<float4*>(act)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  consumers_sync();

  const uint32_t chunk = pl.r_alloc * 16;
  int q = 0;  // the ring's next slice
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * tm;
    const int base = row0 - H;  // global row of buffer row 0
    if (row0 >= valid) {  // every row masked: zeros only
      for (int i = tid; i < tm * DW; i += NT)
        if (row0 + i / DW < T) out[(size_t)row0 * DW + i] = 0.f;
      continue;
    }
    for (int j = 0; j < ops.n_chains; ++j) {
      int M = 0;
      for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
      int a = H - M, b = H + tm + M;

      // the buffer := the activation of x (masked) over the chain's extent
      const int n_in = (b - a) * (DW / 4);
      for (int i0 = tid; i0 < n_in; i0 += PASS * NT) {
        float4 xv[PASS];
#pragma unroll
        for (int u = 0; u < PASS; ++u) {
          const int i = i0 + u * NT, gr = base + a + i / (DW / 4);
          xv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n_in && gr >= 0 && gr < valid)
            xv[u] = __ldg(reinterpret_cast<const float4*>(
                              x + (size_t)gr * DW) + i % (DW / 4));
        }
#pragma unroll
        for (int u = 0; u < PASS; ++u) {
          const int i = i0 + u * NT, r = a + i / (DW / 4), c4 = i % (DW / 4);
          if (i >= n_in) break;
          const float4 v = xv[u];
          const __nv_bfloat162 lo = __floats2bfloat162_rn(lrelu(v.x, slope),
                                                          lrelu(v.y, slope));
          const __nv_bfloat162 hi = __floats2bfloat162_rn(lrelu(v.z, slope),
                                                          lrelu(v.w, slope));
          *reinterpret_cast<uint2*>(act + (c4 >> 1) * chunk + r * 16 +
                                    (c4 & 1) * 8) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
      }
      sm90::fence_proxy_async();
      consumers_sync();

      const Residual from_x{x, base, 0, valid};
      const Residual from_v{vs, 0, 0, tm + 2 * H};
      for (int m = 0; m + 1 < ops.n_ops[j]; m += 2) {
        const int w1 = ops.w[j][m], w2 = ops.w[j][m + 1];
        conv(smem, pl, ring, q, b_all + (size_t)ops.bidx[j][m] * DW, false,
             from_v, vs, w1, a, b, base, valid, slope);
        a += w1;
        b -= w1;
        conv(smem, pl, ring, q, b_all + (size_t)ops.bidx[j][m + 1] * DW,
             true, m == 0 ? from_x : from_v, vs, w2, a, b, base, valid, slope);
        a += w2;
        b -= w2;
      }

      // a == H and b == H + tm: fold the chain's centre rows into the sum
      const bool first = j == 0, last = j == ops.n_chains - 1;
      const int n_out = min(tm, T - row0) * (DW / 4);
      for (int i0 = tid; i0 < n_out; i0 += PASS * NT) {
        float4 sum[PASS], cur[PASS];
#pragma unroll
        for (int u = 0; u < PASS; ++u) {
          const int i = i0 + u * NT;
          sum[u] = cur[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n_out) {
            cur[u] = reinterpret_cast<const float4*>(vs + (size_t)H * DW)[i];
            if (!first)
              sum[u] = reinterpret_cast<const float4*>(
                  out + (size_t)row0 * DW)[i];
          }
        }
#pragma unroll
        for (int u = 0; u < PASS; ++u) {
          const int i = i0 + u * NT, r = i / (DW / 4);
          if (i >= n_out) break;
          float4 s = cur[u];
          s.x += sum[u].x; s.y += sum[u].y; s.z += sum[u].z; s.w += sum[u].w;
          if (last) {
            const float k = row0 + r < valid ? inv_nk : 0.f;
            s.x *= k; s.y *= k; s.z *= k; s.w *= k;
          }
          reinterpret_cast<float4*>(out + (size_t)row0 * DW)[i] = s;
        }
      }
      consumers_sync();
    }
  }
}

}  // namespace widev

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

// The maps of the last few W_all encoded, by pointer, rows and width: a
// map holds nothing else, so a hit is the map the encoder would give, and
// a batch, which launches each stage once a row, encodes each stage's map
// once.
struct MapEntry {
  CUtensorMap map;
  const void* W;
  int rows, d;
};
constexpr int MAP_CACHE = 8;
MapEntry map_cache[MAP_CACHE] = {};
int map_next = 0;

// The tensor map of the bf16 W_all (rows x d, row-major) in boxes of
// box_rows k rows x 64 columns with the 128-byte swizzle: a box is one
// warpgroup's output channels of a ring slice, laid out as
// bf16v::slice_offset (d = 128, boxes of 128 rows) or widev::slice_desc
// (d = 256, boxes of 64 rows) read it.  The driver's encoder is found
// through the runtime, so nothing links against the driver library.
cudaError_t w_tensor_map(CUtensorMap* map, const void* W, int rows, int d,
                         int box_rows) {
  for (const MapEntry& m : map_cache) {
    if (m.W == W && m.rows == rows && m.d == d) {
      *map = m.map;
      return cudaSuccess;
    }
  }
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(W), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  map_cache[map_next] = {*map, W, rows, d};
  map_next = (map_next + 1) % MAP_CACHE;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bf16 W_all; x, b_all and out float32.  The plan (tile rows tm, ring
// slots, rows of a channel chunk, the buffer's, v's and the barriers'
// byte offsets, shared memory) comes from mrf_block.py::bf16_plan.
int mrf_launch(const void* x, const void* W, const void* b_all, void* out,
               const void* valid, int T, int H, int tm, int slots,
               int r_alloc, int buf_off, int v_off, int bar_off, int smem,
               const int* spec, int num_kernels, float slope, void* stream) {
  using namespace bf16v;
  MrfOps ops;
  if (!parse_spec(spec, ops)) return cudaErrorInvalidValue;
  // the ring streams W_all's tap slices in row order: the ops must be
  // stacked in the order they run, and every conv's output rows fit one
  // instruction
  int rows = 0;
  for (int j = 0; j < ops.n_chains; ++j) {
    int M = 0;
    for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
    if (M > H) return cudaErrorInvalidValue;
    int extent = tm + 2 * M;
    for (int m = 0; m < ops.n_ops[j]; ++m) {
      const int w = ops.w[j][m];
      if (w < 0 || ops.woff[j][m] != rows) return cudaErrorInvalidValue;
      rows += (2 * w + 1) * D;
      extent -= 2 * w;
      if (extent > MAX_N) return cudaErrorInvalidValue;
    }
  }
  const Plan pl{tm, H, slots, r_alloc, buf_off, v_off, bar_off};
  if (tm <= 0 || tm % 16 || tm > MAX_TM || slots < 2 || slots > MAX_SLOTS ||
      buf_off < slots * SLICE || buf_off % 16 ||
      r_alloc < tm + 2 * H + 15 || v_off < buf_off + (D / 8) * r_alloc * 16 ||
      v_off % 16 || bar_off < v_off + (tm + 2 * H) * D * 4 || bar_off % 8 ||
      smem < bar_off + 16 * slots + 1024)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = w_tensor_map(&map, W, rows, D, D);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mrf_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mrf_kernel<<<(T + tm - 1) / tm, NT_ALL, smem,
               static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const float*>(x), static_cast<const float*>(b_all),
      static_cast<float*>(out), static_cast<const int*>(valid), T, pl, ops,
      rows / D, 1.0f / num_kernels, slope);
  return cudaGetLastError();
}

// bf16 W_all of a stage 256 wide; x, b_all and out float32; v_all grid
// regions of (tm + 2 H) x 256 floats, the blocks' v.  The plan (tile rows
// tm, ring slots, rows of a channel chunk, the buffer's and the barriers'
// byte offsets, shared memory, blocks) comes from mrf_block.py::bf16_plan
// at d = 256.
int mrf_wide_launch(const void* x, const void* W, const void* b_all,
                    void* out, void* v_all, const void* valid, int T, int H,
                    int tm, int slots, int r_alloc, int buf_off, int bar_off,
                    int smem, int grid, const int* spec, int num_kernels,
                    float slope, void* stream) {
  using namespace widev;
  MrfOps ops;
  if (!parse_spec(spec, ops)) return cudaErrorInvalidValue;
  int rows = 0;
  for (int j = 0; j < ops.n_chains; ++j) {
    int M = 0;
    for (int m = 0; m < ops.n_ops[j]; ++m) M += ops.w[j][m];
    if (M > H) return cudaErrorInvalidValue;
    int extent = tm + 2 * M;
    for (int m = 0; m < ops.n_ops[j]; ++m) {
      const int w = ops.w[j][m];
      if (w < 0 || ops.woff[j][m] != rows) return cudaErrorInvalidValue;
      rows += (2 * w + 1) * DW;
      extent -= 2 * w;
      if (extent > MAX_N) return cudaErrorInvalidValue;
    }
  }
  const Plan pl{tm, H, slots, r_alloc, buf_off, bar_off};
  if (tm <= 0 || tm % 16 || tm > MAX_TM || slots < 2 || slots > MAX_SLOTS ||
      buf_off < slots * SLICE || buf_off % 16 ||
      r_alloc < tm + 2 * H + 15 ||
      bar_off < buf_off + (DW / 8) * r_alloc * 16 || bar_off % 8 ||
      smem < bar_off + 16 * slots + 1024 || grid < 1)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = w_tensor_map(&map, W, rows, DW, KS);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(mrf_kernel_wide,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  mrf_kernel_wide<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const float*>(x), static_cast<const float*>(b_all),
      static_cast<float*>(out), static_cast<float*>(v_all),
      static_cast<const int*>(valid), T, pl, ops, rows / KS,
      1.0f / num_kernels, slope);
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
