// One mel-decoder block body, forward and backward (kernel K4).
//
// Replaces: efficientspeech_tpu/ops/pallas/decoder_block.py::
// decoder_block_fused (_recompute_to_t, _fwd_kernel, _bwd_kernel and the
// custom VJP).  For x (B, M, C) bf16, C = 128 or 256, and keep (B, M)
// float32:
//
//   xm = bf16(x * keep)                         masked input
//   u  = sum_tap xm[m + tap - 2] * dw[tap]      k = 5, taps summed in bf16,
//        + dw_b                                 in tap order
//   v  = bf16(u @ W  | float32 accumulate) + pw_b   (C x C pointwise conv)
//   t  = tanh(v)                                (bf16)
//   y  = LayerNorm(t; float32 statistics) * ln_s + ln_b   -> bf16
//
// and its gradient: dx (masked by keep) and float32 partial sums of the
// seven weight gradients, one set per block (or cluster), summed by the
// caller.  The gradient with respect to keep is zero.  A float32 variant of
// both kernels (x, y, dx, dy float32, every step in float32) follows the
// bf16 ones below, with its own note.
//
// The bf16 forward (GeoHF, C = 128 and 256).  What bounds it on an H100:
// bytes.  At B = 128, M = 1024 it reads x and writes y once (67 MB at C =
// 256, 0.040 ms at 3.35 TB/s); the pointwise product is 17.2 GFLOP, 17 us
// of tensor-core time.  It keeps every intermediate in shared memory and
// registers, and it is the backward's front half (GeoH, below), sharing
// its parts.  Design:
// - Tiles of R = 64 rows (wgmma's M), every row the tile's own: u of a
//   row needs x of its two neighbours on each side, so a tile reads R + 4
//   x rows.  Blocks of C / 64 warpgroups (two at C = 128, four at C =
//   256) are persistent over the tiles; C = 128 fits three blocks an SM
//   (70 KB each), C = 256 one (203 KB: all of W).
// - x's rows by TMA tensor copies (the backward's x map: boxes of 64
//   channels x 68 rows, rows outside [0, M) as zeros) into one slot; the
//   next tile's are issued as soon as this tile's u is written, and land
//   during the product and the row pass.
// - u by a window of x rows sliding down a column, two channels an
//   instruction (bf16x2): a thread takes one 16-byte chunk of 4 rows and
//   reads each of its 8 x rows once, scaling a row whose keep is not 1,
//   and writes u straight into 128-byte-swizzled K-major tiles; warpgroup
//   wg writes the tile of channels 64 wg ...
// - v = u W on wgmma.m64n64k16 (bf16, float32 accumulation), warpgroup wg
//   taking output columns 64 wg ..; W's C x C in 128-byte-swizzled
//   MN-major tiles, loaded once a block.
// - t = tanh(bf16(v) + pw_b) and the LayerNorm in the accumulators: a
//   row's mean and sum of squared deviations over a warpgroup's 64
//   columns from a lane quad, combined across the row's C / 64 slots by
//   Chan's pairwise formulas, one exchange a tile.  y is staged in bf16
//   over the warpgroup's u tile (free once every warpgroup's product is
//   done) in the 128-byte swizzle and written by one TMA tensor store a
//   warpgroup (y's map: boxes of 64 channels x 64 rows, rows at or beyond
//   M clipped); the warpgroup waits for the store to have read the tile
//   before its next u, so only its own four warps meet at those
//   barriers.  (y written straight from the accumulators as 16-byte row
//   segments, a quad's lanes trading their pairs, was slower: PERF.md.)
// - The shared-memory plan is decoder_block.py::bf16_fwd_plan.

// The bf16 backward (GeoH, C = 128 and 256).  What bounds it: bytes, x
// and dy read and dx written, 201 MB at C = 256 (0.060 ms at 3.35 TB/s),
// with its three C x C products close behind (v = u W recomputed, du = dv
// W^T, the weight gradient u^T dv: 51.5 GFLOP at C = 256, 0.052 ms of
// tensor-core time).  Design:
// - Tiles of R = 64 rows (wgmma's M), of which the inner 60 are the
//   tile's own: dx of a frame needs du of its 2 neighbours on each side,
//   so the outer 2 rows on each side are recomputed.  Each block (two
//   warpgroups, one block an SM, persistent over the tiles) owns 128
//   columns: at C = 256 a tile is spread over a cluster of two blocks, so
//   nothing is computed twice.  Block p computes u of its 128 channels,
//   v, t and dv of its 128 output columns, du and dx of its 128 input
//   channels, and keeps the weight gradient of its 128 output columns
//   (all C input channels: 128 float32 registers a thread at C = 256) in
//   the wgmma accumulators across all its tiles.  The two blocks of a
//   cluster swap their halves of u and of dv by bulk copies between their
//   shared memories and the rows' LayerNorm partial sums by st.async,
//   each completing on an mbarrier of the receiving block, so a block
//   waits only for the data it needs; it runs the k-steps of its own half
//   first.  A split cluster barrier (arrive after the dx pass, wait before
//   the next tile's u is sent) keeps a block from writing into the
//   other's u before that one is done with it.  At C = 128 a cluster is
//   one block.
// - All three products on wgmma.m64n64k16 (bf16, float32 accumulation),
//   operands from shared memory in 64 x 64 tiles with the 128-byte
//   swizzle: v = u W (u K-major, W MN-major), du = dv W^T (dv K-major, W
//   K-major: one copy of W serves both), the weight gradient u^T dv (both
//   MN-major: the rows are K, read straight from the u and dv tiles).  A
//   block loads the W tiles it needs once (96 KB of 128 at C = 256: its
//   output columns' and its input channels').  Warpgroup wg takes 64 of
//   the block's columns in each product; the rows are M, so a row of v
//   sits in the four lanes of a quad and t, the LayerNorm and dv are
//   computed in the accumulators.  The rows' statistics are combined
//   across the four 64-column slots of a row by Chan's pairwise formulas
//   (mean, sum of squared deviations, sum g, sum g (t - mean)), one
//   exchange a tile.
// - Loads: x's and dy's rows by TMA tensor copies ((C, M, B) maps, so
//   rows outside [0, M) arrive as zeros) into three rotating slots, the
//   next tile's issued once this tile's dy and t are read, landing during
//   the dx pass; rows whose keep is not 1 are scaled in place (the taps'
//   gradient reads them again).  u is the forward's depthwise: a window
//   sliding down each column, two channels an instruction (bf16x2).  The
//   column sums of the vector gradients (pw bias, LN scale and bias) come
//   from a pass over t (kept in bf16, exactly) and dy in shared memory.
// - No float atomics: each cluster writes one float32 partial of each
//   weight gradient (the weight gradient's in its (C_in, C_out) layout),
//   summed by the caller, so two launches give the same bits.  The
//   shared-memory plan is decoder_block.py::bf16_bwd_plan.
//
// Numerics: the depthwise taps are rounded to bf16 after every product
// and every sum, exactly as the bf16 arithmetic of _recompute_to_t (a
// product of two bf16 values is exact in float32, and float32 rounding
// before bf16 rounding of a sum of two bf16 values gives the same bits);
// v is rounded to bf16 before + pw_b (a bf16 addition), t = tanh in
// bf16, the LayerNorm statistics and the row pass in float32, dv rounded
// to bf16 before both products, the weight gradient over the owned rows
// only.  tanhf, and the
// order of the float32 sums, differ from XLA's, so the kernels are held
// to their plain version by SNR.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int K = 5;
constexpr int PAD = K / 2;
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr size_t SM_SMEM = 233472;     // shared memory of an SM (228 KB)

// Phase stamps for probes/k4_bwd_phases.py: built with
// -DDECODER_BLOCK_STAMPS, thread 0 of every block of each kernel adds the
// %globaltimer time between consecutive stamps to db_stamps[phase];
// compiled out otherwise.
#ifdef DECODER_BLOCK_STAMPS
constexpr int N_STAMPS = 10;
__device__ unsigned long long db_stamps[N_STAMPS];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define DB_STAMP(i)                                   \
  if (threadIdx.x == 0) {                             \
    const unsigned long long now_ = global_ns();      \
    stamp_ns[i] += now_ - stamp_last;                 \
    stamp_last = now_;                                \
  }
#else
#define DB_STAMP(i)
#endif

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The lane's C/32 columns: 4 consecutive ones in each 128-column chunk,
// chunk h's at 128 h + 4 lane.  v[h * 4 + i] <- p[128 h + 4 lane + i].
template <class G>
__device__ __forceinline__ void lane_cols(const float* __restrict__ p,
                                          int lane, float* v) {
#pragma unroll
  for (int h = 0; h < G::C / 128; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[h * 4 + i] = p[h * 128 + lane * 4 + i];
}

// keep of x row u0 - PAD + i of sequence b, 0 outside [0, M)
__device__ __forceinline__ float keep_of(const float* __restrict__ keep,
                                         int b, int u0, int M, int i) {
  const int g = u0 - PAD + i;
  return g >= 0 && g < M ? __ldg(keep + (size_t)b * M + g) : 0.f;
}

// `bytes` (a multiple of 16, from a 16-byte aligned address) of device
// memory into L2, by the TMA unit, ahead of their loads
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
               ::"l"(p), "r"(bytes) : "memory");
}

// ---------------------------------------------------------------------------
// The bf16 backward (GeoH; the design is in the note at the top).

template <int C_>
struct GeoH {
  static constexpr int C = C_;
  static constexpr int R = 64;                 // rows of u a tile (wgmma M)
  static constexpr int OWN = R - 2 * PAD;      // the inner rows a tile owns
  static constexpr int NT = 256;               // two warpgroups
  static constexpr int SPLIT = C / 128;        // blocks of a cluster (a tile)
  static constexpr int SLOTS = 2 * SPLIT;      // 64-column parts of a row
  static constexpr int NCH = C / 64;           // 64-channel operand tiles
  static constexpr int TILE = 64 * 64 * 2;     // an operand tile's bytes
  static constexpr int W_TILES = 4 * NCH - 4;  // the W tiles a block holds
  static constexpr int U_OFF = W_TILES * TILE;
  static constexpr int DV_OFF = U_OFF + NCH * TILE;
  static constexpr int LDU = 128;              // du's float32 row stride (over
                                               // u, and dv at C = 128)
  static constexpr int XROWS = R + 2 * PAD;
  // x rows: two boxes of 64 channels, rows 128 bytes apart
  static constexpr int XBOX = XROWS * 128;
  static constexpr int LDY = 136;              // t's bf16 stride
  // three slots that take a tile's x rows, dy rows (two 64 x 64 boxes in
  // the 128-byte swizzle) and t in turn, so the next tile's x and dy land
  // while this tile's x is still read; each 1 KB aligned
  static constexpr int SLOT = 2 * XBOX;
  static constexpr int LOAD_BYTES = 2 * XBOX + 2 * TILE;
  static constexpr int SLOT_OFF = DV_OFF + NCH * TILE;
  // the rows' partial sums [4][R][4] (mean, M2, sum g, sum g (t - mean)
  // over each 64-column slot of the row), then their statistics [4][R]
  static constexpr int ST_OFF = SLOT_OFF + 3 * SLOT;
  static constexpr int CS_OFF = ST_OFF + 20 * R * 4;
  static constexpr int KP_OFF = CS_OFF + 4 * 3 * 128 * 4;
  static constexpr int KP_STRIDE = (XROWS + 3) / 4 * 4;
  static constexpr int PAR_OFF = KP_OFF + 2 * KP_STRIDE * 4;
  // mbarriers: this tile's x and dy rows landed; the other block's half
  // of u, its row sums, its half of dv arrived
  static constexpr int BAR_OFF = PAR_OFF + (K + 1) * 128 * 2 + 2 * 128 * 4;
  static constexpr int SMEM = BAR_OFF + 4 * 8;
  static constexpr int SMEM_ALLOC = SMEM + 1024;  // room to align the base
  static_assert(SPLIT == 1 || SPLIT == 2, "a cluster of one or two blocks");
  static_assert(SMEM_ALLOC <= (int)SMEM_LIMIT, "backward smem");
  static_assert(R * LDY * 2 <= SLOT && 2 * TILE <= SLOT, "dy, t fit a slot");
  static_assert(SLOT % 1024 == 0 && SLOT_OFF % 1024 == 0, "slots aligned");
  static_assert(R * LDU * 4 <= SLOT_OFF - U_OFF, "du fits over u and dv");
  static_assert(OWN % 4 == 0, "owned rows split over four row groups");
  static_assert(XROWS % 4 == 0, "the x rows' keep values as float4");
  static_assert(4 * (K + 1) * 128 * 4 <= SLOT, "the final sums fit a slot");
};

// byte offset of the 16-byte chunk c (elements 8 c .. 8 c + 7) of row r of
// a 64 x 64 bf16 operand tile: rows of 128 bytes, chunks XORed with the
// row (the 128-byte swizzle; tiles 1024-byte aligned)
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma descriptor of an operand in such tiles from `addr`: 8-row groups
// 1 KB apart (stride byte offset), `lbo` the leading byte offset (unused
// by the shapes here: K-major operands step K inside a tile row, and an
// MN-major one spans one tile's 64 columns)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, float32) += A (64 x 16 bf16) B (16 x 64 bf16), both from
// shared memory; TA / TB: A / B MN-major (1) or K-major (0); D = A B when
// !accumulate.  D's layout: lane 4 g + t of warp q holds, for each
// 8-column block j, rows 16 q + g (d[4 j], d[4 j + 1]) and 16 q + g + 8
// (d[4 j + 2], d[4 j + 3]) at columns 8 j + 2 t and 8 j + 2 t + 1.
template <int TA, int TB>
__device__ __forceinline__ void wgmma64(float (&d)[32], uint64_t a,
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// The slot in shared memory of W's tile (a, b) (input channels 64 a ..,
// output channels 64 b ..) for block p of a cluster, which holds the tiles
// of its own output columns (b = 2 p, 2 p + 1: v = u W) first, then those
// of its own input channels in the other columns (a = 2 p, 2 p + 1: du =
// dv W^T).
template <class G>
__device__ __forceinline__ int w_slot(int a, int b, int p) {
  if ((b >> 1) == p) return 2 * a + (b & 1);
  return 2 * G::NCH + (a & 1) * (G::NCH - 2) + (b < 2 * p ? b : b - 2);
}

// the float pair of a bf16 pair in shared memory
__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a b and a + b on bf16 pairs, each rounded to bf16 (the explicit .rn
// keeps them from being contracted into one fused multiply-add, which
// would skip the product's rounding)
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  __nv_bfloat162 d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<uint32_t*>(&d))
      : "r"(*reinterpret_cast<uint32_t*>(&a)),
        "r"(*reinterpret_cast<uint32_t*>(&b)));
  return d;
}

__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a,
                                                 __nv_bfloat162 b) {
  __nv_bfloat162 d;
  asm("add.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<uint32_t*>(&d))
      : "r"(*reinterpret_cast<uint32_t*>(&a)),
        "r"(*reinterpret_cast<uint32_t*>(&b)));
  return d;
}

// u of rows r0 .. r0 + RW - 1 of one 16-byte chunk (8 channels) in bf16
// arithmetic, two channels an instruction (mul_rn and add_rn round as
// bfr(__fmul_rn) and bfr(__fadd_rn) do: a product of two bf16 values is
// exact in float32), into column chunk `ch` of a 128-byte-swizzled
// K-major tile: a window of K x rows slides down the chunk's column of a
// plain box of x rows (128 bytes apart), so each x row is read once.  xc:
// the chunk in x row r0 (u row r0's first tap); wv: the chunk's K taps and
// bias; KEEP: scale each x row by its keep value kr[i] (in float32, then
// rounded) where that is not 1 (else the rows are already scaled and kr
// is not read).
template <int RW, bool KEEP>
__device__ __forceinline__ void depthwise_chunk(const unsigned char* xc,
                                                const float* kr,
                                                const uint4 (&wv)[K + 1],
                                                unsigned char* ut, int r0,
                                                int ch) {
  auto x_row = [&](int i) {
    uint4 v = *reinterpret_cast<const uint4*>(xc + i * 128);
    const float k = KEEP ? kr[i] : 1.f;
    if (k != 1.f) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(f.x * k, f.y * k);
      }
    }
    return v;
  };
  uint4 xw[K];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) xw[j] = x_row(j);
  const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&wv[K]);
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    xw[K - 1] = x_row(j + K - 1);
    __nv_bfloat162 acc[4];
#pragma unroll
    for (int tap = 0; tap < K; ++tap) {
      const __nv_bfloat162* xh =
          reinterpret_cast<const __nv_bfloat162*>(&xw[tap]);
      const __nv_bfloat162* wh =
          reinterpret_cast<const __nv_bfloat162*>(&wv[tap]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 m = mul_rn(xh[e], wh[e]);
        acc[e] = tap ? add_rn(acc[e], m) : m;
      }
    }
    uint4 o;
    __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) oh[e] = add_rn(acc[e], bh[e]);
    *reinterpret_cast<uint4*>(ut + sw128(r0 + j, ch)) = o;
#pragma unroll
    for (int i = 0; i < K - 1; ++i) xw[i] = xw[i + 1];
  }
}

// t = bf16(tanh(bf16(bf16(v) + pb))) in place over a warpgroup's 64
// accumulator columns (v's layout: wgmma64's D; pb, already rounded to
// bf16, at the lane's columns lc0 + 8 j of pbs; the bf16 addition by
// add_rn), and the mean and M2 = sum (t - mean)^2 of each of the lane's
// two rows over those 64 columns, from its lane quad; each(j, h, tb) sees
// every pair of t as it is made
template <class F>
__device__ __forceinline__ void tanh_row_stats(float (&acc)[32],
                                               const float* pbs, int lc0,
                                               float (&mk)[2],
                                               float (&sq)[2], F&& each) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 pf = *reinterpret_cast<const float2*>(pbs + lc0 + 8 * j);
    const __nv_bfloat162 pb = __floats2bfloat162_rn(pf.x, pf.y);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& a0 = acc[4 * j + 2 * h];
      float& a1 = acc[4 * j + 2 * h + 1];
      const float2 vb =
          __bfloat1622float2(add_rn(__floats2bfloat162_rn(a0, a1), pb));
      const __nv_bfloat162 tb =
          __floats2bfloat162_rn(tanhf(vb.x), tanhf(vb.y));
      each(j, h, tb);
      const float2 tf = __bfloat1622float2(tb);
      a0 = tf.x;
      a1 = tf.y;
      s[h] += a0 + a1;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    mk[h] = s[h] * (1.f / 64);
    sq[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float c0 = acc[4 * j + 2 * h] - mk[h];
      const float c1 = acc[4 * j + 2 * h + 1] - mk[h];
      sq[h] += c0 * c0 + c1 * c1;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
  }
}

// a row's mean and rstd = 1 / sqrt(var + eps) over its S 64-column slots,
// from each slot's mean mk[k] and M2 m2[k] (Chan's pairwise formulas, as
// stable as two passes)
template <int S>
__device__ __forceinline__ void chan_stats(const float (&mk)[S],
                                           const float (&m2)[S], float eps,
                                           float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) s += mk[k];
  mean = s / S;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float dm = mk[k] - mean;
    q += m2[k] + 64.f * dm * dm;
  }
  rstd = 1.f / sqrtf(q / (64 * S) + eps);
}

// du's float32 rows (stride GeoH::LDU): columns in 8-column blocks XORed
// with the row, so the stores from the accumulators meet 32 banks
__device__ __forceinline__ int du_at(int r, int col) {
  return r * 128 + (col ^ ((r & 7) << 3));
}

// x's and dy's tensor maps: (C, M, B) bf16, boxes of 64 channels x rows
// x 68 rows, plain; dy 64 rows, in the 128-byte swizzle (tensor_map)
template <int C>
__global__ void __launch_bounds__(GeoH<C>::NT, 1)
    decoder_block_bwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_dy,
                             const float* __restrict__ keep,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ dww,
                             const float* __restrict__ dwb,
                             const float* __restrict__ pwb,
                             const float* __restrict__ lns,
                             __nv_bfloat16* __restrict__ dx,
                             float* __restrict__ part_pw,
                             float* __restrict__ part_vec, int B, int M,
                             float eps) {
  using G = GeoH<C>;
  constexpr int NT = G::NT, R = G::R, NCH = G::NCH, TILE = G::TILE;
  constexpr int SLOTS = G::SLOTS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* us = smem + G::U_OFF;    // u, NCH tiles of 64 channels
  unsigned char* dvs = smem + G::DV_OFF;  // dv, the same
  float* dus = reinterpret_cast<float*>(us);  // du, over u (and dv)
  unsigned char* slots = smem + G::SLOT_OFF;
  float4* st = reinterpret_cast<float4*>(smem + G::ST_OFF);  // [4][R]
  // the rows' mean, rstd, mean(g) and mean(g that)
  float* rowst = reinterpret_cast<float*>(st + 4 * R);
  float* cs = reinterpret_cast<float*>(smem + G::CS_OFF);  // [4][3][128]
  float* kps = reinterpret_cast<float*>(smem + G::KP_OFF);  // two tiles'
  // the block's 128 channels of the dw taps and bias in bf16, then its
  // columns of the pw bias (rounded to bf16) and the LN scale in float32
  __nv_bfloat16* dwt =
      reinterpret_cast<__nv_bfloat16*>(smem + G::PAR_OFF);  // [K + 1][128]
  float* pbs = reinterpret_cast<float*>(smem + G::PAR_OFF + (K + 1) * 256);
  float* lnss = pbs + 128;
  uint64_t* bar_ld = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
  uint64_t* bar_u = bar_ld + 1;
  uint64_t* bar_st = bar_ld + 2;
  uint64_t* bar_dv = bar_ld + 3;
#ifdef DECODER_BLOCK_STAMPS
  unsigned long long stamp_ns[N_STAMPS] = {}, stamp_last = global_ns();
#endif

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int p = G::SPLIT > 1 ? (int)sm90::cluster_rank() : 0;
  const int peer = p ^ 1, h0 = 128 * p;
  const int cluster = blockIdx.x / G::SPLIT;
  const int nclusters = gridDim.x / G::SPLIT;
  const int tiles_m = (M + G::OWN - 1) / G::OWN;
  const int n_tiles = B * tiles_m;
  // u row 0's row in its sequence, and the sequence, of tile `tl`
  auto tile_u0 = [&](int tl, int& tb) {
    tb = tl / tiles_m;
    return (tl - tb * tiles_m) * G::OWN - PAD;
  };

  // W's tiles, once: slot s holds tile (a, b) (w_slot's inverse)
  for (int i = tid; i < G::W_TILES * 64 * 8; i += NT) {
    const int s = i >> 9, r = (i >> 3) & 63, c = i & 7;
    int a = s >> 1, b = 2 * p + (s & 1);
    if constexpr (NCH > 2) {
      if (s >= 2 * NCH) {
        const int s2 = s - 2 * NCH, bb = s2 % (NCH - 2);
        a = 2 * p + s2 / (NCH - 2);
        b = bb < 2 * p ? bb : bb + 2;
      }
    }
    sm90::cp_async16(smem + s * TILE + sw128(r, c),
                     w + (size_t)(64 * a + r) * C + 64 * b + 8 * c);
  }
  for (int i = tid; i < 128; i += NT) {
#pragma unroll
    for (int tap = 0; tap < K; ++tap)
      dwt[tap * 128 + i] = __float2bfloat16_rn(dww[tap * C + h0 + i]);
    dwt[K * 128 + i] = __float2bfloat16_rn(dwb[h0 + i]);
    pbs[i] = bfr(pwb[h0 + i]);
    lnss[i] = lns[h0 + i];
  }
  for (int i = tid; i < 4 * 3 * 128; i += NT) cs[i] = 0.f;
  // the x rows (u0 - 2 .. u0 + 65) of tile `tl` of the block's channels
  // into slot sx and its dy rows (u0 .. u0 + 63) into slot sy: four TMA
  // boxes, rows outside [0, M) as zeros, counted on bar_ld
  auto load_tile = [&](int tl, int sx, int sy) {
    int tb;
    const int tu0 = tile_u0(tl, tb);
    sm90::mbar_expect_tx(bar_ld, G::LOAD_BYTES);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sm90::tma_load_3d(slots + sx * G::SLOT + h * G::XBOX, &tm_x,
                        h0 + 64 * h, tu0 - PAD, tb, bar_ld);
      sm90::tma_load_3d(slots + sy * G::SLOT + h * TILE, &tm_dy,
                        h0 + 64 * h, tu0, tb, bar_ld);
    }
  };
  // the keep value of x row tid of tile `tl` (threads below XROWS)
  auto keep_at = [&](int tl) {
    int tb;
    const int tu0 = tile_u0(tl, tb);
    return tid < G::XROWS && tl < n_tiles ? keep_of(keep, tb, tu0, M, tid)
                                          : 0.f;
  };
  // the weight gradient of the block's columns: warpgroup wg's 64, all C
  // input channels (m-block mb: channels 64 mb ..), across every tile
  float accw[NCH][32];
#pragma unroll
  for (int mb = 0; mb < NCH; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) accw[mb][i] = 0.f;
  // the dx pass: channels h0 + 2 pc, + 1 of row group rg; their depthwise
  // gradients' partial sums
  const int pc = tid & 63, rg = tid >> 6;
  float2 p_dw[K], p_dwb = make_float2(0.f, 0.f);
#pragma unroll
  for (int tap = 0; tap < K; ++tap) p_dw[tap] = make_float2(0.f, 0.f);
  // row pass: lane (g, t) of warp warp % 4 of warpgroup wg holds rows r0
  // and r0 + 8, columns 64 wg + 8 j + 2 t, + 1 (j < 8) of the block's 128
  const int r0 = 16 * (warp & 3) + g, lc0 = 64 * wg + 2 * t;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(bar_ld + i, 1);
    sm90::fence_mbar_init();
  }
  // the other block's st, u, dv and mbarriers (shared::cluster addresses)
  uint32_t st_peer = 0, u_peer = 0, dv_peer = 0, bars_peer = 0;
  if constexpr (G::SPLIT > 1) {
    st_peer = sm90::map_to_rank(st, peer);
    u_peer = sm90::map_to_rank(us + 2 * p * TILE, peer);
    dv_peer = sm90::map_to_rank(dvs + 2 * p * TILE, peer);
    bars_peer = sm90::map_to_rank(bar_ld, peer);
  }
  __syncthreads();  // the mbarriers are initialised

  // the first tile's rows
  if (tid < G::XROWS) kps[tid] = keep_at(cluster);
  sm90::cp_async_commit();  // W's tiles
  __syncthreads();
  if (tid == 0 && cluster < n_tiles) load_tile(cluster, 0, 1);
  // the other block is done with its u (and du over it): arrive here, wait
  // before sending into it (the arrival also publishes the mbarriers)
  if constexpr (G::SPLIT > 1) sm90::cluster_arrive();

  int it = 0;  // the block's tiles so far: x in slot it % 3, dy in the
               // next one, t in the one after
  for (int tile = cluster; tile < n_tiles; tile += nclusters, ++it) {
    int b;
    const int u0 = tile_u0(tile, b);
    const size_t row0 = (size_t)b * M;
    const int sx = it % 3, sy = (it + 1) % 3, sv = (it + 2) % 3;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(slots + sx * G::SLOT);
    // dy: tile wg holds warpgroup wg's 64 columns
    const unsigned char* dyb = slots + sy * G::SLOT;
    const unsigned char* dyt = dyb + wg * TILE;
    __nv_bfloat16* ts = reinterpret_cast<__nv_bfloat16*>(slots + sv * G::SLOT);
    const float* kp = kps + (it & 1) * G::KP_STRIDE;
    const int next = tile + nclusters;
    const uint32_t par = it & 1;  // the mbarriers' phase this tile
    if (G::SPLIT > 1 && tid == 0) {
      sm90::mbar_expect_tx(bar_u, 2 * TILE);
      sm90::mbar_expect_tx(bar_st, 2 * R * 16);
      sm90::mbar_expect_tx(bar_dv, 2 * TILE);
    }
    // the next tile's keep values, stored after v, when they have come
    const float keep_next = keep_at(next);
    sm90::mbar_wait(bar_ld, par);  // this tile's x and dy
    DB_STAMP(6);
    // x rows whose keep is not 1: bf16(x keep), zeros where it is 0
    if (tid < G::XROWS && kp[tid] != 1.f) {
      const float k = kp[tid];
#pragma unroll 4
      for (int c = 0; c < 16; ++c) {
        uint4* q = reinterpret_cast<uint4*>(slots + sx * G::SLOT +
                                            (c >> 3) * G::XBOX + tid * 128) +
                   (c & 7);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k != 0.f) {
          v = *q;
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(h[j]);
            h[j] = __floats2bfloat162_rn(f.x * k, f.y * k);
          }
        }
        *q = v;
      }
    }
    __syncthreads();
    DB_STAMP(0);

    // u of the block's channels: chunk c (8 channels) of rows 4 q .. 4 q +
    // 3, x's rows scaled above
    {
      const int c = tid & 15, q = tid >> 4;
      const uint4* w8 = reinterpret_cast<const uint4*>(dwt) + c;
      uint4 wv[K + 1];
#pragma unroll
      for (int tap = 0; tap <= K; ++tap) wv[tap] = w8[tap * 16];
      depthwise_chunk<4, false>(
          reinterpret_cast<const unsigned char*>(xs) + (c >> 3) * G::XBOX +
              4 * q * 128 + (c & 7) * 16,
          nullptr, wv, us + (2 * p + (c >> 3)) * TILE, 4 * q, c & 7);
    }
    sm90::fence_proxy_async();
    __syncthreads();
    DB_STAMP(1);
    if constexpr (G::SPLIT > 1) {
      sm90::cluster_wait();  // the other block is done with its u
      if (tid == 0) {
        sm90::bulk_s2s_cluster(u_peer, us + 2 * p * TILE, 2 * TILE,
                               bars_peer + 8);
        sm90::bulk_commit();
      }
    }
    if (it == 0) {  // W's tiles
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncthreads();
    }
    DB_STAMP(2);

    // v = u W: warpgroup wg's 64 columns of the block's 128; the k-steps
    // of the block's own channels first, the other block's once its half
    // of u has come (k-step s: channels 16 s ..; s2 = s in that order)
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    {
      const uint32_t u_a = sm90::smem_u32(us), w_a = sm90::smem_u32(smem);
      sm90::wgmma_fence();
#pragma unroll
      for (int s2 = 0; s2 < C / 16; ++s2) {
        const int s = (s2 + 8 * p) % (C / 16);
        if (G::SPLIT > 1 && s2 == 8) sm90::mbar_wait(bar_u, par);
        wgmma64<0, 1>(acc,
                      sw128_desc(u_a + (s >> 2) * TILE + 32 * (s & 3), 16),
                      sw128_desc(w_a + w_slot<G>(s >> 2, 2 * p + wg, p) * TILE +
                                     2048 * (s & 3),
                                 TILE),
                      s2 > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::reg_fence(acc[i]);
    }
    if (tid < G::XROWS) kps[((it + 1) & 1) * G::KP_STRIDE + tid] = keep_next;
    DB_STAMP(3);

    // t = tanh(bf16(v) + pb) in place (kept in ts too: a bf16 value, so
    // exactly), and each row's statistics over the warpgroup's 64
    // columns: the mean, M2 = sum (t - mean)^2, sum g and sum g (t -
    // mean), g = dy ln_s; combined across the row's slots below
    {
      float mk[2], sq[2];
      tanh_row_stats(acc, pbs, lc0, mk, sq,
                     [&](int j, int h, __nv_bfloat162 tb) {
                       *reinterpret_cast<__nv_bfloat162*>(
                           ts + (r0 + 8 * h) * G::LDY + lc0 + 8 * j) = tb;
                     });
      float sg[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = lc0 + 8 * j;
        const float2 ls = *reinterpret_cast<const float2*>(lnss + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = bf2(reinterpret_cast<const __nv_bfloat16*>(
              dyt + sw128(r0 + 8 * h, j) + 4 * t));
          const float g0 = d.x * ls.x, g1 = d.y * ls.y;
          const float c0 = acc[4 * j + 2 * h] - mk[h];
          const float c1 = acc[4 * j + 2 * h + 1] - mk[h];
          sg[h] += g0 + g1;
          sx[h] += g0 * c0 + g1 * c1;
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sg[h] += __shfl_xor_sync(0xffffffffu, sg[h], o);
          sx[h] += __shfl_xor_sync(0xffffffffu, sx[h], o);
        }
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = (2 * p + wg) * R + r0 + 8 * h;
          const float4 v = make_float4(mk[h], sq[h], sg[h], sx[h]);
          st[i] = v;
          if constexpr (G::SPLIT > 1)
            sm90::st_async_v4(st_peer + 16 * i, v, bars_peer + 16);
        }
    }
    // this block's u half is read: the halo rows may be zeroed
    if (G::SPLIT > 1 && tid == 0) sm90::bulk_wait_read<0>();
    __syncthreads();
    if constexpr (G::SPLIT > 1) sm90::mbar_wait(bar_st, par);
    DB_STAMP(4);

    // the rows' statistics from their slots, in slot order in both blocks
    // (rowst by warpgroup 0), then dv = rstd (g - mean(g) - that mean(g
    // that)) (1 - t^2) into the dv tiles in bf16; u's halo rows leave the
    // weight gradient
    {
      float mean[2], rstd[2], gm[2], gxm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        float4 sk[SLOTS];
        float mk[SLOTS], m2[SLOTS];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          sk[k] = st[k * R + r];
          mk[k] = sk[k].x;
          m2[k] = sk[k].y;
        }
        chan_stats(mk, m2, eps, mean[h], rstd[h]);
        float gs = 0.f, gx = 0.f;
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          gs += sk[k].z;
          gx += sk[k].w + (sk[k].x - mean[h]) * sk[k].z;
        }
        gm[h] = gs / C;
        gxm[h] = rstd[h] * gx / C;
        if (wg == 0 && t == 0) {
          rowst[r] = mean[h];
          rowst[R + r] = rstd[h];
          rowst[2 * R + r] = gm[h];
          rowst[3 * R + r] = gxm[h];
        }
      }
      unsigned char* dvt = dvs + (2 * p + wg) * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = lc0 + 8 * j;
        const float2 ls = *reinterpret_cast<const float2*>(lnss + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = bf2(reinterpret_cast<const __nv_bfloat16*>(
              dyt + sw128(r0 + 8 * h, j) + 4 * t));
          const float t0 = acc[4 * j + 2 * h], t1 = acc[4 * j + 2 * h + 1];
          const float th0 = (t0 - mean[h]) * rstd[h];
          const float th1 = (t1 - mean[h]) * rstd[h];
          *reinterpret_cast<__nv_bfloat162*>(
              dvt + sw128(r0 + 8 * h, j) + 4 * t) =
              __floats2bfloat162_rn(
                  rstd[h] * (d.x * ls.x - gm[h] - th0 * gxm[h]) *
                      (1.f - t0 * t0),
                  rstd[h] * (d.y * ls.y - gm[h] - th1 * gxm[h]) *
                      (1.f - t1 * t1));
        }
      }
      if (tid < 32 * NCH) {
        const int q = (tid >> 3) & 3, r = q < 2 ? q : R - 4 + q;
        *reinterpret_cast<uint4*>(us + (tid >> 5) * TILE + sw128(r, tid & 7)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    sm90::fence_proxy_async();
    __syncthreads();
    if (G::SPLIT > 1 && tid == 0) {
      sm90::bulk_s2s_cluster(dv_peer, dvs + 2 * p * TILE, 2 * TILE,
                             bars_peer + 24);
      sm90::bulk_commit();
    }
    // the column sums over the owned rows of dv (float32, from t and dy
    // again), dy that and dy: channels 2 pc, + 1 of the block's 128, row
    // group rg; each thread adds into its own place in cs
    {
      constexpr int OROWS = G::OWN / 4;
      const int r_beg = PAD + rg * OROWS;
      const int r_end = min(r_beg + OROWS, M - u0);
      const float2 ls = *reinterpret_cast<const float2*>(lnss + 2 * pc);
      // dy's tile of the channel pair, and its place in a row
      const unsigned char* dyc = dyb + (pc >> 5) * TILE + (pc & 3) * 4;
      float2 s_dv = make_float2(0.f, 0.f), s_ls = s_dv, s_lb = s_dv;
#pragma unroll 5
      for (int r = r_beg; r < r_end; ++r) {
        const float mn = rowst[r], rs = rowst[R + r], gmr = rowst[2 * R + r];
        const float gxr = rowst[3 * R + r];
        const float2 tv = bf2(ts + r * G::LDY + 2 * pc);
        const float2 d = bf2(reinterpret_cast<const __nv_bfloat16*>(
            dyc + sw128(r, (pc & 31) >> 2)));
        const float th0 = (tv.x - mn) * rs, th1 = (tv.y - mn) * rs;
        s_dv.x += rs * (d.x * ls.x - gmr - th0 * gxr) * (1.f - tv.x * tv.x);
        s_dv.y += rs * (d.y * ls.y - gmr - th1 * gxr) * (1.f - tv.y * tv.y);
        s_ls.x += d.x * th0;
        s_ls.y += d.y * th1;
        s_lb.x += d.x;
        s_lb.y += d.y;
      }
      float2* c2 = reinterpret_cast<float2*>(cs + rg * 3 * 128) + pc;
      c2[0].x += s_dv.x; c2[0].y += s_dv.y;
      c2[64].x += s_ls.x; c2[64].y += s_ls.y;
      c2[128].x += s_lb.x; c2[128].y += s_lb.y;
    }
    DB_STAMP(5);

    // the weight gradient, accw += u^T dv (warpgroup wg's 64 columns),
    // and du = dv W^T (its 64 channels of the block's 128)
    {
      const uint32_t u_a = sm90::smem_u32(us), dv_a = sm90::smem_u32(dvs);
      const uint32_t w_a = sm90::smem_u32(smem);
      sm90::wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < NCH; ++mb)
#pragma unroll
        for (int ks = 0; ks < R / 16; ++ks)
          wgmma64<1, 1>(accw[mb],
                        sw128_desc(u_a + mb * TILE + 2048 * ks, TILE),
                        sw128_desc(dv_a + (2 * p + wg) * TILE + 2048 * ks,
                                   TILE),
                        1);
      // du's k-steps over the block's own columns of dv first, the other
      // block's once they have come
#pragma unroll
      for (int s2 = 0; s2 < C / 16; ++s2) {
        const int s = (s2 + 8 * p) % (C / 16);
        if (G::SPLIT > 1 && s2 == 8) sm90::mbar_wait(bar_dv, par);
        wgmma64<0, 0>(acc,
                      sw128_desc(dv_a + (s >> 2) * TILE + 32 * (s & 3), 16),
                      sw128_desc(w_a + w_slot<G>(2 * p + wg, s >> 2, p) * TILE +
                                     32 * (s & 3),
                                 16),
                      s2 > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::reg_fence(acc[i]);
#pragma unroll
      for (int mb = 0; mb < NCH; ++mb)
#pragma unroll
        for (int i = 0; i < 32; ++i) sm90::reg_fence(accw[mb][i]);
    }
    __syncthreads();  // every warpgroup is done with u, dv, dy and t
    // the next tile's x and dy into the slots dy and t leave, landing
    // during the dx pass
    if (tid == 0 && next < n_tiles) load_tile(next, sy, sv);
    DB_STAMP(7);

    // du into shared memory over u (float32), then the owned rows of
    // channels h0 + 2 pc, + 1: dx and the depthwise gradients, du and x's
    // rows in windows of K
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(dus + du_at(r0 + 8 * h, lc0 + 8 * j)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    __syncthreads();
    {
      constexpr int OROWS = G::OWN / 4;
      const int r_beg = PAD + rg * OROWS;
      const int r_end = min(r_beg + OROWS, M - u0);
      float2 wf[K], dw[K], xw[K];
      // x's box of the channel pair (rows of 64 bf16), and its place
      const __nv_bfloat16* xc = xs + (pc >> 5) * (G::XBOX / 2) + 2 * (pc & 31);
#pragma unroll
      for (int tap = 0; tap < K; ++tap)
        wf[tap] = __ldg(reinterpret_cast<const float2*>(dww + tap * C + h0) + pc);
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        dw[j] = *reinterpret_cast<const float2*>(
            dus + du_at(r_beg - PAD + j, 2 * pc));
        xw[j] = bf2(xc + (r_beg + j) * 64);
      }
#pragma unroll 5
      for (int r = r_beg; r < r_end; ++r) {
        dw[K - 1] = *reinterpret_cast<const float2*>(
            dus + du_at(r + PAD, 2 * pc));
        xw[K - 1] = bf2(xc + (r + K - 1) * 64);
        const float2 du = dw[PAD];
        p_dwb.x += du.x;
        p_dwb.y += du.y;
#pragma unroll
        for (int tap = 0; tap < K; ++tap) {
          p_dw[tap].x += xw[tap].x * du.x;
          p_dw[tap].y += xw[tap].y * du.y;
        }
        float ax = dw[0].x * wf[K - 1].x, ay = dw[0].y * wf[K - 1].y;
#pragma unroll
        for (int sh = 1; sh < K; ++sh) {
          ax += dw[sh].x * wf[K - 1 - sh].x;
          ay += dw[sh].y * wf[K - 1 - sh].y;
        }
        const float k = kp[r + PAD];
        *reinterpret_cast<__nv_bfloat162*>(dx + (row0 + u0 + r) * C + h0 +
                                           2 * pc) =
            __floats2bfloat162_rn(ax * k, ay * k);
#pragma unroll
        for (int j = 0; j < K - 1; ++j) {
          dw[j] = dw[j + 1];
          xw[j] = xw[j + 1];
        }
      }
    }
    // this block is done with du over its u: the other block may send;
    // its own half of dv has been read by the copy out.  (The next tile
    // writes u only after the barrier that follows its loads.)
    if constexpr (G::SPLIT > 1) {
      sm90::cluster_arrive_relaxed();  // (its reads have been used)
      if (tid == 0) sm90::bulk_wait_read<0>();
    }
    DB_STAMP(8);
  }
  // neither block touches the other's shared memory after this
  if constexpr (G::SPLIT > 1) sm90::cluster_wait();
  sm90::cp_async_wait<0>();  // W's tiles, in a block without a tile

  // per-block partials of the block's 128 columns, summed over threads in
  // a fixed order: part_vec rows 0..K-1 dw taps, K dw bias, K+1 pw bias,
  // K+2 LN scale, K+3 LN bias
  float* red = reinterpret_cast<float*>(slots);  // [4][K + 1][128]
  __syncthreads();
#pragma unroll
  for (int tap = 0; tap <= K; ++tap) {
    const float2 v = tap < K ? p_dw[tap] : p_dwb;
    *reinterpret_cast<float2*>(red + (rg * (K + 1) + tap) * 128 + 2 * pc) = v;
  }
  __syncthreads();
  for (int i = tid; i < (K + 4) * 128; i += NT) {
    const int which = i >> 7, cc = i & 127;
    float a = 0.f;
    if (which <= K) {
      for (int q = 0; q < 4; ++q) a += red[(q * (K + 1) + which) * 128 + cc];
    } else {
      for (int q = 0; q < 4; ++q) a += cs[(q * 3 + which - K - 1) * 128 + cc];
    }
    part_vec[((size_t)cluster * (K + 4) + which) * C + h0 + cc] = a;
  }
  // the weight gradient's partial, (C_in, C_out): rows 64 mb + r0 (+ 8),
  // columns h0 + lc0 + 8 j (+ 1)
  float* pw = part_pw + (size_t)cluster * C * C + h0 + lc0;
#pragma unroll
  for (int mb = 0; mb < NCH; ++mb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(pw + (size_t)(64 * mb + r0 + 8 * h) * C +
                                   8 * j) =
            make_float2(accw[mb][4 * j + 2 * h], accw[mb][4 * j + 2 * h + 1]);
#ifdef DECODER_BLOCK_STAMPS
  DB_STAMP(9);
  if (threadIdx.x == 0)
    for (int i = 0; i < N_STAMPS; ++i) atomicAdd(&db_stamps[i], stamp_ns[i]);
#endif
}

// ---------------------------------------------------------------------------
// The bf16 forward (GeoHF; the design is in the note at the top): the
// backward's front half, sharing its operand tiles (sw128, wgmma64), its
// depthwise (depthwise_chunk), t and the row statistics (tanh_row_stats,
// chan_stats) and its x map (tensor_map).

template <int C_>
struct GeoHF {
  static constexpr int C = C_;
  static constexpr int R = 64;                 // rows a tile (wgmma M)
  static constexpr int NCH = C / 64;           // 64-channel tiles, warpgroups
  static constexpr int NT = 128 * NCH;
  static constexpr int TILE = 64 * 64 * 2;     // an operand tile's bytes
  static constexpr int XROWS = R + 2 * PAD;
  static constexpr int XBOX = XROWS * 128;     // x rows of 64 channels
  static constexpr int RW = 4;                 // rows of u a thread
  // W's NCH x NCH tiles at 0, u's NCH tiles, the x rows' NCH boxes
  static constexpr int U_OFF = NCH * NCH * TILE;
  static constexpr int X_OFF = U_OFF + NCH * TILE;
  // the rows' mean and sum of squared deviations over each 64-column slot
  static constexpr int ST_OFF = X_OFF + NCH * XBOX;
  static constexpr int KP_OFF = ST_OFF + NCH * R * 8;
  static constexpr int KP_STRIDE = (XROWS + 3) / 4 * 4;
  // the depthwise taps and bias in bf16, the pw bias (rounded to bf16),
  // the LN scale and bias
  static constexpr int PAR_OFF = KP_OFF + 2 * KP_STRIDE * 4;
  static constexpr int BAR_OFF = PAR_OFF + (K + 1) * C * 2 + 3 * C * 4;
  static constexpr int SMEM = BAR_OFF + 8;
  static constexpr int SMEM_ALLOC = SMEM + 1024;  // room to align the base
  // blocks an SM: 1 KB of each block's shared memory is reserved
  static constexpr int FWD_BLOCKS = (int)SM_SMEM / (SMEM_ALLOC + 1024);
  static_assert(NCH == 2 || NCH == 4, "C = 128 or 256");
  static_assert(SMEM_ALLOC <= (int)SMEM_LIMIT && FWD_BLOCKS >= 1,
                "forward smem");
  static_assert(16 * RW == R, "a warpgroup's 128 threads: 8 chunks x 16");
  static_assert(X_OFF % 128 == 0 && XBOX % 128 == 0, "TMA boxes aligned");
};

template <int C>
__global__ void __launch_bounds__(GeoHF<C>::NT, GeoHF<C>::FWD_BLOCKS)
    decoder_block_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_y,
                             const float* __restrict__ keep,
                             const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ dww,
                             const float* __restrict__ dwb,
                             const float* __restrict__ pwb,
                             const float* __restrict__ lns,
                             const float* __restrict__ lnb, int B, int M,
                             float eps) {
  using G = GeoHF<C>;
  constexpr int NT = G::NT, R = G::R, NCH = G::NCH, TILE = G::TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* us = smem + G::U_OFF;  // u, NCH tiles of 64 channels
  unsigned char* xs = smem + G::X_OFF;  // x rows, NCH boxes of 64 channels
  float2* st = reinterpret_cast<float2*>(smem + G::ST_OFF);  // [NCH][R]
  float* kps = reinterpret_cast<float*>(smem + G::KP_OFF);   // two tiles'
  __nv_bfloat16* dwt =
      reinterpret_cast<__nv_bfloat16*>(smem + G::PAR_OFF);  // [K + 1][C]
  float* pbs = reinterpret_cast<float*>(smem + G::PAR_OFF + (K + 1) * C * 2);
  float* lss = pbs + C;
  float* lbs = lss + C;
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem + G::BAR_OFF);
#ifdef DECODER_BLOCK_STAMPS
  unsigned long long stamp_ns[N_STAMPS] = {}, stamp_last = global_ns();
#endif

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int tiles_m = (M + R - 1) / R, n_tiles = B * tiles_m;
  // u row 0's row in its sequence, and the sequence, of tile `tl`
  auto tile_u0 = [&](int tl, int& tb) {
    tb = tl / tiles_m;
    return (tl - tb * tiles_m) * R;
  };
  // the keep value of x row tid of tile `tl` (threads below XROWS)
  auto keep_at = [&](int tl) {
    int tb;
    const int tu0 = tile_u0(tl, tb);
    return tid < G::XROWS && tl < n_tiles ? keep_of(keep, tb, tu0, M, tid)
                                          : 0.f;
  };
  // tile `tl`'s x rows (u0 - 2 .. u0 + 65) into xs: NCH TMA boxes, rows
  // outside [0, M) as zeros, counted on bar_x
  auto load_x = [&](int tl) {
    int tb;
    const int tu0 = tile_u0(tl, tb);
    sm90::mbar_expect_tx(bar_x, NCH * G::XBOX);
#pragma unroll
    for (int h = 0; h < NCH; ++h)
      sm90::tma_load_3d(xs + h * G::XBOX, &tm_x, 64 * h, tu0 - PAD, tb,
                        bar_x);
  };

  // W's tiles, once: tile (a, b) (input channels 64 a .., output columns
  // 64 b ..) at slot a NCH + b, MN-major in the 128-byte swizzle
  for (int i = tid; i < NCH * NCH * 64 * 8; i += NT) {
    const int s = i >> 9, r = (i >> 3) & 63, c = i & 7;
    sm90::cp_async16(smem + s * TILE + sw128(r, c),
                     w + (size_t)(64 * (s / NCH) + r) * C + 64 * (s % NCH) +
                         8 * c);
  }
  sm90::cp_async_commit();
  for (int i = tid; i < C; i += NT) {
#pragma unroll
    for (int tap = 0; tap < K; ++tap)
      dwt[tap * C + i] = __float2bfloat16_rn(dww[tap * C + i]);
    dwt[K * C + i] = __float2bfloat16_rn(dwb[i]);
    pbs[i] = bfr(pwb[i]);
    lss[i] = lns[i];
    lbs[i] = lnb[i];
  }
  if (tid == 0) {
    sm90::mbar_init(bar_x, 1);
    sm90::fence_mbar_init();
  }
  if (tid < G::XROWS) kps[tid] = keep_at(blockIdx.x);
  __syncthreads();  // the mbarrier, the vectors and the first keep values
  if (tid == 0 && (int)blockIdx.x < n_tiles) load_x(blockIdx.x);

  // the depthwise: chunk dc (8 channels) of warpgroup wg's 64, rows
  // RW dq .. RW dq + RW - 1
  const int dc = tid & 7, dq = (tid >> 3) & 15;
  // the row pass: lane (g, t) of warp warp % 4 holds rows r0 and r0 + 8,
  // columns lc0 + 8 j and lc0 + 8 j + 1 (j < 8) of the warpgroup's 64
  const int r0 = 16 * (warp & 3) + g, lc0 = 64 * wg + 2 * t;

  int it = 0;  // the block's tiles so far
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    int b;
    const int u0 = tile_u0(tile, b);
    const int next = tile + gridDim.x;
    const float* kp = kps + (it & 1) * G::KP_STRIDE;
    // the next tile's keep values, stored after v, when they have come
    const float keep_next = keep_at(next);
    // the warpgroup's y tile of the last tile has been read out of its u
    // tile (its TMA store's source)
    if ((tid & 127) == 0) sm90::bulk_wait_read<0>();
    sm90::named_barrier(1 + wg, 128);
    sm90::mbar_wait(bar_x, it & 1);  // this tile's x rows
    DB_STAMP(0);

    // u of the warpgroup's 64 channels: chunk dc of rows RW dq .., each x
    // row scaled by its keep as it is read
    {
      const uint4* w8 =
          reinterpret_cast<const uint4*>(dwt + 64 * wg + 8 * dc);
      uint4 wv[K + 1];
#pragma unroll
      for (int tap = 0; tap <= K; ++tap) wv[tap] = w8[tap * (C / 8)];
      depthwise_chunk<G::RW, true>(
          xs + wg * G::XBOX + G::RW * dq * 128 + 16 * dc, kp + G::RW * dq, wv,
          us + wg * TILE, G::RW * dq, dc);
    }
    if (it == 0) sm90::cp_async_wait<0>();  // W's tiles
    sm90::fence_proxy_async();
    __syncthreads();  // u written, x's rows read
    DB_STAMP(1);
    // the next tile's x rows into the slot this tile's leave, landing
    // during the product and the row pass
    if (tid == 0 && next < n_tiles) load_x(next);

    // v = u W: warpgroup wg's 64 columns (k-step s: channels 16 s ..)
    float acc[32];
    {
      const uint32_t u_a = sm90::smem_u32(us), w_a = sm90::smem_u32(smem);
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < C / 16; ++s)
        wgmma64<0, 1>(acc,
                      sw128_desc(u_a + (s >> 2) * TILE + 32 * (s & 3), 16),
                      sw128_desc(w_a + ((s >> 2) * NCH + wg) * TILE +
                                     2048 * (s & 3),
                                 TILE),
                      s > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::reg_fence(acc[i]);
    }
    if (tid < G::XROWS) kps[((it + 1) & 1) * G::KP_STRIDE + tid] = keep_next;
    DB_STAMP(2);

    // t = tanh(bf16(v) + pb) in bf16, in place, and each row's mean and
    // M2 over the warpgroup's 64 columns; combined across the row's slots
    // below
    {
      float mk[2], sq[2];
      tanh_row_stats(acc, pbs, lc0, mk, sq, [](int, int, __nv_bfloat162) {});
      if (t == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st[wg * R + r0 + 8 * h] = make_float2(mk[h], sq[h]);
    }
    __syncthreads();  // the row sums; every warpgroup is done with u
    DB_STAMP(3);

    // the rows' statistics from their slots, then y = (t - mean) rstd
    // ln_s + ln_b in bf16, written by TMA
    {
      float mean[2], rstd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mk[NCH], m2[NCH];
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const float2 sk = st[k * R + r0 + 8 * h];
          mk[k] = sk.x;
          m2[k] = sk.y;
        }
        chan_stats(mk, m2, eps, mean[h], rstd[h]);
      }
      // staged over the warpgroup's u tile (free since the barrier) for
      // one TMA store of 64 rows x 64 channels (rows >= M are clipped)
      unsigned char* yt = us + wg * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 ls = *reinterpret_cast<const float2*>(lss + lc0 + 8 * j);
        const float2 lb = *reinterpret_cast<const float2*>(lbs + lc0 + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(yt + sw128(r0 + 8 * h, j) +
                                             4 * t) =
              __floats2bfloat162_rn(
                  (acc[4 * j + 2 * h] - mean[h]) * rstd[h] * ls.x + lb.x,
                  (acc[4 * j + 2 * h + 1] - mean[h]) * rstd[h] * ls.y +
                      lb.y);
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(1 + wg, 128);
      if ((tid & 127) == 0) {
        sm90::tma_store_3d(&tm_y, yt, 64 * wg, u0, b);
        sm90::bulk_commit();
      }
    }
    DB_STAMP(4);  // thread 0's warp; the next tile's first stamp waits
                  // for the others
  }
  sm90::cp_async_wait<0>();  // W's tiles, in a block without a tile
  if ((tid & 127) == 0) sm90::bulk_wait<0>();  // the last y stores
#ifdef DECODER_BLOCK_STAMPS
  if (threadIdx.x == 0)
    for (int i = 0; i < N_STAMPS; ++i) atomicAdd(&db_stamps[i], stamp_ns[i]);
#endif
}

// ---------------------------------------------------------------------------
// The float32 variant (x, y, dx, dy float32; nothing is rounded to bf16),
// forward and backward on the tensor cores.  The backward (GeoB) comes
// first: the forward (GeoF, below) runs its front half, and shares its
// functions.
//
// The float32 backward.  What bounds it: operations.  Three C x C products
// a row, v = u W (the recomputed forward), the weight gradient u^T dv and
// du = dv W^T: 6 N C^2 FLOP a pass, 51.5 GFLOP at N = 131,072 and C = 256.
// Each runs by 3xTF32 split products (csrc/tf32x3.cuh: three TF32
// products a float32 one, about 21 bits each, nothing rounded to plain
// TF32), 1.88 ms of tensor-core time at C = 256 against 4.80 of FFMA.
//
// Per tile of R rows (R = 16384 / C: 128 at C = 128, 64 at C = 256), of
// which the inner OWN = R - 4 are the tile's own:
// - v and du run transposed, as K1/K2 f32 do: v^T = W^T u^T and du^T =
//   W dv^T on wgmma.m64nRk8, M the output channels (64 a warpgroup per
//   m-block), N the tile's rows in one instruction, K the input channels.
//   A is the weights from L2 through registers, split there
//   (tf32x3::k_loop, 7 k-steps of loads in flight); the wrapper passes W
//   and W^T in A's fragment order, so a lane's four values of a k-step
//   are one 16-byte load, and at C = 256 each block starts its k loop at
//   its own step, so the SMs do not all ask L2 for the same lines at
//   once.  B is u, later dv, split once into hi and lo copies in the
//   no-swizzle K-major layout of tf32x3.cuh (the split buffer S).
// - The weight gradient has the rows as K, and TF32 wgmma takes B K-major
//   only, so S (channels as K) cannot be its B.  It runs on warp-level
//   mma.sync.m16n8k8 (TF32, 3xTF32 as above) with both operands loaded
//   from shared memory: u's hi and lo from S, already split (a chunk is R +
//   4 rows of 16 bytes, 64 mod 128 bytes, so a fragment's 32 lanes meet 32
//   banks), dv from its float32 rows, split in registers.  A warp owns a
//   64 x 32 block of the gradient per pass (C^2 / 16384 passes): it reads
//   the block's float32 partial of it from device memory (L2) into its
//   accumulators, adds the tile's products and writes it back, in the
//   accumulators' order (16-byte accesses).  One partial per block, summed
//   by the caller; no float atomics, so two launches give the same bits.
//   (wgmma over an in-place transposed u measured slower: the transpose
//   cost more than the products saved.)
// - Shared memory (decoder_block.py::f32_bwd_plan holds the same plan): S
//   (hi at 0, lo at LO_OFF; 132 or 136 KB), the float32 rows V (stride
//   C + 8) at V_OFF, the keep values of this tile's and the next tile's x
//   rows, and the weight vectors the passes read.  Per tile: x's R + 4
//   rows (prefetched into L2 a tile ahead, then cp.async), masked, over V
//   -> u, split into S -> v into V -> dv (the LayerNorm and tanh
//   gradients, two rows a warp) in place in V, u's halo rows zeroed in S
//   -> the weight gradient from S and V -> dv split into S -> du into V
//   -> x's rows again (from L2) over S -> dx and the depthwise gradients.
// - Two warpgroups, one block an SM (210 or 219 KB), persistent over the
//   tiles.
//
// Where the time goes (probes/k4_bwd_phases.py) is written down in
// PERF.md: at C = 256 the weight gradient's mma.sync and its partial's
// traffic first, then the two products' A loads from L2.
//
// Numerics: the depthwise taps are summed in tap order with separate
// multiplies and adds (__fmul_rn, __fadd_rn), exactly as
// _recompute_to_t's float32 arithmetic; the row pass is the forward's tanh
// and LayerNorm with their gradients in float32; products by 3xTF32, the
// small terms first.  tanhf and the order of the float32 sums differ from
// the plain version's: held to it at SNR >= 90 dB.

template <int C_>
struct GeoB {
  static constexpr int C = C_;
  static constexpr int R = 16384 / C;         // rows of u per tile (wgmma N)
  static constexpr int OWN = R - 2 * PAD;     // the inner rows a tile owns
  static constexpr int NT = 256, NW = NT / 32;
  static constexpr int MB = C / 128;          // 64-channel m-blocks a warpgroup
  static constexpr int R_ALLOC = R + 4;       // rows of a channel chunk of S
  static constexpr int CHUNK = R_ALLOC * 16;  // its bytes
  static constexpr int LO_OFF = C / 4 * CHUNK;
  static constexpr int V_OFF = 2 * LO_OFF;
  static constexpr int LDV = C + 8;           // V's float32 row stride
  static constexpr int LD = C + 4;            // the x rows' stride
  static constexpr int XROWS = R + 2 * PAD;
  static constexpr int V_BYTES = R * LDV * 4;
  static constexpr int X_BYTES = XROWS * LD * 4;
  // the keep values of x's rows, two tiles' (this one's, the next one's)
  static constexpr int KP_OFF = V_OFF + (V_BYTES > X_BYTES ? V_BYTES : X_BYTES);
  static constexpr int KP_STRIDE = (XROWS + 3) / 4 * 4;
  // the vectors the passes read: dw taps (K x C), dw bias, pw bias, LN scale
  static constexpr int PAR_OFF = KP_OFF + 2 * KP_STRIDE * 4;
  // the products' k loop (tf32x3::k_loop): A's loads PD steps ahead in a
  // ring of RING register slots
  static constexpr int KL_PD = 7, KL_RING = 8;
  // the products start each block's k loop at its own step (C = 256): 132
  // blocks reading the same lines of W at once contend for them in L2
  // (C = 128 runs out of registers with it, and gains nothing)
  static constexpr bool ROTATE = C == 256;
  static constexpr int SMEM = PAR_OFF + (K + 3) * C * 4;
  static constexpr int GROUPS = NT / C;       // row groups of a column
  static constexpr int DW_PASSES = C * C / (64 * 32 * NW);
  static_assert(R == 64 || R == 128, "one wgmma N of tf32x3::mma3");
  static_assert(R_ALLOC % 8 == 4, "a chunk is 64 mod 128 bytes");
  static_assert(SMEM <= (int)SMEM_LIMIT, "backward smem");
  static_assert(X_BYTES <= V_OFF, "x's rows fit over S");
  static_assert(OWN % GROUPS == 0, "owned rows split evenly");
  static_assert(DW_PASSES * 64 * 32 * NW == C * C, "gradient blocks per warp");
  static_assert(((K + 1) * GROUPS + 3 * NW) * C * 4 <= V_OFF,
                "reduction scratch does not fit");
};

__device__ __forceinline__ float4 tap_add(float4 acc, float4 x, float4 w) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(x.x, w.x)),
                     __fadd_rn(acc.y, __fmul_rn(x.y, w.y)),
                     __fadd_rn(acc.z, __fmul_rn(x.z, w.z)),
                     __fadd_rn(acc.w, __fmul_rn(x.w, w.w)));
}

// rows [g0, g0 + n) of sequence b (M rows of C floats), cut to [0, M),
// into L2
template <int C>
__device__ __forceinline__ void prefetch_rows(const float* base, int b,
                                              int M, int g0, int n) {
  const int lo = max(g0, 0), hi = min(g0 + n, M);
  if (hi > lo)
    prefetch_l2(base + ((size_t)b * M + lo) * C, (uint32_t)(hi - lo) * C * 4);
}

// xs row i <- x row u0 - PAD + i of sequence b times its keep kp[i]: rows
// whose keep is 1 by asynchronous 16-byte copies (cp.async; the caller
// waits), rows whose keep is 0 as zeros, any other by a load and a
// multiply.
template <class G>
__device__ void load_x_async(const float* __restrict__ x, int b, int u0,
                             int M, const float* kp, float* xs) {
  constexpr int CH = G::C / 4;
  for (int i = threadIdx.x; i < G::XROWS * CH; i += G::NT) {
    const int r = i / CH, c4 = i - r * CH;
    const float k = kp[r];
    float* dst = xs + r * G::LD + c4 * 4;
    const float* src = x + ((size_t)b * M + u0 - PAD + r) * G::C + c4 * 4;
    if (k == 1.f) {
      sm90::cp_async16(dst, src);
    } else {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k != 0.f) {
        q = __ldg(reinterpret_cast<const float4*>(src));
        q.x *= k; q.y *= k; q.z *= k; q.w *= k;
      }
      *reinterpret_cast<float4*>(dst) = q;
    }
  }
}

// S at (row r, channels 4 c4 ..) <- the split of v
template <class G>
__device__ __forceinline__ void put_split(unsigned char* smem, int r, int c4,
                                          float4 v) {
  float4 lo;
  const float4 hi = tf32x3::split4(v, lo);
  unsigned char* dst = smem + c4 * G::CHUNK + r * 16;
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + G::LO_OFF) = lo;
}

// u of the tile's R rows from the masked x rows xs (stride LD), the taps
// summed in tap order with separate multiplies and adds, split into S.  A
// lane takes a row and 4 channels; a warp's lanes take consecutive rows,
// so its 16-byte stores into S meet every bank.
template <class G>
__device__ void depthwise_split(const float* xs, const float* par,
                                unsigned char* smem) {
  constexpr int C4 = G::C / 4;
  const float4* w4 = reinterpret_cast<const float4*>(par);  // a warp's lanes
                                                           // read one float4
#pragma unroll 2
  for (int i = threadIdx.x; i < G::R * C4; i += G::NT) {
    const int r = i % G::R, c4 = i / G::R;
    const float* xr = xs + r * G::LD + 4 * c4;
    const float4 x0 = *reinterpret_cast<const float4*>(xr);
    const float4 w0 = w4[c4];
    float4 acc = make_float4(__fmul_rn(x0.x, w0.x), __fmul_rn(x0.y, w0.y),
                             __fmul_rn(x0.z, w0.z), __fmul_rn(x0.w, w0.w));
#pragma unroll
    for (int tap = 1; tap < K; ++tap)
      acc = tap_add(acc, *reinterpret_cast<const float4*>(xr + tap * G::LD),
                    w4[tap * C4 + c4]);
    const float4 bb = w4[K * C4 + c4];
    put_split<G>(smem, r, c4,
                 make_float4(__fadd_rn(acc.x, bb.x), __fadd_rn(acc.y, bb.y),
                             __fadd_rn(acc.z, bb.z), __fadd_rn(acc.w, bb.w)));
  }
}

// u of the tile's R rows from the masked x rows xs (stride LD), the taps
// summed in tap order with separate multiplies and adds, split into S,
// sliding a window of K x rows down a column: thread (q, c4) takes
// channels 4 c4 .. 4 c4 + 3 of rows q RW .. q RW + RW - 1, so it reads each
// x row of them once.  A warp's lanes take consecutive c4: their loads are
// one 512-byte row, and their 16-byte stores meet every bank when a chunk
// of S is 16 bytes past a multiple of 128 (R_ALLOC = R + 1).
template <class G>
__device__ void depthwise_window(const float* xs, const float* par,
                                 unsigned char* smem) {
  constexpr int C4 = G::C / 4, RW = G::R * C4 / G::NT;
  static_assert(RW * G::NT == G::R * C4, "rows split evenly");
  static_assert(G::CHUNK % 128 == 16, "a warp's stores meet every bank");
  const int c4 = threadIdx.x % C4, r0 = threadIdx.x / C4 * RW;
  const float4* w4 = reinterpret_cast<const float4*>(par);
  float4 wt[K];
#pragma unroll
  for (int tap = 0; tap < K; ++tap) wt[tap] = w4[tap * C4 + c4];
  const float4 bb = w4[K * C4 + c4];
  const float* xc = xs + r0 * G::LD + 4 * c4;
  float4 xw[K];
#pragma unroll
  for (int j = 0; j < K - 1; ++j)
    xw[j] = *reinterpret_cast<const float4*>(xc + j * G::LD);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    xw[K - 1] = *reinterpret_cast<const float4*>(xc + (r + K - 1) * G::LD);
    float4 acc =
        make_float4(__fmul_rn(xw[0].x, wt[0].x), __fmul_rn(xw[0].y, wt[0].y),
                    __fmul_rn(xw[0].z, wt[0].z), __fmul_rn(xw[0].w, wt[0].w));
#pragma unroll
    for (int tap = 1; tap < K; ++tap) acc = tap_add(acc, xw[tap], wt[tap]);
    put_split<G>(smem, r0 + r, c4,
                 make_float4(__fadd_rn(acc.x, bb.x), __fadd_rn(acc.y, bb.y),
                             __fadd_rn(acc.z, bb.z), __fadd_rn(acc.w, bb.w)));
#pragma unroll
    for (int j = 0; j < K - 1; ++j) xw[j] = xw[j + 1];
  }
}

// This warpgroup's m-block mb of V[r, c] = sum_k S[r, k] w_op[k, c] over
// the tile's R rows into acc: w_op is W (C_in, C_out) for v and W^T
// (C_out, C_in) for du.  Runs transposed on wgmma: A (w_op^T, 64 output
// channels) from L2 through registers, split there; B the split rows of S.
// w_op comes in A's fragment order (decoder_block.py::a_fragments): for
// m-block m, warp q, k-step s, lane 4 g + t, the four values w_op[8 s + t,
// c], w_op[8 s + t, c + 1], w_op[8 s + t + 4, c], w_op[8 s + t + 4, c + 1]
// (c = 64 m + 16 q + 2 g) are one 16-byte load.  Returns with this
// warpgroup's products complete.
template <class G>
__device__ __forceinline__ void product_block(const float* __restrict__ w_op,
                                              const unsigned char* smem,
                                              int mb, float (&acc)[G::R / 2]) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  constexpr int NS = G::C / 8;  // k-steps
  const uint32_t b_hi = sm90::smem_u32(smem);
  const uint64_t d_hi = tf32x3::desc(b_hi, G::CHUNK),
                 d_lo = tf32x3::desc(b_hi + G::LO_OFF, G::CHUNK);
  const int rot = G::ROTATE ? (blockIdx.x * 5) % NS : 0;
  const float4* wa = reinterpret_cast<const float4*>(w_op) +
                     (size_t)((wg * G::MB + mb) * 4 + warp) * NS * 32 + lane;
#pragma unroll
  for (int i = 0; i < G::R / 2; ++i) acc[i] = 0.f;
  tf32x3::k_loop<G::KL_PD, G::KL_RING>(
      NS,
      [&](int s, float (&r)[4]) {  // k rows 8 s + t, 8 s + t + 4
        const float4 a = __ldg(wa + 32 * ((s + rot) % NS));
        r[0] = a.x;
        r[1] = a.y;
        r[2] = a.z;
        r[3] = a.w;
      },
      [&](int s, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
        s = (s + rot) % NS;
        // channels 8 s .. 8 s + 7: chunk 2 s, in 16-byte units
        const uint32_t k = 2 * s * G::R_ALLOC;
        tf32x3::mma3<G::R>(acc, hi, lo, d_hi + k, d_lo + k, 1);
      });
#pragma unroll
  for (int i = 0; i < G::R / 2; ++i) sm90::reg_fence(acc[i]);
}

// V's rows (stride LDV) <- m-block mb of product_block: A's rows g and g +
// 8 of warp q's 16 are output channels ca and ca + 1 (ca = 64 m + 16 q +
// 2 g), so acc[4 j + 2 h + e] is channel ca + h of row 8 j + 2 t + e.
template <class G>
__device__ __forceinline__ void store_block(const float (&acc)[G::R / 2],
                                            int mb, float* V) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ca = 64 * (wg * G::MB + mb) + 16 * warp + 2 * g;
#pragma unroll
  for (int j = 0; j < G::R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(V + (8 * j + 2 * t + e) * G::LDV + ca) =
          make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
}

// V <- S w_op over the tile's R rows, this warpgroup's MB m-blocks of 64
// output channels in turn
template <class G>
__device__ void product_to_v(const float* __restrict__ w_op,
                             unsigned char* smem) {
  float* V = reinterpret_cast<float*>(smem + G::V_OFF);
#pragma unroll 1
  for (int mb = 0; mb < G::MB; ++mb) {
    float acc[G::R / 2];
    product_block<G>(w_op, smem, mb, acc);
    store_block<G>(acc, mb, V);
  }
}

// t of one row from v, and its LayerNorm statistics, over the lane's
// columns: t = tanh(v + pb)
template <int C>
__device__ __forceinline__ void row_t_f32(const float* v_row, int lane,
                                          const float* pb, float* t,
                                          float eps, float& mean,
                                          float& rstd) {
  constexpr int CH = C / 128;
  float s = 0.f;
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const float4 v =
        *reinterpret_cast<const float4*>(v_row + h * 128 + lane * 4);
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t[h * 4 + i] = tanhf(vv[i] + pb[h * 4 + i]);
      s += t[h * 4 + i];
    }
  }
  mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) {
    const float d = t[i] - mean;
    q += d * d;
  }
  rstd = 1.f / sqrtf(warp_sum(q) / C + eps);
}

// D (16 x 8, float32) += A (16 x 8, TF32) B (8 x 8, TF32) for one warp:
// lane 4 g + t holds A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B
// (t, g), (t + 4, g) and D (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8,
// 2 t + 1)
__device__ __forceinline__ void mma_m16n8k8(float (&d)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's weight-gradient partial (+)= the sum over the tile's rows r
// of u[r, i] dv[r, o] (= when `first`): u from S (its halo rows zero), dv
// from V.  A warp owns a 64 x 32 block (i0 .., o0 ..) per pass, in 4 x 4
// mma tiles; the three split products of a tile in turn.  The partial
// keeps the blocks in the accumulators' order, so that a lane's four
// values are one 16-byte access: block q = pass NW + warp at 2,048 q, its
// tile (mt, nt) at 128 (4 mt + nt), lane l's D at 4 l
// (decoder_block.py::f32_bwd_partial_index maps it back to (i, o)).
template <class G>
__device__ void weight_grad(const unsigned char* smem,
                            float* __restrict__ part, bool first) {
  constexpr int C = G::C, CW = G::CHUNK / 4;  // a chunk's 32-bit words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* s_hi = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t* s_lo = reinterpret_cast<const uint32_t*>(smem + G::LO_OFF);
  const float* V = reinterpret_cast<const float*>(smem + G::V_OFF);
#pragma unroll 1
  for (int pass = 0; pass < G::DW_PASSES; ++pass) {
    const int q = pass * G::NW + warp;
    const int i0 = 64 * (q / (C / 32)) + g, o0 = 32 * (q % (C / 32));
    float4* pq = reinterpret_cast<float4*>(part + (size_t)q * 2048) + lane;
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 v = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : pq[32 * (4 * mt + nt)];
        acc[mt][nt][0] = v.x;
        acc[mt][nt][1] = v.y;
        acc[mt][nt][2] = v.z;
        acc[mt][nt][3] = v.w;
      }
#pragma unroll 2
    for (int ks = 0; ks < G::R / 8; ++ks) {
      const int r = 8 * ks + t;
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tf32x3::split(V[(r + 4 * h) * G::LDV + o0 + 8 * nt + g], bhi[nt][h],
                        blo[nt][h]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // (i, r), (i + 8, r), (i, r + 4), (i + 8, r + 4) of u, i = i0 + 16 mt
        const int w0 = ((i0 + 16 * mt) >> 2) * CW + r * 4 + (g & 3);
        const int wa[4] = {w0, w0 + 2 * CW, w0 + 16, w0 + 2 * CW + 16};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ahi[k] = s_hi[wa[k]];
          alo[k] = s_lo[wa[k]];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_m16n8k8(acc[mt][nt], alo, bhi[nt]);
          mma_m16n8k8(acc[mt][nt], ahi, blo[nt]);
          mma_m16n8k8(acc[mt][nt], ahi, bhi[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        pq[32 * (4 * mt + nt)] = make_float4(acc[mt][nt][0], acc[mt][nt][1],
                                             acc[mt][nt][2], acc[mt][nt][3]);
  }
}

template <int C>
__global__ void __launch_bounds__(GeoB<C>::NT, 1)
    decoder_block_bwd_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ keep,
                                 const float* __restrict__ w,
                                 const float* __restrict__ wt,
                                 const float* __restrict__ dww,
                                 const float* __restrict__ dwb,
                                 const float* __restrict__ pwb,
                                 const float* __restrict__ lns,
                                 const float* __restrict__ dy,
                                 float* __restrict__ dx,
                                 float* __restrict__ part_pw,
                                 float* __restrict__ part_vec, int B, int M,
                                 float eps) {
  using G = GeoB<C>;
  constexpr int NT = G::NT, NW = G::NW, CH = C / 128, R = G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* V = reinterpret_cast<float*>(smem + G::V_OFF);
  float* xs = reinterpret_cast<float*>(smem);  // x's rows for dx, over S
  float* kp_s = reinterpret_cast<float*>(smem + G::KP_OFF);  // their keep
  // dw taps (K x C), dw bias, pw bias, LN scale
  float* par = reinterpret_cast<float*>(smem + G::PAR_OFF);
  const float* pb_s = par + (K + 1) * C;
  const float* lns_s = par + (K + 2) * C;
#ifdef DECODER_BLOCK_STAMPS
  unsigned long long stamp_ns[N_STAMPS] = {}, stamp_last = global_ns();
#endif

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < K * C; i += NT) par[i] = dww[i];
  for (int i = tid; i < C; i += NT) {
    par[K * C + i] = dwb[i];
    par[(K + 1) * C + i] = pwb[i];
    par[(K + 2) * C + i] = lns[i];
  }
  // the depthwise gradient and dx: column cf, one of GROUPS row groups
  constexpr int OROWS = G::OWN / G::GROUPS;
  const int cf = tid % C, fg = tid / C;
  // per-thread partial sums: column cf (taps, dw bias), the lane's
  // columns (pw bias, LayerNorm scale and bias)
  float p_dw[K], p_dwb = 0.f, p_pwb[4 * CH], p_lns[4 * CH], p_lnb[4 * CH];
#pragma unroll
  for (int i = 0; i < K; ++i) p_dw[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * CH; ++i) p_pwb[i] = p_lns[i] = p_lnb[i] = 0.f;
  float* pw_out = part_pw + (size_t)blockIdx.x * C * C;
  bool first = true;

  const int tiles_m = (M + G::OWN - 1) / G::OWN;
  // the keep values of a tile's x rows: the first tile's now, each next
  // tile's while this one runs (kp_s holds two tiles')
  auto tile_u0 = [&](int tl, int& tb) {
    tb = tl / tiles_m;
    return (tl - tb * tiles_m) * G::OWN - PAD;
  };
  if (tid < G::XROWS && blockIdx.x < B * tiles_m) {
    int tb;
    const int tu0 = tile_u0(blockIdx.x, tb);
    kp_s[tid] = keep_of(keep, tb, tu0, M, tid);
  }
  int buf = 0;
  for (int tile = blockIdx.x; tile < B * tiles_m; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int m0 = (tile - b * tiles_m) * G::OWN;
    const int u0 = m0 - PAD;  // global row of u row 0
    const size_t row0 = (size_t)b * M;
    float* kp = kp_s + buf * G::KP_STRIDE;
    float kp_next = 0.f;
    if (tid < G::XROWS && tile + (int)gridDim.x < B * tiles_m) {
      int nb;
      const int nu0 = tile_u0(tile + gridDim.x, nb);
      kp_next = keep_of(keep, nb, nu0, M, tid);
    }
    if (tid == 0) {
      // dy's rows of this tile, for the row pass, and x's rows of the
      // block's next tile into L2
      prefetch_rows<C>(dy, b, M, u0, R);
      const int nt = tile + gridDim.x;
      if (nt < B * tiles_m) {
        const int nb = nt / tiles_m;
        prefetch_rows<C>(x, nb, M, (nt - nb * tiles_m) * G::OWN - 2 * PAD,
                         G::XROWS);
      }
    }
    __syncthreads();  // kp, and the last tile's reads of V
    load_x_async<G>(x, b, u0, M, kp, V);  // x's rows over V
    sm90::cp_async_wait_all();
    __syncthreads();
    DB_STAMP(0);
    depthwise_split<G>(V, par, smem);
    sm90::fence_proxy_async();
    __syncthreads();
    DB_STAMP(1);
    product_to_v<G>(w, smem);  // v = u W
    __syncthreads();
    DB_STAMP(2);
    // u's halo rows leave the weight gradient
    for (int i = tid; i < C; i += NT) {
      const int q = i & 3, r = q < 2 ? q : R - 4 + q;
      unsigned char* z = smem + (i >> 2) * G::CHUNK + r * 16;
      *reinterpret_cast<float4*>(z) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(z + G::LO_OFF) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // recompute t and its LayerNorm, then dv = dLN * (1 - t^2) over v, two
    // rows a warp at once (their chains of warp sums interleave).  A row
    // outside [0, M) takes dy = 0, so its dv is 0 and it adds 0 to the
    // sums.
    for (int r0 = warp; r0 < R; r0 += 2 * NW) {
      float t[2][4 * CH], d[2][4 * CH], mean[2], rstd[2], gm[2], gxm[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int g = u0 + r0 + q * NW;
        const bool in = g >= 0 && g < M;
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in)
            v4 = __ldg(reinterpret_cast<const float4*>(
                dy + (row0 + g) * C + h * 128 + lane * 4));
          d[q][h * 4] = v4.x; d[q][h * 4 + 1] = v4.y;
          d[q][h * 4 + 2] = v4.z; d[q][h * 4 + 3] = v4.w;
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float pb[4 * CH];
        lane_cols<G>(pb_s, lane, pb);
        row_t_f32<C>(V + (r0 + q * NW) * G::LDV, lane, pb, t[q], eps,
                     mean[q], rstd[q]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float gs = 0.f, gx = 0.f;
#pragma unroll
        for (int h = 0; h < CH; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gg = d[q][h * 4 + i] * lns_s[h * 128 + lane * 4 + i];
            gs += gg;
            gx += gg * ((t[q][h * 4 + i] - mean[q]) * rstd[q]);
          }
        gm[q] = warp_sum(gs) / C;
        gxm[q] = warp_sum(gx) / C;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = r0 + q * NW;
        const bool owned_row = r >= PAD && r < R - PAD;
#pragma unroll
        for (int h = 0; h < CH; ++h) {
          const int col = h * 128 + lane * 4;
          float dv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float tt = t[q][h * 4 + i], dd = d[q][h * 4 + i];
            const float that = (tt - mean[q]) * rstd[q];
            dv[i] = rstd[q] * (dd * lns_s[col + i] - gm[q] - that * gxm[q]) *
                    (1.f - tt * tt);
            if (owned_row) {
              p_pwb[h * 4 + i] += dv[i];
              p_lns[h * 4 + i] += dd * that;
              p_lnb[h * 4 + i] += dd;
            }
          }
          *reinterpret_cast<float4*>(V + r * G::LDV + col) =
              make_float4(dv[0], dv[1], dv[2], dv[3]);
        }
      }
    }
    __syncthreads();
    DB_STAMP(3);
    weight_grad<G>(smem, pw_out, first);
    first = false;
    __syncthreads();
    DB_STAMP(4);
    // dv, split into S (a lane a row: its 16-byte stores meet every bank)
#pragma unroll 4
    for (int i = tid; i < R * (C / 4); i += NT) {
      const int r = i % R, c4 = i / R;
      put_split<G>(smem, r, c4,
                   *reinterpret_cast<const float4*>(V + r * G::LDV + 4 * c4));
    }
    sm90::fence_proxy_async();
    __syncthreads();
    DB_STAMP(5);
    product_to_v<G>(wt, smem);  // du = dv W^T, over all R rows
    DB_STAMP(6);
    __syncthreads();  // every warpgroup is done with S
    load_x_async<G>(x, b, u0, M, kp, xs);  // again, from L2
    sm90::cp_async_wait_all();
    __syncthreads();
    DB_STAMP(7);
    // owned rows of column cf: depthwise gradients and dx, du and x's rows
    // in windows of K
    {
      const int r_beg = PAD + fg * OROWS;
      const int r_end = min(r_beg + OROWS, M - u0);
      float wf[K], dw[K], xw[K];
#pragma unroll
      for (int tap = 0; tap < K; ++tap) wf[tap] = par[tap * C + cf];
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        dw[j] = V[(r_beg - PAD + j) * G::LDV + cf];  // du rows r - 2 ..
        xw[j] = xs[(r_beg + j) * G::LD + cf];         // x rows r - 2 ..
      }
      for (int r = r_beg; r < r_end; ++r) {
        dw[K - 1] = V[(r + PAD) * G::LDV + cf];
        xw[K - 1] = xs[(r + K - 1) * G::LD + cf];
        const float du = dw[PAD];
        p_dwb += du;
#pragma unroll
        for (int tap = 0; tap < K; ++tap) p_dw[tap] += xw[tap] * du;
        float acc = dw[0] * wf[K - 1];
#pragma unroll
        for (int sh = 1; sh < K; ++sh) acc += dw[sh] * wf[K - 1 - sh];
        dx[(row0 + u0 + r) * C + cf] = acc * kp[r + PAD];
#pragma unroll
        for (int j = 0; j < K - 1; ++j) {
          dw[j] = dw[j + 1];
          xw[j] = xw[j + 1];
        }
      }
    }
    if (tid < G::XROWS) kp_s[(buf ^ 1) * G::KP_STRIDE + tid] = kp_next;
    buf ^= 1;
    __syncthreads();
    DB_STAMP(8);
  }
  if (first)  // a block without a tile still writes its partial
    for (int i = tid; i < C * C; i += NT) pw_out[i] = 0.f;

  // per-block partials of the vectors, summed over threads in a fixed
  // order
  float* red_col = reinterpret_cast<float*>(smem);     // [GROUPS][K + 1][C]
  float* red_row = red_col + G::GROUPS * (K + 1) * C;  // [NW][3][C]
#pragma unroll
  for (int tap = 0; tap < K; ++tap)
    red_col[(fg * (K + 1) + tap) * C + cf] = p_dw[tap];
  red_col[(fg * (K + 1) + K) * C + cf] = p_dwb;
#pragma unroll
  for (int h = 0; h < CH; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = h * 128 + lane * 4 + i;
      red_row[(warp * 3 + 0) * C + col] = p_pwb[h * 4 + i];
      red_row[(warp * 3 + 1) * C + col] = p_lns[h * 4 + i];
      red_row[(warp * 3 + 2) * C + col] = p_lnb[h * 4 + i];
    }
  __syncthreads();
  for (int i = tid; i < (K + 4) * C; i += NT) {
    const int which = i / C, cc = i - which * C;
    float acc = 0.f;
    if (which <= K) {
      for (int q = 0; q < G::GROUPS; ++q)
        acc += red_col[(q * (K + 1) + which) * C + cc];
    } else {
      for (int wp = 0; wp < NW; ++wp)
        acc += red_row[(wp * 3 + which - K - 1) * C + cc];
    }
    part_vec[((size_t)blockIdx.x * (K + 4) + which) * C + cc] = acc;
  }
#ifdef DECODER_BLOCK_STAMPS
  DB_STAMP(9);
  if (threadIdx.x == 0)
    for (int i = 0; i < N_STAMPS; ++i) atomicAdd(&db_stamps[i], stamp_ns[i]);
#endif
}

// ---------------------------------------------------------------------------
// The float32 forward on the tensor cores (GeoF, C = 128 and 256).
//
// What bounds it: at C = 256 operations, the C x C product by 3xTF32
// (three TF32 products a float32 one): 2 N C^2 FLOP a pass, 17.2 GFLOP at
// N = B M = 131,072, 0.104 ms of tensor-core time; at C = 128 bytes, x
// read and y written once, 134 MB, 0.040 ms at 3.35 TB/s (the products
// 0.026 ms).  The design is the backward's front half; it shares the x
// rows' load (load_x_async), the split stores (put_split), the product
// (product_block, store_block) and t's row statistics (row_t_f32):
// - Tiles of R = 64 rows, every row the tile's own: u of a row needs x of
//   its two neighbours on each side, so a tile reads R + 4 rows of x.
//   Rows of u at or beyond M are computed from zeros and not written.
// - u by depthwise_window: a thread slides a window of 5 x rows down a
//   column of 4 channels, so it reads each x row once (depthwise_split,
//   the backward's, reads 5 for every row of u and is bound by
//   shared-memory bandwidth), and splits u into hi and lo copies in shared
//   memory (S), in chunks of R + 1 rows, so a warp's stores, a lane a
//   chunk, meet every bank.
// - v^T = W^T u^T on wgmma.m64n64k8 (product_block): M the output
//   channels, 64 a warpgroup per m-block; N the tile's rows in one
//   instruction; K the input channels.  A is W in A-fragment order from
//   L2 through registers, split there; at C = 256 each block starts its k
//   loop at its own step.  B is S.  At N = 64 the k loop is bound by A's
//   loads from L2 (about half the TF32 peak, probes/tf32_wgmma.py); a
//   tile of 128 rows, which would nearly double that, does not fit at
//   C = 256 and is slower at C = 128 (one block an SM instead of two).
// - A warpgroup holds all its m-blocks' accumulators until both
//   warpgroups are done with S; v's float32 rows then go over S (V, 4
//   banks a row, so the stores meet every bank), and the row pass (four
//   rows a warp: t = tanh(v + pw_b), the LayerNorm with float32
//   statistics, the vectors in registers) writes y as 16-byte row
//   segments, 512 bytes a warp.
// - x's rows of the block's next tile are asynchronous copies (cp.async),
//   issued as soon as this tile's u is split into the x buffer, which
//   nothing reads again this tile: they land during the product and the
//   row pass.
// - Shared memory (decoder_block.py::f32_fwd_plan holds the same plan):
//   S (V over it), x's R + 4 rows, the keep values of two tiles' x rows,
//   the depthwise's taps and bias: 104 KB at C = 128, two blocks an SM
//   (four warpgroups: one block's loads and row pass run under the
//   other's products); 206 KB at C = 256, one.
//
// Numerics: as the backward's front half (the note above).  Held to the
// plain version at SNR >= 90 dB.

template <int C_>
struct GeoF {
  static constexpr int C = C_;
  static constexpr int R = 64;                // rows a tile (wgmma N)
  static constexpr int NT = 256, NW = NT / 32;
  static constexpr int MB = C / 128;          // 64-channel m-blocks a warpgroup
  // rows of a channel chunk of S: its bytes 16 past a multiple of 128
  static constexpr int R_ALLOC = R + 1;
  static constexpr int CHUNK = R_ALLOC * 16;  // its bytes
  static constexpr int LO_OFF = C / 4 * CHUNK;
  static constexpr int V_OFF = 0;             // v's rows over S
  // V's float32 row stride: 4 banks a row, so store_block's stores (rows
  // 2 apart) meet every bank
  static constexpr int LDV = C + 4;
  static constexpr int LD = C + 4;            // the x rows' stride
  static constexpr int XROWS = R + 2 * PAD;
  static constexpr int X_OFF = 2 * LO_OFF;
  // the keep values of x's rows, two tiles' (this one's, the next one's)
  static constexpr int KP_OFF = X_OFF + XROWS * LD * 4;
  static constexpr int KP_STRIDE = (XROWS + 3) / 4 * 4;
  // the depthwise's taps (K x C) and bias
  static constexpr int PAR_OFF = KP_OFF + 2 * KP_STRIDE * 4;
  static constexpr int SMEM = PAR_OFF + (K + 1) * C * 4;
  // blocks an SM: 1 KB of each block's shared memory is reserved
  static constexpr int FWD_BLOCKS = (int)SM_SMEM / (SMEM + 1024);
  // the product's k loop: A's loads PD steps ahead in a ring of RING
  // register slots (with two blocks an SM, each with 128 registers a
  // thread, a smaller ring: the other block's work covers the loads, and
  // the larger ring was no faster)
  static constexpr int KL_PD = FWD_BLOCKS > 1 ? 3 : 7;
  static constexpr int KL_RING = FWD_BLOCKS > 1 ? 4 : 8;
  static constexpr bool ROTATE = C == 256;
  static constexpr int RP = 4;                // rows a warp at once
  static_assert(R == 64 || R == 128, "one wgmma N of tf32x3::mma3");
  static_assert(R % (RP * NW) == 0, "the row pass's rows split evenly");
  static_assert(R * LDV * 4 <= X_OFF, "v's rows fit over S");
  static_assert(FWD_BLOCKS >= 1 && SMEM <= (int)SMEM_LIMIT, "forward smem");
};

template <int C>
__global__ void __launch_bounds__(GeoF<C>::NT, GeoF<C>::FWD_BLOCKS)
    decoder_block_fwd_f32_kernel(const float* __restrict__ x,
                                 const float* __restrict__ keep,
                                 const float* __restrict__ w,
                                 const float* __restrict__ dww,
                                 const float* __restrict__ dwb,
                                 const float* __restrict__ pwb,
                                 const float* __restrict__ lns,
                                 const float* __restrict__ lnb,
                                 float* __restrict__ y, int B, int M,
                                 float eps) {
  using G = GeoF<C>;
  constexpr int NT = G::NT, NW = G::NW, CH = C / 128, R = G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  float* V = reinterpret_cast<float*>(smem + G::V_OFF);
  float* xs = reinterpret_cast<float*>(smem + G::X_OFF);
  float* kp_s = reinterpret_cast<float*>(smem + G::KP_OFF);
  float* par = reinterpret_cast<float*>(smem + G::PAR_OFF);
#ifdef DECODER_BLOCK_STAMPS
  unsigned long long stamp_ns[N_STAMPS] = {}, stamp_last = global_ns();
#endif

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < K * C; i += NT) par[i] = dww[i];
  for (int i = tid; i < C; i += NT) par[K * C + i] = dwb[i];
  // the row pass's vectors at the lane's columns
  float pb[4 * CH], ls[4 * CH], lb[4 * CH];
  lane_cols<G>(pwb, lane, pb);
  lane_cols<G>(lns, lane, ls);
  lane_cols<G>(lnb, lane, lb);
  const int tiles_m = (M + R - 1) / R, tiles = B * tiles_m;
  // x's rows of the block's first tile now; each next tile's once this
  // tile's u is split
  int tile = blockIdx.x, buf = 0;
  if (tile < tiles && tid < G::XROWS) {
    const int b = tile / tiles_m;
    kp_s[tid] = keep_of(keep, b, (tile - b * tiles_m) * R, M, tid);
  }
  __syncthreads();
  if (tile < tiles) {
    const int b = tile / tiles_m;
    load_x_async<G>(x, b, (tile - b * tiles_m) * R, M, kp_s, xs);
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_m;
    const int u0 = (tile - b * tiles_m) * R;  // row of u row 0
    const int next = tile + gridDim.x;
    const int nb = next / tiles_m, nu0 = (next - nb * tiles_m) * R;
    float* kp_next = kp_s + (buf ^ 1) * G::KP_STRIDE;
    if (next < tiles && tid < G::XROWS)
      kp_next[tid] = keep_of(keep, nb, nu0, M, tid);
    sm90::cp_async_wait_all();
    __syncthreads();  // x's rows landed, kp_next written, V read
    DB_STAMP(0);
    depthwise_window<G>(xs, par, smem);
    sm90::fence_proxy_async();
    __syncthreads();  // S written, x's rows read
    DB_STAMP(1);
    if (next < tiles) load_x_async<G>(x, nb, nu0, M, kp_next, xs);
    {
      float acc[G::MB][R / 2];  // v = u W
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb)
        product_block<G>(w, smem, mb, acc[mb]);
      __syncthreads();  // every warpgroup is done with S
      DB_STAMP(2);
#pragma unroll
      for (int mb = 0; mb < G::MB; ++mb) store_block<G>(acc[mb], mb, V);
    }
    __syncthreads();
    DB_STAMP(3);
    // t, its LayerNorm and y, RP rows a warp at once (their chains of
    // warp sums interleave)
    for (int r0 = warp; r0 < R; r0 += G::RP * NW) {
      float t[G::RP][4 * CH], mean[G::RP], rstd[G::RP];
#pragma unroll
      for (int q = 0; q < G::RP; ++q)
        row_t_f32<C>(V + (r0 + q * NW) * G::LDV, lane, pb, t[q], eps,
                     mean[q], rstd[q]);
#pragma unroll
      for (int q = 0; q < G::RP; ++q) {
        const int g = u0 + r0 + q * NW;
        if (g >= M) continue;
#pragma unroll
        for (int i = 0; i < 4 * CH; ++i)
          t[q][i] = (t[q][i] - mean[q]) * rstd[q] * ls[i] + lb[i];
#pragma unroll
        for (int h = 0; h < CH; ++h)
          *reinterpret_cast<float4*>(y + ((size_t)b * M + g) * C + h * 128 +
                                     lane * 4) =
              make_float4(t[q][h * 4], t[q][h * 4 + 1], t[q][h * 4 + 2],
                          t[q][h * 4 + 3]);
      }
    }
    DB_STAMP(4);  // thread 0's warp; the next tile's first stamp waits
                  // for the others
    buf ^= 1;
  }
#ifdef DECODER_BLOCK_STAMPS
  if (threadIdx.x == 0)
    for (int i = 0; i < N_STAMPS; ++i) atomicAdd(&db_stamps[i], stamp_ns[i]);
#endif
}

// A tensor map of a (B, M, C) bf16 tensor as (C, M, B): boxes of 64
// channels x `rows` rows, plain or in the 128-byte swizzle (sw128's
// layout); rows of a sequence outside [0, M) load as zeros and are not
// stored.  cuTensorMapEncodeTiled is found through the runtime's
// entry-point query, so nothing links against libcuda.
template <int C>
cudaError_t tensor_map(CUtensorMap* map, const void* p, int B, int M,
                       int rows, bool swizzle) {
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
  const cuuint64_t dims[3] = {C, static_cast<cuuint64_t>(M),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {C * 2, static_cast<cuuint64_t>(M) * C * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int C>
int fwd_launch(const void* x, const void* keep, const void* w,
               const void* dww, const void* dwb, const void* pwb,
               const void* lns, const void* lnb, void* y, int B, int M,
               float eps, int grid, cudaStream_t stream) {
  using G = GeoHF<C>;
  if (grid < 1) return cudaErrorInvalidValue;
  // x's rows (boxes of 68, plain) and y's (64, swizzled as u's tiles)
  CUtensorMap mx, my;
  cudaError_t e = tensor_map<C>(&mx, x, B, M, G::XROWS, false);
  if (e != cudaSuccess) return e;
  e = tensor_map<C>(&my, y, B, M, G::R, true);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(decoder_block_fwd_kernel<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           G::SMEM_ALLOC);
  if (e != cudaSuccess) return e;
  // the whole of the SM's shared memory, so FWD_BLOCKS blocks fit
  e = cudaFuncSetAttribute(decoder_block_fwd_kernel<C>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  decoder_block_fwd_kernel<C><<<grid, G::NT, G::SMEM_ALLOC, stream>>>(
      mx, my, static_cast<const float*>(keep),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const float*>(lnb), B, M,
      eps);
  return cudaGetLastError();
}

// the bf16 backward's launch: grid blocks in clusters of GeoH::SPLIT
template <int C>
cudaLaunchConfig_t bwd_config(int grid, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  using G = GeoH<C>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(G::NT);
  cfg.dynamicSmemBytes = G::SMEM_ALLOC;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
int bwd_launch(const void* x, const void* keep, const void* w,
               const void* dww, const void* dwb, const void* pwb,
               const void* lns, const void* dy, void* dx, void* part_pw,
               void* part_vec, int B, int M, float eps, int grid,
               cudaStream_t stream) {
  using G = GeoH<C>;
  if (grid < G::SPLIT || grid % G::SPLIT) return cudaErrorInvalidValue;
  // x's rows (boxes of 68, plain) and dy's (64, in u's swizzle)
  CUtensorMap mx, mdy;
  cudaError_t e = tensor_map<C>(&mx, x, B, M, G::XROWS, false);
  if (e != cudaSuccess) return e;
  e = tensor_map<C>(&mdy, dy, B, M, G::R, true);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(decoder_block_bwd_kernel<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           G::SMEM_ALLOC);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = bwd_config<C>(grid, stream, attr);
  e = cudaLaunchKernelEx(
      &cfg, decoder_block_bwd_kernel<C>, mx, mdy,
      static_cast<const float*>(keep), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(dww), static_cast<const float*>(dwb),
      static_cast<const float*>(pwb), static_cast<const float*>(lns),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part_pw),
      static_cast<float*>(part_vec), B, M, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
int fwd_launch_f32(const void* x, const void* keep, const void* w,
                   const void* dww, const void* dwb, const void* pwb,
                   const void* lns, const void* lnb, void* y, int B, int M,
                   float eps, int grid, cudaStream_t stream) {
  using G = GeoF<C>;
  if (grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_fwd_f32_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  // the whole of the SM's shared memory, so FWD_BLOCKS blocks fit
  e = cudaFuncSetAttribute(decoder_block_fwd_f32_kernel<C>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  decoder_block_fwd_f32_kernel<C><<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(keep),
      static_cast<const float*>(w), static_cast<const float*>(dww),
      static_cast<const float*>(dwb), static_cast<const float*>(pwb),
      static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<float*>(y), B, M, eps);
  return cudaGetLastError();
}

template <int C>
int bwd_launch_f32(const void* x, const void* keep, const void* w,
                   const void* wt, const void* dww, const void* dwb,
                   const void* pwb, const void* lns, const void* dy,
                   void* dx, void* part_pw, void* part_vec, int B, int M,
                   float eps, int grid, cudaStream_t stream) {
  using G = GeoB<C>;
  if (wt == nullptr || grid < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decoder_block_bwd_f32_kernel<C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  decoder_block_bwd_f32_kernel<C><<<grid, G::NT, G::SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(keep),
      static_cast<const float*>(w), static_cast<const float*>(wt),
      static_cast<const float*>(dww), static_cast<const float*>(dwb),
      static_cast<const float*>(pwb), static_cast<const float*>(lns),
      static_cast<const float*>(dy), static_cast<float*>(dx),
      static_cast<float*>(part_pw), static_cast<float*>(part_vec), B, M, eps);
  return cudaGetLastError();
}

// The one list of the variants the kernels are built for (the Python
// wrapper's WIDTHS, in bf16 and float32): calls f with the width and the
// dtype (true: float32) as compile-time constants, or returns fallback for
// any other width.
template <class F>
int with_variant(int channels, int f32, int fallback, F f) {
  using T = std::true_type;
  using N = std::false_type;
  switch (channels) {
    case 128:
      return f32 ? f(std::integral_constant<int, 128>(), T())
                 : f(std::integral_constant<int, 128>(), N());
    case 256:
      return f32 ? f(std::integral_constant<int, 256>(), T())
                 : f(std::integral_constant<int, 256>(), N());
    default: return fallback;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of the bf16 backward that the card runs at once (one block an
// SM; a cluster's blocks in one GPC), or 0 (also on a CUDA error).
int decoder_block_bwd_clusters(int channels) {
  return with_variant(channels, 0, 0, [](auto c, auto) {
    constexpr int C = decltype(c)::value;
    if (cudaFuncSetAttribute(decoder_block_bwd_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GeoH<C>::SMEM_ALLOC) != cudaSuccess)
      return 0;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = bwd_config<C>(GeoH<C>::SPLIT, 0, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, decoder_block_bwd_kernel<C>,
                                       &cfg) != cudaSuccess)
      return 0;
    return n;
  });
}

// The bf16 backward's plan, decoder_block.py::bf16_bwd_plan's fields in
// its order: 0 tile rows, 1 owned rows, 2 warpgroups, 3 blocks a cluster,
// 4 W's tiles a block holds (at byte 0), byte offsets 5 of u's tiles and
// 6 of dv's, 7 du's float32 stride (over them), 8 the byte offset of the
// three slots (x rows, dy rows, t in turn) and 9 a slot's bytes, 10 an x
// box's bytes, 11 t's bf16 stride, byte offsets 12 of the row sums
// and statistics, 13 of the column sums, 14 of the two tiles' keep
// values, 15 of the weight vectors, 16 of the four mbarriers, 17
// shared-memory bytes (past the 1024-byte aligned base); -1 for another
// field or width.
int decoder_block_bf16_bwd_plan(int channels, int field) {
  return with_variant(channels, 0, -1, [&](auto c, auto) {
    using G = GeoH<decltype(c)::value>;
    const int v[] = {G::R,       G::OWN,      G::NT / 128, G::SPLIT,
                     G::W_TILES, G::U_OFF,    G::DV_OFF,   G::LDU,
                     G::SLOT_OFF, G::SLOT,    G::XBOX,     G::LDY,
                     G::ST_OFF,  G::CS_OFF,   G::KP_OFF,   G::PAR_OFF,
                     G::BAR_OFF, G::SMEM};
    return field >= 0 && field < 18 ? v[field] : -1;
  });
}

// The float32 backward's plan, decoder_block.py::f32_bwd_plan's fields in
// its order: 0 tile rows, 1 owned rows, 2 warpgroups, 3 rows of a channel
// chunk of the split buffer, 4 the lo copy's byte offset, 5 the float32
// rows' byte offset, 6 their float32 stride, 7 the x rows' stride, 8 the
// byte offset of the rows' keep values, 9 that of the weight vectors, 10
// shared-memory bytes; -1 for another field or width.
int decoder_block_f32_bwd_plan(int channels, int field) {
  return with_variant(channels, 1, -1, [&](auto c, auto) {
    using G = GeoB<decltype(c)::value>;
    const int v[] = {G::R,      G::OWN, G::NT / 128, G::R_ALLOC,
                     G::LO_OFF, G::V_OFF, G::LDV,    G::LD,
                     G::KP_OFF, G::PAR_OFF, G::SMEM};
    return field >= 0 && field < 11 ? v[field] : -1;
  });
}

// The float32 forward's plan, decoder_block.py::f32_fwd_plan's fields in
// its order: 0 tile rows, 1 blocks an SM, 2 warpgroups, 3 rows of a
// channel chunk of the split buffer, 4 the byte offset of its lo copy (hi
// at 0, v's rows over both), 5 v's float32 stride, 6 the byte offset of
// the x rows and 7 their stride, byte offsets 8 of two tiles' keep values
// and 9 of the weight vectors, 10 shared-memory bytes; -1 for another
// field or width.
int decoder_block_f32_fwd_plan(int channels, int field) {
  return with_variant(channels, 1, -1, [&](auto c, auto) {
    using G = GeoF<decltype(c)::value>;
    const int v[] = {G::R,      G::FWD_BLOCKS, G::NT / 128, G::R_ALLOC,
                     G::LO_OFF, G::LDV,        G::X_OFF,    G::LD,
                     G::KP_OFF, G::PAR_OFF,    G::SMEM};
    return field >= 0 && field < 11 ? v[field] : -1;
  });
}

// The bf16 forward's plan, decoder_block.py::bf16_fwd_plan's fields in
// its order: 0 tile rows, 1 blocks an SM, 2 warpgroups, byte offsets 3 of
// u's tiles (W's at 0) and 4 of the x rows' boxes, 5 an x box's bytes,
// byte offsets 6 of the rows' sums, 7 of two tiles' keep values, 8 of the
// weight vectors and 9 of the mbarrier, 10 shared-memory bytes (past the
// 1024-byte aligned base); -1 for another field or width.
int decoder_block_bf16_fwd_plan(int channels, int field) {
  return with_variant(channels, 0, -1, [&](auto c, auto) {
    using G = GeoHF<decltype(c)::value>;
    const int v[] = {G::R,      G::FWD_BLOCKS, G::NT / 128, G::U_OFF,
                     G::X_OFF,  G::XBOX,       G::ST_OFF,   G::KP_OFF,
                     G::PAR_OFF, G::BAR_OFF,   G::SMEM};
    return field >= 0 && field < 11 ? v[field] : -1;
  });
}

int decoder_block_taps() { return K; }

#ifdef DECODER_BLOCK_STAMPS
// The stamped kernels' phase sums (ns, over every block's thread 0) into
// out[0 .. N_STAMPS), then set to 0; the probe's build only.
int decoder_block_stamps(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, db_stamps, sizeof(db_stamps));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[N_STAMPS] = {};
  return cudaMemcpyToSymbol(db_stamps, zero, sizeof(zero));
}
#endif

// x, y: (B, M, C) bf16 (f32 = 0) or float32 (f32 = 1); keep (B, M) f32; w
// (C_in, C_out) in x's dtype, the float32 variant's in wgmma's A-fragment
// order (decoder_block.py::a_fragments); dww (K, C) f32; dwb, pwb, lns, lnb
// (C,) f32.  grid: blocks (they stride over the tiles).
int decoder_block_fwd_launch(const void* x, const void* keep, const void* w,
                             const void* dww, const void* dwb,
                             const void* pwb, const void* lns,
                             const void* lnb, void* y, int B, int M,
                             int channels, int f32, float eps, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(channels, f32, cudaErrorInvalidValue,
                      [&](auto c, auto f) {
    constexpr int C = decltype(c)::value;
    if (decltype(f)::value)
      return fwd_launch_f32<C>(x, keep, w, dww, dwb, pwb, lns, lnb, y, B, M,
                               eps, grid, s);
    return fwd_launch<C>(x, keep, w, dww, dwb, pwb, lns, lnb, y, B, M, eps,
                         grid, s);
  });
}

// dy, dx: (B, M, C) in x's dtype; the float32 variant takes W and W^T
// (wt, C_out x C_in; may be null in bf16) in wgmma's A-fragment order
// (decoder_block.py::a_fragments); part_pw (grid / split, C_in,
// C_out) f32 (the float32 variant's in its accumulators' order, see
// weight_grad); part_vec (grid / split, K + 4, C) f32: dw taps, dw bias, pw
// bias, LN scale, LN bias.  grid is a multiple of the blocks a tile
// shares (bf16: a cluster's, decoder_block_bf16_bwd_plan field 3;
// float32: one).
int decoder_block_bwd_launch(const void* x, const void* keep, const void* w,
                             const void* wt, const void* dww,
                             const void* dwb, const void* pwb,
                             const void* lns, const void* dy, void* dx,
                             void* part_pw, void* part_vec, int B, int M,
                             int channels, int f32, float eps, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(channels, f32, cudaErrorInvalidValue,
                      [&](auto c, auto f) {
    constexpr int C = decltype(c)::value;
    if (decltype(f)::value)
      return bwd_launch_f32<C>(x, keep, w, wt, dww, dwb, pwb, lns, dy, dx,
                               part_pw, part_vec, B, M, eps, grid, s);
    return bwd_launch<C>(x, keep, w, dww, dwb, pwb, lns, dy, dx, part_pw,
                         part_vec, B, M, eps, grid, s);
  });
}

}  // extern "C"
