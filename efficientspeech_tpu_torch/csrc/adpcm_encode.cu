// Fixed-step block-ADPCM wire encoder, 4, 3 or 2 bits a code.
//
// Replaces: efficientspeech_tpu/audio/adpcm.py::encode_blocks_device,
// encode3_blocks_device and encode2_blocks_device (not Pallas kernels: a
// lax.scan over the 255 time steps inside the jitted serving program,
// with every 256-sample block a lane).  Eager PyTorch would launch a
// dozen small ops a step, some 3,000 a request; this is one launch.
//
// For x (B, T) float32, T % 256 == 0, each 256-sample block (a lane):
//   samples s = round_half_even(clip(x, -1, 1) * 32767) as int32;
//   step index = the left searchsorted of the 89-entry IMA step table for
//     int(max(C_MEAN * sum|d| / 255, max|d| / C_MAX)), d the 255 diffs,
//     clipped to 88 (the sum is below 2^24, so exact in float32, and the
//     divisions are true divisions, as jnp.mean takes them);
//   255 quantiser steps against the running prediction (integer only);
//   out = a 4-byte header (s[0] as int16 little-endian, the index, 0) and
//     the 255 codes plus a pad code of 0, packed LSB-first.
// The result is bit-equal to the JAX encoder and to the plain version in
// audio/adpcm.py for finite input.
//
// What bounds it on an H100: bytes.  The batch path's 128 rows of 4,096
// frames x 256 samples read 537 MB of float32 and write 52 MB (adpcm3):
// 0.176 ms at 3.35 TB/s.  The work is ~20 integer operations a sample, a
// chain of dependent ones through the prediction.  Design, simple first:
// one thread a lane, 32 lanes a block; the block stages its lanes'
// samples through shared memory as int16 by coalesced float4 loads (rows
// padded to an odd number of words, so the 32 lanes of a warp meet 32
// banks), each thread runs its lane's statistics and quantiser from
// there, packs its codes into 32-bit words in shared memory, and the
// block writes its lanes' bytes, which are contiguous, by coalesced
// 32-bit stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;           // samples a lane
constexpr int LANES = 32;            // lanes a CUDA block, one thread each
constexpr int ROW = BLOCK / 2 + 1;   // 32-bit words of a lane's int16 row
constexpr int N_STEPS = 89;

__constant__ int c_steps[N_STEPS] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484,
    7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818,
    18500, 20350, 22385, 24623, 27086, 29794, 32767};

// the step selectors of each width (audio/adpcm.py: C_MEAN and C_MAX,
// C3_*, C2_*) as float32
template <int BITS> __device__ __forceinline__ float c_mean() {
  return BITS == 4 ? 1.5f : BITS == 3 ? 1.0f : 1.3f;
}
template <int BITS> __device__ __forceinline__ float c_max() {
  return BITS == 3 ? 2.0f : 3.0f;
}

// 32-bit words of one lane's wire bytes: 33, 25 or 17 (odd, so the
// lanes' word stores meet distinct banks)
template <int BITS> __host__ __device__ constexpr int words() {
  return 1 + BLOCK * BITS / 32;
}

__device__ __forceinline__ uint32_t to_int16(float v) {
  v = fminf(fmaxf(v, -1.0f), 1.0f);
  // round half to even, as jnp.round and torch.round do
  return static_cast<uint16_t>(__float2int_rn(__fmul_rn(v, 32767.0f)));
}

__device__ __forceinline__ int sample(const uint32_t* row, int t) {
  const uint32_t w = row[t >> 1];
  return static_cast<int16_t>((t & 1) ? (w >> 16) : (w & 0xFFFFu));
}

// the code magnitude and the prediction step of |diff| d at `step`
template <int BITS>
__device__ __forceinline__ int quantise(int d, int step, int& vpdiff) {
  const int h = step >> 1;
  if (BITS == 4) {
    const int b2 = d >= step;
    d -= b2 * step;
    const int b1 = d >= h;
    d -= b1 * h;
    const int b0 = d >= (step >> 2);
    vpdiff = (step >> 3) + b2 * step + b1 * h + b0 * (step >> 2);
    return b2 * 4 + b1 * 2 + b0;
  } else if (BITS == 3) {
    const int b1 = d >= step;
    d -= b1 * step;
    const int b0 = d >= h;
    vpdiff = (step >> 2) + b1 * step + b0 * h;
    return b1 * 2 + b0;
  } else {
    const int b0 = d >= step;
    vpdiff = h + b0 * step;
    return b0;
  }
}

template <int BITS>
__global__ void __launch_bounds__(LANES)
adpcm_encode_kernel(const float* __restrict__ x, uint32_t* __restrict__ out,
                    int n_lanes) {
  constexpr int W = words<BITS>();
  __shared__ uint32_t rows[LANES * ROW];
  __shared__ uint32_t wire[LANES * W];
  const int lane0 = blockIdx.x * LANES;
  const int n = min(LANES, n_lanes - lane0);

  // stage the block's lanes, contiguous in x, as int16 pairs
  const float4* src =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(lane0) * BLOCK);
  for (int i = threadIdx.x; i < n * (BLOCK / 4); i += LANES) {
    const float4 v = src[i];
    uint32_t* dst = rows + (i / (BLOCK / 4)) * ROW + (i % (BLOCK / 4)) * 2;
    dst[0] = to_int16(v.x) | (to_int16(v.y) << 16);
    dst[1] = to_int16(v.z) | (to_int16(v.w) << 16);
  }
  __syncthreads();

  const int l = threadIdx.x;
  if (l < n) {
    const uint32_t* row = rows + l * ROW;
    const int pred0 = sample(row, 0);
    int sum = 0, peak = 0, prev = pred0;
    for (int t = 1; t < BLOCK; ++t) {
      const int s = sample(row, t);
      const int d = abs(s - prev);
      sum += d;
      peak = max(peak, d);
      prev = s;
    }
    const float mean = __fdiv_rn(static_cast<float>(sum),
                                 static_cast<float>(BLOCK - 1));
    const float target =
        fmaxf(__fmul_rn(c_mean<BITS>(), mean),
              __fdiv_rn(static_cast<float>(peak), c_max<BITS>()));
    const int want = static_cast<int>(target);   // truncates, as astype
    int lo = 0, hi = N_STEPS;                    // first entry >= want
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c_steps[mid] < want) lo = mid + 1; else hi = mid;
    }
    const int idx = min(lo, N_STEPS - 1);
    const int step = c_steps[idx];

    uint32_t* w = wire + l * W;
    w[0] = (static_cast<uint32_t>(pred0) & 0xFFFFu) |
           (static_cast<uint32_t>(idx) << 16);
    uint64_t acc = 0;
    int bits = 0, k = 1, pred = pred0;
    for (int t = 1; t < BLOCK; ++t) {
      const int diff = sample(row, t) - pred;
      const int sign = diff < 0;
      int vpdiff;
      const int mag = quantise<BITS>(abs(diff), step, vpdiff);
      pred = min(max(pred + (sign ? -vpdiff : vpdiff), -32768), 32767);
      acc |= static_cast<uint64_t>(mag | (sign << (BITS - 1))) << bits;
      bits += BITS;
      if (bits >= 32) {
        w[k++] = static_cast<uint32_t>(acc);
        acc >>= 32;
        bits -= 32;
      }
    }
    // the pad code (0) completes the last word: 256 codes fill W - 1 words
    w[k] = static_cast<uint32_t>(acc);
  }
  __syncthreads();

  uint32_t* dst = out + static_cast<size_t>(lane0) * W;
  for (int i = threadIdx.x; i < n * W; i += LANES) dst[i] = wire[i];
}

template <int BITS>
cudaError_t launch(const float* x, uint32_t* out, int n_lanes,
                   cudaStream_t stream) {
  adpcm_encode_kernel<BITS><<<(n_lanes + LANES - 1) / LANES, LANES, 0,
                              stream>>>(x, out, n_lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: n_lanes x 256 float32, 16-byte aligned; out: n_lanes x (4 + 32 *
// bits) bytes, 4-byte aligned; bits 4, 3 or 2; n_lanes >= 1.
int adpcm_encode_launch(const void* x, void* out, int n_lanes, int bits,
                        void* stream) {
  if (n_lanes < 1 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: return launch<4>(xf, o, n_lanes, st);
    case 3: return launch<3>(xf, o, n_lanes, st);
    case 2: return launch<2>(xf, o, n_lanes, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
