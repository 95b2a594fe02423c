// Probe of the float32 kernels' k loop on an H100 (probes/tf32_wgmma.py).
//
// Not a port of a TPU kernel: it runs tf32x3::k_loop, the loop of the
// float32 variants of folded_matmul (K1) and mrf_fused (K2), on its own.
// Each of 256 threads (two warpgroups, one block an SM) splits one A
// fragment a k-step and issues the three split products
// (wgmma.m64nNk8.tf32, N = 16, 64 or 128 rows) into float32 accumulators,
// with A, the weights, either loaded from L2 each step as the kernels
// load it (each warp 16 columns x 8 k rows of a 1,024-step x 128-column
// float32 W, two or four steps ahead) or held in registers.  B is a
// zeroed tile in the kernels' shared-memory layout.  The time of `nsteps`
// steps gives the rate of the loop against the TF32 peak, and the gap
// between the two sources what the A loads cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int NT = 256;

template <int N, bool FROM_L2, int PD, int R>
__global__ void __launch_bounds__(NT, 1)
    k_loop_probe(const float* __restrict__ W, float* out, int nsteps) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CHUNK = N * 16;  // 4 channels of N rows
  for (int i = threadIdx.x; i < 4 * CHUNK / 16; i += NT)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  sm90::fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + g;
  const float* wt = W + t * 128 + col;
  const float held = W[col];
  const uint32_t b = sm90::smem_u32(smem);
  const uint64_t d_hi = tf32x3::desc(b, CHUNK),
                 d_lo = tf32x3::desc(b + 2 * CHUNK, CHUNK);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  tf32x3::k_loop<PD, R>(
      nsteps,
      [&](int s, float (&r)[4]) {
        if (FROM_L2) {
          const float* q = wt + (size_t)(8 * (s & 1023)) * 128;
          r[0] = __ldg(q);
          r[1] = __ldg(q + 8);
          r[2] = __ldg(q + 512);
          r[3] = __ldg(q + 520);
        } else {
          r[0] = r[1] = r[2] = r[3] = held;
        }
      },
      [&](int, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
        tf32x3::mma3<N>(acc, hi, lo, d_hi, d_lo, 1);
      });
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum += acc[i];
  if (sum != 0.f) out[blockIdx.x * NT + threadIdx.x] = sum;
}

template <int N, bool FROM_L2, int PD, int R>
int launch(const void* W, void* out, int blocks, int nsteps,
           cudaStream_t stream) {
  const int smem = 4 * N * 16;
  k_loop_probe<N, FROM_L2, PD, R><<<blocks, NT, smem, stream>>>(
      static_cast<const float*>(W), static_cast<float*>(out), nsteps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n: 16, 64 or 128 rows; from_l2: A loaded from W (1,024 x 8 x 128
// float32) each step, ahead by `ahead` (2 or 4) steps, or held in
// registers; nsteps a multiple of 8; out one float a thread.
int tf32_probe_launch(int n, int from_l2, int ahead, const void* W,
                      void* out, int blocks, int nsteps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsteps % 8) return cudaErrorInvalidValue;
#define PROBE(N)                                                         \
  if (n == N) {                                                          \
    if (!from_l2) return launch<N, false, 2, 4>(W, out, blocks, nsteps, s); \
    if (ahead == 2) return launch<N, true, 2, 4>(W, out, blocks, nsteps, s); \
    if (ahead == 4) return launch<N, true, 4, 8>(W, out, blocks, nsteps, s); \
  }
  PROBE(16) PROBE(64) PROBE(128)
#undef PROBE
  return cudaErrorInvalidValue;
}

}  // extern "C"
