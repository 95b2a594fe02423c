// Native YIN pitch extractor (de Cheveigné & Kawahara 2002).
//
// A copy of the JAX package's native/pitch.cpp (the host side of the
// preprocessing pipeline's explicit ``backend="yin"`` pitch path), built
// with g++ into build/host/ at first use by ops/kernels/build.load_host and
// loaded with ctypes by audio/pitch.py.  Without -fopenmp the frames run in
// order; each frame's value is the same either way.

#include <cmath>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr float kSilenceEnergy = 1e-6f;

// One frame of YIN: difference function, CMND, dip search, parabolic refine.
float yin_frame(const float* x, int w, int tau_min, int tau_max,
                float threshold, int sr) {
  // energy gate
  double e0 = 0.0;
  for (int j = 0; j < w; ++j) e0 += double(x[j]) * x[j];
  if (e0 / w < kSilenceEnergy) return 0.0f;

  std::vector<double> d(tau_max + 1, 0.0);
  for (int tau = 1; tau <= tau_max; ++tau) {
    double acc = 0.0;
    const float* a = x;
    const float* b = x + tau;
    for (int j = 0; j < w; ++j) {
      const double diff = double(a[j]) - double(b[j]);
      acc += diff * diff;
    }
    d[tau] = acc;
  }

  // cumulative-mean-normalized difference
  std::vector<double> cmnd(tau_max + 1, 1.0);
  double cum = 0.0;
  for (int tau = 1; tau <= tau_max; ++tau) {
    cum += d[tau];
    cmnd[tau] = cum > 1e-12 ? d[tau] * tau / cum : 1.0;
  }

  int tau = -1;
  for (int t = tau_min; t <= tau_max; ++t) {
    if (cmnd[t] < threshold) {
      tau = t;
      while (tau + 1 <= tau_max && cmnd[tau + 1] < cmnd[tau]) ++tau;
      break;
    }
  }
  if (tau < 0) return 0.0f;

  double shift = 0.0;
  if (tau >= 1 && tau < tau_max) {
    const double a = cmnd[tau - 1], b = cmnd[tau], c = cmnd[tau + 1];
    const double denom = a - 2 * b + c;
    if (std::fabs(denom) > 1e-12) {
      shift = 0.5 * (a - c) / denom;
      if (shift > 1.0) shift = 1.0;
      if (shift < -1.0) shift = -1.0;
    }
  }
  return float(double(sr) / (double(tau) + shift));
}

}  // namespace

extern "C" void yin_pitch(const float* wav, int n, int sr, int hop,
                          float fmin, float fmax, float threshold,
                          float* out, int n_frames) {
  const int w = 1024;  // integration window (matches the numpy backend)
  int tau_min = int(sr / fmax);
  if (tau_min < 2) tau_min = 2;
  const int tau_max = int(sr / fmin) + 1;
  const int span = w + tau_max;

  // zero-padded copy so every frame can read a full span
  std::vector<float> padded(size_t(n) + span, 0.0f);
  std::memcpy(padded.data(), wav, sizeof(float) * size_t(n));

#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int i = 0; i < n_frames; ++i) {
    const float* frame = padded.data() + size_t(i) * hop;
    out[i] = yin_frame(frame, w, tau_min, tau_max, threshold, sr);
  }
}
