// Host-side decoder of the fixed-step block-ADPCM wires, 4, 3 and 2 bits
// a code (audio/adpcm.py documents the format; this mirrors the encoder's
// closed loop exactly).  Per block: a 4-byte header (pred0 int16 LE, step
// index u8, reserved) and the packed codes -> 256 float32 samples.  The
// step is fixed per block, so the prediction delta of each code is a small
// table built once a block and the inner loop is a branchless
// table-add-clamp at memory speed.
//
// Counterpart of the JAX package's host decoder, native/adpcm.cpp
// (adpcm4_decode, adpcm3_decode, adpcm2_decode), which this copies.  Its
// plain twins are the numpy decoders of audio/adpcm.py (_decode_numpy,
// _decode3_numpy, _decode2_numpy); the output is bit-equal to them.
// Built with g++ at first use (ops/kernels/build.py: load_host), with
// -march=native: the library is built on the machine that runs it.

#include <cstdint>

namespace {

const int kBlock = 256;
const int kHeader = 4;
const int kBlockBytes = kHeader + kBlock / 2;

const int16_t kStep[89] = {
    7,     8,     9,     10,    11,    12,    13,    14,    16,    17,
    19,    21,    23,    25,    28,    31,    34,    37,    41,    45,
    50,    55,    60,    66,    73,    80,    88,    97,    107,   118,
    130,   143,   157,   173,   190,   209,   230,   253,   279,   307,
    337,   371,   408,   449,   494,   544,   598,   658,   724,   796,
    876,   963,   1060,  1166,  1282,  1411,  1552,  1707,  1878,  2066,
    2272,  2499,  2749,  3024,  3327,  3660,  4026,  4428,  4871,  5358,
    5894,  6484,  7132,  7845,  8630,  9493,  10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" void adpcm4_decode(const uint8_t* data, int n_blocks,
                              float* out) {
  // divide in double then narrow, matching numpy's (int / 32767.0)
  // .astype(float32) bit-for-bit
  const double scale = 1.0 / 32767.0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const uint8_t* p = data + (int64_t)blk * kBlockBytes;
    int pred = (int16_t)(p[0] | (p[1] << 8));
    int idx = clampi(p[2], 0, 88);
    int step = kStep[idx];
    int h = step >> 1, q = step >> 2, s8 = step >> 3;
    int32_t delta[16];
    for (int code = 0; code < 16; ++code) {
      int vpdiff = s8 + ((code & 4) ? step : 0) + ((code & 2) ? h : 0)
                   + ((code & 1) ? q : 0);
      delta[code] = (code & 8) ? -vpdiff : vpdiff;
    }
    const uint8_t* codes = p + kHeader;
    float* o = out + (int64_t)blk * kBlock;
    o[0] = (float)(pred * scale);
    // two nibbles (low first) per wire byte; sample t uses nibble t-1
    for (int t = 1; t < kBlock; t += 2) {
      int byte = codes[(t - 1) >> 1];
      pred = clampi(pred + delta[byte & 0x0F], -32768, 32767);
      o[t] = (float)(pred * scale);
      if (t + 1 < kBlock) {
        pred = clampi(pred + delta[byte >> 4], -32768, 32767);
        o[t + 1] = (float)(pred * scale);
      }
    }
  }
}

// 3-bit variant: sign + 2 magnitude bits, fixed step per 256-sample block.
// 8 codes pack into 3 bytes; 100-byte blocks (4-byte header + 96 code
// bytes) -> 256 float32 samples.  Mirrors adpcm.py's encode3/_decode3.
extern "C" void adpcm3_decode(const uint8_t* data, int n_blocks,
                              float* out) {
  const int kBlock3 = 256;
  const int kBlock3Bytes = kHeader + kBlock3 * 3 / 8;
  const double scale = 1.0 / 32767.0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const uint8_t* p = data + (int64_t)blk * kBlock3Bytes;
    int pred = (int16_t)(p[0] | (p[1] << 8));
    int idx = clampi(p[2], 0, 88);
    int step = kStep[idx];
    int h = step >> 1, s4 = step >> 2;
    int32_t delta[8];
    for (int code = 0; code < 8; ++code) {
      int vpdiff = s4 + ((code & 2) ? step : 0) + ((code & 1) ? h : 0);
      delta[code] = (code & 4) ? -vpdiff : vpdiff;
    }
    const uint8_t* bytes = p + kHeader;
    float* o = out + (int64_t)blk * kBlock3;
    o[0] = (float)(pred * scale);
    // groups of 8 codes from 3 bytes; sample t uses code t-1 (the last
    // code of the final group is padding)
    int t = 1;
    for (int g = 0; g < kBlock3 / 8; ++g) {
      int b0 = bytes[g * 3], b1 = bytes[g * 3 + 1], b2 = bytes[g * 3 + 2];
      int codes[8] = {
          b0 & 7,          (b0 >> 3) & 7,
          ((b0 >> 6) & 3) | ((b1 & 1) << 2), (b1 >> 1) & 7,
          (b1 >> 4) & 7,   ((b1 >> 7) & 1) | ((b2 & 3) << 1),
          (b2 >> 2) & 7,   (b2 >> 5) & 7};
      for (int j = 0; j < 8 && t < kBlock3; ++j, ++t) {
        pred = clampi(pred + delta[codes[j]], -32768, 32767);
        o[t] = (float)(pred * scale);
      }
    }
  }
}

// 2-bit variant: sign + 1 magnitude bit, fixed step per 256-sample block.
// 4 codes per byte; 68-byte blocks (4-byte header + 64 code bytes) ->
// 256 float32 samples.  Mirrors adpcm.py's encode2/_decode2.
extern "C" void adpcm2_decode(const uint8_t* data, int n_blocks,
                              float* out) {
  const int kBlock2 = 256;
  const int kBlock2Bytes = kHeader + kBlock2 / 4;
  const double scale = 1.0 / 32767.0;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const uint8_t* p = data + (int64_t)blk * kBlock2Bytes;
    int pred = (int16_t)(p[0] | (p[1] << 8));
    int idx = clampi(p[2], 0, 88);
    int step = kStep[idx];
    int h = step >> 1;
    int32_t delta[4];
    for (int code = 0; code < 4; ++code) {
      int vpdiff = h + ((code & 1) ? step : 0);
      delta[code] = (code & 2) ? -vpdiff : vpdiff;
    }
    const uint8_t* bytes = p + kHeader;
    float* o = out + (int64_t)blk * kBlock2;
    o[0] = (float)(pred * scale);
    // 4 codes (low bits first) per wire byte; sample t uses code t-1
    // (the last code of the final byte is padding)
    int t = 1;
    for (int g = 0; g < kBlock2 / 4; ++g) {
      int b = bytes[g];
      for (int j = 0; j < 4 && t < kBlock2; ++j, ++t) {
        pred = clampi(pred + delta[(b >> (2 * j)) & 3], -32768, 32767);
        o[t] = (float)(pred * scale);
      }
    }
  }
}
