// The forward triplane sampler's core, shared by the plain sampler
// (`triplane_sample.cu`, TPU kernels B1 and B6) and the sampler fused with
// the decoder tail (`triplane_sample_fused.cu`, B5a and B5b).
//
// Function. For a point at normalized [-1, 1] coordinates (x, y, z), the
// mean over planes xy, xz and yz of a bilinear sample (align_corners=True,
// border clamp), with the first coordinate of each pair on the width
// (column) axis. Planes are channel-last bf16, (B, 3, R, R, 32): one texel
// is a row of 64 bytes.
//
// Layout. Four lanes serve one point, eight channels a lane, so each of a
// point's 12 taps is one 16-byte non-coherent load a lane and a warp
// serves eight points per step. The four lanes of a point compute its
// indices and weights alike (four times, not 32 times as one lane per
// channel would). Offsets are 32-bit within one image's three planes
// (the wrappers raise where 3 * R * R * 32 does not fit), from a 64-bit
// image base.
//
// Arithmetic. The sums are float32 per channel in the order of the first
// design: per plane (1 - fx)(1 - fy) t00 + fx (1 - fy) t01 + (1 - fx) fy
// t10 + fx fy t11, then xy + xz + yz, then / 3, rounded once by the
// caller; so the output equals the first design's bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace triplane_taps {

constexpr int kChannels = 32;
constexpr int kLanesPerPoint = 4;
constexpr int kLaneChannels = kChannels / kLanesPerPoint;  // 8: 16 bytes
constexpr int kPointsPerStep = 32 / kLanesPerPoint;         // 8 a warp
constexpr int kTaps = 12;  // 3 planes x 2 x 2

// The 12 taps of one point for one lane: element offsets of the lane's
// 8-channel chunk of each texel within the image's three planes, in the
// order (plane, y0 x0, y0 x1, y1 x0, y1 x1), and each plane's fractions.
struct PointTaps {
  int offset[kTaps];
  float fx[3];
  float fy[3];
};

// An integer in [0, 2^23) as a float, exactly, on the integer and float
// pipes (no conversion instruction): its bits under 2^23's exponent.
__device__ __forceinline__ float small_int_to_float(int i) {
  return __int_as_float(0x4b000000 | i) - 8388608.0f;
}

// Taps of one (R, R) plane at the pair (a, b): a on the width axis, b on
// the height axis.
__device__ __forceinline__ void plane_taps(float a, float b, int r,
                                           int plane, int chunk,
                                           PointTaps& taps) {
  const float last = static_cast<float>(r - 1);
  const float ix = fminf(fmaxf((a + 1.0f) * 0.5f * last, 0.0f), last);
  const float iy = fminf(fmaxf((b + 1.0f) * 0.5f * last, 0.0f), last);
  // ix and iy lie in [0, R - 1]: one conversion each gives the floor.
  const int x0 = __float2int_rd(ix);
  const int y0 = __float2int_rd(iy);
  taps.fx[plane] = ix - small_int_to_float(x0);
  taps.fy[plane] = iy - small_int_to_float(y0);
  const int x1 = min(x0 + 1, r - 1);
  const int y1 = min(y0 + 1, r - 1);
  const int row0 = (plane * r + y0) * r * kChannels + chunk * kLaneChannels;
  const int row1 = (plane * r + y1) * r * kChannels + chunk * kLaneChannels;
  taps.offset[4 * plane + 0] = row0 + x0 * kChannels;
  taps.offset[4 * plane + 1] = row0 + x1 * kChannels;
  taps.offset[4 * plane + 2] = row1 + x0 * kChannels;
  taps.offset[4 * plane + 3] = row1 + x1 * kChannels;
}

__device__ __forceinline__ PointTaps point_taps(float x, float y, float z,
                                                int r, int chunk) {
  PointTaps taps;
  plane_taps(x, y, r, 0, chunk, taps);
  plane_taps(x, z, r, 1, chunk, taps);
  plane_taps(y, z, r, 2, chunk, taps);
  return taps;
}

// bf16 pair (low element first) -> two floats, exactly.
__device__ __forceinline__ float bf16_low(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_high(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&t)[8]) {
  t[0] = bf16_low(v.x);
  t[1] = bf16_high(v.x);
  t[2] = bf16_low(v.y);
  t[3] = bf16_high(v.y);
  t[4] = bf16_low(v.z);
  t[5] = bf16_high(v.z);
  t[6] = bf16_low(v.w);
  t[7] = bf16_high(v.w);
}

// Two floats -> a bf16 pair (round to nearest even), low element first.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 out;
  out.x = pack_bf16x2(v[0], v[1]);
  out.y = pack_bf16x2(v[2], v[3]);
  out.z = pack_bf16x2(v[4], v[5]);
  out.w = pack_bf16x2(v[6], v[7]);
  return out;
}

// The 12 taps of P points, all loaded before any is used, so that a lane
// has 12 P independent 16-byte loads in flight.
template <int P>
__device__ __forceinline__ void load_taps(
    const __nv_bfloat16* const (&image)[P], const PointTaps (&taps)[P],
    uint4 (&texels)[P][kTaps]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int i = 0; i < kTaps; ++i) {
      texels[p][i] = __ldg(reinterpret_cast<const uint4*>(
          image[p] + taps[p].offset[i]));
    }
  }
}

// The lane's 8 channels of the point: the sum over the three planes of
// the bilinear blends, divided by 3, rounded to bf16 and packed.
__device__ __forceinline__ uint4 blend(const PointTaps& taps,
                                       const uint4 (&texels)[kTaps]) {
  float sum[3][8];
#pragma unroll
  for (int plane = 0; plane < 3; ++plane) {
    const float fx = taps.fx[plane];
    const float fy = taps.fy[plane];
    float t00[8], t01[8], t10[8], t11[8];
    unpack8(texels[4 * plane + 0], t00);
    unpack8(texels[4 * plane + 1], t01);
    unpack8(texels[4 * plane + 2], t10);
    unpack8(texels[4 * plane + 3], t11);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      sum[plane][c] = (1.0f - fx) * (1.0f - fy) * t00[c] +
                      fx * (1.0f - fy) * t01[c] +
                      (1.0f - fx) * fy * t10[c] + fx * fy * t11[c];
    }
  }
  float out[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    out[c] = (sum[0][c] + sum[1][c] + sum[2][c]) / 3.0f;
  }
  return pack8(out);
}

// Samples the lane's 8 channels of P points at once, rounded to bf16 and
// packed into 16 bytes each. `point[p]` is a point below `total`; the
// caller clamps the indices of a ragged tail and drops their results.
template <int P>
__device__ __forceinline__ void sample_points(
    const __nv_bfloat16* __restrict__ planes,
    const float* __restrict__ coords, const int (&point)[P],
    int points_per_image, int r, int chunk, uint4 (&result)[P]) {
  const int64_t image_size = 3LL * r * r * kChannels;
  const __nv_bfloat16* image[P];
  PointTaps taps[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float* c = coords + static_cast<int64_t>(point[p]) * 3;
    image[p] = planes + (point[p] / points_per_image) * image_size;
    taps[p] = point_taps(__ldg(c), __ldg(c + 1), __ldg(c + 2), r, chunk);
  }
  uint4 texels[P][kTaps];
  load_taps<P>(image, taps, texels);
#pragma unroll
  for (int p = 0; p < P; ++p) result[p] = blend(taps[p], texels[p]);
}

}  // namespace triplane_taps
