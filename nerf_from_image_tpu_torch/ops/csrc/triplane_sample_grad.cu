// Backward of the triplane bilinear sampler for Hopper (sm_90a).
//
// Replaces TPU kernel B2: `_resident_grad_kernel` in
// nerf_from_image_tpu/ops/pallas/triplane_window.py (reached through
// `windowed_grad`, the custom VJP of `sample_triplane_windowed`). It
// computes the function of that kernel, the backward of
// `triplane_sample.cu`, not its TPU mechanism (window scatter through
// one-hot matrix products into VMEM accumulators): for each point and
// each of planes xy, xz and yz,
//   dplanes: the four bilinear-weighted cotangents g * w / 3, added into
//            a float32 (B, 3, R, R, C) buffer;
//   dcoords: the tap differences along each axis, times (R - 1) / 2 and
//            zero where the border clamp holds (half at a coordinate
//            exactly on the border, as JAX differentiates its clip),
//            dotted with g / 3 over the channels and summed onto the
//            plane's two coordinates.
//
// Layout. Planes are channel-last bf16, (B, 3, R, R, C) with C = 32;
// coordinates (B, N, 3) float32; grad_out (B, N, C) bf16. Outputs:
// dplanes (B, 3, R, R, C) float32, zeroed by the caller, and dcoords
// (B, N, 3) float32, written whole.
//
// Design. As the forward: one warp per point, one lane per channel, so
// every tap is one coalesced 64-byte row read and one 128-byte row of
// float32 atomic adds. Neighbouring points share texels, so the 12 adds
// per lane are atomicAdd into the float32 buffer (their order, and so the
// last bits of the sums, changes from run to run). The coordinate
// gradient needs a sum over channels: a warp-shuffle reduction, after
// which lane 0 writes the point's 3 floats.
//
// Bound on this card. Per point it reads 12 + 64 bytes (coordinates,
// cotangent) and writes 12 (dcoords); it reads the texels the points touch
// once and writes the float32 dplanes (201 MB at the flagship
// 8 x 3 x 256^2 x 32). About 1 GB per flagship pass of 8.4M points, some
// 0.3 ms at 3.35 TB/s; its operations would take less. What limits it in
// practice is the 12 x 32 atomic adds per point, served by L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;       // one lane per channel
constexpr int kPointsPerBlock = 8;  // one warp per point

struct Axis {
  int lo, hi;   // the two texel indices of the tap
  float frac;   // weight of `hi`
  float slope;  // d(clamped texel coordinate) / d(coordinate)
};

__device__ __forceinline__ Axis make_axis(float g, int r) {
  const float last = static_cast<float>(r - 1);
  const float raw = (g + 1.0f) * 0.5f * last;
  const float i = fminf(fmaxf(raw, 0.0f), last);
  const float i0 = floorf(i);
  Axis a;
  a.lo = min(max(static_cast<int>(i0), 0), r - 1);
  a.hi = min(a.lo + 1, r - 1);
  a.frac = i - i0;
  const float inside = (raw > 0.0f && raw < last) ? 1.0f : 0.0f;
  const float edge = (raw == 0.0f || raw == last) ? 0.5f : 0.0f;
  a.slope = (inside + edge) * 0.5f * last;
  return a;
}

__device__ __forceinline__ float load_texel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// One plane: adds this lane's channel of the four weighted cotangents to
// dplane, and returns this lane's share of the gradient of the plane's
// two coordinates (a on the width axis, b on the height axis).
__device__ __forceinline__ float2 plane_grad(
    const __nv_bfloat16* __restrict__ plane, float* __restrict__ dplane,
    float a, float b, int r, int lane, float g) {
  const Axis x = make_axis(a, r);
  const Axis y = make_axis(b, r);
  const int64_t row0 = static_cast<int64_t>(y.lo) * r;
  const int64_t row1 = static_cast<int64_t>(y.hi) * r;
  const int64_t o00 = (row0 + x.lo) * kChannels + lane;
  const int64_t o01 = (row0 + x.hi) * kChannels + lane;
  const int64_t o10 = (row1 + x.lo) * kChannels + lane;
  const int64_t o11 = (row1 + x.hi) * kChannels + lane;

  const float fx = x.frac, fy = y.frac;
  atomicAdd(dplane + o00, (1.0f - fx) * (1.0f - fy) * g);
  atomicAdd(dplane + o01, fx * (1.0f - fy) * g);
  atomicAdd(dplane + o10, (1.0f - fx) * fy * g);
  atomicAdd(dplane + o11, fx * fy * g);

  const float t00 = load_texel(plane + o00);
  const float t01 = load_texel(plane + o01);
  const float t10 = load_texel(plane + o10);
  const float t11 = load_texel(plane + o11);
  const float da = ((1.0f - fy) * (t01 - t00) + fy * (t11 - t10)) * x.slope;
  const float db = ((1.0f - fx) * (t10 - t00) + fx * (t11 - t01)) * y.slope;
  return make_float2(da * g, db * g);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kChannels * kPointsPerBlock)
    triplane_sample_grad_kernel(const __nv_bfloat16* __restrict__ planes,
                                const float* __restrict__ coords,
                                const __nv_bfloat16* __restrict__ grad_out,
                                float* __restrict__ dplanes,
                                float* __restrict__ dcoords,
                                int64_t points_per_image,
                                int64_t total_points, int r) {
  const int lane = threadIdx.x;
  const int64_t point =
      static_cast<int64_t>(blockIdx.x) * kPointsPerBlock + threadIdx.y;
  if (point >= total_points) return;

  const int64_t image = point / points_per_image;
  const int64_t plane_size = static_cast<int64_t>(r) * r * kChannels;
  const int64_t first = image * 3 * plane_size;

  const float* c = coords + point * 3;
  const float x = __ldg(c);
  const float y = __ldg(c + 1);
  const float z = __ldg(c + 2);
  const float g =
      __bfloat162float(grad_out[point * kChannels + lane]) / 3.0f;

  const float2 xy = plane_grad(planes + first, dplanes + first, x, y, r,
                               lane, g);
  const float2 xz = plane_grad(planes + first + plane_size,
                               dplanes + first + plane_size, x, z, r, lane,
                               g);
  const float2 yz = plane_grad(planes + first + 2 * plane_size,
                               dplanes + first + 2 * plane_size, y, z, r,
                               lane, g);
  const float dx = warp_sum(xy.x + xz.x);
  const float dy = warp_sum(xy.y + yz.x);
  const float dz = warp_sum(xz.y + yz.y);
  if (lane == 0) {
    float* out = dcoords + point * 3;
    out[0] = dx;
    out[1] = dy;
    out[2] = dz;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: planes (B, 3, R, R, 32) bf16, coords (B, N, 3)
// float32, grad_out (B, N, 32) bf16, dplanes (B, 3, R, R, 32) float32
// (zeroed by the caller), dcoords (B, N, 3) float32. Launches on `stream`
// and returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int triplane_sample_grad_bf16(const void* planes,
                                         const void* coords,
                                         const void* grad_out, void* dplanes,
                                         void* dcoords, int64_t batch,
                                         int64_t points_per_image, int r,
                                         void* stream) {
  const int64_t total = batch * points_per_image;
  if (total == 0) return 0;
  const dim3 block(kChannels, kPointsPerBlock);
  const dim3 grid(static_cast<unsigned int>(
      (total + kPointsPerBlock - 1) / kPointsPerBlock));
  triplane_sample_grad_kernel<<<grid, block, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(grad_out),
      static_cast<float*>(dplanes), static_cast<float*>(dcoords),
      points_per_image, total, r);
  return static_cast<int>(cudaGetLastError());
}
