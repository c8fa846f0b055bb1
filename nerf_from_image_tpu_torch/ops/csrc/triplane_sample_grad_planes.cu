// Planes-only backward of the triplane bilinear sampler for Hopper
// (sm_90a).
//
// Replaces TPU kernel B4: `_resident_grad_planes_kernel` in
// nerf_from_image_tpu/ops/pallas/triplane_window.py (reached through
// `windowed_grad_planes`, the backward of `windowed_core_planes`, which
// `sample_triplane_windowed(coord_grads=False)` selects for the GAN train
// steps). It computes the function of that kernel, not its TPU mechanism
// (window scatter through one-hot matrix products into VMEM accumulators):
// for each point and each of planes xy, xz and yz, the four
// bilinear-weighted cotangents g * w / 3, added into a float32
// (B, 3, R, R, C) buffer. It is `triplane_sample_grad.cu` (B2) with the
// coordinate gradient taken out, so it never reads the planes: the caller
// needs to keep only the coordinates from the forward.
//
// Layout. Coordinates (B, N, 3) float32; grad_out (B, N, C) bf16 with
// C = 32. Output dplanes (B, 3, R, R, C) float32, zeroed by the caller.
// The taps follow B1's border clamp: a coordinate outside [-1, 1] lands on
// the border texel.
//
// Design. B2's layout: one warp per point, one lane per channel, so every
// tap is one 128-byte row of float32 atomic adds. The adds' return values
// are unused, so they compile to fire-and-forget reductions (RED). Their
// order, and so the last bits of the sums, changes from run to run.
//
// Bound on this card. Per point it reads 12 + 64 bytes (coordinates and
// cotangent), 637 MB at the flagship coarse pass of 8.4M points, and
// writes the float32 dplanes (201 MB at 8 x 3 x 256^2 x 32), which the
// caller has zeroed (another 201 MB): about 0.84-1.04 GB, 0.25-0.31 ms at
// 3.35 TB/s. Its operations would take less. What limits it in practice
// is the 12 x 32 atomic adds per point, served by L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;       // one lane per channel
constexpr int kPointsPerBlock = 8;  // one warp per point

struct Axis {
  int lo, hi;  // the two texel indices of the tap
  float frac;  // weight of `hi`
};

__device__ __forceinline__ Axis make_axis(float g, int r) {
  const float last = static_cast<float>(r - 1);
  const float i = fminf(fmaxf((g + 1.0f) * 0.5f * last, 0.0f), last);
  const float i0 = floorf(i);
  Axis a;
  a.lo = min(max(static_cast<int>(i0), 0), r - 1);
  a.hi = min(a.lo + 1, r - 1);
  a.frac = i - i0;
  return a;
}

// One plane: adds this lane's channel of the four weighted cotangents to
// dplane at the pair (a, b): a on the width axis, b on the height axis.
__device__ __forceinline__ void plane_scatter(float* __restrict__ dplane,
                                              float a, float b, int r,
                                              int lane, float g) {
  const Axis x = make_axis(a, r);
  const Axis y = make_axis(b, r);
  const int64_t row0 = static_cast<int64_t>(y.lo) * r;
  const int64_t row1 = static_cast<int64_t>(y.hi) * r;
  const float fx = x.frac, fy = y.frac;
  atomicAdd(dplane + (row0 + x.lo) * kChannels + lane,
            (1.0f - fx) * (1.0f - fy) * g);
  atomicAdd(dplane + (row0 + x.hi) * kChannels + lane, fx * (1.0f - fy) * g);
  atomicAdd(dplane + (row1 + x.lo) * kChannels + lane, (1.0f - fx) * fy * g);
  atomicAdd(dplane + (row1 + x.hi) * kChannels + lane, fx * fy * g);
}

__global__ void __launch_bounds__(kChannels * kPointsPerBlock)
    triplane_sample_grad_planes_kernel(
        const float* __restrict__ coords,
        const __nv_bfloat16* __restrict__ grad_out,
        float* __restrict__ dplanes, int64_t points_per_image,
        int64_t total_points, int r) {
  const int lane = threadIdx.x;
  const int64_t point =
      static_cast<int64_t>(blockIdx.x) * kPointsPerBlock + threadIdx.y;
  if (point >= total_points) return;

  const int64_t image = point / points_per_image;
  const int64_t plane_size = static_cast<int64_t>(r) * r * kChannels;
  float* first = dplanes + image * 3 * plane_size;

  const float* c = coords + point * 3;
  const float x = __ldg(c);
  const float y = __ldg(c + 1);
  const float z = __ldg(c + 2);
  const float g =
      __bfloat162float(grad_out[point * kChannels + lane]) / 3.0f;

  plane_scatter(first, x, y, r, lane, g);
  plane_scatter(first + plane_size, x, z, r, lane, g);
  plane_scatter(first + 2 * plane_size, y, z, r, lane, g);
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: coords (B, N, 3) float32, grad_out (B, N, 32) bf16,
// dplanes (B, 3, R, R, 32) float32 (zeroed by the caller). Launches on
// `stream` and returns the launch's cudaError_t (0 on success); does not
// synchronise.
extern "C" int triplane_sample_grad_planes_bf16(const void* coords,
                                                const void* grad_out,
                                                void* dplanes, int64_t batch,
                                                int64_t points_per_image,
                                                int r, void* stream) {
  const int64_t total = batch * points_per_image;
  if (total == 0) return 0;
  const dim3 block(kChannels, kPointsPerBlock);
  const dim3 grid(static_cast<unsigned int>(
      (total + kPointsPerBlock - 1) / kPointsPerBlock));
  triplane_sample_grad_planes_kernel<<<grid, block, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(grad_out),
      static_cast<float*>(dplanes), points_per_image, total, r);
  return static_cast<int>(cudaGetLastError());
}
