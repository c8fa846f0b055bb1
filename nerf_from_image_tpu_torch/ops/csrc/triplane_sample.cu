// Triplane bilinear sampler for Hopper (sm_90a).
//
// Replaces TPU kernel B1: `_resident_kernel` in
// nerf_from_image_tpu/ops/pallas/triplane_window.py (reached through
// `sample_windowed_raw` and `sample_triplane_windowed`). It computes the
// function of that kernel, not its TPU mechanism: for each point at
// normalized [-1, 1] coordinates (x, y, z), the mean over planes xy, xz and
// yz of a bilinear sample (align_corners=True, border clamp), with the
// first coordinate of each pair on the width axis. The TPU kernel's point
// blocks, plane windows, one-hot matrix products and overflow fix-up have
// no counterpart: a GPU gathers texels directly.
//
// Layout. Planes are channel-last bf16, (B, 3, R, R, C) with C = 32, so one
// texel is a C-vector of 64 bytes and a 2x2 tap is four such rows.
// Coordinates are (B, N, 3) float32; the output is (B, N, C) bf16, in the
// natural point order.
//
// Design. One warp per point and one lane per channel: the 12 tap loads of
// a point are each one coalesced 64-byte row, the lanes compute the same
// indices and weights redundantly, and the sum is float32, divided by 3 and
// rounded once to the output type. Offsets are int64.
//
// Bound on this card. The kernel reads each point's 12 bytes of
// coordinates, writes its C outputs (64 bytes in bf16) and reads the
// texels the points touch (at most the whole planes, 100 MB at the
// flagship 8 x 3 x 256^2 x 32 bf16). It does 3 x 4 x 32 multiply-adds per
// point, far below the card's rate for those bytes, so it is bound by
// bytes: about 0.7 GB per flagship pass of 8.4M points, some 0.2 ms at
// 3.35 TB/s. The taps themselves come mostly from L2, since neighbouring
// points of a ray and neighbouring rays touch the same texels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;       // one lane per channel
constexpr int kPointsPerBlock = 8;  // one warp per point

__device__ __forceinline__ float load_texel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Bilinear sample of channel `lane` of one (R, R, C) plane at the pair
// (a, b): a on the width (column) axis, b on the height (row) axis.
__device__ __forceinline__ float sample_plane(
    const __nv_bfloat16* __restrict__ plane, float a, float b, int r,
    int lane) {
  const float last = static_cast<float>(r - 1);
  const float ix = fminf(fmaxf((a + 1.0f) * 0.5f * last, 0.0f), last);
  const float iy = fminf(fmaxf((b + 1.0f) * 0.5f * last, 0.0f), last);
  const float x0f = floorf(ix);
  const float y0f = floorf(iy);
  const float fx = ix - x0f;
  const float fy = iy - y0f;
  const int x0 = min(max(static_cast<int>(x0f), 0), r - 1);
  const int y0 = min(max(static_cast<int>(y0f), 0), r - 1);
  const int x1 = min(x0 + 1, r - 1);
  const int y1 = min(y0 + 1, r - 1);

  const __nv_bfloat16* row0 =
      plane + static_cast<int64_t>(y0) * r * kChannels + lane;
  const __nv_bfloat16* row1 =
      plane + static_cast<int64_t>(y1) * r * kChannels + lane;
  const float t00 = load_texel(row0 + static_cast<int64_t>(x0) * kChannels);
  const float t01 = load_texel(row0 + static_cast<int64_t>(x1) * kChannels);
  const float t10 = load_texel(row1 + static_cast<int64_t>(x0) * kChannels);
  const float t11 = load_texel(row1 + static_cast<int64_t>(x1) * kChannels);
  return (1.0f - fx) * (1.0f - fy) * t00 + fx * (1.0f - fy) * t01 +
         (1.0f - fx) * fy * t10 + fx * fy * t11;
}

__global__ void __launch_bounds__(kChannels * kPointsPerBlock)
    triplane_sample_kernel(const __nv_bfloat16* __restrict__ planes,
                           const float* __restrict__ coords,
                           __nv_bfloat16* __restrict__ out,
                           int64_t points_per_image, int64_t total_points,
                           int r) {
  const int lane = threadIdx.x;
  const int64_t point =
      static_cast<int64_t>(blockIdx.x) * kPointsPerBlock + threadIdx.y;
  if (point >= total_points) return;

  const int64_t image = point / points_per_image;
  const int64_t plane_size = static_cast<int64_t>(r) * r * kChannels;
  const __nv_bfloat16* xy = planes + image * 3 * plane_size;
  const __nv_bfloat16* xz = xy + plane_size;
  const __nv_bfloat16* yz = xz + plane_size;

  const float* c = coords + point * 3;
  const float x = __ldg(c);
  const float y = __ldg(c + 1);
  const float z = __ldg(c + 2);

  const float acc = sample_plane(xy, x, y, r, lane) +
                    sample_plane(xz, x, z, r, lane) +
                    sample_plane(yz, y, z, r, lane);
  out[point * kChannels + lane] = __float2bfloat16(acc / 3.0f);
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: planes (B, 3, R, R, 32) bf16, coords (B, N, 3)
// float32, out (B, N, 32) bf16. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int triplane_sample_bf16(const void* planes, const void* coords,
                                    void* out, int64_t batch,
                                    int64_t points_per_image, int r,
                                    void* stream) {
  const int64_t total = batch * points_per_image;
  if (total == 0) return 0;
  const dim3 block(kChannels, kPointsPerBlock);
  const dim3 grid(static_cast<unsigned int>(
      (total + kPointsPerBlock - 1) / kPointsPerBlock));
  triplane_sample_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const float*>(coords), static_cast<__nv_bfloat16*>(out),
      points_per_image, total, r);
  return static_cast<int>(cudaGetLastError());
}
