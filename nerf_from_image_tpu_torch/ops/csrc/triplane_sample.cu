// Triplane bilinear sampler for Hopper (sm_90a).
//
// Replaces TPU kernel B1: `_resident_kernel` in
// nerf_from_image_tpu/ops/pallas/triplane_window.py (reached through
// `sample_windowed_raw` and `sample_triplane_windowed`), and TPU kernel B6,
// `_window_kernel` in the same file, which computes the same function for
// planes too large for the TPU's VMEM. It computes their function, not
// their TPU mechanism: for each point at normalized [-1, 1] coordinates
// (x, y, z), the mean over planes xy, xz and yz of a bilinear sample
// (align_corners=True, border clamp), with the first coordinate of each
// pair on the width axis. The TPU kernels' point blocks, plane windows,
// one-hot matrix products and overflow fix-up have no counterpart: a GPU
// gathers texels directly, at any plane resolution.
//
// Layout. Planes are channel-last bf16, (B, 3, R, R, C) with C = 32, so one
// texel is a C-vector of 64 bytes and a 2x2 tap is four such rows.
// Coordinates are (B, N, 3) float32; the output is (B, N, C) bf16, in the
// natural point order.
//
// Design (`triplane_taps.cuh`). Four lanes a point, eight channels a lane:
// each tap is one 16-byte load a lane, and the four lanes of a point
// compute its indices and weights. A lane takes kPointsPerLane points an
// iteration, so it has 12 x kPointsPerLane independent loads in flight,
// and writes each point's 8 channels with one 16-byte store (a warp's
// eight points are 512 contiguous bytes). The grid is persistent: as many
// blocks as the card's SMs hold at once, walking the points with a grid
// stride. The sums are float32 in the first design's order, divided by 3
// and rounded once to bf16.
//
// Bound on this card. The kernel reads each point's 12 bytes of
// coordinates, writes its C outputs (64 bytes in bf16) and reads the
// texels the points touch (at most the whole planes, 100 MB at the
// flagship 8 x 3 x 256^2 x 32 bf16). It does 3 x 4 x 32 multiply-adds per
// point, far below the card's rate for those bytes, so it is bound by
// bytes: about 0.7 GB per flagship pass of 8.4M points, some 0.2 ms at
// 3.35 TB/s. The taps themselves (768 bytes a point) come mostly from L1
// and L2, since the samples of one ray share their xy taps and
// neighbouring rays share texels: that traffic, not HBM's, is what the
// wide loads and the loads in flight are for. What bounds this design is
// instruction issue: some 56 warp instructions a point (the 96 unpacks
// and 96 multiply-adds of a lane's 12 taps, the index arithmetic the four
// lanes of a point repeat, the divisions by 3); points that all hit L1
// take as long as the flagship pass. The grid-stride order keeps the
// whole card on a narrow band of rays, which L2 holds: giving each block
// its own contiguous run of points was slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "triplane_taps.cuh"

namespace {

using triplane_taps::kChannels;
using triplane_taps::kLaneChannels;
using triplane_taps::kLanesPerPoint;
using triplane_taps::kPointsPerStep;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPointsPerLane = 2;
constexpr int kWarpPoints = kPointsPerStep * kPointsPerLane;  // 16

__global__ void __launch_bounds__(kThreads)
    triplane_sample_kernel(const __nv_bfloat16* __restrict__ planes,
                           const float* __restrict__ coords,
                           __nv_bfloat16* __restrict__ out,
                           int points_per_image, int total, int r) {
  const int lane = threadIdx.x % 32;
  const int slot = lane / kLanesPerPoint;
  const int chunk = lane % kLanesPerPoint;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps +
                       threadIdx.x / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps *
                         kWarpPoints;
  for (int64_t base = warp * kWarpPoints; base < total; base += stride) {
    int point[kPointsPerLane];
    bool valid[kPointsPerLane];
#pragma unroll
    for (int p = 0; p < kPointsPerLane; ++p) {
      const int64_t mine = base + slot + p * kPointsPerStep;
      valid[p] = mine < total;
      point[p] = valid[p] ? static_cast<int>(mine) : total - 1;
    }
    uint4 feat[kPointsPerLane];
    triplane_taps::sample_points<kPointsPerLane>(
        planes, coords, point, points_per_image, r, chunk, feat);
#pragma unroll
    for (int p = 0; p < kPointsPerLane; ++p) {
      if (valid[p]) {
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(point[p]) *
                                            kChannels +
                                  chunk * kLaneChannels) = feat[p];
      }
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous, 16-byte aligned tensors: planes (B, 3, R, R, 32) bf16,
// coords (B, N, 3) float32, out (B, N, 32) bf16, with B * N and
// 3 * R * R * 32 below 2^31 (the wrapper checks all of this). `sms` is the
// card's SM count; the grid is that many times the blocks an SM holds at
// once. Launches on `stream` and returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int triplane_sample_bf16(const void* planes, const void* coords,
                                    void* out, int64_t batch,
                                    int64_t points_per_image, int r,
                                    int sms, void* stream) {
  const int64_t total = batch * points_per_image;
  if (total == 0) return 0;
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, triplane_sample_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  int64_t blocks = (total + kWarps * kWarpPoints - 1) /
                   (kWarps * kWarpPoints);
  const int64_t resident = static_cast<int64_t>(sms) * blocks_per_sm;
  if (blocks > resident) blocks = resident;
  triplane_sample_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const float*>(coords), static_cast<__nv_bfloat16*>(out),
      static_cast<int>(points_per_image), static_cast<int>(total), r);
  return static_cast<int>(cudaGetLastError());
}
