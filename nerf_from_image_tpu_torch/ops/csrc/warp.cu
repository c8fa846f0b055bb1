// Bilinear image warp into affine crops for Hopper (sm_90a), forward and
// backward to the image.
//
// Replaces TPU kernel B3: `grid_sample_zeros_windowed` in
// nerf_from_image_tpu/ops/pallas/warp.py, which embeds the images in a
// zero-margin plane set and reuses the windowed triplane kernels (B1 for
// the forward, the planes-only B4 for the backward) because a TPU gathers
// badly. Here the function gets kernels of its own: a bilinear sample with
// zeros padding and align_corners=False (the semantics of
// `core.augment._grid_sample_zeros`), computed in float32. The grid is
// data (sampled transforms), so the backward goes to the image only, and
// neither direction assumes anything of it: any scale, rotation or shear,
// crops partly or wholly outside the image, or points in no order at all.
//
// Layout. images (B, C, H, W) float32; grid (B, N, H', W', 2) float32 xy
// in [-1, 1], N crops per image; out (B, N, C, H', W') float32. The
// backward takes grad_out of the output's shape and writes dimages
// (B, C, H, W) float32 whole. 32-bit offsets: the wrapper raises for any
// tensor of 2^31 elements or more, and for more than 65,535 crops (a grid
// row each); C is at most 8 (the wrapper takes 6). No other size limit.
//
// Design of the forward. The first design (one thread per output pixel
// in a 1-D grid over all crops, two 64-bit divisions per thread) took
// 0.063-0.077 ms a call at the inversion's shapes (NVIDIA H100 80GB HBM3,
// 700 W), slower than F.grid_sample's 0.059 ms, against a 12 us bound.
// Now a 2-D grid, blockIdx.y the crop, so a thread finds its image with
// one 32-bit division of a block index; 32-bit offsets; and each warp an
// 8 x 4 patch of pixels rather than 32 pixels of a row, so that a warp's
// gathers, which follow the crop's rotation through the image, touch fewer
// cache lines. Tried on the card and slower: 4 or 8 pixels a thread (as a
// row of 4 read with float4 grid loads and written with 16-byte stores, or
// down a column).
//
// Design of the backward. The first design (one thread per output pixel,
// 3 channels x 4 taps of scalar float32 atomicAdd straight into dimages)
// took 0.275 ms a call at the inversion's shapes: 23.6M reductions onto
// 393K addresses, 60 on each from 15 overlapping crops, serialised in L2.
// Now one thread per output pixel computes its taps once and adds all
// channels of a tap with one float4 atomicAdd (sm_90's vector float add)
// into a channel-last (B, H, W, 4) float32 scratch, 4 reductions a pixel
// in place of 12 (two float4s a tap for 5 to 8 channels); one more kernel
// writes the scratch out as (B, C, H, W). The order of the adds, and so
// the last bits of the sums, changes from run to run.
//
// Bound on this card. At the inversion's 8 images of 3 x 128^2 into 15
// crops the forward reads 1.6 MB of images and 15.7 MB of grid and writes
// 23.6 MB; the backward reads the 23.6 MB cotangent and the grid and
// writes 1.6 MB: some 12 us each at 3.35 TB/s. A few operations per byte,
// so both are bound by bytes, and at this size by launch latency.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// The forward's block: 4 warps, each an 8 x 4 patch of output pixels, one
// pixel a lane, side by side: a 32 x 4 patch of one crop.
constexpr int kForwardThreads = 128;
constexpr int kPatchWidth = 8 * (kForwardThreads / 32);
constexpr int kPatchHeight = 4;

struct Taps {
  int offset[4];      // nw, ne, sw, se, as offsets in one (H, W) image
  float weight[4];    // 0 for a tap outside the image
};

__device__ __forceinline__ Taps make_taps(float gx, float gy, int ih,
                                          int iw) {
  const float ix = ((gx + 1.0f) * iw - 1.0f) / 2.0f;
  const float iy = ((gy + 1.0f) * ih - 1.0f) / 2.0f;
  const float ix0 = floorf(ix);
  const float iy0 = floorf(iy);
  const float wx1 = ix - ix0, wx0 = ix0 + 1.0f - ix;
  const float wy1 = iy - iy0, wy0 = iy0 + 1.0f - iy;
  const int x0 = static_cast<int>(ix0), y0 = static_cast<int>(iy0);
  const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
  const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
  const float ws[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
  Taps t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool valid = xs[k] >= 0 && xs[k] <= iw - 1 && ys[k] >= 0 &&
                       ys[k] <= ih - 1;
    t.offset[k] = valid ? ys[k] * iw + xs[k] : 0;
    t.weight[k] = valid ? ws[k] : 0.0f;
  }
  return t;
}

__device__ __forceinline__ float tap_sum(const float* __restrict__ plane,
                                         const Taps& t) {
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) v += __ldg(plane + t.offset[k]) * t.weight[k];
  return v;
}

// Grid (ceil(W' / 32) * ceil(H' / 4), B * N): a block covers a 32 x 4
// patch of one crop, warp w its columns 8w ... 8w + 7 and lane (col, row) =
// (lane % 8, lane / 8) one pixel. Each gather of a warp thus reads around
// an 8 x 4 patch of output pixels, whose taps fall on a few neighbouring
// image rows whatever the crop's rotation.
__global__ void __launch_bounds__(kForwardThreads)
    warp_forward_kernel(const float* __restrict__ images,
                        const float* __restrict__ grid,
                        float* __restrict__ out, int crops, int channels,
                        int ih, int iw, int oh, int ow) {
  const int crop = blockIdx.y;  // b * N + n
  const int tiles_x = (ow + kPatchWidth - 1) / kPatchWidth;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = (blockIdx.x % tiles_x) * kPatchWidth + warp * 8 + lane % 8;
  const int y = (blockIdx.x / tiles_x) * kPatchHeight + lane / 8;
  if (x >= ow || y >= oh) return;
  const int pixels = oh * ow;
  const int p = y * ow + x;
  const int image_size = ih * iw;
  const float* src = images + (crop / crops) * channels * image_size;
  float* dst = out + crop * channels * pixels + p;
  const float2 xy =
      __ldg(reinterpret_cast<const float2*>(grid) + crop * pixels + p);
  const Taps t = make_taps(xy.x, xy.y, ih, iw);
  for (int c = 0; c < channels; ++c) {
    dst[c * pixels] = tap_sum(src + c * image_size, t);
  }
}

// Grid (ceil(H' * W' / kThreads), B * N): one thread per output pixel of
// one crop. The taps are computed once and each adds its weighted
// cotangents of all channels into the channel-last scratch, kSlots float4
// atomics a tap.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
    warp_backward_kernel(const float* __restrict__ grad_out,
                         const float* __restrict__ grid,
                         float4* __restrict__ scratch, int crops,
                         int channels, int ih, int iw, int out_pixels) {
  const int crop = blockIdx.y;  // b * N + n
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= out_pixels) return;
  const float2 xy = __ldg(reinterpret_cast<const float2*>(grid) +
                          crop * out_pixels + p);
  const Taps t = make_taps(xy.x, xy.y, ih, iw);
  const float* src = grad_out + crop * channels * out_pixels + p;
  float g[4 * kSlots];
#pragma unroll
  for (int c = 0; c < 4 * kSlots; ++c) {
    g[c] = c < channels ? __ldg(src + c * out_pixels) : 0.0f;
  }
  float4* dst = scratch + (crop / crops) * ih * iw * kSlots;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float w = t.weight[k];
    if (w == 0.0f) continue;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      atomicAdd(dst + t.offset[k] * kSlots + q,
                make_float4(w * g[4 * q], w * g[4 * q + 1],
                            w * g[4 * q + 2], w * g[4 * q + 3]));
    }
  }
}

// The channel-last scratch (B, H, W, 4 * kSlots) out as dimages (B, C, H,
// W): one thread per texel, every element of dimages written.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
    channels_first_kernel(const float4* __restrict__ scratch,
                          float* __restrict__ dimages, int channels,
                          int image_size, int texels) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= texels) return;
  const int b = i / image_size, t = i - b * image_size;
  float* dst = dimages + b * channels * image_size + t;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const float4 v = scratch[i * kSlots + q];
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * q + j < channels) dst[(4 * q + j) * image_size] = vs[j];
    }
  }
}

template <int kSlots>
cudaError_t backward(const float* grad_out, const float* grid,
                     float* dimages, float4* scratch, int batch, int crops,
                     int channels, int ih, int iw, int out_pixels,
                     cudaStream_t s) {
  const int texels = batch * ih * iw;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(float4) * kSlots * static_cast<size_t>(texels), s);
  if (err != cudaSuccess) return err;
  if (crops > 0 && out_pixels > 0) {
    const dim3 blocks((out_pixels + kThreads - 1) / kThreads, batch * crops);
    warp_backward_kernel<kSlots><<<blocks, kThreads, 0, s>>>(
        grad_out, grid, scratch, crops, channels, ih, iw, out_pixels);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  channels_first_kernel<kSlots>
      <<<(texels + kThreads - 1) / kThreads, kThreads, 0, s>>>(
          scratch, dimages, channels, ih * iw, texels);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous float32 tensors: images (B, C, H, W), grid (B, N, H', W', 2),
// out (B, N, C, H', W'). Launch on `stream` and return the first
// launch's cudaError_t (0 on success); neither synchronises.
extern "C" int warp_forward_f32(const void* images, const void* grid,
                                void* out, int64_t batch, int crops,
                                int channels, int ih, int iw, int oh, int ow,
                                void* stream) {
  if (batch * crops * oh * ow == 0) return 0;
  const dim3 blocks_grid(((ow + kPatchWidth - 1) / kPatchWidth) *
                             ((oh + kPatchHeight - 1) / kPatchHeight),
                         static_cast<unsigned int>(batch * crops));
  warp_forward_kernel<<<blocks_grid, kForwardThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), static_cast<const float*>(grid),
      static_cast<float*>(out), crops, channels, ih, iw, oh, ow);
  return static_cast<int>(cudaGetLastError());
}

// grad_out (B, N, C, H', W'), grid (B, N, H', W', 2), dimages (B, C, H, W)
// (written whole), scratch (B, H, W, 4 * ceil(C / 4)) float32 (zeroed
// here); C at most 8. Runs a memset and two kernels.
extern "C" int warp_backward_f32(const void* grad_out, const void* grid,
                                 void* dimages, void* scratch, int batch,
                                 int crops, int channels, int ih, int iw,
                                 int oh, int ow, void* stream) {
  if (batch * ih * iw == 0) return 0;
  if (channels < 1 || channels > 8) return cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(grad_out);
  const float* xy = static_cast<const float*>(grid);
  float* d = static_cast<float*>(dimages);
  float4* acc = static_cast<float4*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      channels <= 4
          ? backward<1>(g, xy, d, acc, batch, crops, channels, ih, iw,
                        oh * ow, s)
          : backward<2>(g, xy, d, acc, batch, crops, channels, ih, iw,
                        oh * ow, s));
}
