// Designs of the planes-only triplane backward (B4) and of the crop-warp
// backward (B3 bwd) that were tried on the card and not kept. The kept
// designs are `triplane_sample_grad_planes.cu` and `warp.cu` in
// `nerf_from_image_tpu_torch/ops/csrc/`; `probes/backward_designs.py`
// times these beside them at the same inputs, each held against the
// port's plain version.
//
// Built on its own by the probe script (nvcc -gencode
// arch=compute_90a,code=sm_90a, plain C interface, ctypes), never by the
// package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------
// B4 without a sort: the points in image order, so that one image's
// dplanes (25 MB at R = 256) stays in L2 while its points are added; a
// group of eight lanes walks kRun consecutive points (consecutive samples
// of a ray), a lane four channels; a plane's four tap sums stay in
// registers while the plane's low tap stays the same, and go out as one
// float4 atomicAdd (red.global.add.v4.f32) per tap and lane when it
// changes.

constexpr int kChannels = 32;
constexpr int kRun = 8;
constexpr int kUnsortedThreads = 256;

struct PlaneRun {
  int tap[4];  // float offsets of the four taps' first channel; -1: none
  float s[4][4];
};

__device__ __forceinline__ void flush_run(float* __restrict__ dplanes,
                                          PlaneRun& run, int ch) {
  const float third = 1.0f / 3.0f;
  if (run.tap[0] < 0) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = make_float4(run.s[k][0] * third, run.s[k][1] * third,
                                 run.s[k][2] * third, run.s[k][3] * third);
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
      atomicAdd(reinterpret_cast<float4*>(dplanes + run.tap[k] + ch), v);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) run.s[k][c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kUnsortedThreads)
    grad_planes_unsorted_kernel(const float* __restrict__ coords,
                                const __nv_bfloat16* __restrict__ grad_out,
                                float* __restrict__ dplanes, int n,
                                int total, int r) {
  const int thread = blockIdx.x * kUnsortedThreads + threadIdx.x;
  const int first = (thread / 8) * kRun;
  const int ch = (thread % 8) * 4;
  if (first >= total) return;
  const int last = min(first + kRun, total);
  const float fr = static_cast<float>(r - 1);
  PlaneRun runs[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    runs[p].tap[0] = -1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) runs[p].s[k][c] = 0.0f;
    }
  }
  for (int point = first; point < last; ++point) {
    const float* cp = coords + static_cast<int64_t>(point) * 3;
    const float xyz[3] = {__ldg(cp), __ldg(cp + 1), __ldg(cp + 2)};
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
        grad_out + static_cast<int64_t>(point) * kChannels + ch));
    const float2 g01 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 g23 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float g[4] = {g01.x, g01.y, g23.x, g23.y};
    const int image = point / n;
    int lo[3], hi[3];
    float frac[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float i = fminf(fmaxf((xyz[a] + 1.0f) * 0.5f * fr, 0.0f), fr);
      const float i0 = floorf(i);
      lo[a] = min(max(static_cast<int>(i0), 0), r - 1);
      hi[a] = min(lo[a] + 1, r - 1);
      frac[a] = i - i0;
    }
    const int cols[3] = {0, 0, 1}, rows[3] = {1, 2, 2};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int ca = cols[p], ra = rows[p];
      const int base = (image * 3 + p) * r * r;
      const int t00 = (base + lo[ra] * r + lo[ca]) * kChannels;
      if (t00 != runs[p].tap[0]) {
        flush_run(dplanes, runs[p], ch);
        runs[p].tap[0] = t00;
        runs[p].tap[1] = (base + lo[ra] * r + hi[ca]) * kChannels;
        runs[p].tap[2] = (base + hi[ra] * r + lo[ca]) * kChannels;
        runs[p].tap[3] = (base + hi[ra] * r + hi[ca]) * kChannels;
      }
      const float fx = frac[ca], fy = frac[ra];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float gx = fx * g[c], hx = g[c] - gx;
        runs[p].s[0][c] += (1.0f - fy) * hx;
        runs[p].s[1][c] += (1.0f - fy) * gx;
        runs[p].s[2][c] += fy * hx;
        runs[p].s[3][c] += fy * gx;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) flush_run(dplanes, runs[p], ch);
}

// ---------------------------------------------------------------------
// B3 backward with the image in shared memory. Zeros padding,
// align_corners=False, float32; grad_out (B, N, C, H', W'), grid
// (B, N, H', W', 2), dimages (B, C, H, W).

struct Taps {
  int offset[4];    // nw, ne, sw, se, as offsets in one (H, W) image
  float weight[4];  // 0 for a tap outside the image
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

// The image plane of one channel in shared memory: one block per (image,
// channel, group of `per_block` crops) adds its crops' taps into the plane
// with shared-memory atomics, then flushes the touched texels with global
// float4 atomics (scalar ones where H * W is not a multiple of 4).
__global__ void __launch_bounds__(512)
    warp_backward_plane_kernel(const float* __restrict__ grad_out,
                               const float* __restrict__ grid,
                               float* __restrict__ dimages, int crops,
                               int channels, int ih, int iw, int out_pixels,
                               int per_block) {
  extern __shared__ __align__(16) float plane[];
  const int image_size = ih * iw;
  const int bc = blockIdx.y;  // b * C + c
  const int b = bc / channels, c = bc % channels;
  for (int i = threadIdx.x; i < image_size; i += blockDim.x) plane[i] = 0.0f;
  __syncthreads();
  const int n0 = blockIdx.x * per_block, n1 = min(crops, n0 + per_block);
  for (int n = n0; n < n1; ++n) {
    const int crop = b * crops + n;
    const float2* g2 = reinterpret_cast<const float2*>(grid) +
                       static_cast<int64_t>(crop) * out_pixels;
    const float* src =
        grad_out + (static_cast<int64_t>(crop) * channels + c) * out_pixels;
    for (int p = threadIdx.x; p < out_pixels; p += blockDim.x) {
      const float2 xy = __ldg(g2 + p);
      const Taps t = make_taps(xy.x, xy.y, ih, iw);
      const float g = __ldg(src + p);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (t.weight[k] != 0.0f) {
          atomicAdd(plane + t.offset[k], t.weight[k] * g);
        }
      }
    }
  }
  __syncthreads();
  float* dst = dimages + static_cast<int64_t>(bc) * image_size;
  if (image_size % 4 == 0) {
    for (int i = threadIdx.x; i < image_size / 4; i += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(plane)[i];
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(dst) + i, v);
      }
    }
  } else {
    for (int i = threadIdx.x; i < image_size; i += blockDim.x) {
      if (plane[i] != 0.0f) atomicAdd(dst + i, plane[i]);
    }
  }
}

// All channels of one image in shared memory: one block per (image, group
// of `per_block` crops); the taps are computed once per pixel for all
// channels.
__global__ void __launch_bounds__(1024)
    warp_backward_image_kernel(const float* __restrict__ grad_out,
                               const float* __restrict__ grid,
                               float* __restrict__ dimages, int crops,
                               int channels, int ih, int iw, int out_pixels,
                               int per_block) {
  extern __shared__ __align__(16) float planes[];
  const int image_size = ih * iw;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < channels * image_size; i += blockDim.x) {
    planes[i] = 0.0f;
  }
  __syncthreads();
  const int n0 = blockIdx.x * per_block, n1 = min(crops, n0 + per_block);
  for (int n = n0; n < n1; ++n) {
    const int crop = b * crops + n;
    const float2* g2 = reinterpret_cast<const float2*>(grid) +
                       static_cast<int64_t>(crop) * out_pixels;
    const float* src =
        grad_out + static_cast<int64_t>(crop) * channels * out_pixels;
    for (int p = threadIdx.x; p < out_pixels; p += blockDim.x) {
      const float2 xy = __ldg(g2 + p);
      const Taps t = make_taps(xy.x, xy.y, ih, iw);
      for (int c = 0; c < channels; ++c) {
        const float g = __ldg(src + c * out_pixels + p);
        float* plane = planes + c * image_size;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.weight[k] != 0.0f) {
            atomicAdd(plane + t.offset[k], t.weight[k] * g);
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = dimages + static_cast<int64_t>(b) * channels * image_size;
  const int total = channels * image_size;
  if (image_size % 4 == 0) {
    for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(planes)[i];
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(dst) + i, v);
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      if (planes[i] != 0.0f) atomicAdd(dst + i, planes[i]);
    }
  }
}

}  // namespace

extern "C" int probe_grad_planes_unsorted(const void* coords,
                                          const void* grad_out, void* dplanes,
                                          int batch, int n, int r,
                                          void* stream) {
  const int total = batch * n;
  if (total == 0) return 0;
  const int64_t threads = (static_cast<int64_t>(total) + kRun - 1) / kRun * 8;
  const unsigned int blocks = static_cast<unsigned int>(
      (threads + kUnsortedThreads - 1) / kUnsortedThreads);
  grad_planes_unsorted_kernel<<<blocks, kUnsortedThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(grad_out),
      static_cast<float*>(dplanes), n, total, r);
  return static_cast<int>(cudaGetLastError());
}

// per_block crops a block; dimages zeroed by the caller. Returns
// cudaErrorInvalidValue where the plane(s) do not fit in shared memory.
extern "C" int probe_warp_backward_plane(const void* grad_out,
                                         const void* grid, void* dimages,
                                         int batch, int crops, int channels,
                                         int ih, int iw, int oh, int ow,
                                         int per_block, int all_channels,
                                         void* stream) {
  if (batch * crops * oh * ow == 0) return 0;
  const size_t bytes = static_cast<size_t>(ih) * iw * 4 *
                       (all_channels ? channels : 1);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 blocks((crops + per_block - 1) / per_block,
                    all_channels ? batch : batch * channels);
  cudaError_t err;
  if (all_channels) {
    err = cudaFuncSetAttribute(warp_backward_image_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    warp_backward_image_kernel<<<blocks, 1024, bytes, s>>>(
        static_cast<const float*>(grad_out), static_cast<const float*>(grid),
        static_cast<float*>(dimages), crops, channels, ih, iw, oh * ow,
        per_block);
  } else {
    err = cudaFuncSetAttribute(warp_backward_plane_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    warp_backward_plane_kernel<<<blocks, 512, bytes, s>>>(
        static_cast<const float*>(grad_out), static_cast<const float*>(grid),
        static_cast<float*>(dimages), crops, channels, ih, iw, oh * ow,
        per_block);
  }
  return static_cast<int>(cudaGetLastError());
}
