// Triplane bilinear sampler fused with the decoder tail, for Hopper
// (sm_90a).
//
// Replaces TPU kernel B5a: `_resident_kernel_fused` with `_decode_tail` in
// nerf_from_image_tpu/ops/pallas/triplane_window.py, and TPU kernel B5b,
// `_window_kernel_fused` in the same file, which computes the same function
// for planes too large to keep resident in the TPU's VMEM (both reached
// through `sample_windowed_raw(..., decode=...)`). A GPU gathers texels
// from device memory at any plane resolution, so one kernel serves both.
// It computes their function, not their TPU mechanism (no windows, one-hot
// matrix products or fold matrix). For each point at normalized [-1, 1]
// coordinates:
//
//   feat = bf16(mean over planes xy, xz, yz of a bilinear sample)
//   h    = softplus(feat @ w0 + b0)              (32 -> 64, f32 sums)
//   d    = bf16(h) @ w1 + b1                     (64 -> 1 + K, f32 sums)
//   rgb  = bf16(softmax(d[1:])) @ palette[image] (K -> 3, f32 sums)
//   out  = bf16([d[0] | rgb])
//
// with w0, w1 and the palette in bf16 and the biases in float32, the
// roundings of the Pallas kernel. The sampling is B1's
// (`triplane_sample.cu`): align_corners=True, border clamp, the first
// coordinate of each pair on the width axis.
//
// Layout. Planes are channel-last bf16, (B, 3, R, R, 32); coordinates
// (B, N, 3) float32; w0 (32, 64) and w1 (64, 1 + K) bf16, row-major,
// input index first; b0 (64,) and b1 (1 + K,) float32; the palette
// (B, K, 3) bf16; the output (B, N, 4) bf16.
//
// Design. A warp takes 32 points at a time, in two halves:
// - Sampling, B1's layout: one point after another, one lane per channel,
//   so each tap load is a coalesced 64-byte row. The bf16-rounded feature
//   goes to a per-warp 32 x 33 float tile in shared memory (the padding
//   keeps the transposed reads free of bank conflicts).
// - Decoding, one lane per point: each lane reads its point's 32 features
//   into registers and runs the whole decoder tail alone, so no work is
//   repeated across lanes. The weights sit in shared memory as float32,
//   each row read by all lanes at once (a broadcast), four at a time.
// The weights are staged once per block, and each warp walks over many
// tiles of points. K is fixed at 10, the palette of every reference
// dataset, so the decoder's loops unroll fully. Offsets are int64 (planes
// of any R).
//
// Bound on this card. Per point the kernel reads 12 bytes of coordinates,
// writes 8 bytes of output and reads the texels the points touch (at most
// the whole planes); it does 2 x (32 x 64 + 64 x (1 + K) + 3 x K) = 5.5
// kFLOP of decoder products (K = 10) and about 1 kFLOP of float32 taps,
// softplus and softmax. At the flagship coarse pass (8.4M points) that is
// about 0.25 GB (0.075 ms at 3.35 TB/s) against 0.13 ms of float32
// operations and 0.05 ms of bf16 tensor-core products: bound by
// operations. This version runs the products on the CUDA cores in
// float32, where they take about 0.7 ms; moving them to the tensor cores
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChannels = 32;   // one lane per channel while sampling
constexpr int kHidden = 64;
constexpr int kValues = 10;     // palette entries K
constexpr int kOut = 1 + kValues;
// w1's shared-memory row: the 1 + K outputs padded to a multiple of 4,
// for float4 reads.
constexpr int kW1 = (kOut + 3) / 4 * 4;
constexpr int kWarps = 8;
constexpr int kTile = 32;       // points per warp tile, one per lane
constexpr int kRow = kChannels + 1;  // padded feature row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_texel(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// softplus(x) = log(1 + exp(x)), written as jax.nn.softplus (logaddexp).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(kChannels * kWarps)
    triplane_sample_fused_kernel(
        const __nv_bfloat16* __restrict__ planes,
        const float* __restrict__ coords,
        const __nv_bfloat16* __restrict__ w0,
        const float* __restrict__ b0,
        const __nv_bfloat16* __restrict__ w1,
        const float* __restrict__ b1,
        const __nv_bfloat16* __restrict__ palette,
        __nv_bfloat16* __restrict__ out, int64_t points_per_image,
        int64_t total_points, int r) {
  __shared__ __align__(16) float w0_s[kHidden * kChannels];  // [j][c]
  __shared__ float b0_s[kHidden];
  __shared__ __align__(16) float w1_s[kHidden * kW1];  // [j][k], 0-padded
  __shared__ float b1_s[kW1];
  __shared__ float feat_s[kWarps][kTile * kRow];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kChannels + lane;
  for (int i = tid; i < kHidden * kChannels; i += kChannels * kWarps) {
    const int j = i / kChannels;
    const int c = i % kChannels;
    w0_s[i] = __bfloat162float(w0[c * kHidden + j]);
  }
  for (int i = tid; i < kHidden * kW1; i += kChannels * kWarps) {
    const int j = i / kW1;
    const int k = i % kW1;
    w1_s[i] = k < kOut ? __bfloat162float(w1[j * kOut + k]) : 0.0f;
  }
  if (tid < kHidden) b0_s[tid] = b0[tid];
  if (tid < kW1) b1_s[tid] = tid < kOut ? b1[tid] : 0.0f;
  __syncthreads();

  const int64_t plane_size = static_cast<int64_t>(r) * r * kChannels;
  float* feat = feat_s[warp];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * kTile;
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kTile;
       base < total_points; base += stride) {
    // Sampling: lane `lane` holds its own point's coordinates, and the
    // warp samples the tile's points one by one, one lane per channel.
    const int64_t mine = base + lane;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    if (mine < total_points) {
      cx = __ldg(coords + mine * 3);
      cy = __ldg(coords + mine * 3 + 1);
      cz = __ldg(coords + mine * 3 + 2);
    }
    const int count = total_points - base < kTile
                          ? static_cast<int>(total_points - base)
                          : kTile;
    for (int p = 0; p < count; ++p) {
      const float x = __shfl_sync(kFull, cx, p);
      const float y = __shfl_sync(kFull, cy, p);
      const float z = __shfl_sync(kFull, cz, p);
      const int64_t image = (base + p) / points_per_image;
      const __nv_bfloat16* xy = planes + image * 3 * plane_size;
      const __nv_bfloat16* xz = xy + plane_size;
      const __nv_bfloat16* yz = xz + plane_size;
      feat[p * kRow + lane] = round_bf16(
          (sample_plane(xy, x, y, r, lane) + sample_plane(xz, x, z, r, lane) +
           sample_plane(yz, y, z, r, lane)) / 3.0f);
    }
    __syncwarp();

    // Decoding: lane `lane` runs its point through the decoder tail.
    if (lane < count) {
      float f[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) f[c] = feat[lane * kRow + c];
      float d[kW1];
#pragma unroll
      for (int k = 0; k < kW1; ++k) d[k] = b1_s[k];
#pragma unroll 2
      for (int j = 0; j < kHidden; ++j) {
        const float4* w0_row = reinterpret_cast<const float4*>(
            w0_s + j * kChannels);
        float h = b0_s[j];
#pragma unroll
        for (int q = 0; q < kChannels / 4; ++q) {
          const float4 w = w0_row[q];
          h = fmaf(f[4 * q], w.x, h);
          h = fmaf(f[4 * q + 1], w.y, h);
          h = fmaf(f[4 * q + 2], w.z, h);
          h = fmaf(f[4 * q + 3], w.w, h);
        }
        h = round_bf16(softplus(h));
        const float4* w1_row = reinterpret_cast<const float4*>(w1_s + j * kW1);
#pragma unroll
        for (int q = 0; q < kW1 / 4; ++q) {
          const float4 w = w1_row[q];
          d[4 * q] = fmaf(h, w.x, d[4 * q]);
          d[4 * q + 1] = fmaf(h, w.y, d[4 * q + 1]);
          d[4 * q + 2] = fmaf(h, w.z, d[4 * q + 2]);
          d[4 * q + 3] = fmaf(h, w.w, d[4 * q + 3]);
        }
      }

      // Softmax over the K palette logits, then the palette product.
      float peak = d[1];
#pragma unroll
      for (int k = 2; k < kOut; ++k) peak = fmaxf(peak, d[k]);
      float total = 0.0f;
#pragma unroll
      for (int k = 1; k < kOut; ++k) {
        d[k] = expf(d[k] - peak);
        total += d[k];
      }
      const int64_t point = base + lane;
      const __nv_bfloat16* pal =
          palette + (point / points_per_image) * kValues * 3;
      float rgb[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 1; k < kOut; ++k) {
        const float prob = round_bf16(d[k] / total);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          rgb[ch] = fmaf(prob,
                         __bfloat162float(__ldg(pal + (k - 1) * 3 + ch)),
                         rgb[ch]);
        }
      }
      // [d0 | r g b] as four bf16, one 8-byte store.
      const __nv_bfloat162 lo = __floats2bfloat162_rn(d[0], rgb[0]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(rgb[1], rgb[2]);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned int*>(&lo);
      packed.y = *reinterpret_cast<const unsigned int*>(&hi);
      *reinterpret_cast<uint2*>(out + point * 4) = packed;
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors (see Layout above); `num_values` (K) must be 10.
// `max_blocks` caps the grid (each warp then walks over several tiles of
// points). Launches on `stream` and returns the launch's cudaError_t (0 on
// success); does not synchronise.
extern "C" int triplane_sample_fused_bf16(
    const void* planes, const void* coords, const void* w0, const void* b0,
    const void* w1, const void* b1, const void* palette, void* out,
    int64_t batch, int64_t points_per_image, int r, int num_values,
    int max_blocks, void* stream) {
  const int64_t total = batch * points_per_image;
  if (total == 0) return 0;
  if (num_values != kValues || max_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int64_t kPointsPerBlock = kWarps * kTile;
  int64_t blocks = (total + kPointsPerBlock - 1) / kPointsPerBlock;
  if (blocks > max_blocks) blocks = max_blocks;
  const dim3 block(kChannels, kWarps);
  triplane_sample_fused_kernel<<<static_cast<unsigned int>(blocks), block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(palette),
      static_cast<__nv_bfloat16*>(out), points_per_image, total, r);
  return static_cast<int>(cudaGetLastError());
}
