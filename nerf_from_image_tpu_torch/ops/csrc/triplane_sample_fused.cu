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
// (`triplane_taps.cuh`): align_corners=True, border clamp, the first
// coordinate of each pair on the width axis.
//
// Layout. Planes are channel-last bf16, (B, 3, R, R, 32); coordinates
// (B, N, 3) float32; w0 (32, 64) and w1 (64, 1 + K) bf16, row-major,
// input index first; b0 (64,) and b1 (1 + K,) float32; the palette
// (B, K, 3) bf16; the output (B, N, 4) bf16.
//
// Design. A warp takes 32 points at a time:
// - Sampling, B1's core: four lanes a point, one 16-byte load a tap, two
//   points a lane at once. The bf16 features go to the warp's 32-row tile
//   in shared memory, rows padded from 64 to 80 bytes so that the
//   `ldmatrix` reads of eight rows fall on distinct banks.
// - Layer 1 on the tensor cores, `mma.sync` m16n8k16 (bf16 in, float32
//   sums starting from b0): A is a 16-point half of the tile, read by
//   `ldmatrix`; B is w0, 16 fragments staged once a block in shared
//   memory in lane order. (Held in registers for the warp's life they
//   take 48 registers a lane, which halves the blocks an SM holds, and
//   the kernel ran slower so.)
// - Softplus in registers on the special-function units (one exp2 and
//   one log2, jax.nn.softplus's logaddexp form), rounded to bf16. The
//   accumulators of two neighbouring n-tiles are laid out as one m16k16 A
//   fragment, so h feeds layer 2 from registers.
// - Layer 2 on the tensor cores: w1 padded with zeros from 64 x 11 to
//   64 x 16 (8 fragments), float32 sums from b1.
// - Softmax over the K logits: a row's 16 outputs lie on the four lanes of
//   a quad, which reduce with `__shfl_xor_sync` 1 and 2. The bf16
//   probabilities (zero at the distance and past K) are again an m16k16 A
//   fragment, and the palette product is a third `mma.sync` with the row's
//   own image's palette as B (a tile that straddles images runs it once
//   per image). One 8-byte store a point.
// The grid is persistent (the card's SMs times the blocks each holds), and
// each warp walks over many tiles. K is fixed at 10, the palette of every
// reference dataset.
//
// Bound on this card. Per point the kernel reads 12 bytes of coordinates,
// writes 8 bytes of output and reads the texels the points touch (at most
// the whole planes); it does 2 x (32 x 64 + 64 x (1 + K) + 3 x K) = 5.5
// kFLOP of decoder products (K = 10) and about 1 kFLOP of float32 taps,
// softplus and softmax. At the flagship coarse pass (8.4M points) that is
// about 0.25 GB (0.075 ms at 3.35 TB/s) against 0.13 ms of float32
// operations and 0.05 ms of bf16 tensor-core products: bound by
// operations. Above that sits the special-function units' floor: 64 exp2
// and 64 log2 a point for the softplus, 16 a clock per SM, about 0.26 ms
// at the flagship pass and 1,980 MHz. What bounds this design is
// instruction issue: B1's sampling core (some 56 warp instructions a
// point) and some 47 of decode (six a hidden unit for the softplus, the
// fragment reads, the softmax and the palette product); points that all
// hit L1 take nearly as long as the flagship pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "triplane_taps.cuh"

namespace {

using triplane_taps::kChannels;
using triplane_taps::kLaneChannels;
using triplane_taps::kLanesPerPoint;
using triplane_taps::kPointsPerStep;

constexpr int kHidden = 64;
constexpr int kValues = 10;  // palette entries K
constexpr int kOut = 1 + kValues;
constexpr int kOutPadded = 16;  // two n-tiles of 8
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // points per warp tile: two m-tiles of 16
constexpr int kRow = kChannels + 8;  // padded feature row, in bf16
constexpr int kSamplePoints = 2;  // points a lane samples at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kW0Frags = (kChannels / 16) * (kHidden / 8);    // 16
constexpr int kW1Frags = (kHidden / 16) * (kOutPadded / 8);   // 8

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 2^x and log2(x) on the special-function units, subnormals flushed to
// zero (the arguments here are never subnormal, and a result that would
// be is as good as zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float log2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float reciprocal_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2E = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// softplus(x) = max(x, 0) + log(1 + exp(-|x|)) (jax.nn.softplus's
// logaddexp form): one exp2 and one log2 on the special-function units.
__device__ __forceinline__ float softplus(float x) {
  return fmaf(kLn2, log2_approx(1.0f + exp2_approx(-fabsf(x) * kLog2E)),
              fmaxf(x, 0.0f));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives its share of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16 bf16, row-major) @ b (16 x 8 bf16, column-major), in
// float32. Lane 4g + t holds c[0..1] at row g, columns 2t and 2t + 1, and
// c[2..3] at row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The m16n8k16 B fragment of lane 4g + t: k rows 2t, 2t + 1 and 2t + 8,
// 2t + 9 of the 16-row step at k0, column n, of a (K, cols) row-major
// bf16 matrix; columns at or past `cols` are zero.
__device__ __forceinline__ void b_fragment(
    const __nv_bfloat16* __restrict__ w, int cols, int k0, int n, int t,
    uint32_t (&b)[2]) {
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const int k = k0 + 2 * t;
  const bool in = n < cols;
  b[0] = pack_bf16(in ? w[k * cols + n] : zero,
                   in ? w[(k + 1) * cols + n] : zero);
  b[1] = pack_bf16(in ? w[(k + 8) * cols + n] : zero,
                   in ? w[(k + 9) * cols + n] : zero);
}

// A point index, or the last point for one past the end (a ragged tail).
__device__ __forceinline__ int clamp_point(int64_t point, int total) {
  return point < total ? static_cast<int>(point) : total - 1;
}

// The palette product's B fragment for lane 4g + t: rows (k) 2t, 2t + 1,
// 2t + 8 and 2t + 9, column (n) g, where row k holds palette entry k - 1
// of `image` (rows 0 and past K, and columns past 2, are zero).
__device__ __forceinline__ __nv_bfloat16 palette_entry(
    const __nv_bfloat16* __restrict__ pal, int k, int g) {
  return k >= 1 && k <= kValues && g < 3 ? __ldg(pal + (k - 1) * 3 + g)
                                         : __float2bfloat16(0.0f);
}

__device__ __forceinline__ void palette_fragment(
    const __nv_bfloat16* __restrict__ palette, int image, int g, int t,
    uint32_t (&b)[2]) {
  const __nv_bfloat16* pal =
      palette + static_cast<int64_t>(image) * kValues * 3;
  b[0] = pack_bf16(palette_entry(pal, 2 * t, g),
                   palette_entry(pal, 2 * t + 1, g));
  b[1] = pack_bf16(palette_entry(pal, 2 * t + 8, g),
                   palette_entry(pal, 2 * t + 9, g));
}

__global__ void __launch_bounds__(kThreads)
    triplane_sample_fused_kernel(
        const __nv_bfloat16* __restrict__ planes,
        const float* __restrict__ coords,
        const __nv_bfloat16* __restrict__ w0,
        const float* __restrict__ b0,
        const __nv_bfloat16* __restrict__ w1,
        const float* __restrict__ b1,
        const __nv_bfloat16* __restrict__ palette,
        __nv_bfloat16* __restrict__ out, int points_per_image, int total,
        int r) {
  __shared__ __align__(16) __nv_bfloat16 feat_s[kWarps][kTile * kRow];
  __shared__ float b0_s[kHidden];
  __shared__ float b1_s[kOutPadded];
  __shared__ uint2 frag_s[kW0Frags + kW1Frags][32];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x < kHidden) b0_s[threadIdx.x] = b0[threadIdx.x];
  if (threadIdx.x < kOutPadded) {
    b1_s[threadIdx.x] = threadIdx.x < kOut ? b1[threadIdx.x] : 0.0f;
  }

  // Lane 4g + t of the mma layout; lane 4 slot + chunk of the sampler's.
  const int g = lane / 4;
  const int t = lane % 4;
  const int slot = lane / kLanesPerPoint;
  const int chunk = lane % kLanesPerPoint;

  // w0's 16 and w1's 8 B fragments, staged once a block in shared memory
  // in lane order, so that each is one conflict-free 8-byte read a lane
  // (the biases above are staged under the same barrier).
  for (int f = warp; f < kW0Frags + kW1Frags; f += kWarps) {
    uint32_t b[2];
    if (f < kW0Frags) {
      b_fragment(w0, kHidden, 16 * (f / 8), 8 * (f % 8) + g, t, b);
    } else {
      const int f1 = f - kW0Frags;
      b_fragment(w1, kOut, 16 * (f1 / 2), 8 * (f1 % 2) + g, t, b);
    }
    frag_s[f][lane] = make_uint2(b[0], b[1]);
  }
  __syncthreads();

  __nv_bfloat16* tile = feat_s[warp];
  // This lane's ldmatrix row and column within a 16-row half of the tile.
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2);
  const int a_col = 8 * (lane / 16);
  // Columns 2t, 2t + 1, 8 + 2t and 9 + 2t of layer 2's output, which this
  // lane holds for rows g and g + 8: column 0 is the distance, 1..K the
  // logits.
  const int col[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
  bool logit[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) logit[i] = col[i] >= 1 && col[i] <= kValues;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * kTile;
  for (int64_t base =
           (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kTile;
       base < total; base += stride) {
    // Sampling: rows slot, slot + 8, slot + 16, slot + 24 of the tile; a
    // ragged tail samples the last point again, and its rows are not
    // stored.
#pragma unroll
    for (int step = 0; step < kTile / kPointsPerStep; step += kSamplePoints) {
      int point[kSamplePoints];
#pragma unroll
      for (int p = 0; p < kSamplePoints; ++p) {
        point[p] = clamp_point(base + slot + (step + p) * kPointsPerStep,
                               total);
      }
      uint4 feat[kSamplePoints];
      triplane_taps::sample_points<kSamplePoints>(
          planes, coords, point, points_per_image, r, chunk, feat);
#pragma unroll
      for (int p = 0; p < kSamplePoints; ++p) {
        const int row = slot + (step + p) * kPointsPerStep;
        *reinterpret_cast<uint4*>(tile + row * kRow +
                                  chunk * kLaneChannels) = feat[p];
      }
    }
    __syncwarp();

#pragma unroll
    for (int mt = 0; mt < kTile / 16; ++mt) {
      // Layer 1: (16 x 32) @ (32 x 64) + b0.
      uint32_t a[kChannels / 16][4];
#pragma unroll
      for (int ks = 0; ks < kChannels / 16; ++ks) {
        ldmatrix_x4(a[ks], tile + (16 * mt + a_row) * kRow + 16 * ks + a_col);
      }
      float acc[kHidden / 8][4];
#pragma unroll
      for (int nt = 0; nt < kHidden / 8; ++nt) {
        const float lo = b0_s[8 * nt + 2 * t];
        const float hi = b0_s[8 * nt + 2 * t + 1];
        acc[nt][0] = lo;
        acc[nt][1] = hi;
        acc[nt][2] = lo;
        acc[nt][3] = hi;
#pragma unroll
        for (int ks = 0; ks < kChannels / 16; ++ks) {
          const uint2 f = frag_s[ks * (kHidden / 8) + nt][lane];
          const uint32_t b[2] = {f.x, f.y};
          mma_bf16(acc[nt], a[ks], b);
        }
      }
      // Softplus, rounded to bf16: n-tiles 2kk and 2kk + 1 are the A
      // fragment of layer 2's k-step kk.
      uint32_t h[kHidden / 16][4];
#pragma unroll
      for (int kk = 0; kk < kHidden / 16; ++kk) {
        h[kk][0] = triplane_taps::pack_bf16x2(softplus(acc[2 * kk][0]),
                                              softplus(acc[2 * kk][1]));
        h[kk][1] = triplane_taps::pack_bf16x2(softplus(acc[2 * kk][2]),
                                              softplus(acc[2 * kk][3]));
        h[kk][2] = triplane_taps::pack_bf16x2(softplus(acc[2 * kk + 1][0]),
                                              softplus(acc[2 * kk + 1][1]));
        h[kk][3] = triplane_taps::pack_bf16x2(softplus(acc[2 * kk + 1][2]),
                                              softplus(acc[2 * kk + 1][3]));
      }
      // Layer 2: (16 x 64) @ (64 x 16) + b1.
      float d[kOutPadded / 8][4];
#pragma unroll
      for (int nt = 0; nt < kOutPadded / 8; ++nt) {
        const float lo = b1_s[8 * nt + 2 * t];
        const float hi = b1_s[8 * nt + 2 * t + 1];
        d[nt][0] = lo;
        d[nt][1] = hi;
        d[nt][2] = lo;
        d[nt][3] = hi;
#pragma unroll
        for (int kk = 0; kk < kHidden / 16; ++kk) {
          const uint2 f =
              frag_s[kW0Frags + kk * (kOutPadded / 8) + nt][lane];
          const uint32_t b[2] = {f.x, f.y};
          mma_bf16(d[nt], h[kk], b);
        }
      }

      // Softmax over the K logits of rows g (half 0) and g + 8 (half 1),
      // each reduced over the quad of lanes that holds the row; the
      // probabilities (zero at the distance and past K) are the m16k16 A
      // fragment of the palette product.
      float prob[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v[4] = {d[0][2 * half], d[0][2 * half + 1],
                            d[1][2 * half], d[1][2 * half + 1]};
        float peak = v[1];  // column 2t + 1 is always a logit
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (logit[i]) peak = fmaxf(peak, v[i]);
        }
        peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, 1));
        peak = fmaxf(peak, __shfl_xor_sync(kFull, peak, 2));
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          prob[half][i] = logit[i] ? exp2_approx((v[i] - peak) * kLog2E)
                                   : 0.0f;
          sum += prob[half][i];
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        const float inv = reciprocal_approx(sum);
#pragma unroll
        for (int i = 0; i < 4; ++i) prob[half][i] *= inv;
      }
      const uint32_t pa[4] = {
          triplane_taps::pack_bf16x2(prob[0][0], prob[0][1]),
          triplane_taps::pack_bf16x2(prob[1][0], prob[1][1]),
          triplane_taps::pack_bf16x2(prob[0][2], prob[0][3]),
          triplane_taps::pack_bf16x2(prob[1][2], prob[1][3])};

      // Palette product, (16 x 16) @ (16 x 8): row k of B is palette entry
      // k - 1 of the row's image, column n its channel n < 3. A tile that
      // straddles images runs it once per image and keeps each row's own.
      const int64_t row0 = base + 16 * mt;
      const int last = clamp_point(row0 + 15, total);
      const int image_g = clamp_point(row0 + g, total) / points_per_image;
      const int image_g8 =
          clamp_point(row0 + g + 8, total) / points_per_image;
      float rgb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int image = clamp_point(row0, total) / points_per_image;
           image <= last / points_per_image; ++image) {
        uint32_t pb[2];
        palette_fragment(palette, image, g, t, pb);
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(c, pa, pb);
        if (image == image_g) {
          rgb[0] = c[0];
          rgb[1] = c[1];
        }
        if (image == image_g8) {
          rgb[2] = c[2];
          rgb[3] = c[3];
        }
      }
      // Lane 4g holds the distance (column 0), red and green of rows g and
      // g + 8, lane 4g + 1 their blue: [d0 | r g b] as four bf16, one
      // 8-byte store a point.
      const float blue_g = __shfl_down_sync(kFull, rgb[0], 1);
      const float blue_g8 = __shfl_down_sync(kFull, rgb[2], 1);
      if (t == 0) {
        if (row0 + g < total) {
          *reinterpret_cast<uint2*>(out + (row0 + g) * 4) = make_uint2(
              triplane_taps::pack_bf16x2(d[0][0], rgb[0]),
              triplane_taps::pack_bf16x2(rgb[1], blue_g));
        }
        if (row0 + g + 8 < total) {
          *reinterpret_cast<uint2*>(out + (row0 + g + 8) * 4) = make_uint2(
              triplane_taps::pack_bf16x2(d[0][2], rgb[2]),
              triplane_taps::pack_bf16x2(rgb[3], blue_g8));
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors (see Layout above), planes and out 16-byte aligned,
// with B * N and 3 * R * R * 32 below 2^31 (the wrapper checks all of
// this); `num_values` (K) must be 10. `sms` is the card's SM count; the
// grid is at most that many times the blocks an SM holds at once, and each
// warp then walks over several tiles of points. Launches on `stream` and
// returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int triplane_sample_fused_bf16(
    const void* planes, const void* coords, const void* w0, const void* b0,
    const void* w1, const void* b1, const void* palette, void* out,
    int64_t batch, int64_t points_per_image, int r, int num_values,
    int sms, void* stream) {
  const int64_t total = batch * points_per_image;
  if (total == 0) return 0;
  if (num_values != kValues || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, triplane_sample_fused_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  constexpr int64_t kPointsPerBlock = kWarps * kTile;
  int64_t blocks = (total + kPointsPerBlock - 1) / kPointsPerBlock;
  const int64_t resident = static_cast<int64_t>(sms) * blocks_per_sm;
  if (blocks > resident) blocks = resident;
  triplane_sample_fused_kernel<<<static_cast<unsigned int>(blocks),
                                 kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const float*>(coords),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(palette),
      static_cast<__nv_bfloat16*>(out), static_cast<int>(points_per_image),
      static_cast<int>(total), r);
  return static_cast<int>(cudaGetLastError());
}
