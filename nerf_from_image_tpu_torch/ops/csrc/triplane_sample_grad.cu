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
// What bounds it. The first design (one warp per point, one lane per
// channel, 12 float32 atomicAdd rows per point straight into dplanes)
// took 6.78 ms at the flagship coarse pass (8.4M points on 8 x 3 x 256^2
// x 32 planes; NVIDIA H100 80GB HBM3, 700 W), 22x its 0.305 ms byte
// bound: 3.2G scalar atomics into a 201 MB buffer that L2 (50 MB) does
// not hold, on 1.29M distinct texels, about 78 atomic rows per touched
// texel and 39,445 taps on the hottest border texel.
//
// Design. Bin, sum in shared memory, flush once:
//   1. triplane_bins.cuh sorts the (point, plane) pairs by the 16 x 16
//      texel tile of their low tap (a counting sort in three kernels),
//      writing each pair's entry (point, fractions, cell within the tile,
//      slope codes) in bin order, and cuts each bin into chunks of at
//      most `chunk` entries, one block each.
//   2. A block of 16 warps sorts its chunk by cell in shared memory, so
//      that the entries of one cell (the same four texels) follow each
//      other; a warp walks a sixteenth of them with one lane per channel,
//      sums a run of one cell's weighted cotangents in registers and adds
//      the run's four sums into a float32 (17 x 17 x 32) accumulator (the
//      tile and its one-texel halo, 37 KB). Shared-memory float atomics
//      are compare-and-swap loops on this card, so they are spent once a
//      run, not once a tap.
//   3. The block flushes the accumulator with one global float4
//      atomicAdd per four channels of a touched texel: the halo overlaps
//      the neighbouring tiles, so the flush stays an add: at most 2,312
//      vector atomics a block of up to 2,048 entries, where the first
//      design spent 128 scalar ones per point and plane.
//   4. One thread per entry then dots the cotangent with the cell's four
//      taps, staged as bf16 in shared memory (18.5 KB), for the plane's
//      share of dcoords (a per-plane partial); a last kernel sums the three
//      partials into dcoords.
// Each entry reads its point's 64-byte cotangent once per plane (three
// times a point, 1.6 GB at the flagship pass, in cell order): that and
// the per-entry work of steps 2 and 4 are what it spends its time on
// (PERF.md). The wrapper allocates the scratch: the bin counts, the work
// items, the B * N * 3 entries (int4) and the (3, B * N, 2) float32
// partials.

#include "triplane_bins.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using triplane_bins::kTile;

constexpr int kChannels = 32;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunk = 2048;  // entries a block takes, at most
constexpr int kCells = kTile * kTile;  // low taps within a tile
constexpr int kSpan = kTile + 1;       // tile + halo
constexpr int kRegionTexels = kSpan * kSpan;
constexpr int kRegionFloats = kRegionTexels * kChannels;
constexpr int kUnroll = 8;  // entries whose cotangent loads go out together
constexpr int kSumThreads = 256;
// Dynamic shared memory of grad_tiles_kernel, in this order.
constexpr int kAccBytes = kRegionFloats * 4;          // 36,992
constexpr int kStageBytes = kRegionFloats * 2;        // 18,496
constexpr int kEntryBytes = kMaxChunk * (4 + 8 + 4);  // 32,768
constexpr int kCountBytes = 2 * kCells * 4;           // 2,048
constexpr int kSharedBytes = kAccBytes + kStageBytes + kEntryBytes +
                             kCountBytes;             // 90,304

__device__ __forceinline__ float4 bf16x4(uint2 v) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// The four taps of a cell (low tap (lx, ly) in the tile at (x0, y0)), as
// texel offsets in the (kSpan, kSpan) region: the high tap stays on the
// plane's last texel where the low one is.
struct Cell {
  int o00, o01, o10, o11;
};

__device__ __forceinline__ Cell cell_taps(int cell, int x0, int y0, int r) {
  const int lx = cell % kTile, ly = cell / kTile;
  const int hx = x0 + lx + 1 < r ? lx + 1 : lx;
  const int hy = y0 + ly + 1 < r ? ly + 1 : ly;
  return {ly * kSpan + lx, ly * kSpan + hx, hy * kSpan + lx, hy * kSpan + hx};
}

// A run's four sums of one channel, times 1/3, into the accumulator,
// skipping zeros (shared-memory float atomics are compare-and-swap loops).
__device__ __forceinline__ void add_run(float* acc, const Cell& t, int ch,
                                       float s00, float s01, float s10,
                                       float s11, float third) {
  const int o[4] = {t.o00, t.o01, t.o10, t.o11};
  const float v[4] = {s00, s01, s10, s11};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (v[k] != 0.0f) atomicAdd(acc + o[k] * kChannels + ch, v[k] * third);
  }
}

// acc += the dot product of 8 bf16 channels of a cotangent and a texel.
__device__ __forceinline__ void dot8(uint4 g, uint4 t, float& acc) {
  const float4 g0 = bf16x4(make_uint2(g.x, g.y));
  const float4 g1 = bf16x4(make_uint2(g.z, g.w));
  const float4 t0 = bf16x4(make_uint2(t.x, t.y));
  const float4 t1 = bf16x4(make_uint2(t.z, t.w));
  acc += g0.x * t0.x + g0.y * t0.y + g0.z * t0.z + g0.w * t0.w +
         g1.x * t1.x + g1.y * t1.y + g1.z * t1.z + g1.w * t1.w;
}

// One block per work item (bin, first entry), in four phases:
//   1. each thread takes up to 4 of the chunk's entries, counts their
//      cells (the low tap within the tile) in shared memory and prefetches
//      their cotangent rows into L2 in bin order; one warp scans the
//      counts; the entries go to shared memory sorted by cell;
//   2. each warp walks a sixteenth of the sorted entries with one lane per
//      channel, summing the four bilinear-weighted cotangents of a run of
//      entries of one cell in registers, and adds the run's sums into the
//      float32 accumulator (shared-memory atomics, 4 a lane a run);
//   3. the block flushes the accumulator into dplanes, one global float4
//      atomicAdd per four channels of a touched texel (the halo overlaps
//      the neighbouring tiles);
//   4. each thread takes its entries again, one entry a thread: the four
//      taps' dot products with the cotangent, from the staged bf16 texels,
//      give the plane's share of dcoords (a per-plane partial).
// Blocks past the number of work items return at once: the grid is sized
// on the host for the most work items the bins could give. Two blocks a
// SM (90 KB of shared memory each, so at most 64 registers a thread): 32
// warps to hide the latency of the cotangent loads.
__global__ void __launch_bounds__(kThreads, 2)
    grad_tiles_kernel(const __nv_bfloat16* __restrict__ planes,
                      const __nv_bfloat16* __restrict__ grad_out,
                      float* __restrict__ dplanes,
                      float2* __restrict__ partial,
                      const int* __restrict__ ends,
                      const int2* __restrict__ work,
                      const int* __restrict__ work_count,
                      const int4* __restrict__ entries, int total_points,
                      int r, int tiles, int chunk) {
  if (static_cast<int>(blockIdx.x) >= *work_count) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem + kAccBytes);
  int* e_point = reinterpret_cast<int*>(smem + kAccBytes + kStageBytes);
  float2* e_frac = reinterpret_cast<float2*>(e_point + kMaxChunk);
  int* e_meta = reinterpret_cast<int*>(e_frac + kMaxChunk);
  int* count = e_meta + kMaxChunk;
  int* offset = count + kCells;

  const int2 item = work[blockIdx.x];
  const int bin = item.x, first = item.y;
  const int len = min(first + chunk, ends[bin]) - first;
  const int tx = bin % tiles;
  const int ty = (bin / tiles) % tiles;
  const int image_plane = bin / (tiles * tiles);  // b * 3 + plane
  const int plane = image_plane % 3;
  const int x0 = tx * kTile, y0 = ty * kTile;
  const int64_t plane_base = static_cast<int64_t>(image_plane) * r * r;
  const float third = 1.0f / 3.0f;

  // The chunk's entries, loaded first so that they arrive while the
  // accumulator is zeroed and the texels staged.
  constexpr int kPerThread = kMaxChunk / kThreads;
  int4 entry[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * kThreads;
    entry[i] = e < len ? __ldg(entries + first + e) : make_int4(0, 0, 0, -1);
  }
  for (int i = threadIdx.x; i < kRegionFloats; i += kThreads) acc[i] = 0.0f;
  for (int i = threadIdx.x; i < kCells; i += kThreads) count[i] = 0;
  // The region's texels, 16 bytes (8 channels) a load; texels past the
  // plane's edge are never read.
  for (int i = threadIdx.x; i < kRegionTexels * 4; i += kThreads) {
    const int t = i >> 2, part = i & 3;
    const int gy = y0 + t / kSpan, gx = x0 + t % kSpan;
    if (gy < r && gx < r) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          planes + (plane_base + static_cast<int64_t>(gy) * r + gx) *
                       kChannels + part * 8));
      *reinterpret_cast<uint4*>(stage + t * kChannels + part * 8) = v;
    }
  }
  __syncthreads();

  // 1. Cells, counted and sorted.
  int rank[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (entry[i].w >= 0) {
      // Bring the cotangent row into L2 now, in the bin's (point) order;
      // phases 2 and 4 read it in cell order.
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          grad_out + static_cast<int64_t>(entry[i].x) * kChannels));
      rank[i] = atomicAdd(count + (entry[i].w & 255), 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    constexpr int kPerLane = kCells / 32;
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) sum += count[threadIdx.x * kPerLane + k];
    int inclusive = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, inclusive, d);
      if (static_cast<int>(threadIdx.x) >= d) inclusive += up;
    }
    int run = inclusive - sum;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      offset[threadIdx.x * kPerLane + k] = run;
      run += count[threadIdx.x * kPerLane + k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (entry[i].w >= 0) {
      const int at = offset[entry[i].w & 255] + rank[i];
      e_point[at] = entry[i].x;
      e_frac[at] = make_float2(__int_as_float(entry[i].y),
                               __int_as_float(entry[i].z));
      e_meta[at] = entry[i].w;
    }
  }
  __syncthreads();

  // 2. Runs of one cell summed in registers, one lane per channel.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = (len + kWarps - 1) / kWarps;
  const int lo = min(len, warp * per_warp), hi = min(len, lo + per_warp);
  float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
  int run_cell = -1;
  for (int j0 = lo; j0 < hi; j0 += kUnroll) {
    // The batch's loads first: cells and fractions from shared memory,
    // then the cotangents.
    float g[kUnroll];
    int cells[kUnroll];
    float2 f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j0 + u < hi;
      cells[u] = in ? e_meta[j0 + u] & 255 : -1;
      f[u] = in ? e_frac[j0 + u] : make_float2(0.0f, 0.0f);
      g[u] = in ? __bfloat162float(__ldg(
                      grad_out + static_cast<int64_t>(e_point[j0 + u]) *
                                     kChannels + lane))
                : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cells[u] < 0) break;
      if (cells[u] != run_cell) {
        if (run_cell >= 0) {
          add_run(acc, cell_taps(run_cell, x0, y0, r), lane, s00, s01, s10,
                  s11, third);
        }
        run_cell = cells[u];
        s00 = s01 = s10 = s11 = 0.0f;
      }
      const float gx = f[u].x * g[u], hx = g[u] - gx;  // g fx, g (1 - fx)
      s00 += (1.0f - f[u].y) * hx;
      s01 += (1.0f - f[u].y) * gx;
      s10 += f[u].y * hx;
      s11 += f[u].y * gx;
    }
  }
  if (run_cell >= 0) {
    add_run(acc, cell_taps(run_cell, x0, y0, r), lane, s00, s01, s10, s11,
            third);
  }
  __syncthreads();

  // 3. The flush, four channels an atomic (sm_90's vector float add).
  for (int i = threadIdx.x; i < kRegionFloats / 4; i += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(acc)[i];
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
      const int t = i / (kChannels / 4);
      const int gy = y0 + t / kSpan, gx = x0 + t % kSpan;
      atomicAdd(reinterpret_cast<float4*>(
                    dplanes +
                    (plane_base + static_cast<int64_t>(gy) * r + gx) *
                        kChannels + 4 * (i % (kChannels / 4))),
                v);
    }
  }

  // 4. dcoords: per entry, the dot product of each tap with the cotangent.
  const float quarter_last = 0.25f * static_cast<float>(r - 1);
  for (int e = threadIdx.x; e < len; e += kThreads) {
    const int p = e_point[e], m = e_meta[e];
    const float2 f = e_frac[e];
    const Cell t = cell_taps(m & 255, x0, y0, r);
    const uint4* g = reinterpret_cast<const uint4*>(
        grad_out + static_cast<int64_t>(p) * kChannels);
    const uint4* s = reinterpret_cast<const uint4*>(stage);
    float t00 = 0.0f, t01 = 0.0f, t10 = 0.0f, t11 = 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 gq = __ldg(g + q);
      dot8(gq, s[t.o00 * 4 + q], t00);
      dot8(gq, s[t.o01 * 4 + q], t01);
      dot8(gq, s[t.o10 * 4 + q], t10);
      dot8(gq, s[t.o11 * 4 + q], t11);
    }
    const float da = (1.0f - f.y) * (t01 - t00) + f.y * (t11 - t10);
    const float db = (1.0f - f.x) * (t10 - t00) + f.x * (t11 - t01);
    const float sx = ((m >> 8) & 3) * quarter_last * third;
    const float sy = ((m >> 10) & 3) * quarter_last * third;
    partial[static_cast<int64_t>(plane) * total_points + p] =
        make_float2(da * sx, db * sy);
  }
}

// dcoords from the per-plane partials (a on the plane's column axis, b on
// its row axis): x from xy and xz, y from xy and yz, z from xz and yz.
__global__ void __launch_bounds__(kSumThreads)
    sum_partials_kernel(const float2* __restrict__ partial,
                        float* __restrict__ dcoords, int total_points) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= total_points) return;
  const float2 xy = partial[i];
  const float2 xz = partial[total_points + i];
  const float2 yz = partial[2 * static_cast<int64_t>(total_points) + i];
  float* out = dcoords + static_cast<int64_t>(i) * 3;
  out[0] = xy.x + xz.x;
  out[1] = xy.y + yz.x;
  out[2] = xz.y + yz.y;
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: planes (B, 3, R, R, 32) bf16, coords (B, N, 3)
// float32, grad_out (B, N, 32) bf16, dplanes (B, 3, R, R, 32) float32
// (zeroed by the caller), dcoords (B, N, 3) float32; scratch: partial
// (3, B * N, 2) float32, counts (B * 3 * ceil(R / 16)^2) int32, work
// (max_work, 2) int32 with max_work at least bins + B * N * 3 / chunk + 1,
// work_count (1) int32, entries (B * N * 3, 4) int32; chunk at most 2048.
// B * N * 3 and the planes' element count stay below 2^31 (the wrapper
// checks). Runs five kernels on
// `stream` and returns the first launch's cudaError_t (0 on success);
// does not synchronise.
extern "C" int triplane_sample_grad_bf16(
    const void* planes, const void* coords, const void* grad_out,
    void* dplanes, void* dcoords, void* partial, void* counts, void* work,
    void* work_count, void* entries, int batch, int points_per_image, int r,
    int chunk, int max_work, void* stream) {
  const int total = batch * points_per_image;
  if (total == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (r + kTile - 1) / kTile;
  cudaError_t err = triplane_bins::bin_points(
      static_cast<const float*>(coords), static_cast<int*>(counts),
      static_cast<int2*>(work), static_cast<int*>(work_count),
      static_cast<int4*>(entries), batch, points_per_image, r, chunk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attribute_set = false;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(grad_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  grad_tiles_kernel<<<max_work, kThreads, kSharedBytes, s>>>(
      static_cast<const __nv_bfloat16*>(planes),
      static_cast<const __nv_bfloat16*>(grad_out),
      static_cast<float*>(dplanes), static_cast<float2*>(partial),
      static_cast<const int*>(counts), static_cast<const int2*>(work),
      static_cast<const int*>(work_count),
      static_cast<const int4*>(entries),
      total, r, tiles, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<(total + kSumThreads - 1) / kSumThreads, kSumThreads,
                        0, s>>>(static_cast<const float2*>(partial),
                                static_cast<float*>(dcoords), total);
  return static_cast<int>(cudaGetLastError());
}
