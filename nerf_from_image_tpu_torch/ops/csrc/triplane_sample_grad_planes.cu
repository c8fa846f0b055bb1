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
// (B, 3, R, R, C) buffer. It never reads the planes: the caller needs to
// keep only the coordinates from the forward.
//
// Layout. Coordinates (B, N, 3) float32; grad_out (B, N, C) bf16 with
// C = 32. Output dplanes (B, 3, R, R, C) float32, zeroed by the caller.
// The taps follow B1's border clamp: a coordinate outside [-1, 1] lands on
// the border texel.
//
// What bounds it. The first design (one warp per point, one lane per
// channel, 12 float32 atomicAdd rows per point straight into dplanes)
// took 6.31 ms at the flagship coarse pass (8.4M points on 8 x 3 x 256^2
// x 32 planes; NVIDIA H100 80GB HBM3, 700 W), 25x its 0.25 ms byte bound:
// 3.2G scalar reductions, served by L2 one sector at a time.
//
// Design. B2's binning (`triplane_sample_grad.cu`) without its coordinate
// branch:
//   1. triplane_bins.cuh sorts the (point, plane) pairs by the 16 x 16
//      texel tile of their low tap and cuts each bin into chunks of at
//      most `chunk` entries, one block each.
//   2. A block of 16 warps sorts its chunk by cell (the low tap within
//      the tile) in shared memory and prefetches the entries' cotangent
//      rows into L2 in bin order, which is nearly point order.
//   3. Each warp walks a sixteenth of the sorted entries with one lane per
//      channel, eight rows in flight, sums a run of one cell's weighted
//      cotangents in registers and adds the run's four sums into a float32
//      (17 x 17 x 32) accumulator (the tile and its one-texel halo, 37 KB)
//      with shared-memory atomics: compare-and-swap loops on this card,
//      spent once a run, not once a tap.
//   4. The block flushes the accumulator with one global float4
//      atomicAdd per four channels of a touched texel (the halo overlaps
//      the neighbouring tiles, so the flush stays an add).
// Without B2's staged texels and coordinate partials a block holds 71 KB
// of shared memory. Each (point, plane) entry still reads its point's
// 64-byte cotangent row, three times a point (1.6 GB at the flagship
// pass), and the binning writes and reads 16 bytes an entry: those
// gathers and the blocks' serial phases are where the time goes. Tried on
// the card and slower (PERF.md): a lane per four channels (8-byte loads,
// four rows a warp load), the rows staged in shared memory by cp.async,
// the cells coloured into four classes written without atomics, and the
// unsorted walk in image order with float4 reductions
// (probes/backward_designs.cu). The order of the adds, and so the last
// bits of the sums, changes from run to run. The wrapper allocates the
// scratch: the bin counts, the work items and the B * N * 3 entries
// (int4).

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
// Dynamic shared memory of grad_planes_tiles_kernel, in this order.
constexpr int kAccBytes = kRegionFloats * 4;          // 36,992
constexpr int kEntryBytes = kMaxChunk * 16;           // 32,768
constexpr int kCountBytes = 2 * kCells * 4;           // 2,048
constexpr int kSharedBytes = kAccBytes + kEntryBytes + kCountBytes;  // 71,808

// The four taps of a cell (low tap (lx, ly) in the tile at (x0, y0)), as
// texel offsets in the (kSpan, kSpan) region: the high tap stays on the
// plane's last texel where the low one is.
struct Cell {
  int o[4];  // (low, low), (low, high x), (high y, low), (high y, high x)
};

__device__ __forceinline__ Cell cell_taps(int cell, int x0, int y0, int r) {
  const int lx = cell % kTile, ly = cell / kTile;
  const int hx = x0 + lx + 1 < r ? lx + 1 : lx;
  const int hy = y0 + ly + 1 < r ? ly + 1 : ly;
  return {{ly * kSpan + lx, ly * kSpan + hx, hy * kSpan + lx,
           hy * kSpan + hx}};
}

// A run's four sums of one channel, times 1/3, into the accumulator,
// skipping zeros.
__device__ __forceinline__ void add_run(float* acc, const Cell& t, int ch,
                                       const float (&s)[4]) {
  const float third = 1.0f / 3.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (s[k] != 0.0f) atomicAdd(acc + t.o[k] * kChannels + ch, s[k] * third);
  }
}

// One block per work item (bin, first entry), in the phases 2-4 of the
// header. Blocks past the number of work items return at once: the grid
// is sized on the host for the most work items the bins could give. Two
// blocks a SM (so at most 64 registers a thread).
__global__ void __launch_bounds__(kThreads, 2)
    grad_planes_tiles_kernel(const __nv_bfloat16* __restrict__ grad_out,
                             float* __restrict__ dplanes,
                             const int* __restrict__ ends,
                             const int2* __restrict__ work,
                             const int* __restrict__ work_count,
                             const int4* __restrict__ entries, int r,
                             int tiles, int chunk) {
  if (static_cast<int>(blockIdx.x) >= *work_count) return;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  // The chunk's entries sorted by cell: (point, column fraction, row
  // fraction, cell), one 16-byte load an entry.
  int4* sorted = reinterpret_cast<int4*>(smem + kAccBytes);
  int* count = reinterpret_cast<int*>(sorted + kMaxChunk);
  int* offset = count + kCells;

  const int2 item = work[blockIdx.x];
  const int bin = item.x, first = item.y;
  const int len = min(first + chunk, ends[bin]) - first;
  const int tx = bin % tiles;
  const int ty = (bin / tiles) % tiles;
  const int image_plane = bin / (tiles * tiles);  // b * 3 + plane
  const int x0 = tx * kTile, y0 = ty * kTile;
  const int64_t plane_base = static_cast<int64_t>(image_plane) * r * r;

  // The chunk's entries, loaded first so that they arrive while the
  // accumulator is zeroed.
  constexpr int kPerThread = kMaxChunk / kThreads;
  int4 entry[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int e = threadIdx.x + i * kThreads;
    entry[i] = e < len ? __ldg(entries + first + e) : make_int4(0, 0, 0, -1);
  }
  for (int i = threadIdx.x; i < kRegionFloats / 4; i += kThreads) {
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = threadIdx.x; i < kCells; i += kThreads) count[i] = 0;
  __syncthreads();

  // 2. Cells counted, scanned and sorted; the cotangent rows prefetched
  //    into L2 in the bin's order, since phase 3 reads them in cell order.
  int rank[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (entry[i].w >= 0) {
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
      const int cell = entry[i].w & 255;
      sorted[offset[cell] + rank[i]] =
          make_int4(entry[i].x, entry[i].y, entry[i].z, cell);
    }
  }
  __syncthreads();

  // 3. Runs of one cell summed in registers, one lane per channel.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = (len + kWarps - 1) / kWarps;
  const int lo = min(len, warp * per_warp), hi = min(len, lo + per_warp);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int run_cell = -1;
  for (int j0 = lo; j0 < hi; j0 += kUnroll) {
    int4 e[kUnroll];
    float g[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      e[u] = j0 + u < hi ? sorted[j0 + u] : make_int4(0, 0, 0, -1);
      g[u] = j0 + u < hi
                 ? __bfloat162float(__ldg(
                       grad_out + static_cast<int64_t>(e[u].x) * kChannels +
                       lane))
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cell = e[u].w;
      if (cell < 0) break;
      const float2 f = make_float2(__int_as_float(e[u].y),
                                   __int_as_float(e[u].z));
      if (cell != run_cell) {
        if (run_cell >= 0) {
          add_run(acc, cell_taps(run_cell, x0, y0, r), lane, s);
        }
        run_cell = cell;
        s[0] = s[1] = s[2] = s[3] = 0.0f;
      }
      const float gx = f.x * g[u], hx = g[u] - gx;  // g fx, g (1 - fx)
      s[0] += (1.0f - f.y) * hx;
      s[1] += (1.0f - f.y) * gx;
      s[2] += f.y * hx;
      s[3] += f.y * gx;
    }
  }
  if (run_cell >= 0) add_run(acc, cell_taps(run_cell, x0, y0, r), lane, s);
  __syncthreads();

  // 4. The flush, four channels an atomic (sm_90's vector float add).
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
}

}  // namespace

// Plain C interface, loaded with ctypes. Pointers are device pointers of
// contiguous tensors: coords (B, N, 3) float32, grad_out (B, N, 32) bf16,
// dplanes (B, 3, R, R, 32) float32 (zeroed by the caller); scratch: counts
// (B * 3 * ceil(R / 16)^2) int32, work (max_work, 2) int32 with max_work
// at least bins + B * N * 3 / chunk + 1, work_count (1) int32, entries
// (B * N * 3, 4) int32; chunk at most 2048. B * N * 3 and the planes'
// element count stay below 2^31 (the wrapper checks). Runs four kernels
// on `stream` and returns the first launch's cudaError_t (0 on success);
// does not synchronise.
extern "C" int triplane_sample_grad_planes_bf16(
    const void* coords, const void* grad_out, void* dplanes, void* counts,
    void* work, void* work_count, void* entries, int batch,
    int points_per_image, int r, int chunk, int max_work, void* stream) {
  if (batch * points_per_image == 0) return 0;
  if (chunk < 1 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = triplane_bins::bin_points(
      static_cast<const float*>(coords), static_cast<int*>(counts),
      static_cast<int2*>(work), static_cast<int*>(work_count),
      static_cast<int4*>(entries), batch, points_per_image, r, chunk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attribute_set = false;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(grad_planes_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  grad_planes_tiles_kernel<<<max_work, kThreads, kSharedBytes, s>>>(
      static_cast<const __nv_bfloat16*>(grad_out),
      static_cast<float*>(dplanes), static_cast<const int*>(counts),
      static_cast<const int2*>(work), static_cast<const int*>(work_count),
      static_cast<const int4*>(entries), r, (r + kTile - 1) / kTile, chunk);
  return static_cast<int>(cudaGetLastError());
}
