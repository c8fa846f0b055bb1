// Tile binning of triplane sample points, for the backward kernels.
//
// A backward that scatters each point's bilinear taps straight into a
// float32 plane buffer larger than L2 pays one global atomic per tap row,
// most of them on texels that many other points also hit. Binning first
// groups the (point, plane) pairs by the kTile x kTile texel tile of their
// low tap, so that a block can add a whole bin into a tile accumulator in
// shared memory and flush it once.
//
// bin(point, plane) = ((b * 3 + plane) * tiles + ty) * tiles + tx, with
// tiles = ceil(R / kTile) and (tx, ty) the tile of the low tap's (column,
// row). Planes xy, xz, yz take (x, y), (x, z), (y, z) as (column, row).
//
// bin_points() runs a counting sort written out in three kernels:
//   1. histogram: per-block counters in shared memory over one image's
//      3 * tiles^2 bins, flushed with one global atomic per non-zero bin;
//   2. scan (one block): the exclusive scan of the counts into offsets,
//      and the list of work items, (bin, first entry), one per chunk of at
//      most `chunk` entries of a bin, so that a hot bin (the border tile,
//      where clamped points pile up) is split over several blocks;
//   3. scatter: each pair's entry (make_entry: the point, its fractions,
//      its cell within the tile) to the next free slot of its bin, with
//      one cursor atomic per group of lanes of a warp that share a bin
//      (__match_any_sync). Within a warp the entries keep point order;
//      across warps the order is the order the warps ran in.
// After it, counts[bin] holds the end of the bin's entries.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace triplane_bins {

constexpr int kTile = 16;
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
// Histogram and scatter blocks in flight over the whole batch: 8 a SM.
constexpr int kBinBlocks = 132 * 8;

struct Axis {
  int lo;      // the low texel of the tap (the high one is lo + 1, or lo
               // on the plane's last texel)
  float frac;  // weight of the high texel
};

// One axis of an (R, R) plane at normalized coordinate g: align_corners
// with a border clamp.
__device__ __forceinline__ Axis make_axis(float g, int r) {
  const float last = static_cast<float>(r - 1);
  const float raw = (g + 1.0f) * 0.5f * last;
  const float i = fminf(fmaxf(raw, 0.0f), last);
  const float i0 = floorf(i);
  return {min(max(static_cast<int>(i0), 0), r - 1), i - i0};
}

// The three bins of a point within its image, plane * tiles^2 + row tile
// * tiles + column tile, from its axes.
__device__ __forceinline__ void image_bins(const Axis& x, const Axis& y,
                                           const Axis& z, int tiles,
                                           int bins[3]) {
  const int tx = x.lo / kTile, ty = y.lo / kTile, tz = z.lo / kTile;
  const int per_plane = tiles * tiles;
  bins[0] = ty * tiles + tx;                  // xy: column x, row y
  bins[1] = per_plane + tz * tiles + tx;      // xz: column x, row z
  bins[2] = 2 * per_plane + tz * tiles + ty;  // yz: column y, row z
}

// Grid (blocks, B); dynamic shared memory 3 * tiles^2 ints.
__global__ void __launch_bounds__(kBinThreads)
    histogram_kernel(const float* __restrict__ coords, int* __restrict__ counts,
                     int n, int r, int tiles) {
  extern __shared__ int hist[];
  const int per_image = 3 * tiles * tiles;
  for (int i = threadIdx.x; i < per_image; i += kBinThreads) hist[i] = 0;
  __syncthreads();
  const int b = blockIdx.y;
  for (int i = blockIdx.x * kBinThreads + threadIdx.x; i < n;
       i += gridDim.x * kBinThreads) {
    const float* c = coords + (static_cast<int64_t>(b) * n + i) * 3;
    int bins[3];
    image_bins(make_axis(__ldg(c), r), make_axis(__ldg(c + 1), r),
               make_axis(__ldg(c + 2), r), tiles, bins);
    atomicAdd(hist + bins[0], 1);
    atomicAdd(hist + bins[1], 1);
    atomicAdd(hist + bins[2], 1);
  }
  __syncthreads();
  int* image_counts = counts + static_cast<int64_t>(b) * per_image;
  for (int i = threadIdx.x; i < per_image; i += kBinThreads) {
    if (hist[i] != 0) atomicAdd(image_counts + i, hist[i]);
  }
}

// Exclusive scan of v over a block of kScanThreads; also returns the total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inclusive = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, inclusive, d);
    if (lane >= d) inclusive += up;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += up;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next scan
  return before + inclusive - v;
}

// One block of kScanThreads: counts -> offsets in place, the work items
// (bin, first entry) and their number, work_count[0].
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(int* __restrict__ counts, int2* __restrict__ work,
                int* __restrict__ work_count, int bins, int chunk) {
  __shared__ int warp_sums[32];
  const int per = (bins + kScanThreads - 1) / kScanThreads;
  const int lo = min(bins, threadIdx.x * per);
  const int hi = min(bins, lo + per);
  int entries = 0, chunks = 0;
  for (int i = lo; i < hi; ++i) {
    entries += counts[i];
    chunks += (counts[i] + chunk - 1) / chunk;
  }
  int total_entries, total_chunks;
  int offset = block_exclusive_scan(entries, warp_sums, &total_entries);
  int item = block_exclusive_scan(chunks, warp_sums, &total_chunks);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = offset;
    for (int k = 0; k < c; k += chunk) work[item++] = make_int2(i, offset + k);
    offset += c;
  }
  if (threadIdx.x == 0) work_count[0] = total_chunks;
}

// What a backward needs of one (point, plane) pair, 16 bytes, written in
// the bin's order so that a block reads its entries in one sweep:
// x = the point (b * N + n); y, z = the bilinear fractions along the
// plane's column and row axis (float bits); w = the low tap's cell within
// its tile (row * kTile + column) | column slope code << 8 | row slope
// code << 10, where a slope code is 2 inside the plane, 1 exactly on its
// border and 0 where the clamp holds: the derivative of the clamped
// texel coordinate is code * (R - 1) / 4 (half the inside slope exactly on
// the border, as JAX differentiates its clip).
__device__ __forceinline__ int slope_code(float g, int r) {
  const float last = static_cast<float>(r - 1);
  const float raw = (g + 1.0f) * 0.5f * last;
  return (raw > 0.0f && raw < last) ? 2
                                    : ((raw == 0.0f || raw == last) ? 1 : 0);
}

__device__ __forceinline__ int4 make_entry(int point, const Axis& col,
                                           const Axis& row, int col_code,
                                           int row_code) {
  const int cell = (row.lo % kTile) * kTile + col.lo % kTile;
  return make_int4(point, __float_as_int(col.frac), __float_as_int(row.frac),
                   cell | (col_code << 8) | (row_code << 10));
}

// Appends `entry` to bin `bin` (none for -1): one cursor atomic for all
// the lanes of the warp that share the bin. Every lane of the warp calls it.
__device__ __forceinline__ void claim(int* __restrict__ cursor,
                                      int4* __restrict__ entries, int bin,
                                      int4 entry) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && bin >= 0) {
    base = atomicAdd(cursor + bin, __popc(peers));
  }
  base = __shfl_sync(0xffffffffu, base, leader);
  if (bin >= 0) {
    entries[base + __popc(peers & ((1u << lane) - 1u))] = entry;
  }
}

// Grid (blocks, B); counts holds the offsets and becomes the ends.
__global__ void __launch_bounds__(kBinThreads)
    scatter_kernel(const float* __restrict__ coords, int* __restrict__ counts,
                   int4* __restrict__ entries, int n, int r, int tiles) {
  const int b = blockIdx.y;
  int* cursor = counts + static_cast<int64_t>(b) * 3 * tiles * tiles;
  // The same trip count for every lane of a warp, for the warp votes.
  for (int base = blockIdx.x * kBinThreads; base < n;
       base += gridDim.x * kBinThreads) {
    const int i = base + static_cast<int>(threadIdx.x);
    const int point = b * n + i;
    int bins[3] = {-1, -1, -1};
    int4 entry[3];
    if (i < n) {
      const float* c = coords + static_cast<int64_t>(point) * 3;
      const float x = __ldg(c), y = __ldg(c + 1), z = __ldg(c + 2);
      const Axis ax = make_axis(x, r), ay = make_axis(y, r),
                 az = make_axis(z, r);
      const int cx = slope_code(x, r), cy = slope_code(y, r),
                cz = slope_code(z, r);
      image_bins(ax, ay, az, tiles, bins);
      entry[0] = make_entry(point, ax, ay, cx, cy);
      entry[1] = make_entry(point, ax, az, cx, cz);
      entry[2] = make_entry(point, ay, az, cy, cz);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) claim(cursor, entries, bins[p], entry[p]);
  }
}

// Bins the B * N * 3 (point, plane) pairs of coords (B, N, 3). counts has
// B * 3 * tiles^2 ints (zeroed here), work room for every chunk (at most
// bins + entries / chunk + 1 items), work_count one int, entries B * N * 3
// int4. Returns the first launch error, or cudaSuccess.
inline cudaError_t bin_points(const float* coords, int* counts, int2* work,
                              int* work_count, int4* entries, int batch, int n,
                              int r, int chunk, cudaStream_t stream) {
  const int tiles = (r + kTile - 1) / kTile;
  const int bins = batch * 3 * tiles * tiles;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * bins, stream);
  if (err != cudaSuccess) return err;
  const int per_image_blocks = max(1, kBinBlocks / batch);
  const dim3 grid(min((n + kBinThreads - 1) / kBinThreads, per_image_blocks),
                  batch);
  const size_t hist_bytes = sizeof(int) * 3 * tiles * tiles;
  histogram_kernel<<<grid, kBinThreads, hist_bytes, stream>>>(coords, counts,
                                                              n, r, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, work, work_count, bins,
                                              chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<<<grid, kBinThreads, 0, stream>>>(coords, counts, entries,
                                                   n, r, tiles);
  return cudaGetLastError();
}

}  // namespace triplane_bins
