// Stable front-compaction with exact channel gather (kernel K2).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/pallas_compaction.py:
// _kernel (launched by _pallas_compact_gather_batched; entry point
// compact_and_gather_exact).
//
// Input: a channel-leading [C, K] float32 table (K a multiple of 128) and
// its occupancy mask.  Output: for the r-th occupied column in ascending
// order (r < capacity), loc[r] = the column's index and vals[r, :] = its C
// channels.  Data movement only, so the result is exact.
//
// The TPU kernel staged each window of blocks in VMEM and relied on the
// sequential grid so that each later DMA overwrote the previous window's
// garbage tail.  Here every 128-column block is one thread block of four
// warps and needs no order: lane ranks come from a warp ballot and popcount
// plus the counts of the warps before it, and the exclusive offset of each
// block comes from a cumsum of per-block counts taken outside the kernel.
// Slots at or past the occupied count are not written.
//
// Bound on the H100: the flagship call reads 24576 x (4 channels + 1 mask)
// and writes at most 1024 x 5 words, ~0.5 MB, so launch latency bounds it.

#include <cuda_runtime.h>

namespace {

__global__ void compact_gather(const float* __restrict__ bins,
                               const unsigned char* __restrict__ occ,
                               const int* __restrict__ excl, int c, int k, int capacity,
                               int* __restrict__ loc, float* __restrict__ vals) {
  __shared__ int warp_counts[4];
  const int g = blockIdx.x * 128 + threadIdx.x;
  const bool o = occ[g] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_counts[w];
  if (!o) return;
  const int slot = excl[blockIdx.x] + rank;
  if (slot >= capacity) return;
  loc[slot] = g;
  for (int ch = 0; ch < c; ++ch) {
    vals[static_cast<size_t>(slot) * c + ch] = bins[static_cast<size_t>(ch) * k + g];
  }
}

}  // namespace

extern "C" int pcp_compact_gather(const float* bins, const unsigned char* occ,
                                  const int* excl, int c, int k, int capacity, int* loc,
                                  float* vals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  compact_gather<<<k / 128, 128, 0, s>>>(bins, occ, excl, c, k, capacity, loc, vals);
  return static_cast<int>(cudaGetLastError());
}
