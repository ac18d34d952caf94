// Stable front-compaction with exact channel gather (kernel K2).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/pallas_compaction.py:
// _kernel (launched by _pallas_compact_gather_batched; entry point
// compact_and_gather_exact).
//
// Input: a channel-leading [C, K] float32 table (K a multiple of 128) and
// its occupancy mask.  Output: for the r-th occupied column in ascending
// order (r < capacity), loc[r] = the column's index and vals[r, :] = its C
// channels, and num = the occupied count (all of it, past capacity too).
// Data movement only, so the result is exact.  Slots at or past num are not
// written.  A batch of B tables (one a scan, each compacted on its own)
// takes the scan as the grid's y dimension in both launches.
//
// The TPU kernel staged each window of blocks in VMEM and relied on the
// sequential grid so that each later DMA overwrote the previous window's
// garbage tail.  GPU blocks run in no order, so here one C call makes two
// launches over 1,024-column blocks, with nothing to reset between calls:
//
//   count:   each of 256 threads loads its 4 mask bytes as one 32-bit word
//            (as four byte loads when the mask does not start 4-byte
//            aligned); a block reduction writes the block's occupied count.
//   scatter: each block sums the counts of the blocks before it (one load a
//            thread up to 256 blocks), ranks its columns in ascending order
//            by four warp ballots (one per byte of the threads' words) and
//            the counts of the warps before it, and writes loc and the
//            slot's channels, one float4 store when C == 4; the last block
//            writes num.
//
// The wrapper's only other work is the allocation of loc, vals and the
// [1 + blocks] int32 buffer that holds num and the block counts.
//
// Bound on the H100: the call must read the mask once (one byte a column)
// and, for each of the min(num, capacity) slots it fills, the column's
// channels, and write loc and vals: at the flagship shape (24,576 columns,
// 641 occupied) ~48 KB, 0.014 us at 3.35 TB/s; at the fullscale shape
// (262,144 columns, 6,866 occupied) ~0.51 MB, 0.15 us.  Two launches'
// latency sets the time instead: 3.6-4.0 us of device time on an H100 80GB
// HBM3 at 700 W (chip_smoke.py, scripts/torch_kernel_ab.py), 26x the
// fullscale bound (chip_smoke.py's bound_ms), against 12-14 us for
// bins.T[occ].  The flagship batch of 32 scans (one launch pair) took
// 4.8 us, against 20 us for bins.transpose(1, 2)[occ].

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 4 columns a thread: 1,024 columns a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// occupied flags of the word's 4 bytes, one bit at the bottom of each byte
__device__ __forceinline__ unsigned byte_flags(unsigned w) {
  return __vcmpne4(w, 0u) & 0x01010101u;
}

// mask bytes 4 * wi .. 4 * wi + 3 as one little-endian word (0 past the
// end): one 32-bit load when the mask starts 4-byte aligned, else four
// byte loads (a view such as valid[1:] of a padded buffer)
template <bool kAligned>
__device__ __forceinline__ unsigned mask_word(const unsigned char* __restrict__ occ, int wi, int k4) {
  if (wi >= k4) return 0u;
  if (kAligned) return __ldg(reinterpret_cast<const unsigned*>(occ) + wi);
  const unsigned char* b = occ + 4 * static_cast<size_t>(wi);
  return b[0] | (b[1] << 8) | (b[2] << 16) | (static_cast<unsigned>(b[3]) << 24);
}

template <bool kAligned>
__global__ void count_blocks(const unsigned char* __restrict__ occ, int k4, int* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  occ += static_cast<size_t>(blockIdx.y) * 4 * k4;  // this block's scan
  counts += static_cast<size_t>(blockIdx.y) * gridDim.x;
  const int wi = blockIdx.x * kThreads + threadIdx.x;
  const int n = __reduce_add_sync(kFull, __popc(byte_flags(mask_word<kAligned>(occ, wi, k4))));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sum[w];
    counts[blockIdx.x] = s;
  }
}

template <bool kAligned>
__global__ void scatter(const float* __restrict__ bins, const unsigned char* __restrict__ occ,
                        const int* __restrict__ counts, int c, int k, int k4, int capacity,
                        int* __restrict__ loc, float* __restrict__ vals, int* __restrict__ num) {
  {  // this block's scan
    const size_t scan = blockIdx.y;
    bins += scan * c * k;
    occ += scan * k;
    counts += scan * gridDim.x;
    loc += scan * capacity;
    vals += scan * capacity * c;
    num += scan;
  }
  __shared__ int before[kWarps];     // partial sums of the earlier blocks' counts
  __shared__ int warp_count[kWarps];  // occupied columns of each warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int part = 0;
  for (int j = threadIdx.x; j < blockIdx.x; j += kThreads) part += counts[j];
  part = __reduce_add_sync(kFull, part);
  const int wi = blockIdx.x * kThreads + threadIdx.x;
  const unsigned flags = byte_flags(mask_word<kAligned>(occ, wi, k4));
  // column 4 * wi + j is byte j of the word: the lanes below this one hold
  // the warp's earlier columns, all four bytes of each
  const unsigned lower = (1u << lane) - 1u;
  int rank = 0;
  int in_warp = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned ballot = __ballot_sync(kFull, (flags >> (8 * j)) & 1u);
    rank += __popc(ballot & lower);
    in_warp += __popc(ballot);
  }
  if (lane == 0) {
    before[warp] = part;
    warp_count[warp] = in_warp;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) rank += before[w] + (w < warp ? warp_count[w] : 0);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += before[w] + warp_count[w];
    *num = total;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!((flags >> (8 * j)) & 1u)) continue;
    const int slot = rank++;
    if (slot >= capacity) break;
    const int g = 4 * wi + j;
    loc[slot] = g;
    if (c == 4) {
      reinterpret_cast<float4*>(vals)[slot] =
          make_float4(bins[g], bins[k + g], bins[2 * static_cast<size_t>(k) + g],
                      bins[3 * static_cast<size_t>(k) + g]);
    } else {
      for (int ch = 0; ch < c; ++ch) {
        vals[static_cast<size_t>(slot) * c + ch] = bins[static_cast<size_t>(ch) * k + g];
      }
    }
  }
}

}  // namespace

// bins [batch, c, k] float32, occ [batch, k] bytes (k a multiple of 128,
// any start); loc [batch, capacity] int32, vals [batch, capacity, c]
// float32, scratch [batch * (1 + blocks)] int32: scratch[b] receives scan
// b's num, the rest the block counts.  Both launches on `stream`.
extern "C" int pcp_compact_gather(const float* bins, const unsigned char* occ, int batch, int c,
                                  int k, int capacity, int* loc, float* vals, int* scratch,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k4 = k / 4;
  const int blocks = (k4 + kThreads - 1) / kThreads;
  const dim3 grid(blocks, batch);
  int* counts = scratch + batch;
  // a scan's mask starts k bytes after the one before, k a multiple of 128:
  // the first scan's alignment is every scan's
  if ((reinterpret_cast<std::uintptr_t>(occ) & 3) == 0) {
    count_blocks<true><<<grid, kThreads, 0, s>>>(occ, k4, counts);
    scatter<true><<<grid, kThreads, 0, s>>>(bins, occ, counts, c, k, k4, capacity, loc, vals,
                                            scratch);
  } else {
    count_blocks<false><<<grid, kThreads, 0, s>>>(occ, k4, counts);
    scatter<false><<<grid, kThreads, 0, s>>>(bins, occ, counts, c, k, k4, capacity, loc, vals,
                                             scratch);
  }
  return static_cast<int>(cudaGetLastError());
}
