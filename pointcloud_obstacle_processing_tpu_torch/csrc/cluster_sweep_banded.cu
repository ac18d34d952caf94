// Banded neighbour-min sweep with in-window pointer jump (kernel K5).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/cluster.py:
// _pallas_sweep_jump_banded.  Computes the contract of its XLA twin
// (_xla_sweep_jump_banded): for row i of 128-row query tile t, with the
// 128-aligned column window [s, s + W), s = starts[t],
//
//   out[i] = min(labels[i],
//                min{lc[j] : s <= j < s + W, adj(i, j) or j == labels[i]})
//   lc[j]  = labels[j] if valid[j] else C
//   adj    = valid[i] && valid[j] && d2(i, j) <= tol2
//
// The pointer jump is taken only when labels[i] falls inside the window, as
// the twin's column compare does; K4's unconditional gather would change a
// sweep's output here.  A tile whose tile_live flag is 0 (the cluster loop's
// frontier: no label in its window changed) or that holds no valid row
// writes labels[i] through and skips the window: the first skip is the
// reference kernel's, the second gives what the computed rows would (a
// padding row's value is its own label).  tile_live may be null: all live.
//
// Labels stay int32 (the Pallas kernel carried them as f32 only for its DMA
// layout).  One block of 512 threads per query tile: four groups of 128
// threads, thread r of each group on query row r, each group on every
// fourth column of the window, so a warp reads one shared-memory word at a
// time (a broadcast).  The window is staged through shared memory in chunks
// of 1024 columns (x, y, z, |p|^2, lc); the four partial minima meet in
// shared memory.  Min over int32 is exact in any order.  The distance is
// the reference's expression tree without FMA contraction:
// cross = (qx*cx + qy*cy) + qz*cz; d2 = (q_sq + c_sq) - 2*cross.
//
// Bound on the H100: at the fullscale shape (C = 16384, W = 4096) a sweep
// scores at most 128 x 128 x 4096 = 67 M pairs of ~11 flops, 0.74 GFLOP,
// ~11 us at the fp32 rate, and the live tiles are about half of that; it
// reads ~1.4 MB.  The loop runs one launch per sweep, so launch latency and
// the 128 blocks on 132 SMs (most of them padding or converged tiles)
// bound it.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;
constexpr int kSplit = 4;
constexpr int kChunk = 1024;

__global__ void cluster_sweep_banded(const float* __restrict__ px, const float* __restrict__ py,
                                     const float* __restrict__ pz,
                                     const float* __restrict__ psq,
                                     const unsigned char* __restrict__ valid,
                                     const int* __restrict__ labels,
                                     const int* __restrict__ starts,
                                     const unsigned char* __restrict__ tile_live, int c,
                                     int window, float tol2, int* __restrict__ out) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];
  __shared__ float ss[kChunk];
  __shared__ int sl[kChunk];
  __shared__ int part[kSplit][kTile];
  const int t = blockIdx.x;
  const int r = threadIdx.x % kTile;
  const int g = threadIdx.x / kTile;
  const int i = t * kTile + r;
  const int qlab = labels[i];
  const bool qv = valid[i] != 0;
  const bool live = tile_live == nullptr || tile_live[t] != 0;
  if (!__syncthreads_or(live && qv)) {  // uniform over the block
    if (g == 0) out[i] = qlab;
    return;
  }
  const int start = starts[t];
  const float qx = px[i];
  const float qy = py[i];
  const float qz = pz[i];
  const float qsq = psq[i];
  int best = c;
  if (g == 0 && qlab >= start && qlab < start + window) {  // the in-window jump column
    best = valid[qlab] ? labels[qlab] : c;
  }
  for (int base = 0; base < window; base += kChunk) {
    const int len = window - base < kChunk ? window - base : kChunk;
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int col = start + base + j;
      sx[j] = px[col];
      sy[j] = py[col];
      sz[j] = pz[col];
      ss[j] = psq[col];
      sl[j] = valid[col] ? labels[col] : c;
    }
    __syncthreads();
    if (qv) {
      for (int j = g; j < len; j += kSplit) {
        const float cross =
            __fadd_rn(__fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])), __fmul_rn(qz, sz[j]));
        const float d2 = __fsub_rn(__fadd_rn(qsq, ss[j]), __fmul_rn(2.0f, cross));
        if (d2 <= tol2 && sl[j] < best) best = sl[j];
      }
    }
  }
  part[g][r] = best;
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int k = 1; k < kSplit; ++k) best = part[k][r] < best ? part[k][r] : best;
    out[i] = best < qlab ? best : qlab;
  }
}

}  // namespace

extern "C" int pcp_cluster_sweep_banded(const float* px, const float* py, const float* pz,
                                        const float* psq, const unsigned char* valid,
                                        const int* labels, const int* starts,
                                        const unsigned char* tile_live, int c, int window,
                                        float tol2, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cluster_sweep_banded<<<c / kTile, kTile * kSplit, 0, s>>>(px, py, pz, psq, valid, labels,
                                                            starts, tile_live, c, window, tol2,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}
