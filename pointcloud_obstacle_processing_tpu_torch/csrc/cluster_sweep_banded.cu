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
// layout).  The points come packed, one float4 (x, y, z, |p|^2) a row,
// made once per clustering.  Each tile's window is split over a thread-block
// cluster of kCluster blocks (__cluster_dims__), block rank b scoring the
// quarter [s + b*W/4, s + (b+1)*W/4).  In a block of 512 threads, thread r
// of each of four groups holds query row r, each group on every fourth
// column of the quarter, so a warp reads one shared-memory float4 at a time
// (a broadcast).  The quarter is staged in chunks of 1024 columns (the
// float4 and lc = valid ? labels : C).  The four groups' partial minima meet
// in the block's shared memory, the four blocks' through distributed shared
// memory: rank 0 reads its peers' partials (map_shared_rank) after a
// cluster barrier and writes out; a second barrier keeps every peer's
// shared memory alive until then.  Every block of a cluster reads the same
// tile, so all four take the skip alike.  Min over int32 is exact in any
// order.  The distance is the reference's expression tree as XLA:CPU
// evaluates it: cross = fma(qz, cz, fma(qx, cx, qy*cy)) with explicit fused
// multiply-adds (-fmad=false leaves the intrinsics alone); d2 = (q_sq +
// c_sq) - 2*cross.
//
// A launch may take a range of the query tiles, tile_first .. tile_first +
// tiles - 1, against the whole column table (the point-sharded path's shard,
// the reference's _pallas_sweep_jump_banded(..., qslice=...), cluster.py:329);
// the output holds the range's rows, each as in the whole sweep.
//
// A batch of scans is one launch, the scan the grid's y coordinate (the
// reference's jax.vmap of the kernel): scan b reads its points, valid and
// labels at b * c, its starts and tile_live at b * (c / 128), and writes its
// rows at b * tiles * 128; each scan's sweep is the one-scan sweep of its
// operands.  A scan whose tiles are all skipped (the cluster loop's converged
// scans: no tile live) costs one read of its flags a block.
//
// Bound on the H100: at the fullscale shape (C = 16384, W = 4096) a sweep
// scores at most 128 x 128 x 4096 = 67 M pairs of ~9 operations, 0.6
// GFLOP, ~9 us at the fp32 rate, and the live tiles are about half of that;
// it reads ~0.4 MB.  The loop runs one launch per sweep, so launch latency
// and the few live tiles bound it: the cluster split puts four SMs, not
// one, on each live tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;
constexpr int kSplit = 4;    // column groups of a block
constexpr int kCluster = 4;  // blocks of a cluster, one window quarter each
constexpr int kChunk = 1024;

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kTile * kSplit)
    cluster_sweep_banded(const float4* __restrict__ pts, const unsigned char* __restrict__ valid,
                         const int* __restrict__ labels, const int* __restrict__ starts,
                         const unsigned char* __restrict__ tile_live, int c, int tile_first,
                         int tiles, int window, float tol2, int* __restrict__ out) {
  const int scan = static_cast<int>(blockIdx.y);
  pts += static_cast<size_t>(scan) * c;
  valid += static_cast<size_t>(scan) * c;
  labels += static_cast<size_t>(scan) * c;
  starts += static_cast<size_t>(scan) * (c / kTile);
  if (tile_live != nullptr) tile_live += static_cast<size_t>(scan) * (c / kTile);
  out += static_cast<size_t>(scan) * tiles * kTile;
  __shared__ float4 sp[kChunk];
  __shared__ int sl[kChunk];
  __shared__ int part[kSplit][kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = tile_first + static_cast<int>(blockIdx.x) / kCluster;
  const int r = threadIdx.x % kTile;
  const int g = threadIdx.x / kTile;
  const int i = t * kTile + r;
  const int o = i - tile_first * kTile;  // the row of the output
  const int qlab = labels[i];
  const bool qv = valid[i] != 0;
  const bool live = tile_live == nullptr || tile_live[t] != 0;
  if (!__syncthreads_or(live && qv)) {  // uniform over the block and the cluster
    if (rank == 0 && g == 0) out[o] = qlab;
    return;
  }
  const int start = starts[t];
  const int quarter = window / kCluster;
  const int lo = start + rank * quarter;
  const float4 q = pts[i];
  int best = c;
  if (rank == 0 && g == 0 && qlab >= start && qlab < start + window) {  // the jump column
    best = valid[qlab] ? labels[qlab] : c;
  }
  for (int base = 0; base < quarter; base += kChunk) {
    const int len = quarter - base < kChunk ? quarter - base : kChunk;
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int col = lo + base + j;
      sp[j] = pts[col];
      sl[j] = valid[col] ? labels[col] : c;
    }
    __syncthreads();
    if (qv) {
      for (int j = g; j < len; j += kSplit) {
        const float4 p = sp[j];
        const float cross = __fmaf_rn(q.z, p.z, __fmaf_rn(q.x, p.x, __fmul_rn(q.y, p.y)));
        const float d2 = __fsub_rn(__fadd_rn(q.w, p.w), __fmul_rn(2.0f, cross));
        if (d2 <= tol2 && sl[j] < best) best = sl[j];
      }
    }
  }
  part[g][r] = best;
  cluster.sync();  // every block's partials are written
  if (rank == 0 && g == 0) {
#pragma unroll
    for (int b = 0; b < kCluster; ++b) {
      const int* peer = cluster.map_shared_rank(&part[0][0], b);
#pragma unroll
      for (int k = 0; k < kSplit; ++k) {
        const int v = peer[k * kTile + r];
        best = v < best ? v : best;
      }
    }
    out[o] = best < qlab ? best : qlab;
  }
  cluster.sync();  // no block leaves while rank 0 may still read its partials
}

}  // namespace

// pts [batch, c, 4]; valid and labels [batch, c]; starts and tile_live
// [batch, c / 128] (every tile); out [batch, tiles * 128]: the rows of tiles
// tile_first .. tile_first + tiles - 1 of each scan
extern "C" int pcp_cluster_sweep_banded(const float* pts, const unsigned char* valid,
                                        const int* labels, const int* starts,
                                        const unsigned char* tile_live, int batch, int c,
                                        int tile_first, int tiles, int window, float tol2,
                                        int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles * kCluster, batch);
  cluster_sweep_banded<<<grid, kTile * kSplit, 0, s>>>(
      reinterpret_cast<const float4*>(pts), valid, labels, starts, tile_live, c, tile_first,
      tiles, window, tol2, out);
  return static_cast<int>(cudaGetLastError());
}
