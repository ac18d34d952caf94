// Fused neighbour-min sweep with pointer jump (kernel K4).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/cluster.py:
// _pallas_sweep_jump.  Computes the contract of its XLA twin
// (_xla_sweep_jump): for every row i of the centered cluster buffer
//
//   out[i] = min(labels[i],
//                labels_col[labels[i]],
//                min{labels_col[j] : d2(i, j) <= tol2, valid[i], valid[j]})
//
// with labels_col[j] = labels[j] for valid j and C otherwise.  The pointer
// jump (column j == labels[i]) is one gather instead of a column compare.
// Unlike the Pallas kernel, rows of all-padding tiles are not forced to C:
// every row gets the twin's value, so kernel and plain version agree on
// every row (the stage output is the same either way).
//
// One block of 256 threads per 256-row query tile; the columns are staged
// through shared memory in chunks of 1024 (x, y, z, |p|^2, labels_col).
// The distance is the reference's expression tree as XLA:CPU evaluates it:
// cross = fma(qz, cz, fma(qx, cx, qy*cy)) with explicit fused multiply-adds
// (-fmad=false leaves the intrinsics alone); d2 = (q_sq + c_sq) - 2*cross.  Only the
// adjacency test reads it, and the output is an integer, so the result is
// exact once that tree is kept.
//
// A launch may take a range of the query rows, [row_first, row_first +
// rows) against every column (the point-sharded path's shard: the
// reference's _pallas_sweep_jump(..., qslice=...), cluster.py:86, called
// from _neighbor_min_sweep :461-530); the output holds the range's rows,
// each computed as in the whole sweep, so the gathered ranges equal it bit
// for bit.  A collective must run between sweeps there, so this per-sweep
// form, not the loop kernels, is the sharded path's.
//
// Bound on the H100: rows x C pairs per sweep, ~9 operations each.  On one
// card the cluster loop runs in one launch of a loop kernel at every
// capacity (cluster_loop.cu, cluster_grid_loop.cu); this kernel, one launch
// a sweep with the hook in PyTorch (ops/cluster.py per_sweep_loop), runs
// the point-sharded full sweep and is the yardstick chip_smoke.py's "loop
// crossover:" lines time beside the loop kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kChunk = 1024;

__global__ void cluster_sweep(const float* __restrict__ px, const float* __restrict__ py,
                              const float* __restrict__ pz, const float* __restrict__ psq,
                              const unsigned char* __restrict__ valid,
                              const int* __restrict__ labels, int c, int row_first, int rows,
                              float tol2, int* __restrict__ out) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];
  __shared__ float ss[kChunk];
  __shared__ int sl[kChunk];
  const int local = blockIdx.x * kTile + threadIdx.x;  // the row of the range
  const int i = row_first + local;
  const bool row = local < rows && i < c;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, qsq = 0.0f;
  bool qv = false;
  int qlab = c;
  int best = c;
  if (row) {
    qx = px[i];
    qy = py[i];
    qz = pz[i];
    qsq = psq[i];
    qv = valid[i] != 0;
    qlab = labels[i];
    best = valid[qlab] ? labels[qlab] : c;  // the pointer-jump column
  }
  for (int base = 0; base < c; base += kChunk) {
    const int len = c - base < kChunk ? c - base : kChunk;
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int g = base + j;
      sx[j] = px[g];
      sy[j] = py[g];
      sz[j] = pz[g];
      ss[j] = psq[g];
      sl[j] = valid[g] ? labels[g] : c;
    }
    __syncthreads();
    if (row && qv) {
      for (int j = 0; j < len; ++j) {
        const float cross =
            __fmaf_rn(qz, sz[j], __fmaf_rn(qx, sx[j], __fmul_rn(qy, sy[j])));
        const float d2 = __fsub_rn(__fadd_rn(qsq, ss[j]), __fmul_rn(2.0f, cross));
        if (d2 <= tol2 && sl[j] < best) best = sl[j];
      }
    }
  }
  if (row) out[local] = best < qlab ? best : qlab;
}

}  // namespace

// out [rows]: the sweep of rows row_first .. row_first + rows - 1
extern "C" int pcp_cluster_sweep(const float* px, const float* py, const float* pz,
                                 const float* psq, const unsigned char* valid,
                                 const int* labels, int c, int row_first, int rows, float tol2,
                                 int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cluster_sweep<<<(rows + kTile - 1) / kTile, kTile, 0, s>>>(px, py, pz, psq, valid, labels, c,
                                                            row_first, rows, tol2, out);
  return static_cast<int>(cudaGetLastError());
}
