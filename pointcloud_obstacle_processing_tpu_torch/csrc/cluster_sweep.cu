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
// Bound on the H100: C^2 pairs per sweep, ~9 operations each.  Off every
// path: the cluster loop runs in one launch of a loop kernel at every
// capacity (cluster_loop.cu, cluster_grid_loop.cu), and this kernel, one
// launch a sweep with the hook in PyTorch (ops/cluster.py per_sweep_loop),
// is the yardstick chip_smoke.py's "loop crossover:" lines time beside them.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;
constexpr int kChunk = 1024;

__global__ void cluster_sweep(const float* __restrict__ px, const float* __restrict__ py,
                              const float* __restrict__ pz, const float* __restrict__ psq,
                              const unsigned char* __restrict__ valid,
                              const int* __restrict__ labels, int c, float tol2,
                              int* __restrict__ out) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];
  __shared__ float ss[kChunk];
  __shared__ int sl[kChunk];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool row = i < c;
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
  if (row) out[i] = best < qlab ? best : qlab;
}

}  // namespace

extern "C" int pcp_cluster_sweep(const float* px, const float* py, const float* pz,
                                 const float* psq, const unsigned char* valid,
                                 const int* labels, int c, float tol2, int* out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cluster_sweep<<<(c + kTile - 1) / kTile, kTile, 0, s>>>(px, py, pz, psq, valid, labels, c,
                                                         tol2, out);
  return static_cast<int>(cudaGetLastError());
}
