// Banded k-nearest selection (kernel K3).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/outliers.py:
// _sortnet_mean_pallas (both forms, with and without the q_valid skip).
//
// For query tile t (row_tile queries) the candidates are the `width`
// columns starting at starts[t] of the lattice-ordered cloud.  For every
// query the kernel emits the 16 smallest squared distances, ascending, as
// out[s, q] (a [16, n_q] table); the masked mean of the k smallest square
// roots follows in PyTorch, shared with the plain version.
//
// The TPU version took a [16, nc, T] plane tile of precomputed squared
// distances from HBM and ran a Batcher/bitonic network on it.  Here the
// distances are computed in registers from the centered channel vectors,
// |p|^2, the validity mask and the starts, so no [T, W] tile touches
// memory: each block stages its tile's window columns in shared memory and
// each thread keeps its query's 16 smallest values in a sorted register
// array (insertion by one unrolled compare-exchange pass).  Any exact
// selection yields the same sorted 16, so the network is not copied.
// The distance is the reference's expression tree, without FMA
// contraction: cross = (qx*cx + qy*cy) + qz*cz; d2 = (q_sq + c_sq) -
// 2*cross; clamped at 0; `big` for invalid columns and for self.  Tiles
// with no valid query write `big` (their rows are masked downstream).
//
// Bound on the H100: 24576 queries x 1408 columns = 34.6 M distances of
// ~10 flops each at the flagship shape, ~0.35 GFLOP: far under the fp32
// peak, so the bound is the per-column instruction count (shared-memory
// loads, compare, rare insertions) over 64 x 3 blocks of 128 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kSel = 16;

__global__ void knn_select(const float* __restrict__ px, const float* __restrict__ py,
                           const float* __restrict__ pz, const float* __restrict__ psq,
                           const unsigned char* __restrict__ valid,
                           const int* __restrict__ starts,
                           const unsigned char* __restrict__ tile_live, int n, int n_q,
                           int row_tile, int width, float big, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* cx = sm;
  float* cy = cx + width;
  float* cz = cy + width;
  float* cs = cz + width;
  unsigned char* cv = reinterpret_cast<unsigned char*>(cs + width);
  const int t = blockIdx.x;
  const int r = blockIdx.y * blockDim.x + threadIdx.x;  // row within the tile
  const bool in_tile = r < row_tile;
  const int q = t * row_tile + r;
  if (!tile_live[t]) {  // uniform over the block
    if (in_tile) {
      for (int s = 0; s < kSel; ++s) out[static_cast<size_t>(s) * n_q + q] = big;
    }
    return;
  }
  const int start = starts[t];
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    cx[j] = px[start + j];
    cy[j] = py[start + j];
    cz[j] = pz[start + j];
    cs[j] = psq[start + j];
    cv[j] = valid[start + j];
  }
  __syncthreads();
  if (!in_tile) return;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f, qsq = 0.0f;  // padded queries sit at 0
  if (q < n) {
    qx = px[q];
    qy = py[q];
    qz = pz[q];
    qsq = psq[q];
  }
  float top[kSel];
#pragma unroll
  for (int s = 0; s < kSel; ++s) top[s] = big;
  for (int j = 0; j < width; ++j) {
    const float cross =
        __fadd_rn(__fadd_rn(__fmul_rn(qx, cx[j]), __fmul_rn(qy, cy[j])), __fmul_rn(qz, cz[j]));
    float d2 = __fsub_rn(__fadd_rn(qsq, cs[j]), __fmul_rn(2.0f, cross));
    d2 = d2 < 0.0f ? 0.0f : d2;
    if (!cv[j] || q == start + j) d2 = big;
    if (d2 < top[kSel - 1]) {
      top[kSel - 1] = d2;
#pragma unroll
      for (int s = kSel - 1; s > 0; --s) {
        const float a = top[s - 1];
        const float b = top[s];
        top[s - 1] = fminf(a, b);
        top[s] = fmaxf(a, b);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSel; ++s) out[static_cast<size_t>(s) * n_q + q] = top[s];
}

}  // namespace

extern "C" int pcp_knn_select(const float* px, const float* py, const float* pz,
                              const float* psq, const unsigned char* valid, const int* starts,
                              const unsigned char* tile_live, int n, int n_q, int row_tile,
                              int width, float big, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const size_t smem = static_cast<size_t>(width) * (4 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_select, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(n_q / row_tile, (row_tile + threads - 1) / threads);
  knn_select<<<grid, threads, smem, s>>>(px, py, pz, psq, valid, starts, tile_live, n, n_q,
                                         row_tile, width, big, out);
  return static_cast<int>(cudaGetLastError());
}
