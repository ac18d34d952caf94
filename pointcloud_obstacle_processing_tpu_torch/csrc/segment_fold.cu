// In-order segment fold: XLA:CPU's scatter-add order, per destination bin.
//
// Replaces no TPU kernel.  It carries three plain-XLA sums of the JAX
// package: the `scatter` voxel engine's `.at[packed].add`
// (pointcloud_obstacle_processing_tpu/ops/voxel.py:542-544), the 3-key
// fallback's segment sums (`_reduce_sorted_keys`, voxel.py:123-124), and the
// `mxu` engine's one-hot products (ops/mxu_histogram.py:130-140), whose
// per-bin sums of bf16 terms XLA:CPU computes exactly and so in any order.
// XLA:CPU's scatter-add is a sequential fold in input order; the callers
// sort their rows stably by destination, so each bin's rows lie in one run,
// in input order, and this kernel folds each run from +0.0 with
// round-to-nearest float32 adds:
//
//   out[b, c, d] = (((+0.0 + v[b, c, i0]) + v[b, c, i0 + 1]) + ...)
//
// over the run of rows i of scan b with dest[b, i] == d.  Rows whose dest lies
// outside [0, bins) are dropped; bins no row reaches stay +0.0 (the C call
// zeroes `out` first, on the same stream).  Starting from +0.0 maps a lone
// -0.0 to +0.0, as the scatter-add into zeros does.
//
// A float32 fold cannot be re-associated, so each run's add chain is serial.
// This first form gives one thread a run: a thread whose row starts a run
// (the scan's first row, or a dest unlike the row before) walks to the run's
// end with the C sums in registers, then writes its bin.  It loads four rows
// at a time, so four loads are in flight where one would wait on the next
// row's dest, and adds them in order.  Its loads do not coalesce across a
// warp (heads lie a run apart); runs are ~12 rows a voxel on the fullscale
// window and hundreds on the ground.  Bound on the H100:
// bytes, N * (4 + 4C) read and scans * bins * 4C written, over 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;

template <int C>
__global__ void segment_fold(const int* __restrict__ dest, const float* __restrict__ vals,
                             int scans, int n, int bins, float* __restrict__ out) {
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= static_cast<long long>(scans) * n) return;
  const int b = static_cast<int>(row / n);
  const int i = static_cast<int>(row - static_cast<long long>(b) * n);
  const int* d_scan = dest + static_cast<long long>(b) * n;
  const int d = d_scan[i];
  if (d < 0 || d >= bins || (i > 0 && d_scan[i - 1] == d)) return;
  const float* v = vals + static_cast<long long>(b) * C * n;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  // kUnroll rows' loads in flight at a time (those past the run are
  // discarded), then their adds in row order
  for (int j = i; j < n; j += kUnroll) {
    int dj[kUnroll];
    float vj[kUnroll][C];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j + u < n;
      dj[u] = in ? __ldg(d_scan + j + u) : -1;
#pragma unroll
      for (int c = 0; c < C; ++c)
        vj[u][c] = in ? __ldg(v + static_cast<long long>(c) * n + j + u) : 0.0f;
    }
    bool end = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      end = end || dj[u] != d;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (!end) acc[c] = __fadd_rn(acc[c], vj[u][c]);
    }
    if (end) break;
  }
  float* o = out + static_cast<long long>(b) * C * bins + d;
#pragma unroll
  for (int c = 0; c < C; ++c) o[static_cast<long long>(c) * bins] = acc[c];
}

template <int C>
cudaError_t launch(const int* dest, const float* vals, int scans, int n, int bins, float* out,
                   cudaStream_t s) {
  const long long rows = static_cast<long long>(scans) * n;
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  segment_fold<C><<<static_cast<unsigned>(blocks), threads, 0, s>>>(dest, vals, scans, n, bins,
                                                                    out);
  return cudaGetLastError();
}

}  // namespace

// dest [scans, n] int32, vals [scans, c, n] float32 (1 <= c <= 8), both
// contiguous; out [scans, c, bins] float32, which this call zeroes.  Memset
// and one launch on `stream`.
extern "C" int pcp_segment_fold(const int* dest, const float* vals, int scans, int n, int c,
                                int bins, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(scans) * c * bins * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long long>(scans) * n == 0) return 0;
  switch (c) {
    case 1: err = launch<1>(dest, vals, scans, n, bins, out, s); break;
    case 2: err = launch<2>(dest, vals, scans, n, bins, out, s); break;
    case 3: err = launch<3>(dest, vals, scans, n, bins, out, s); break;
    case 4: err = launch<4>(dest, vals, scans, n, bins, out, s); break;
    case 5: err = launch<5>(dest, vals, scans, n, bins, out, s); break;
    case 6: err = launch<6>(dest, vals, scans, n, bins, out, s); break;
    case 7: err = launch<7>(dest, vals, scans, n, bins, out, s); break;
    case 8: err = launch<8>(dest, vals, scans, n, bins, out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
