// Weighted binning: per-bin sums of split bf16 weight terms (kernel K7).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/pallas_binning.py: _kernel
// (launched by binned_weighted_sum).
//
// sums[j, ch] = sum over valid rows i with ids[i] == j of the terms of
// weights[i, ch]: hi = bf16(w) and, with `exact`, lo = bf16(w - hi), each
// widened back to float32 and added in float32.  Those are the reference's
// terms: its MXU product takes the weights in bf16 against bf16 one-hots and
// accumulates in float32.  A valid row whose id lies outside [0, k) adds
// nothing, as in the reference (ids in [k, a*b) land in padding bins it
// drops; negative ids and ids >= a*b match no one-hot), so the kernel
// checks the bounds and never writes outside the [k, C] output.
//
// The TPU kernel built one-hot tiles in VMEM and ran one-hot products on
// the sequential grid into a resident accumulator; that form is a matrix
// product of N * k * C multiply-adds for N * C useful adds.  Here each
// thread takes one row, checks it once and adds the terms of its C
// weights with float32 atomicAdd into the zeroed output (a zero lo term is
// skipped: adding +0.0 to a sum that started at +0.0 changes nothing).  A
// warp's C-float rows are contiguous, so its loads use whole cache lines.
// Atomics add in an unspecified order, as the MXU does: counts (unit
// weights) are exact up to 2^24 members per bin, sums agree with any other
// order within the f32 reordering bound.
//
// Bound on the H100: reads ids, weights and the mask once and writes the
// [k, C] output once, so memory; at N = 131,072, C = 4, k = 214,000 that is
// ~6.2 MB, ~1.9 us at 3.35 TB/s.  Contention on popular bins is what the
// atomics can lose time to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void binned_sum(const int* __restrict__ ids, const float* __restrict__ weights,
                           const unsigned char* __restrict__ valid, int n, int c, int k,
                           int exact, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int id = ids[i];
  if (id < 0 || id >= k) return;
  const float* w = weights + static_cast<size_t>(i) * c;
  float* dst = out + static_cast<size_t>(id) * c;
  for (int ch = 0; ch < c; ++ch) {
    const float hi = to_bf16(w[ch]);
    atomicAdd(dst + ch, hi);
    if (exact) {
      const float lo = to_bf16(w[ch] - hi);
      if (lo != 0.0f) atomicAdd(dst + ch, lo);
    }
  }
}

}  // namespace

// ids [n] int32, weights [n, c] float32, valid [n] bytes; out [k, c] float32,
// zeroed by the caller.  Launches on `stream`.
extern "C" int pcp_binned_sum(const int* ids, const float* weights, const unsigned char* valid,
                              int n, int c, int k, int exact, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  binned_sum<<<(n + 255) / 256, 256, 0, s>>>(ids, weights, valid, n, c, k, exact, out);
  return static_cast<int>(cudaGetLastError());
}
