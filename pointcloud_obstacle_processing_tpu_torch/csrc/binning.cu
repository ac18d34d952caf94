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
// product of N * k * C multiply-adds for N * C useful adds.  Here one C call
// zeroes the output with cudaMemsetAsync and launches one thread per row on
// the same stream, so the wrapper issues no PyTorch operation besides the
// output's allocation.  With C == 4 (x, y, z weights and a unit count, the
// reference's documented use) and 16-byte aligned weights, a thread loads
// its row with one float4 __ldg, forms hi + lo of each channel in registers
// and issues one atomicAdd(float4*, float4), the 128-bit vector atomic on
// global memory of compute capability 9.0, in place of up to 8 scalar
// atomics.  Other C take a scalar path of C atomics: a row of C floats
// starts at i * 4C bytes, 16-byte aligned only when C is a multiple of 4.
//
// hi + lo is exact in float32 (w - hi is a multiple of w's ulp below half a
// bf16 ulp of hi, so hi + lo spans at most 24 bits), so each row adds
// exactly its two terms' sum: one more node of a summation tree over the
// same terms, and any binary tree of n float32 terms lies within
// (n - 1) * 2^-24 * S of the exact sum.  Atomics add in an unspecified
// order, as the MXU does: counts (unit weights, lo = 0) are exact up to
// 2^24 members per bin, sums agree with any other order within the float32
// reordering bound.  Equal ids within a warp are not aggregated: at the
// documented shape (131,072 rows over 214,000 bins) rows rarely share a bin.
//
// Bound on the H100: reads ids, weights and the mask once and writes the
// [k, C] output once, so memory; at N = 131,072, C = 4, k = 214,000 that is
// ~6.2 MB, ~1.9 us at 3.35 TB/s.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, scripts/torch_kernel_ab.py): 4.3-4.6 us of device time
// (memset and kernel; torch.zeros + index_add_ 8.4-9.3 us), 27-57 us a
// wrapper call, which the host sets: 23-40 us of host time a call, as much
// as the library call's 21-39 (host_ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the row's contribution to one channel: hi, or hi + lo (exact)
__device__ __forceinline__ float term(float w, int exact) {
  const float hi = to_bf16(w);
  return exact ? __fadd_rn(hi, to_bf16(__fsub_rn(w, hi))) : hi;
}

__global__ void binned_sum4(const int* __restrict__ ids, const float4* __restrict__ weights,
                            const unsigned char* __restrict__ valid, int n, int k, int exact,
                            float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !valid[i]) return;
  const int id = __ldg(ids + i);
  if (id < 0 || id >= k) return;
  const float4 w = __ldg(weights + i);
  atomicAdd(out + id, make_float4(term(w.x, exact), term(w.y, exact), term(w.z, exact),
                                  term(w.w, exact)));
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
  for (int ch = 0; ch < c; ++ch) atomicAdd(dst + ch, term(w[ch], exact));
}

}  // namespace

// ids [n] int32, weights [n, c] float32, valid [n] bytes; out [k, c] float32,
// which this call zeroes.  Memset and launch on `stream`.
extern "C" int pcp_binned_sum(const int* ids, const float* weights, const unsigned char* valid,
                              int n, int c, int k, int exact, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(k) * c * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + 255) / 256;
  if (c == 4 && (reinterpret_cast<std::uintptr_t>(weights) & 15) == 0) {
    binned_sum4<<<blocks, 256, 0, s>>>(ids, reinterpret_cast<const float4*>(weights), valid, n,
                                       k, exact, reinterpret_cast<float4*>(out));
  } else {
    binned_sum<<<blocks, 256, 0, s>>>(ids, weights, valid, n, c, k, exact, out);
  }
  return static_cast<int>(cudaGetLastError());
}
