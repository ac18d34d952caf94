// The per-scan 3x3 tail of RANSAC's coefficient refinement.
//
// Replaces no TPU kernel: it is plain XLA in the reference
// (pointcloud_obstacle_processing_tpu/ops/ransac.py: _smallest_eigvec_3x3
// and the tail of ransac_plane_once's refine), and this kernel replays the
// arithmetic XLA:CPU gives it, so that the planes are the reference's bit
// for bit.  Per scan, from the covariance C (already summed in XLA:CPU's
// order), the centroid c, the inlier count and the current plane (n, d):
//
//   tr = (C00 + C11) + C22;  M = tr I - C
//   v = n; 24 times: w_i = fma(M_i2, v2, fma(M_i1, v1, M_i0 * v0))
//                    r = sqrt(sum3(w, w)); if r > 1e-20: v = w / max(r, 1e-20)
//   v = v * sign(sum3(v, n) + 1e-30);  d' = -fma(v2, c2, fma(v0, c0, v1 * c1))
//   (n, d) = count >= 3 ? (v, d') : (n, d)
//
// sum3(a, b) is jnp.sum(a * b) of three values as XLA:CPU contracts it in
// these loops: fma(a2, b2, fma(a0, b0, a1 * b1)) for one scan,
// fma(a2, b2, fma(a1, b1, a0 * b0)) under jax.vmap (`vmapped`).  The plain
// version (ops.ransac.plane_tail_plain) takes each fma in float64 rounded
// once, which is the fused result but for double-rounding ties.
//
// Design: one thread a scan, everything in registers; the PyTorch form is
// 6 launches a power-iteration step, ~150 a refinement pass, where this is
// one.  Bound: ~500 float32 operations a scan, nothing to speak of; the
// launch is the cost.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sum3(const float* a, const float* b, bool vmapped) {
  return vmapped ? __fmaf_rn(a[2], b[2], __fmaf_rn(a[1], b[1], __fmul_rn(a[0], b[0])))
                 : __fmaf_rn(a[2], b[2], __fmaf_rn(a[0], b[0], __fmul_rn(a[1], b[1])));
}

__global__ void plane_refine(const float* __restrict__ cov, const float* __restrict__ cen,
                             const float* __restrict__ n_inl, const float* __restrict__ normal,
                             const float* __restrict__ d, int batch, int vmapped,
                             float* __restrict__ out_n, float* __restrict__ out_d) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const bool vm = vmapped != 0;
  float c[9];
  for (int i = 0; i < 9; ++i) c[i] = cov[b * 9 + i];
  const float tr = __fadd_rn(__fadd_rn(c[0], c[4]), c[8]);
  float m[9];
  for (int i = 0; i < 9; ++i) m[i] = __fsub_rn(i % 4 == 0 ? tr : 0.0f, c[i]);
  float n0[3], v[3];
  for (int i = 0; i < 3; ++i) n0[i] = v[i] = normal[b * 3 + i];
  for (int it = 0; it < 24; ++it) {
    float w[3];
    for (int i = 0; i < 3; ++i) {
      w[i] = __fmaf_rn(m[3 * i + 2], v[2], __fmaf_rn(m[3 * i + 1], v[1], __fmul_rn(m[3 * i], v[0])));
    }
    const float r = __fsqrt_rn(sum3(w, w, vm));
    if (r > 1e-20f) {
      const float den = fmaxf(r, 1e-20f);
      for (int i = 0; i < 3; ++i) v[i] = __fdiv_rn(w[i], den);
    }
  }
  const float o = __fadd_rn(sum3(v, n0, vm), 1e-30f);
  const float sg = o > 0.0f ? 1.0f : (o < 0.0f ? -1.0f : 0.0f);
  for (int i = 0; i < 3; ++i) v[i] = __fmul_rn(v[i], sg);
  const float cx = cen[b * 3], cy = cen[b * 3 + 1], cz = cen[b * 3 + 2];
  const float nd = -__fmaf_rn(v[2], cz, __fmaf_rn(v[0], cx, __fmul_rn(v[1], cy)));
  const bool ok = n_inl[b] >= 3.0f;
  for (int i = 0; i < 3; ++i) out_n[b * 3 + i] = ok ? v[i] : n0[i];
  out_d[b] = ok ? nd : d[b];
}

}  // namespace

// cov [batch, 3, 3], cen [batch, 3], n_inl [batch], normal [batch, 3], d
// [batch] in; out_n [batch, 3], out_d [batch] out
extern "C" int pcp_plane_refine(const float* cov, const float* cen, const float* n_inl,
                                const float* normal, const float* d, int batch, int vmapped,
                                float* out_n, float* out_d, void* stream) {
  if (batch <= 0) return 0;
  plane_refine<<<(batch + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      cov, cen, n_inl, normal, d, batch, vmapped, out_n, out_d);
  return static_cast<int>(cudaGetLastError());
}
