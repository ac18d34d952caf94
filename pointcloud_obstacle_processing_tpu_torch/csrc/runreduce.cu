// Sorted-run segmented reduce + compaction (kernel K1).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/pallas_runreduce.py:
// _kernel, _kernel2w and _kernel8 (launched by _pallas_batched,
// _pallas_batched2w and _pallas_batched8; entry point sorted_run_reduce).
//
// Input: a key-sorted buffer (sentinel keys for invalid rows, sorted last)
// and its payloads: three float32 offset buffers, or two int32 buffers with
// 16-bit fixed-point offsets (x in pxy's high half, y in its low half, z in
// pz) decoded here with a logical shift.  Output: for each run of equal keys,
// (key as f32, sum_x, sum_y, sum_z, count) at slot = rank of the run, for
// the first `capacity` runs.
//
// The bits are those of the reference's _xla_fallback: windows of W rows,
// a Hillis-Steele shift+add scan inside each window, and one carry add for
// each row before the window's first head, the carries chained window after
// window.  The TPU kernel walked the windows in grid order and let each
// later DMA overwrite the previous window's garbage tail; GPU blocks run in
// no order, so the work is split into three launches:
//   1. rr_scan: one block per window scans its rows in shared memory
//      (double-buffered, log2(W) steps) and records the window's last row
//      and the position of its first head;
//   2. rr_carry: one block chains the per-window carries sequentially
//      (98 windows at the flagship shape) from a shared-memory copy;
//   3. rr_scatter: one block per 128-row block adds the carry and writes
//      each run-end row to its slot: exclusive run-end offsets per 128-row
//      block come from a cumsum outside the kernel, lane ranks from a warp
//      ballot.
// Built with -fmad=false; the adds are __fadd_rn in the reference's operand
// order, including the "+ 0.0" of masked steps.
//
// Bound on the H100: at 100352 rows the kernel moves ~2.4 MB (keys, two
// payloads, four scanned channels written and read back), a microsecond at
// HBM rate, so the three launches and the 10 block-wide barriers of the
// scan bound it.  A single-pass scan with decoupled look-back would remove
// the carry launch; that is later work.

#include <cuda_runtime.h>

namespace {

__global__ void rr_scan(const int* __restrict__ skey, const void* __restrict__ pay_a,
                        const void* __restrict__ pay_b, const float* __restrict__ pay_c,
                        int packed, float quantum, int n, int w, int sentinel,
                        float* __restrict__ local, float* __restrict__ lastcol,
                        int* __restrict__ first_head) {
  extern __shared__ unsigned char smem[];
  float* v0 = reinterpret_cast<float*>(smem);  // [4][w]
  float* v1 = v0 + 4 * w;                      // [4][w]
  int* f0 = reinterpret_cast<int*>(v1 + 4 * w);  // [w]
  int* f1 = f0 + w;                              // [w]
  __shared__ int s_first;
  const int t = blockIdx.x;
  const int base = t * w;
  if (threadIdx.x == 0) s_first = w;
  __syncthreads();
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int g = base + i;
    const int key = skey[g];
    const bool valid = key < sentinel;
    const int prev = g > 0 ? skey[g - 1] : -1;
    const int head = (valid && key != prev) ? 1 : 0;
    float ox, oy, oz;
    if (packed) {
      const unsigned pxy = static_cast<unsigned>(static_cast<const int*>(pay_a)[g]);
      const int pz = static_cast<const int*>(pay_b)[g];
      ox = __fmul_rn(static_cast<float>(pxy >> 16), quantum);
      oy = __fmul_rn(static_cast<float>(pxy & 0xFFFFu), quantum);
      oz = __fmul_rn(static_cast<float>(pz), quantum);
    } else {
      ox = static_cast<const float*>(pay_a)[g];
      oy = static_cast<const float*>(pay_b)[g];
      oz = pay_c[g];
    }
    v0[i] = ox;
    v0[w + i] = oy;
    v0[2 * w + i] = oz;
    v0[3 * w + i] = valid ? 1.0f : 0.0f;
    f0[i] = head;
    if (head) atomicMin(&s_first, i);
  }
  __syncthreads();
  float* cur = v0;
  float* nxt = v1;
  int* fc = f0;
  int* fn = f1;
  for (int d = 1; d < w; d <<= 1) {
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
      const int fi = fc[i];
      const int fs = i >= d ? fc[i - d] : 1;
      for (int ch = 0; ch < 4; ++ch) {
        const float vs = i >= d ? cur[ch * w + i - d] : 0.0f;
        nxt[ch * w + i] = __fadd_rn(cur[ch * w + i], fi != 0 ? 0.0f : vs);
      }
      fn[i] = fi | fs;
    }
    __syncthreads();
    float* tv = cur; cur = nxt; nxt = tv;
    int* tf = fc; fc = fn; fn = tf;
  }
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    for (int ch = 0; ch < 4; ++ch) local[ch * n + base + i] = cur[ch * w + i];
  }
  if (threadIdx.x < 4) lastcol[t * 4 + threadIdx.x] = cur[threadIdx.x * w + w - 1];
  if (threadIdx.x == 0) first_head[t] = s_first;
}

__global__ void rr_carry(const float* __restrict__ lastcol, const int* __restrict__ first_head,
                         int steps, int w, float* __restrict__ carry) {
  extern __shared__ float cs[];
  float* lc = cs;                                    // [steps][4]
  int* gate = reinterpret_cast<int*>(cs + 4 * steps);  // [steps]
  for (int i = threadIdx.x; i < 4 * steps; i += blockDim.x) lc[i] = lastcol[i];
  for (int i = threadIdx.x; i < steps; i += blockDim.x) gate[i] = first_head[i] >= w;
  __syncthreads();
  if (threadIdx.x < 4) {
    const int ch = threadIdx.x;
    float c = 0.0f;
    for (int t = 0; t < steps; ++t) {
      carry[t * 4 + ch] = c;
      c = __fadd_rn(lc[t * 4 + ch], gate[t] ? c : 0.0f);
    }
  }
}

__global__ void rr_scatter(const int* __restrict__ skey, const float* __restrict__ local,
                           const int* __restrict__ first_head, const float* __restrict__ carry,
                           const int* __restrict__ excl, int n, int w, int sentinel,
                           int capacity, float* __restrict__ out) {
  __shared__ int warp_counts[4];
  const int g = blockIdx.x * 128 + threadIdx.x;
  const int key = skey[g];
  const int next = g + 1 < n ? skey[g + 1] : -2;
  const bool is_end = key < sentinel && key != next;
  const unsigned ballot = __ballot_sync(0xffffffffu, is_end);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int k = 0; k < warp; ++k) rank += warp_counts[k];
  if (!is_end) return;
  const int slot = excl[blockIdx.x] + rank;
  if (slot >= capacity) return;
  const int t = g / w;
  const bool before_head = (g - t * w) < first_head[t];
  float* o = out + static_cast<size_t>(slot) * 5;
  o[0] = static_cast<float>(key);
  for (int ch = 0; ch < 4; ++ch) {
    o[1 + ch] = __fadd_rn(local[ch * n + g], before_head ? carry[t * 4 + ch] : 0.0f);
  }
}

}  // namespace

extern "C" int pcp_runreduce(const int* skey, const void* pay_a, const void* pay_b,
                             const void* pay_c, int packed, float quantum, int n, int w,
                             int sentinel, const int* excl, int capacity, float* local,
                             float* lastcol, int* first_head, float* carry, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int steps = n / w;
  const int threads = w < 1024 ? w : 1024;
  const size_t smem = static_cast<size_t>(w) * 40;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rr_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rr_scan<<<steps, threads, smem, s>>>(skey, pay_a, pay_b, static_cast<const float*>(pay_c),
                                       packed, quantum, n, w, sentinel, local, lastcol,
                                       first_head);
  const size_t smem2 = static_cast<size_t>(steps) * 20;
  if (smem2 > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rr_carry, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem2));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rr_carry<<<1, 256, smem2, s>>>(lastcol, first_head, steps, w, carry);
  rr_scatter<<<n / 128, 128, 0, s>>>(skey, local, first_head, carry, excl, n, w, sentinel,
                                     capacity, out);
  return static_cast<int>(cudaGetLastError());
}
