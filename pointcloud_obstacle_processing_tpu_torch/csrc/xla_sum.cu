// Float32 row sums in XLA:CPU's order for jnp.sum (ops.sum_like_xla).
//
// Replaces no TPU kernel: the reference's sums are plain XLA reductions,
// and this kernel replays the order XLA:CPU gives them, which the
// reference's CPU results (the port's yardstick) follow.  XLA:CPU's
// tree-reduction rewrite turns a reduction of n > 32 values into a
// reduce-window of 32 (stride 32, zero padding split pad / 2 in front and
// the rest behind), repeated until 32 or fewer values remain, then a plain
// reduce; every window and the last reduce add their values one after
// another from +0.0.  The plain version (ops.sum_like_xla_plain) does the
// same with one PyTorch add a step: ~88 launches a row of 24,576 values,
// ~104 at 262,144; this kernel is one launch for every row of a call (two
// for rows longer than kLongRow).
//
// Operands: a [L, S, n] and optionally b [L, T, n], each with its own
// element strides (a transposed or broadcast view is read in place).  Out
// [L, S, T]: the sum over n of a[l, s, :] or, with b, of the products
// a[l, s, :] * b[l, t, :].  Above 32 values XLA:CPU computes such a product
// in a fusion of its own, so it is rounded before the windows add it
// (__fmul_rn, then __fadd_rn); up to 32 the product is fused into the
// plain reduce's adds (acc = __fmaf_rn(a, b, acc)).
//
// Design: a warp takes 32 windows at a time, loads their 1,024 values
// coalesced (the 32 loads of a lane unrolled, in flight together; lane k of
// load j holds value k of window j) into a [32][33] shared tile, and lane w
// adds window w's 32 values in order.  xla_sum runs a row in one block: the
// window sums stay in shared memory, and each further level and the last
// plain reduce run on them there.  A row longer than kLongRow would leave
// most SMs idle (RANSAC's refinement at fullscale sums 4 and 9 rows of
// 262,144), so xla_sum_windows first spreads its windows over blocks, each
// adding a run of whole second-level windows, and xla_sum then sums each
// row's second-level sums (the same order: XLA:CPU's sum of a row is its
// sum of the row's window sums, level by level).
//
// Bound on the H100: one read of every operand value (4 bytes, or 8 with
// b), so memory.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32;                // XLA:CPU's reduce-window size
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLongRow = 32 * 1024;     // longer rows take xla_sum_windows first
constexpr int kWin2PerBlock = kWarps;   // second-level windows a block of it

struct Operand {
  const float* p;
  long long s_l, s_r, s_n;  // element strides of the lead, row and value axes
};

__device__ __forceinline__ float value(const Operand& a, const Operand& b, bool prod,
                                       long long ra, long long rb, long long e) {
  const float x = a.p[ra + e * a.s_n];
  return prod ? __fmul_rn(x, b.p[rb + e * b.s_n]) : x;
}

// The sums of the 32 first-level windows 32 g ... 32 g + 31 of a row of n
// values (window w covers values 32 w - lo ... 32 w - lo + 31, zero outside
// [0, n)), by one warp through its tile; lane w returns window 32 g + w's.
__device__ __forceinline__ float window_sums(float (*tile)[kWin + 1], const Operand& a,
                                             const Operand& b, bool prod, long long ra,
                                             long long rb, int n, int lo, int g, int lane) {
  const long long base = static_cast<long long>(g) * kWin * kWin - lo;
  float x[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const long long e = base + j * kWin + lane;
    x[j] = (e >= 0 && e < n) ? value(a, b, prod, ra, rb, e) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kWin; ++j) tile[j][lane] = x[j];
  __syncwarp();
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kWin; ++k) acc = __fadd_rn(acc, tile[lane][k]);
  __syncwarp();
  return acc;
}

// the operand offsets of output row = (l * rows_a + s) * rows_b + t
__device__ __forceinline__ void row_offsets(const Operand& a, const Operand& b, bool prod,
                                            int row, int rows_a, int rows_b, long long* ra,
                                            long long* rb) {
  const int t = row % rows_b;
  const int s = (row / rows_b) % rows_a;
  const long long l = row / (rows_a * rows_b);
  *ra = l * a.s_l + s * a.s_r;
  *rb = prod ? l * b.s_l + t * b.s_r : 0;
}

__global__ void __launch_bounds__(kThreads)
xla_sum(Operand a, Operand b, int rows_a, int rows_b, int n, int p1, float* __restrict__ out) {
  extern __shared__ float smem[];
  float (*tile)[kWin][kWin + 1] = reinterpret_cast<float (*)[kWin][kWin + 1]>(smem);
  float* buf0 = smem + kWarps * kWin * (kWin + 1);  // [p1] window sums
  float* buf1 = buf0 + p1;                          // [(p1 + 31) / 32] the next level's
  const bool prod = b.p != nullptr;
  const int row = blockIdx.x;
  long long ra, rb;
  row_offsets(a, b, prod, row, rows_a, rows_b, &ra, &rb);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int count;  // values left for the next level
  if (n > kWin) {
    const int lo = ((kWin - n % kWin) % kWin) / 2;
    for (int g = warp; g * kWin < p1; g += kWarps) {
      const float acc = window_sums(tile[warp], a, b, prod, ra, rb, n, lo, g, lane);
      if (g * kWin + lane < p1) buf0[g * kWin + lane] = acc;
    }
    count = p1;
  } else if (prod) {  // a short reduction: the product fused into the plain reduce's adds
    if (tid == 0) {
      float acc = 0.0f;
      for (int e = 0; e < n; ++e) acc = __fmaf_rn(a.p[ra + e * a.s_n], b.p[rb + e * b.s_n], acc);
      out[row] = acc;
    }
    return;
  } else {
    for (int e = tid; e < n; e += kThreads) buf0[e] = value(a, b, prod, ra, rb, e);
    count = n;
  }
  float* src = buf0;
  float* dst = buf1;
  while (count > kWin) {
    __syncthreads();
    const int lo = ((kWin - count % kWin) % kWin) / 2;
    const int next = (count + kWin - 1) / kWin;
    for (int w = tid; w < next; w += kThreads) {
      float acc = 0.0f;
      for (int k = 0; k < kWin; ++k) {
        const int i = w * kWin - lo + k;
        acc = __fadd_rn(acc, (i >= 0 && i < count) ? src[i] : 0.0f);
      }
      dst[w] = acc;
    }
    float* swap = src;
    src = dst;
    dst = swap;
    count = next;
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int i = 0; i < count; ++i) acc = __fadd_rn(acc, src[i]);
    out[row] = acc;
  }
}

// The second-level window sums of long rows: block (x, row) adds the
// second-level windows kWin2PerBlock x ... of row `row` into sums2[row * p2
// + ...], each from its 32 first-level windows (window w2 takes first-level
// windows 32 w2 - lo2 ... 32 w2 - lo2 + 31, zero outside [0, p1)).
__global__ void __launch_bounds__(kThreads)
xla_sum_windows(Operand a, Operand b, int rows_a, int rows_b, int n, int p1, int p2,
                float* __restrict__ sums2) {
  constexpr int kGroups = kWin2PerBlock + 1;  // the block's first-level windows, in 32s
  __shared__ float tile[kWarps][kWin][kWin + 1];
  __shared__ float s1[kGroups * kWin];
  const bool prod = b.p != nullptr;
  const int row = blockIdx.y;
  long long ra, rb;
  row_offsets(a, b, prod, row, rows_a, rows_b, &ra, &rb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lo = ((kWin - n % kWin) % kWin) / 2;
  const int lo2 = ((kWin - p1 % kWin) % kWin) / 2;
  const int w2_0 = blockIdx.x * kWin2PerBlock;
  const int first = w2_0 * kWin - lo2;  // the first first-level window it needs
  const int g0 = (first >= 0 ? first : first - (kWin - 1)) / kWin;  // floor(first / 32)
  for (int k = warp; k < kGroups; k += kWarps) {
    const int g = g0 + k;
    const float acc = (g >= 0 && g * kWin < p1)
                          ? window_sums(tile[warp], a, b, prod, ra, rb, n, lo, g, lane)
                          : 0.0f;
    const int i = g * kWin + lane;  // this lane's first-level window
    s1[k * kWin + lane] = (i >= 0 && i < p1) ? acc : 0.0f;
  }
  __syncthreads();
  const int w2 = w2_0 + threadIdx.x;
  if (threadIdx.x < kWin2PerBlock && w2 < p2) {
    const float* win = s1 + (first - g0 * kWin) + threadIdx.x * kWin;
    float acc = 0.0f;
    for (int k = 0; k < kWin; ++k) acc = __fadd_rn(acc, win[k]);
    sums2[static_cast<size_t>(row) * p2 + w2] = acc;
  }
}

int launch_rows(const Operand& a, const Operand& b, int lead, int rows_a, int rows_b, int n,
                float* out, cudaStream_t stream) {
  const int p1 = n > kWin ? (n + kWin - 1) / kWin : kWin;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kWarps) * kWin * (kWin + 1) + p1 +
                                       (p1 + kWin - 1) / kWin);
  cudaError_t err = cudaFuncSetAttribute(xla_sum, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(lead) * rows_a * rows_b;
  xla_sum<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a, b, rows_a, rows_b, n, p1,
                                                                      out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Second-level window sums a row of n values needs in scratch (0: the row
// takes one launch).
extern "C" int pcp_xla_sum_scratch(int n) {
  if (n <= kLongRow) return 0;
  const int p1 = (n + kWin - 1) / kWin;
  return (p1 + kWin - 1) / kWin;
}

// a [L, S, n] with strides (sa_l, sa_s, sa_n), b [L, T, n] (nullptr: no
// product, T = 1) with its strides; out [L, S, T] contiguous; scratch
// L * S * T * pcp_xla_sum_scratch(n) floats.
extern "C" int pcp_xla_sum(const float* a, long long sa_l, long long sa_s, long long sa_n,
                           const float* b, long long sb_l, long long sb_s, long long sb_n,
                           int lead, int rows_a, int rows_b, int n, float* out, float* scratch,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand oa{a, sa_l, sa_s, sa_n};
  const Operand ob{b, sb_l, sb_s, sb_n};
  const int p2 = pcp_xla_sum_scratch(n);
  if (p2 == 0) return launch_rows(oa, ob, lead, rows_a, rows_b, n, out, s);
  const int rows = lead * rows_a * rows_b;
  const int p1 = (n + kWin - 1) / kWin;
  xla_sum_windows<<<dim3((p2 + kWin2PerBlock - 1) / kWin2PerBlock, rows), kThreads, 0, s>>>(
      oa, ob, rows_a, rows_b, n, p1, p2, scratch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Operand sums2{scratch, 0, p2, 1};
  return launch_rows(sums2, Operand{nullptr, 0, 0, 0}, 1, rows, 1, p2, out, s);
}
