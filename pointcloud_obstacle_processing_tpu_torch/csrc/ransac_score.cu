// RANSAC's round on the card: the hypotheses built, gated, scored and
// selected in one launch, and the inlier masks, the last of which closes the
// round: ops.ransac.ransac_hypotheses_score, ops.ransac.plane_inliers and
// ops.ransac.plane_inliers_close.
//
// Replaces no TPU kernel.  It carries the JAX package's plain-XLA round
// (pointcloud_obstacle_processing_tpu/ops/ransac.py:124-168: each
// hypothesis' plane from its three drawn points, the axis gate, every
// point's distance to every hypothesis, the inlier count a hypothesis, the
// first largest count; :194-204, the refinement's mask; and the state the
// removal loop keeps, :264-276).  Every kernel is bitwise its plain twin
// (ops/ransac.py hypotheses_plain, ransac_score_plain, plane_inliers_plain,
// plane_inliers_close_plain): each float step is one IEEE rounding, in the
// plain form's operand order (the _rn intrinsics; the file builds with
// -fmad=false).  The distance is fma(z, nz, fma(x, nx, y * ny)) + d (ops.dot3's
// chain, then the add), |dist| < thresh, and a NaN distance is no inlier.
//
// The score kernel: a block of 256 threads takes 256 R rows of one scan (the
// grid's y), R rows a thread (2, or 8 where the call has rows enough for the
// blocks to still fill the card), each row read once, coalesced; an invalid
// row takes NaN coordinates, so no plane counts it, and a warp whose rows are
// all invalid (a compacted cloud's tail) skips the tests.  The block stages
// the scan's planes in shared memory as (nx, ny, nz, d) with their gates,
// 1,024 at a time (a chunk padded to 32 with NaN planes), each built where it
// is staged: a thread a hypothesis reads its three drawn points through the
// [B, K, 3] indices and computes the plane and its gate (build_plane), about
// 40 float steps behind two dependent loads, issued after the rows' loads so
// the two overlap.
// Where a call's row blocks are too few to fill the card (the flagship's
// 24,576 rows make 48), the hypotheses are split over the grid's z in slices
// of a multiple of 32: every block stages the whole chunk, scores only its
// slice, and a scan's ticket counts every (row block, slice).
// For each of a group of 32 hypotheses a thread counts the inliers among its
// R rows in a register; then the warp adds each count (__reduce_add_sync),
// lane j keeps the sum of hypothesis j and adds it into the block's count in
// shared memory; the block adds each nonzero count into a [B, K] int32
// scratch with one atomic.  The counts are integers, so the order of the
// adds does not matter.  The last block of a scan (a ticket a scan) applies
// the gate (-1 where it is false), picks the least k among the largest
// counts (torch.argmax's first occurrence), writes found (count > 0) and the
// winner's normal and offset, and zeroes its scratch row and ticket for the
// next call: no memset, no host read, no [B, N, K] tensor.  The scratch and
// tickets are the caller's, cached a device and stream.  The gated counts
// and the winner's index are written only where the caller asks for them
// (the tests do; the round does not).
//
// The axis gate: the reference tests arccos(cosang) <= eps; arccos is
// monotone, so the host finds once per eps the least float32 cos_min in
// [0, 1] that passes (XLA:CPU's acos, ops.ransac.axis_cos_min) and the kernel
// tests cosang >= cos_min; a NaN cosang fails both forms.
//
// plane_inliers: a thread a row, (|dist| < thresh) & valid against one plane
// a scan read from device memory (the winner's, or a refined plane), and
// with n_inl and prev given, prev kept in scans with n_inl < 3 (the
// refinement's select).
//
// plane_inliers_close: the round's last refinement mask, which closes it.
// The refinement's running mask is always the mask of its running plane (it
// starts as the winner's, and where n_inl < 3 plane and mask both stay), so
// the round's final mask is inliers(plane) & found.  Where the scan's round
// is active a thread a row applies it in place: valid &= ~mask, union |=
// mask, last = mask; one thread a scan keeps the per-scan state: the plane
// into coeffs[i] where found, pvalid[i] = found, i += found, and the loop's
// found.  Every other block reads only active, found and the plane, which
// that thread does not write; it writes no [B, N] tensor but last.
//
// Bound on the H100: operations.  The score kernel tests B*N*K (row, plane)
// pairs, 8 float32 operations each (three products and three adds of the
// distance, the absolute value, the compare), against 13 bytes a row read;
// at K = 128 the pairs' time is several times the rows'.  Each pair costs
// about seven issued instructions (four float steps, the subtraction of the
// threshold, the sign's add; the plane's shared load and the warp's sum
// shared by R rows and 32 lanes), so the issue rate, not the float32 rate,
// sets the pace; at the flagship's 24,576 rows a chain of dependent
// latencies (the rows, the planes, the atomics, the ticket, the selection)
// does.  The masks are bytes: 13 read and 1 written a row.  The closing form
// reads a valid flag and writes last a row of an active scan, reads the
// point only of a valid row where the round found a plane, and writes valid
// and union only where the mask holds.

#include <cuda_runtime.h>

#include <climits>
#include <cstring>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlaneChunk = 1024;  // planes a block stages at a time (16 KB)

// the plane distance as ops.dot3 and ransac._plane_dist evaluate it
__device__ __forceinline__ float plane_dist(float x, float y, float z, float4 p) {
  return __fadd_rn(__fmaf_rn(z, p.z, __fmaf_rn(x, p.x, __fmul_rn(y, p.y))), p.w);
}

// every field 8 bytes wide, as ops.ransac._SCORE_ARGS packs it
struct ScoreArgs {
  const float* pts;               // [B, N, 3]
  const bool* valid;              // [B, N]
  const long long* tri;           // [B, K, 3]: the drawn points
  const int* n_valid;             // [B]
  long long scans, n, k;
  long long rows;                 // rows a thread: 2 or 8
  long long slice;                // hypotheses a z-slice, a multiple of 32
  float thresh;
  int pad0;
  float cos_min;
  int pad1;
  float ax;
  int pad2;
  float ay;
  int pad3;
  float az;
  int pad4;
  int* scratch;                   // [B, K] counts then [B] tickets, zero between calls
  bool* found;                    // [B] out
  float* normal;                  // [B, 3] out
  float* d;                       // [B] out
  int* counts;                    // [B, K] out, or null
  long long* best;                // [B] out, or null
  void* stream;
};

struct Plane {
  float4 p;
  bool gate;
};

// Hypothesis j of scan b from its three drawn points, as ops.ransac.
// hypotheses_plain computes it: the cross product fma(uy, vz, -(uz * vy))
// and its turns, the norm sqrt(fma(nz, nz, fma(nx, nx, ny * ny))), the
// degenerate test, 1 / max(norm, 1e-20) (NaN kept, as torch.clamp_min keeps
// it), the three products, d = -fma(nz, p0z, fma(nx, p0x, ny * p0y)), the
// unfused |nx*ax + ny*ay + nz*az| clamped to [0, 1] against cos_min, and
// n_valid >= 3.  An index outside [0, N) (never drawn) is clamped into it.
__device__ __forceinline__ Plane build_plane(const ScoreArgs& a, int b, long long j, int nv) {
  const long long* t = a.tri + (static_cast<long long>(b) * a.k + j) * 3;
  const float* base = a.pts + static_cast<long long>(b) * a.n * 3;
  float p[3][3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const long long i = min(max(t[v], 0LL), a.n - 1);
    p[v][0] = base[i * 3];
    p[v][1] = base[i * 3 + 1];
    p[v][2] = base[i * 3 + 2];
  }
  const float ux = __fsub_rn(p[1][0], p[0][0]), uy = __fsub_rn(p[1][1], p[0][1]),
              uz = __fsub_rn(p[1][2], p[0][2]);
  const float vx = __fsub_rn(p[2][0], p[0][0]), vy = __fsub_rn(p[2][1], p[0][1]),
              vz = __fsub_rn(p[2][2], p[0][2]);
  float nx = __fmaf_rn(uy, vz, -__fmul_rn(uz, vy));
  float ny = __fmaf_rn(uz, vx, -__fmul_rn(ux, vz));
  float nz = __fmaf_rn(ux, vy, -__fmul_rn(uy, vx));
  const float norm = __fsqrt_rn(__fmaf_rn(nz, nz, __fmaf_rn(nx, nx, __fmul_rn(ny, ny))));
  const bool degenerate = norm < 1e-12f;
  const float clamped = isnan(norm) ? norm : fmaxf(norm, 1e-20f);
  const float inv = __fdiv_rn(1.0f, clamped);
  nx = __fmul_rn(nx, inv);
  ny = __fmul_rn(ny, inv);
  nz = __fmul_rn(nz, inv);
  const float d = -__fmaf_rn(nz, p[0][2], __fmaf_rn(nx, p[0][0], __fmul_rn(ny, p[0][1])));
  float c = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(nx, a.ax), __fmul_rn(ny, a.ay)),
                            __fmul_rn(nz, a.az)));
  c = c > 1.0f ? 1.0f : c;  // NaN stays NaN and fails the test
  return {make_float4(nx, ny, nz, d), c >= a.cos_min && !degenerate && nv >= 3};
}

// three blocks an SM: at most 80 registers a thread (unbounded, the 8-row
// form takes 99, and two blocks an SM)
template <int R>
__global__ void __launch_bounds__(kThreads, 3) ransac_score(ScoreArgs a) {
  __shared__ float4 planes[kPlaneChunk];
  __shared__ bool gates[kPlaneChunk];
  __shared__ int block_counts[kPlaneChunk];
  __shared__ int warp_count[kWarps];
  __shared__ unsigned warp_k[kWarps];
  __shared__ bool last;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const long long row = static_cast<long long>(b) * a.n;
  const long long prow = static_cast<long long>(b) * a.k;
  const float nan = __int_as_float(0x7fc00000);
  const int nv = a.n_valid[b];
  // this block's slice of the hypotheses
  const long long s_lo = static_cast<long long>(blockIdx.z) * a.slice;
  const long long s_hi = min(a.k, s_lo + a.slice);

  // a thread's rows, kThreads apart; an invalid row, or a row past N, is
  // NaN: its distance to every plane is NaN, never below the threshold
  float x[R], y[R], z[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = (static_cast<long long>(blockIdx.x) * R + r) * kThreads + tid;
    float px = nan, py = nan, pz = nan;
    bool ok = false;
    if (i < a.n) {  // the point and its flag loaded together
      const float* p = a.pts + (row + i) * 3;
      px = p[0];
      py = p[1];
      pz = p[2];
      ok = a.valid[row + i];
    }
    x[r] = ok ? px : nan;
    y[r] = ok ? py : nan;
    z[r] = ok ? pz : nan;
    any = any || ok;
  }
  const bool live = __any_sync(0xffffffffu, any);  // uniform over the warp

  // the chunks of 1,024 planes that meet the slice; each staged whole
  long long k0 = s_lo / kPlaneChunk * kPlaneChunk, kc = 0;
  for (; k0 < s_hi; k0 += kPlaneChunk) {
    kc = min(static_cast<long long>(kPlaneChunk), a.k - k0);
    const int kc32 = static_cast<int>((kc + 31) & ~31LL);
    for (int j = tid; j < kc32; j += kThreads) {
      Plane pl{make_float4(nan, nan, nan, nan), false};  // padding: no row counts
      if (j < kc) pl = build_plane(a, b, k0 + j, nv);
      planes[j] = pl.p;
      gates[j] = pl.gate;
      block_counts[j] = 0;
    }
    __syncthreads();
    // the slice's groups of 32 in this chunk (slices and chunks start on 32)
    const int j_lo = static_cast<int>(max(s_lo, k0) - k0);
    const int j_hi = static_cast<int>(min(s_hi - k0, static_cast<long long>(kc32)));
    for (int j0 = j_lo; live && j0 < j_hi; j0 += 32) {
      // the thread's counts of 32 hypotheses first (no warp operation
      // between them, so their tests interleave), then the warp's sums:
      // lane u keeps hypothesis j0 + u's
      int count[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const float4 p = planes[j0 + u];
        // |dist| < thresh as the sign of |dist| - thresh: exact (a nonzero
        // difference of two floats never rounds to zero; equal gives +0),
        // and a NaN difference is the card's positive canonical NaN
        unsigned c = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          c += __float_as_uint(__fsub_rn(fabsf(plane_dist(x[r], y[r], z[r], p)), a.thresh)) >> 31;
        }
        count[u] = static_cast<int>(c);
      }
      int mine = 0;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int sum = __reduce_add_sync(0xffffffffu, count[u]);
        if (lane == u) mine = sum;
      }
      if (mine) atomicAdd(&block_counts[j0 + lane], mine);
    }
    __syncthreads();
    for (int j = j_lo + tid; j < j_hi && j < kc; j += kThreads) {
      const int c = block_counts[j];
      if (c) atomicAdd(&a.scratch[prow + k0 + j], c);
    }
    if (k0 + kPlaneChunk < s_hi) __syncthreads();  // the next chunk rewrites the tiles
  }
  k0 -= kPlaneChunk;  // the chunk left in shared memory: [k0, k0 + kc)

  // the ticket: the scan's last block (of every row block and slice) selects
  unsigned* ticket = reinterpret_cast<unsigned*>(a.scratch + a.scans * a.k);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&ticket[b], 1u) == gridDim.x * gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the gate, the counts (out where asked for), and each thread's first
  // largest count; the staged chunk's gates and planes are still in shared
  // memory
  int best_c = INT_MIN;
  unsigned best_k = UINT_MAX;
  for (long long j = tid; j < a.k; j += kThreads) {
    const long long q = prow + j;
    const bool staged = j >= k0 && j < k0 + kc;
    const bool g = staged ? gates[j - k0] : build_plane(a, b, j, nv).gate;
    const int c = g ? __ldcg(a.scratch + q) : -1;
    a.scratch[q] = 0;
    if (a.counts != nullptr) a.counts[q] = c;
    if (c > best_c) {
      best_c = c;
      best_k = static_cast<unsigned>(j);
    }
  }
  // the warp's, then the block's: the largest count, then its least k
  const int wc = __reduce_max_sync(0xffffffffu, best_c);
  const unsigned wk = __reduce_min_sync(0xffffffffu, best_c == wc ? best_k : UINT_MAX);
  if (lane == 0) {
    warp_count[tid >> 5] = wc;
    warp_k[tid >> 5] = wk;
  }
  __syncthreads();
  if (tid == 0) {
    int c = warp_count[0];
    unsigned kk = warp_k[0];
    for (int w = 1; w < kWarps; ++w) {
      if (warp_count[w] > c || (warp_count[w] == c && warp_k[w] < kk)) {
        c = warp_count[w];
        kk = warp_k[w];
      }
    }
    const bool staged = kk >= k0 && kk < k0 + kc;
    const float4 p = staged ? planes[kk - k0] : build_plane(a, b, kk, nv).p;
    if (a.best != nullptr) a.best[b] = kk;
    a.found[b] = c > 0;
    a.normal[b * 3] = p.x;
    a.normal[b * 3 + 1] = p.y;
    a.normal[b * 3 + 2] = p.z;
    a.d[b] = p.w;
    ticket[b] = 0;
  }
}

struct InlierArgs {
  const float* pts;     // [B, N, 3]
  const bool* valid;    // [B, N]
  const float* normal;  // [B, 3]
  const float* d;       // [B]
  const float* n_inl;   // [B] (with prev) or null
  const bool* prev;     // [B, N] or null
  int n;
  float thresh;
  bool* out;            // [B, N]
};

__global__ void __launch_bounds__(kThreads) plane_inliers(InlierArgs a) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long r = static_cast<long long>(b) * a.n + i;
  bool in;
  if (a.prev != nullptr && !(a.n_inl[b] >= 3.0f)) {
    in = a.prev[r];
  } else {
    in = false;
    if (a.valid[r]) {
      const float* p = a.pts + r * 3;
      const float4 pl = make_float4(a.normal[b * 3], a.normal[b * 3 + 1], a.normal[b * 3 + 2],
                                    a.d[b]);
      in = fabsf(plane_dist(p[0], p[1], p[2], pl)) < a.thresh;
    }
  }
  a.out[r] = in;
}

struct CloseArgs {
  const float* pts;     // [B, N, 3]
  const float* normal;  // [B, 3] the round's plane
  const float* d;       // [B]
  const bool* found;    // [B] the round's
  const bool* active;   // [B]
  int n, max_planes;
  float thresh;
  bool* valid;          // [B, N] in and out
  bool* uni;            // [B, N] in and out
  bool* last;           // [B, N] out where active
  float* coeffs;        // [B, max_planes, 4] in and out
  bool* pvalid;         // [B, max_planes] in and out
  int* planes;          // [B] in and out: the planes kept
  bool* state_found;    // [B] in and out: the loop's found
};

__global__ void __launch_bounds__(kThreads) plane_inliers_close(CloseArgs a) {
  const int b = blockIdx.y;
  const bool act = a.active[b];
  if (!act) return;
  const bool f = a.found[b];
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // the scan's state
    const int i = a.planes[b];
    if (i >= 0 && i < a.max_planes) {
      const long long s = static_cast<long long>(b) * a.max_planes + i;
      if (f) {
        a.coeffs[s * 4] = a.normal[b * 3];
        a.coeffs[s * 4 + 1] = a.normal[b * 3 + 1];
        a.coeffs[s * 4 + 2] = a.normal[b * 3 + 2];
        a.coeffs[s * 4 + 3] = a.d[b];
      }
      a.pvalid[s] = f;
    }
    a.planes[b] = i + (f ? 1 : 0);
    a.state_found[b] = f;
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const long long r = static_cast<long long>(b) * a.n + i;
  bool m = false;
  if (f && a.valid[r]) {
    const float* p = a.pts + r * 3;
    const float4 pl = make_float4(a.normal[b * 3], a.normal[b * 3 + 1], a.normal[b * 3 + 2],
                                  a.d[b]);
    m = fabsf(plane_dist(p[0], p[1], p[2], pl)) < a.thresh;
  }
  if (m) {
    a.valid[r] = false;
    a.uni[r] = true;
  }
  a.last[r] = m;
}

template <int R>
cudaError_t launch_score(const ScoreArgs& a, int slices, cudaStream_t st) {
  const int blocks = static_cast<int>((a.n + kThreads * R - 1) / (kThreads * R));
  ransac_score<R><<<dim3(blocks, static_cast<unsigned>(a.scans), slices), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The score kernel on the arguments packed as ScoreArgs; rows a thread and
// the slice are the caller's choice (ops.ransac.score_form).
extern "C" int pcp_ransac_score(const char* packed) {
  ScoreArgs a;
  memcpy(&a, packed, sizeof(a));
  if (a.scans <= 0) return 0;
  if (a.scans > 65535 || a.n < 1 || a.n > INT_MAX || a.k < 1 || a.k > INT_MAX ||
      a.slice < 32 || a.slice % 32 || (a.rows != 2 && a.rows != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long slices = (a.k + a.slice - 1) / a.slice;
  if (slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(a.stream);
  const int z = static_cast<int>(slices);
  return static_cast<int>(a.rows == 8 ? launch_score<8>(a, z, st) : launch_score<2>(a, z, st));
}

extern "C" int pcp_plane_inliers(const float* pts, const bool* valid, const float* normal,
                                 const float* d, const float* n_inl, const bool* prev, int scans,
                                 int n, float thresh, bool* out, void* stream) {
  if (scans <= 0 || n <= 0) return 0;
  if (scans > 65535) return static_cast<int>(cudaErrorInvalidValue);
  InlierArgs a{pts, valid, normal, d, n_inl, prev, n, thresh, out};
  const int tiles = (n + kThreads - 1) / kThreads;
  plane_inliers<<<dim3(tiles, scans), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcp_plane_inliers_close(const float* pts, const float* normal, const float* d,
                                       const bool* found, const bool* active, int scans, int n,
                                       int max_planes, float thresh, bool* valid, bool* uni,
                                       bool* last, float* coeffs, bool* pvalid, int* planes,
                                       bool* state_found, void* stream) {
  if (scans <= 0) return 0;
  if (scans > 65535 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  CloseArgs a{pts, normal, d, found, active, n, max_planes, thresh, valid, uni, last, coeffs,
              pvalid, planes, state_found};
  const int tiles = n > 0 ? (n + kThreads - 1) / kThreads : 1;  // block 0 keeps the state
  plane_inliers_close<<<dim3(tiles, scans), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
