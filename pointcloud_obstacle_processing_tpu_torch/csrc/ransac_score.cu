// RANSAC's hypothesis scoring and selection, and its inlier masks:
// ops.ransac.ransac_score and ops.ransac.plane_inliers.
//
// Replaces no TPU kernel.  It carries the JAX package's plain-XLA scoring
// (pointcloud_obstacle_processing_tpu/ops/ransac.py:154-168: every point's
// distance to every hypothesis, the inlier count a hypothesis, the gate, the
// first largest count, the winner's mask) and the refinement's mask
// (:194-204), which in eager PyTorch were a [B, N, K] float32 table and six
// or more passes over it a round.  Both kernels are bitwise their plain twins
// (ops/ransac.py ransac_score_plain, plane_inliers_plain): the distance is
// fma(z, nz, fma(x, nx, y * ny)) + d with each step one IEEE rounding
// (ops.dot3's chain, then the add; the _rn intrinsics, and the file builds
// with -fmad=false), |dist| < thresh, and a NaN distance is no inlier.
//
// ransac_score: a block of 256 threads takes 256 R rows of one scan (the
// grid's y), R rows a thread (2, or 8 where the call has rows enough for
// the blocks to still fill the card), each row read once, coalesced; an invalid row takes NaN coordinates, so no plane counts
// it, and a warp whose rows are all invalid (a compacted cloud's tail)
// skips the tests.  The block stages the scan's planes in shared memory as
// (nx, ny, nz, d) with their gates, 1,024 at a time (a chunk padded to 32
// with NaN planes).
// For each of a group of 32 hypotheses a thread counts the inliers among
// its R rows in a register; then the warp adds each count
// (__reduce_add_sync), lane j keeps the sum of hypothesis j and adds it into the block's
// count in shared memory; the block adds each nonzero count into a [B, K]
// int32 scratch with one atomic.  The counts are integers, so the order of
// the adds does not matter.  The last block of a scan (a ticket a scan)
// applies the gate (-1 where it is false), writes the counts, picks the
// least k among the largest counts (torch.argmax's first occurrence),
// writes the winner's index, found (count > 0), normal and offset, and
// zeroes its scratch row and ticket for the next call: no memset, no host
// read, no [B, N, K] tensor.  The scratch and tickets are the caller's,
// cached a device and stream.
//
// plane_inliers: a thread a row, (|dist| < thresh) & valid against one plane
// a scan read from device memory (the winner's, or a refined plane), and
// with n_inl and prev given, prev kept in scans with n_inl < 3 (the
// refinement's select).
//
// Bound on the H100: operations.  ransac_score tests B*N*K (row, plane)
// pairs, 8 float32 operations each (three products and three adds of the
// distance, the absolute value, the compare), against 13 bytes a row read;
// at K = 128 the pairs' time is several times the rows'.  Each pair costs
// about seven issued instructions (four float steps, the subtraction of
// the threshold, the sign's add; the plane's shared load and the warp's sum
// shared by R rows and 32 lanes), so the issue rate, not the float32 rate,
// sets the pace; at the flagship's 24,576 rows a chain of dependent
// latencies (the rows, the planes, the atomics, the ticket, the selection)
// does.  plane_inliers is bytes: 13 read and 1 written a row.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlaneChunk = 1024;  // planes a block stages at a time (16 KB)
// rows of a call for each row a thread of the 8-row form: 2 blocks an SM
constexpr long long kRowsForm = 2LL * 132 * kThreads;

// the plane distance as ops.dot3 and ransac._plane_dist evaluate it
__device__ __forceinline__ float plane_dist(float x, float y, float z, float4 p) {
  return __fadd_rn(__fmaf_rn(z, p.z, __fmaf_rn(x, p.x, __fmul_rn(y, p.y))), p.w);
}

struct ScoreArgs {
  const float* pts;               // [B, N, 3]
  const bool* valid;              // [B, N]
  const float *nx, *ny, *nz, *ds; // [B, K] each
  const bool* gate;               // [B, K]
  int n, k;
  float thresh;
  int* scratch;                   // [B, K] counts, zero between calls
  unsigned* ticket;               // [B], zero between calls
  int* counts;                    // [B, K] out
  long long* best;                // [B] out
  bool* found;                    // [B] out
  float* normal;                  // [B, 3] out
  float* d;                       // [B] out
};

template <int R>
__global__ void __launch_bounds__(kThreads) ransac_score(ScoreArgs a) {
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

  // a thread's rows, kThreads apart; an invalid row, or a row past N, is
  // NaN: its distance to every plane is NaN, never below the threshold
  float x[R], y[R], z[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = (blockIdx.x * R + r) * kThreads + tid;
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

  for (int k0 = 0; k0 < a.k; k0 += kPlaneChunk) {
    const int kc = min(kPlaneChunk, a.k - k0);
    const int kc32 = (kc + 31) & ~31;
    for (int j = tid; j < kc32; j += kThreads) {
      float4 p = make_float4(nan, nan, nan, nan);  // padding: no row counts
      bool g = false;
      if (j < kc) {
        const long long q = prow + k0 + j;
        p = make_float4(a.nx[q], a.ny[q], a.nz[q], a.ds[q]);
        g = a.gate[q];
      }
      planes[j] = p;
      gates[j] = g;
      block_counts[j] = 0;
    }
    __syncthreads();
    for (int j0 = 0; live && j0 < kc32; j0 += 32) {
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
    for (int j = tid; j < kc; j += kThreads) {
      const int c = block_counts[j];
      if (c) atomicAdd(&a.scratch[prow + k0 + j], c);
    }
    __syncthreads();  // the next chunk rewrites planes and block_counts
  }

  // the ticket: the scan's last block to finish selects
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.ticket[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the gate, the counts out, and each thread's first largest count; with
  // one chunk of planes, the gates and planes are still in shared memory
  const bool staged = a.k <= kPlaneChunk;
  int best_c = INT_MIN;
  unsigned best_k = UINT_MAX;
  for (int j = tid; j < a.k; j += kThreads) {
    const long long q = prow + j;
    const int c = (staged ? gates[j] : a.gate[q]) ? __ldcg(a.scratch + q) : -1;
    a.scratch[q] = 0;
    a.counts[q] = c;
    if (c > best_c) {
      best_c = c;
      best_k = j;
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
    const long long q = prow + kk;
    const float4 p = staged ? planes[kk] : make_float4(a.nx[q], a.ny[q], a.nz[q], a.ds[q]);
    a.best[b] = kk;
    a.found[b] = c > 0;
    a.normal[b * 3] = p.x;
    a.normal[b * 3 + 1] = p.y;
    a.normal[b * 3 + 2] = p.z;
    a.d[b] = p.w;
    a.ticket[b] = 0;
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

}  // namespace

template <int R>
cudaError_t launch_score(const ScoreArgs& a, int scans, cudaStream_t st) {
  const int blocks = (a.n + kThreads * R - 1) / (kThreads * R);
  ransac_score<R><<<dim3(blocks, scans), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

extern "C" int pcp_ransac_score(const float* pts, const bool* valid, const float* nx,
                                const float* ny, const float* nz, const float* ds, const bool* gate,
                                int scans, int n, int k, float thresh, int* scratch, int* counts,
                                long long* best, bool* found, float* normal, float* d,
                                void* stream) {
  if (scans <= 0) return 0;
  if (scans > 65535 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the scratch: [scans, k] counts, then a ticket a scan
  ScoreArgs a{pts, valid, nx, ny, nz, ds, gate, n, k, thresh, scratch,
              reinterpret_cast<unsigned*>(scratch + static_cast<long long>(scans) * k),
              counts, best, found, normal, d};
  const auto st = static_cast<cudaStream_t>(stream);
  // rows a thread: 8 where that still leaves 2 blocks an SM of the card's
  // 132 (a batch of 32 flagship scans), else 2 (the flagship's 24,576 rows,
  // fullscale's 262,144, two fullscale windows).  1 and 4 rows a thread
  // were measured too and won nowhere by more than a few tenths of a us.
  const long long total = static_cast<long long>(scans) * n;
  if (total >= kRowsForm * 8) return static_cast<int>(launch_score<8>(a, scans, st));
  return static_cast<int>(launch_score<2>(a, scans, st));
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
