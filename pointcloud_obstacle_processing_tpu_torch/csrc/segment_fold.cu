// In-order segment fold: XLA:CPU's scatter-add order, per destination bin.
//
// Replaces no TPU kernel.  It carries three plain-XLA sums of the JAX
// package: the `scatter` voxel engine's `.at[packed].add`
// (pointcloud_obstacle_processing_tpu/ops/voxel.py:542-544), the 3-key
// fallback's segment sums (`_reduce_sorted_keys`, voxel.py:123-124), and the
// `mxu` engine's one-hot products (ops/mxu_histogram.py:130-140), whose
// per-bin sums of bf16 terms XLA:CPU computes exactly and so in any order.
// XLA:CPU's scatter-add is a sequential fold in input order; the callers
// sort their rows stably by destination, and this kernel folds each bin's
// rows from +0.0 with round-to-nearest float32 adds:
//
//   out[b, c, d] = (((+0.0 + v[b, c, r0]) + v[b, c, r1]) + ...)
//
// over the rows r of scan b with dest[b, r] == d, in row order.  Row r's value
// is vals[b, c, order[b, r]] where an `order` is given (the stable sort's
// permutation: the callers' gather happens here), else vals[b, c, r]; vals
// is read through its element strides, so a [N, C] buffer's transpose is
// read as it lies.  With split terms the kernel folds t0 = bf16(v) (round to
// nearest even, as torch's `.to(torch.bfloat16)` rounds) and, for two terms,
// t1 = bf16(v - t0) in a second accumulator, then writes fold(t0) +
// fold(t1): the `mxu` engine's `part_t0 + part_t1`, bit for bit.  Bins in
// [bins, width) and bins no row reaches are +0.0.
//
// Contract: within each scan, dest mapped as d < 0 -> -1 and d >= bins ->
// bins is non-decreasing (every caller's dest is a stably sorted key).
// Rows mapped to -1 or bins are dropped.
//
// Design.  Blocks own bins, not rows: block (j, b) owns bins [j*T, (j+1)*T)
// of scan b (T = 1,024; 256 where 1,024 would give fewer blocks than the
// card has SMs).  It finds its rows with two 128-ary searches on the sorted dest
// (each probe a cached load, three rounds for 2M rows), zeroes a [terms, C,
// T] tile in shared memory, stages its rows in chunks (dest, then the values
// gathered through `order`, 16 bytes a row where a row's 4 values lie
// together: every thread's loads in flight at once; the split terms made
// there, in parallel), and folds each run of a chunk on one thread,
// serially (adds alone), starting from the
// tile's value for that bin (+0.0, or the fold so far where the run began in
// the chunk before).  A run never straddles two blocks.  Then it stores the
// tile's C rows with 16-byte stores, so every output element is written
// exactly once: no memset, one launch a call, a batch included.  Tiles of
// 512 to 2,048 bins and chunks of 512 rows timed within 5% of these sizes at
// the fullscale scan's operands on an H100.  Its time is a latency chain a
// block (three search rounds, then the dest and permutation loads, then the
// values they point at, each a round trip to memory, then the fold and the
// stores), with loads in flight only while it stages.  Bound on
// the H100: bytes, N * (4 + 4C) (+ 8 with `order`) read and scans * width *
// 4C written, over 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;      // bins a block owns (the shared tile's size)
constexpr int kSmallTile = 256;  // where kTile gives fewer blocks than SMs
constexpr int kChunk = 1024;     // rows staged a step
constexpr int kRowsPerThread = kChunk / kThreads;
constexpr int kProbes = kThreads / 2;        // probes a search round, per target
static_assert(kChunk % kThreads == 0 && kSmallTile <= kTile && kSmallTile % 4 == 0,
              "segment_fold: tile and chunk sizes");

struct FoldArgs {
  const int* dest;          // [scans, n]
  const float* vals;        // [scans, C, n] through the strides below
  const long long* order;   // [scans, n] or null
  float* out;               // [scans, C, width]
  long long stride_scan, stride_c, stride_n;  // vals' element strides
  int n, bins, width, tile;  // tile: bins a block owns, kTile or kSmallTile
  bool rows16;  // each row's 4 values are 16 aligned bytes: one vector load
};

__device__ __forceinline__ int clamp_dest(int d, int bins) {
  return d < 0 ? -1 : (d >= bins ? bins : d);
}

// float -> bfloat16 -> float, round to nearest even; NaN as torch's 0x7fc0
__device__ __forceinline__ float bf16_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// TERMS 0: the values; 1: bf16(v); 2: bf16(v) and bf16(v - bf16(v)), folded
// apart and added at the end
template <int C, int TERMS>
__global__ void __launch_bounds__(kThreads) segment_fold(FoldArgs a) {
  constexpr int kAcc = TERMS == 2 ? 2 : 1;
  extern __shared__ float smem[];
  float* tile = smem;                                      // [kAcc][C][kTile]
  int* sd = reinterpret_cast<int*>(tile + kAcc * C * kTile);  // [kChunk]
  float* sv = reinterpret_cast<float*>(sd + kChunk);       // [kAcc][C][kChunk]
  __shared__ int s_lo[2], s_hi[2], s_cnt[kThreads / 32];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tw = a.tile;
  const int lo_bin = blockIdx.x * tw;
  const int hi_bin = min(lo_bin + tw, a.width);
  const int* d_scan = a.dest + static_cast<long long>(b) * a.n;

  // the block's rows: [first row with dest >= t0, first row with dest >= t1)
  // of the mapped dest, both searched at once (threads 0-127 and 128-255)
  const int t0 = min(lo_bin, a.bins), t1 = min(hi_bin, a.bins);
  if (tid < 2) {
    s_lo[tid] = 0;
    s_hi[tid] = t0 < t1 ? a.n : 0;
  }
  for (int i = tid; i < kAcc * C * tw; i += kThreads) tile[(i / tw) * kTile + i % tw] = 0.0f;
  __syncthreads();
  const int half = tid / kProbes, k = tid % kProbes;
  const int target = half ? t1 : t0;
  for (;;) {
    const int lo = s_lo[half], hi = s_hi[half];
    if (s_lo[0] >= s_hi[0] && s_lo[1] >= s_hi[1]) break;
    const int step = (hi - lo + kProbes - 1) / kProbes;
    const int p = lo + k * step;
    const bool below = hi > lo && p < hi && clamp_dest(__ldg(d_scan + p), a.bins) < target;
    const unsigned ballot = __ballot_sync(0xffffffffu, below);
    if ((tid & 31) == 0) s_cnt[tid / 32] = __popc(ballot);
    __syncthreads();
    if (tid < 2 && s_hi[tid] > s_lo[tid]) {
      const int l = s_lo[tid], h = s_hi[tid];
      const int st = (h - l + kProbes - 1) / kProbes;
      const int probes = (h - l + st - 1) / st;
      int c = 0;
      for (int w = 0; w < kProbes / 32; ++w) c += s_cnt[tid * (kProbes / 32) + w];
      s_lo[tid] = c == 0 ? l : l + (c - 1) * st + 1;
      s_hi[tid] = c == probes ? h : l + c * st;
    }
    __syncthreads();
  }
  const int r0 = s_lo[0], r1 = s_lo[1];

  const long long* o_scan = a.order ? a.order + static_cast<long long>(b) * a.n : nullptr;
  const float* v_scan = a.vals + static_cast<long long>(b) * a.stride_scan;
  for (int base = r0; base < r1; base += kChunk) {
    const int len = min(kChunk, r1 - base);
    // stage: each thread's rows' loads first, then the stores to the chunk
    int dj[kRowsPerThread];
    float vj[kRowsPerThread][C];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int kk = tid + u * kThreads;
      const bool in = kk < len;
      const int row = base + kk;
      dj[u] = in ? __ldg(d_scan + row) - lo_bin : 0;
      const long long src = in ? (o_scan ? __ldg(o_scan + row) : row) : 0;
      if (C == 4 && a.rows16) {
        const float4 q = in ? __ldg(reinterpret_cast<const float4*>(v_scan + src * 4))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        vj[u][0] = q.x;
        vj[u][C > 1 ? 1 : 0] = q.y;
        vj[u][C > 2 ? 2 : 0] = q.z;
        vj[u][C > 3 ? 3 : 0] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          vj[u][c] = in ? __ldg(v_scan + c * a.stride_c + src * a.stride_n) : 0.0f;
      }
    }
    // the split terms here, in parallel, so that the runs' serial chains
    // below are adds alone
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int kk = tid + u * kThreads;
      if (kk < len) {
        sd[kk] = dj[u];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float v = vj[u][c];
          const float h0 = TERMS == 0 ? v : bf16_round(v);
          sv[c * kChunk + kk] = h0;
          if (TERMS == 2) sv[((kAcc - 1) * C + c) * kChunk + kk] = bf16_round(__fsub_rn(v, h0));
        }
      }
    }
    __syncthreads();
    // fold: the thread holding a run's first row of the chunk walks it
    for (int kk = tid; kk < len; kk += kThreads) {
      const int d = sd[kk];
      if (kk > 0 && sd[kk - 1] == d) continue;
      float acc[kAcc][C];
#pragma unroll
      for (int t = 0; t < kAcc; ++t)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[t][c] = tile[(t * C + c) * kTile + d];
      for (int m = kk; m < len; m += 4) {
        bool end = false;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          end = end || m + u >= len || sd[min(m + u, len - 1)] != d;
          if (!end) {
#pragma unroll
            for (int t = 0; t < kAcc; ++t)
#pragma unroll
              for (int c = 0; c < C; ++c)
                acc[t][c] = __fadd_rn(acc[t][c], sv[(t * C + c) * kChunk + m + u]);
          }
        }
        if (end) break;
      }
#pragma unroll
      for (int t = 0; t < kAcc; ++t)
#pragma unroll
        for (int c = 0; c < C; ++c) tile[(t * C + c) * kTile + d] = acc[t][c];
    }
    __syncthreads();
  }

  // store the tile's C rows, each element once (16-byte stores where the
  // rows stay 16-byte aligned)
  const int count = hi_bin - lo_bin;
  for (int c = 0; c < C; ++c) {
    float* o = a.out + (static_cast<long long>(b) * C + c) * a.width + lo_bin;
    const float* t0row = tile + c * kTile;
    const float* t1row = tile + ((kAcc - 1) * C + c) * kTile;
    if ((a.width & 3) == 0) {
      for (int i = tid * 4; i < count; i += kThreads * 4) {
        float4 s = *reinterpret_cast<const float4*>(t0row + i);
        if (TERMS == 2) {
          const float4 s1 = *reinterpret_cast<const float4*>(t1row + i);
          s = make_float4(__fadd_rn(s.x, s1.x), __fadd_rn(s.y, s1.y), __fadd_rn(s.z, s1.z),
                          __fadd_rn(s.w, s1.w));
        }
        *reinterpret_cast<float4*>(o + i) = s;
      }
    } else {
      for (int i = tid; i < count; i += kThreads)
        o[i] = TERMS == 2 ? __fadd_rn(t0row[i], t1row[i]) : t0row[i];
    }
  }
}

// the card's SMs, once a device
int sm_count() {
  static int counts[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 132;
  if (counts[device] == 0 &&
      cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    counts[device] = 132;
  return counts[device];
}

template <int C, int TERMS>
cudaError_t launch(FoldArgs a, int scans, cudaStream_t s) {
  constexpr int kAcc = TERMS == 2 ? 2 : 1;
  constexpr size_t smem = (kAcc * C * kTile + kChunk + kAcc * C * kChunk) * sizeof(float);
  if (smem > 48 * 1024) {
    // above 48 KB a block's dynamic shared memory needs the opt-in, once a
    // device
    static unsigned long long configured = 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= 64 || !(configured >> device & 1ull)) {
      err = cudaFuncSetAttribute(segment_fold<C, TERMS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      if (device < 64) configured |= 1ull << device;
    }
  }
  // small tiles where the big ones would leave SMs without a block
  a.tile = (a.width + kTile - 1) / kTile * static_cast<long long>(scans) < sm_count()
               ? kSmallTile
               : kTile;
  const dim3 grid((a.width + a.tile - 1) / a.tile, scans);
  segment_fold<C, TERMS><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <int TERMS>
cudaError_t launch_terms(const FoldArgs& a, int scans, int c, cudaStream_t s) {
  switch (c) {
    case 1: return launch<1, TERMS>(a, scans, s);
    case 2: return launch<2, TERMS>(a, scans, s);
    case 3: return launch<3, TERMS>(a, scans, s);
    case 4: return launch<4, TERMS>(a, scans, s);
    case 5: return launch<5, TERMS>(a, scans, s);
    case 6: return launch<6, TERMS>(a, scans, s);
    case 7: return launch<7, TERMS>(a, scans, s);
    case 8: return launch<8, TERMS>(a, scans, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dest [scans, n] int32 contiguous; vals float32 at vals + b * stride_scan +
// c * stride_c + r * stride_n (element strides), 1 <= c <= 8; order [scans,
// n] int64 contiguous or null; bf16_terms 0, 1 or 2; out [scans, c, width]
// float32 (width >= bins), every element written by this call.  One launch
// on `stream`.
extern "C" int pcp_segment_fold(const int* dest, const float* vals, const long long* order,
                                int scans, int n, int c, int bins, int width,
                                long long stride_scan, long long stride_c, long long stride_n,
                                int bf16_terms, float* out, void* stream) {
  if (scans <= 0 || width <= 0) return 0;
  if (scans > 65535 || bins > width || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool rows16 = c == 4 && stride_c == 1 && stride_n == 4 && stride_scan % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  FoldArgs a{dest, vals, order, out, stride_scan, stride_c, stride_n, n, bins, width, kTile,
             rows16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bf16_terms) {
    case 0: err = launch_terms<0>(a, scans, c, s); break;
    case 1: err = launch_terms<1>(a, scans, c, s); break;
    case 2: err = launch_terms<2>(a, scans, c, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
