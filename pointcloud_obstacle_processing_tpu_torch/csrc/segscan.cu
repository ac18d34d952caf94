// Segmented inclusive sum-scan in the Hillis-Steele step order (kernel K6).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/segscan.py: _segscan_pallas
// (the pallas_call running the step sequence _scan_steps; entry point
// segmented_inclusive_scan).
//
// Input: values [C, N] float32 and heads [N] (one byte each, shared by every
// channel).  Output [C, N]: after the steps d = 1, 2, 4, ... < N of
//
//   v'[i] = v[i] + (f[i] ? 0.0f : v[i - d])      f'[i] = f[i] | f[i - d]
//
// (a source before the start gives 0.0 and flag 1), bitwise what the
// reference's step sequence gives: each step reads only the previous
// step's values, and the add of +0.0 where the flag is set is kept (an
// input -0.0 comes out +0.0).  A Blelloch or decoupled-lookback scan would
// add in another order and is not this function.
//
// The TPU kernel held one [1, N] channel in VMEM and ran every step there.
// A block here holds far less, so the steps split in two, and the second
// part runs only where a segment reaches far back:
// * segscan_local runs the steps d < kHalo for one kTile-value tile of one
//   channel a block, from the tile and the kHalo values before it: after
//   the steps d = 1 ... kHalo / 2 a window position p is exact once p >=
//   kHalo - 1, so the whole tile is.  Values stay in registers; each step
//   stores them to one of two shared buffers in turn, syncs once, and reads
//   its source.  The flags need no step of their own: before the step of
//   shift d an element's flag is set exactly when the window's last head
//   at or before it (positions before the row count as heads) lies less
//   than d back, so one prefix max of head positions gives them all.  Once
//   no position an output depends on reads a source (runs shorter than d
//   everywhere in the window), the later local steps only add +0.0, and one
//   add stands for them all: runs of a dozen values take 5-6 of the 10.
//   After these steps an element whose flag is set (a head within the last
//   kHalo values) has its final value: every later step adds +0.0, so it is
//   written out as v + 0.0, with one bit for those that were -0.0 before
//   (the later steps read them as they were).  The others are "live": their
//   segment reaches further back.  A tile with a live element writes all
//   its values as they stand, and its flags; each tile writes whether it
//   has one.
// * segscan_global runs the steps d = kHalo * 2^s only where some tile is
//   live (it returns at once otherwise, the case of every scan of
//   voxel-like runs).  Those steps join only the elements of one residue
//   modulo kHalo: on the coarse sequence m -> m * kHalo + r they are the
//   Hillis-Steele steps of shift 2^s.  So a block takes a few residues of
//   one channel, their whole coarse sequences (every value once), runs all
//   the later steps in shared memory, and writes every value out.  With no
//   head at all that is one more read and write of the buffer, where one
//   launch a later step (11 at N = 2^21) read and wrote all of it each.
// * Past kMaxSharedN values a row, one residue's coarse sequence no longer
//   fits a block's shared memory: segscan_local then writes every tile as
//   live, and the later steps run as segscan_step, one launch a step over
//   the whole buffer in global memory (values and flags double-buffered).
//
// Bound on the H100: one read and one write of [C, N] float32 plus the
// heads, so memory: at [4, 2^21] ~69 MB, ~0.02 ms at 3.35 TB/s.  The local
// kernel reads (kTile + kHalo) / kTile = 1.25 times the values it writes
// (a 1,024-value tile, twice, measured slower at both of chip_smoke.py's
// shapes).

#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 1024;              // values before a tile; local steps d < kHalo
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxResidues = 32;         // residues a block of segscan_global

constexpr int kTile = 4096;              // outputs a block of segscan_local
// the longest row whose later steps run in shared memory: one residue's
// coarse sequence, 32 values a thread
constexpr int kMaxSharedN = kHalo * 32 * kThreads;

__global__ void __launch_bounds__(kThreads)
segscan_local(const float* __restrict__ values, const unsigned char* __restrict__ heads, int n,
              int global_steps, int all_live, float* __restrict__ out, float* __restrict__ live_out,
              unsigned char* __restrict__ flags, int* __restrict__ tile_live,
              unsigned* __restrict__ neg0) {
  constexpr int kWindow = kTile + kHalo;
  constexpr int kPer = kWindow / kThreads;  // window positions a thread
  __shared__ float sv[2][kWindow];
  __shared__ int s_tot[kPer * kWarps];  // prefix max of head positions, a warp's span
  const int tile0 = blockIdx.x * kTile;
  const int ws = tile0 - kHalo;  // row index of window position 0
  const int ch = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* row = values + static_cast<size_t>(ch) * n;

  // values, and the last head at or before each position (a warp's span by
  // shuffles, the spans' prefix in shared memory)
  float v[kPer];
  int dist[kPer];
  for (int r = 0; r < kPer; ++r) {
    const int p = tid + r * kThreads;
    const int g = ws + p;
    const bool in = g >= 0 && g < n;
    v[r] = in ? row[g] : 0.0f;
    int h = (!in || heads[g]) ? p : -1;
    for (int o = 1; o < 32; o *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, h, o);
      if (lane >= o) h = max(h, up);
    }
    dist[r] = h;
    if (lane == 31) s_tot[r * kWarps + warp] = h;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix max over the kPer * kWarps spans, in position order
    constexpr int kSpan = kPer * kWarps / 32;
    int m[kSpan];
    int run = -1;
    for (int k = 0; k < kSpan; ++k) {
      m[k] = run;
      run = max(run, s_tot[lane * kSpan + k]);
    }
    int before = run;
    for (int o = 1; o < 32; o *= 2) {
      const int up = __shfl_up_sync(0xffffffffu, before, o);
      if (lane >= o) before = max(before, up);
    }
    before = __shfl_up_sync(0xffffffffu, before, 1);
    if (lane == 0) before = -1;
    for (int k = 0; k < kSpan; ++k) s_tot[lane * kSpan + k] = max(before, m[k]);
  }
  __syncthreads();
  for (int r = 0; r < kPer; ++r) {
    const int p = tid + r * kThreads;
    dist[r] = p - max(dist[r], s_tot[r * kWarps + warp]);  // p + 1 where none: far enough
  }

  int buf = 0;
  for (int d = 1; d < n && d < kHalo; d *= 2, buf ^= 1) {
    bool reads = false;  // some position at or past d (all an output depends on) reads a source
    for (int r = 0; r < kPer; ++r) {
      const int p = tid + r * kThreads;
      sv[buf][p] = v[r];
      reads |= p >= d && dist[r] >= d;
    }
    if (!__syncthreads_or(reads)) {
      // every such position is flagged, at this step and every later one:
      // each adds +0.0, and one add does what they all do
      for (int r = 0; r < kPer; ++r) v[r] = v[r] + 0.0f;
      break;
    }
    for (int r = 0; r < kPer; ++r) {
      const int p = tid + r * kThreads;
      // p < d happens only in the halo's first positions, which no output
      // depends on
      const float src = p >= d ? sv[buf][p - d] : 0.0f;
      v[r] = v[r] + (dist[r] < d ? 0.0f : src);
    }
  }

  // the tile: final values of the flagged, or, in a tile with a live
  // element, every value as it stands
  const bool later = global_steps > 0;
  bool mine = false;
  for (int r = kHalo / kThreads; r < kPer; ++r) {
    mine |= later && ws + tid + r * kThreads < n && dist[r] >= kHalo;
  }
  const bool live = __syncthreads_or(mine) != 0 || all_live;
  if (later && ch == 0 && tid == 0) tile_live[blockIdx.x] = live;
  for (int r = kHalo / kThreads; r < kPer; ++r) {
    const int g = ws + tid + r * kThreads;
    const size_t at = static_cast<size_t>(ch) * n + g;
    if (live) {
      if (g < n) {
        live_out[at] = v[r];
        if (ch == 0) flags[g] = dist[r] < kHalo;
      }
      continue;
    }
    const unsigned neg = __ballot_sync(0xffffffffu, later && v[r] == 0.0f && signbit(v[r]));
    if (later && lane == 0 && g < n) neg0[static_cast<size_t>(ch) * ((n + 31) / 32) + g / 32] = neg;
    if (g < n) out[at] = later ? v[r] + 0.0f : v[r];
  }
}

// The steps d = kHalo * 2^s < n, where some tile is live: a block takes
// `residues` residues modulo kHalo of one channel and their whole coarse
// sequences, kPerThread values a thread.
template <int kPerThread>
__global__ void __launch_bounds__(kThreads)
segscan_global(int c, int n, int residues, const float* __restrict__ live_in,
               const unsigned char* __restrict__ flags, const int* __restrict__ tile_live,
               const unsigned* __restrict__ neg0, float* __restrict__ out) {
  extern __shared__ float sg[];  // [coarse * residues] values, then as many flag bytes
  const int tiles = (n + kTile - 1) / kTile;
  int any = 0;
  for (int t = threadIdx.x; t < tiles; t += kThreads) any |= tile_live[t];
  if (!__syncthreads_or(any)) return;  // no tile live: every value is final

  const int coarse = (n + kHalo - 1) / kHalo;
  const int count = coarse * residues;
  unsigned char* sf = reinterpret_cast<unsigned char*>(sg + count);
  const size_t words = (n + 31) / 32;
  const int groups = kHalo / residues;  // residue groups a channel
  for (int item = blockIdx.x; item < groups * c; item += gridDim.x) {
    __syncthreads();  // the previous item's reads of shared memory are done
    const int r0 = (item % groups) * residues;
    const int ch = item / groups;
    const size_t rowc = static_cast<size_t>(ch) * n;
    float v[kPerThread];
    unsigned char f[kPerThread];
    for (int q = 0; q < kPerThread; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int j = (e / residues) * kHalo + r0 + e % residues;
      v[q] = 0.0f;
      f[q] = 1;
      if (e < count && j < n) {
        if (tile_live[j / kTile]) {
          v[q] = live_in[rowc + j];
          f[q] = flags[j];
        } else {  // flagged: its value before the +0.0 segscan_local added
          v[q] = ((neg0[ch * words + j / 32] >> (j % 32)) & 1u) ? -0.0f : out[rowc + j];
        }
      }
    }
    for (int s = 1; s < coarse; s *= 2) {
      __syncthreads();
      for (int q = 0; q < kPerThread; ++q) {
        const int e = threadIdx.x + q * kThreads;
        if (e < count) {
          sg[e] = v[q];
          sf[e] = f[q];
        }
      }
      __syncthreads();
      const int shift = s * residues;
      for (int q = 0; q < kPerThread; ++q) {
        const int e = threadIdx.x + q * kThreads;
        const bool src = e >= shift && e < count;
        v[q] = v[q] + (f[q] ? 0.0f : (src ? sg[e - shift] : 0.0f));
        f[q] |= src ? sf[e - shift] : static_cast<unsigned char>(1);
      }
    }
    for (int q = 0; q < kPerThread; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int j = (e / residues) * kHalo + r0 + e % residues;
      if (e < count && j < n) out[rowc + j] = v[q];
    }
  }
}

// One later step d over the whole [c, n] buffer in global memory, for rows
// past kMaxSharedN: v'[i] = v[i] + (f[i] ? 0 : v[i - d]), f'[i] = f[i] |
// f[i - d] (channel 0 writes the flags).
__global__ void __launch_bounds__(kThreads)
segscan_step(int c, int n, int d, const float* __restrict__ v_in,
             const unsigned char* __restrict__ f_in, float* __restrict__ v_out,
             unsigned char* __restrict__ f_out) {
  const size_t total = static_cast<size_t>(c) * n;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t k = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; k < total;
       k += stride) {
    const int j = static_cast<int>(k % n);
    const bool src = j >= d;
    const bool f = f_in[j] != 0;
    v_out[k] = v_in[k] + (f ? 0.0f : (src ? v_in[k - d] : 0.0f));
    if (k < static_cast<size_t>(n)) f_out[j] = f || !src || f_in[j - d];
  }
}

template <int kPerThread>
int launch_global(int c, int n, int residues, const float* live_in, const unsigned char* flags,
                  const int* tile_live, const unsigned* neg0, float* out, cudaStream_t s) {
  const int coarse = (n + kHalo - 1) / kHalo;
  const size_t smem = static_cast<size_t>(coarse) * residues * (sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(segscan_global<kPerThread>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave of blocks, each looping over residue groups: the launch that
  // returns at once (no tile live) costs one block an SM
  int dev = 0, sms = 0, occ = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, segscan_global<kPerThread>,
                                                           kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int blocks = min((kHalo / residues) * c, sms * max(occ, 1));
  segscan_global<kPerThread><<<blocks, kThreads, smem, s>>>(c, n, residues, live_in, flags,
                                                            tile_live, neg0, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Steps past segscan_local's reach for a row of n values.
extern "C" int pcp_segscan_global_steps(int n) {
  int steps = 0;
  for (long long d = kHalo; d < n; d *= 2) ++steps;
  return steps;
}

// values [c, n] and heads [n] in; out [c, n]; scratch [c, n] (unused when
// n <= kHalo); flags [2, n] bytes (the second row only past kMaxSharedN);
// ints: ceil(n / kTile) tile flags, then c * ceil(n / 32) words of -0.0
// bits.  One launch, or two where steps past the local kernel's reach
// remain; past kMaxSharedN values a row, one more a later step.
extern "C" int pcp_segscan(const float* values, const unsigned char* heads, int c, int n,
                           float* out, float* scratch, unsigned char* flags, int* ints,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int global_steps = pcp_segscan_global_steps(n);
  const int tiles = (n + kTile - 1) / kTile;
  int* tile_live = ints;
  unsigned* neg0 = reinterpret_cast<unsigned*>(ints + tiles);
  if (n > kMaxSharedN) {
    // every tile as it stands, into the buffer that leaves the last step's
    // output in `out`; then the later steps in global memory
    float* v[2] = {global_steps % 2 ? scratch : out, global_steps % 2 ? out : scratch};
    unsigned char* f[2] = {flags, flags + n};
    segscan_local<<<dim3(tiles, c), kThreads, 0, s>>>(values, heads, n, global_steps, 1, out,
                                                     v[0], f[0], tile_live, neg0);
    cudaError_t err = cudaGetLastError();
    int dev = 0, sms = 0;
    if (err == cudaSuccess && (err = cudaGetDevice(&dev)) == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    for (int k = 0; err == cudaSuccess && k < global_steps; ++k) {
      segscan_step<<<sms * 4, kThreads, 0, s>>>(c, n, kHalo << k, v[k % 2], f[k % 2],
                                               v[(k + 1) % 2], f[(k + 1) % 2]);
      err = cudaGetLastError();
    }
    return static_cast<int>(err);
  }
  segscan_local<<<dim3(tiles, c), kThreads, 0, s>>>(values, heads, n, global_steps, 0, out,
                                                   scratch, flags, tile_live, neg0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || global_steps == 0) return static_cast<int>(err);
  const int coarse = (n + kHalo - 1) / kHalo;
  int residues = kMaxResidues;  // as many as 16 values a thread hold
  while (residues > 1 && coarse * residues > 16 * kThreads) residues /= 2;
  if (coarse * residues <= 16 * kThreads) {
    return launch_global<16>(c, n, residues, scratch, flags, tile_live, neg0, out, s);
  }
  return launch_global<32>(c, n, 1, scratch, flags, tile_live, neg0, out, s);
}
