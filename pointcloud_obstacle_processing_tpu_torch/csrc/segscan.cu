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
// A block here holds far less, so the steps split in two:
// * segscan_local runs the steps d < kTile inside one block per kTile
//   outputs and up to kGroup channels.  The block loads its tile and the
//   kTile values before it (the halo): after m steps a window position j
//   is exact once j >= 2^m - 1, so after the 10 steps d = 1 ... 512 the
//   tile's half of the window is exact.  Each step computes into registers,
//   syncs, then writes back, so no step reads a value it has updated.  The
//   flags depend only on the column and are computed once for the group.
// * segscan_step runs one step d >= kTile over the whole row per launch,
//   ping-ponging between two buffers: 7 launches at N = 131,072 and 11 at
//   2,097,152.  One thread per column updates its flag once and then every
//   channel.
//
// Bound on the H100: one read and one write of [C, N] float32 plus the
// heads, so memory; at [4, 2^21] that is ~69 MB, ~0.02 ms at 3.35 TB/s.
// The halo doubles the local kernel's reads and each global step reads and
// writes the whole buffer again; fusing those steps is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;         // outputs per block of segscan_local
constexpr int kWindow = 2 * kTile;  // the tile and its halo
constexpr int kGroup = 4;           // channels per block of segscan_local

__global__ void __launch_bounds__(kTile)
segscan_local(const float* __restrict__ values, const unsigned char* __restrict__ heads,
              int c, int n, float* __restrict__ dst, unsigned char* __restrict__ flags_out) {
  __shared__ float sv[kGroup][kWindow];
  __shared__ unsigned char sf[kWindow];
  const int tile0 = blockIdx.x * kTile;
  const int ws = tile0 - kTile;  // row index of window position 0
  const int c0 = blockIdx.y * kGroup;
  const int nc = min(kGroup, c - c0);

  for (int r = 0; r < 2; ++r) {
    const int j = threadIdx.x + r * kTile;
    const int g = ws + j;
    const bool in = g >= 0 && g < n;
    sf[j] = in ? static_cast<unsigned char>(heads[g] != 0) : 1;
    for (int k = 0; k < kGroup; ++k) {
      if (k < nc) sv[k][j] = in ? values[static_cast<size_t>(c0 + k) * n + g] : 0.0f;
    }
  }
  __syncthreads();

  for (int d = 1; d < n && d < kTile; d *= 2) {
    float nv[2][kGroup];
    unsigned char nf[2];
    for (int r = 0; r < 2; ++r) {
      const int j = threadIdx.x + r * kTile;
      // j < d happens only in the halo's first 2^m - 1 positions, which no
      // output depends on; the row's own start is g - d < 0
      const bool src = ws + j - d >= 0 && j >= d;
      const unsigned char f = sf[j];
      nf[r] = f | (src ? sf[j - d] : static_cast<unsigned char>(1));
      for (int k = 0; k < kGroup; ++k) {
        if (k < nc) {
          const float add = f ? 0.0f : (src ? sv[k][j - d] : 0.0f);
          nv[r][k] = sv[k][j] + add;
        }
      }
    }
    __syncthreads();
    for (int r = 0; r < 2; ++r) {
      const int j = threadIdx.x + r * kTile;
      sf[j] = nf[r];
      for (int k = 0; k < kGroup; ++k) {
        if (k < nc) sv[k][j] = nv[r][k];
      }
    }
    __syncthreads();
  }

  const int g = tile0 + threadIdx.x;
  if (g >= n) return;
  const int j = kTile + threadIdx.x;
  for (int k = 0; k < kGroup; ++k) {
    if (k < nc) dst[static_cast<size_t>(c0 + k) * n + g] = sv[k][j];
  }
  if (blockIdx.y == 0) flags_out[g] = sf[j];
}

__global__ void segscan_step(const float* __restrict__ src, const unsigned char* __restrict__ fsrc,
                             int c, int n, int d, float* __restrict__ dst,
                             unsigned char* __restrict__ fdst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool in = i >= d;
  const unsigned char f = fsrc[i];
  fdst[i] = f | (in ? fsrc[i - d] : static_cast<unsigned char>(1));
  for (int k = 0; k < c; ++k) {
    const size_t row = static_cast<size_t>(k) * n;
    const float add = f ? 0.0f : (in ? src[row + i - d] : 0.0f);
    dst[row + i] = src[row + i] + add;
  }
}

}  // namespace

// values [c, n] and heads [n] in; out [c, n]; scratch [c, n] (may be out
// when n <= kTile); flags [2, n] bytes of scratch.  Launches on `stream`.
extern "C" int pcp_segscan(const float* values, const unsigned char* heads, int c, int n,
                           float* out, float* scratch, unsigned char* flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int global_steps = 0;
  for (long long d = kTile; d < n; d *= 2) ++global_steps;
  // the local steps write the buffer from which an even number of
  // ping-pongs ends in out
  float* a = (global_steps % 2 == 0) ? out : scratch;
  float* b = (a == out) ? scratch : out;
  unsigned char* fa = flags;
  unsigned char* fb = flags + n;
  const dim3 grid((n + kTile - 1) / kTile, (c + kGroup - 1) / kGroup);
  segscan_local<<<grid, kTile, 0, s>>>(values, heads, c, n, a, fa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (long long d = kTile; d < n; d *= 2) {
    segscan_step<<<(n + 255) / 256, 256, 0, s>>>(a, fa, c, n, static_cast<int>(d), b, fb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    float* t = a; a = b; b = t;
    unsigned char* u = fa; fa = fb; fb = u;
  }
  return 0;
}
