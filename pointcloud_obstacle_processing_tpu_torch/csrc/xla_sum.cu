// Float32 row sums in XLA:CPU's order for jnp.sum (ops.sum_like_xla), and
// RANSAC's refinement step (ops.ransac.covariance_tail): the covariance's
// nine sums with the 3x3 tail (plane_tail.cuh) as their epilogue.
//
// Replaces no TPU kernel: the reference's sums are plain XLA reductions,
// and this kernel replays the order XLA:CPU gives them, which the
// reference's CPU results (the port's yardstick) follow.  XLA:CPU's
// tree-reduction rewrite turns a reduction of n > 32 values into a
// reduce-window of 32 (stride 32, zero padding split pad / 2 in front and
// the rest behind), repeated until 32 or fewer values remain, then a plain
// reduce; every window and the last reduce add their values one after
// another from +0.0.  Call c[0] = n the values of level 0 and c[i + 1] =
// ceil(c[i] / 32) the windows of level i + 1 (while c[i] > 32); c[top] <= 32
// values enter the plain reduce.  A sum from +0.0 is never -0.0, so adding
// the zero padding anywhere changes nothing: a window of level i is the
// in-order sum of 32^i consecutive value slots, zero outside [0, n).
//
// Operands: a [L, S, n] and optionally b [L, T, n], each with its own
// element strides (a transposed or broadcast view is read in place).  Out
// [L, S, T]: the sum over n of a[l, s, :] or, with b, of the products
// a[l, s, :] * b[l, t, :].  Above 32 values XLA:CPU computes such a product
// in a fusion of its own, so it is rounded before the windows add it
// (__fmul_rn, then __fadd_rn); up to 32 the product is fused into the
// plain reduce's adds (acc = __fmaf_rn(a, b, acc)).
//
// Design: one launch at every length.  Rows of up to 32 values take
// xla_sum_short, a thread an output.  Longer rows take xla_sum_cluster: a
// thread-block cluster of up to 16 blocks owns a tile of rows of one lead
// index and reads each of those rows once for all of the tile's outputs.
// The host picks the tile: one row (and one of b) a cluster where a call
// has too few clusters to fill the card (a scan's sums: 9 clusters of 14
// blocks for its covariance), up to 4 rows of a, or 3 of a and 3 of b, for
// a batch (the batch of 32: 32 clusters of 4 blocks, each reading a scan's
// 6 covariance rows once for its 9 sums); covariance_tail always takes
// the 3 x 3 tile, one cluster a scan owning the scan's nine sums.
//   * The partition comes from the host (ops.xla_sum_plan): block b owns
//     the windows bounds[b] .. bounds[b + 1] - 1 of one level of the tree,
//     the highest level with at least one window a block.  A level boundary
//     is the only cut that keeps XLA's order: the sum of a row is the sum
//     of its window sums, level by level.
//   * A warp's unit is one level-2 window: 32 level-1 windows of 32 values,
//     1,024 value slots of each of the tile's rows.  The warp copies them
//     into shared memory with cp.async (16-byte copies where the value axis
//     is contiguous and 16-byte aligned, 4-byte copies for strided views;
//     zero-filled outside [0, n)), half a unit (16 values of each window)
//     a stage, into a ring of two stages a warp, so that the next half's
//     copy is in flight while one is summed.  Each window's 16-byte chunks are swizzled so that
//     lane w reads window w's values in order as float4 without bank
//     conflicts; lane w then holds window w's sum of every output, and
//     lane o adds output o's 32 window sums in order: the unit's sum.
//   * A block keeps its units' sums in shared memory; one thread an output
//     carries them up the levels above 2 in order, each level's open
//     window a running sum, and stores each of its own windows' sums into
//     the leader block's shared memory (distributed shared memory), at the
//     window's index.
//   * After cluster.sync() the leader runs the remaining levels (a thread a
//     window and output) and the plain reduce (a thread an output), and
//     writes the outputs, or, for covariance_tail, hands the nine sums to
//     plane_tail (its operands loaded at the kernel's start).  No global
//     scratch, no second launch, no counter in device memory: concurrent
//     calls on several streams share nothing.
//
// Bound on the H100: one read of every operand row (4 bytes a value and
// row), so memory.  As measured (PERF.md): a launch of a few units a
// block takes ~3 us of device time whatever its rows, and a block reads
// ~40 GB/s, so one cluster's 16 SMs read well under the card's rate; hence
// one row a cluster where clusters are few.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "plane_tail.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWin = 32;                 // XLA:CPU's reduce-window size
constexpr int kUnit = kWin * kWin;       // value slots of a level-2 window: a warp's unit
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxLevels = 8;            // c[top] <= 32 after at most 7 levels for n < 2^31
constexpr int kMaxBlocks = 16;           // a non-portable cluster
constexpr int kMaxOwned = 32;            // windows a block owns (the plan's level keeps it so)
constexpr int kChunk = 64;               // unit sums a block holds before carrying them up
constexpr int kHalf = kWin / 2;          // a stage holds half of each window of a unit
constexpr int kStageRow = kWin * kHalf;  // a stage's floats a row

struct Operand {
  const float* p;
  long long s_l, s_r, s_n;  // element strides of the lead, row and value axes
};

struct Plan {
  int n;
  int top;                      // levels of windows: c[1 .. top]
  int level;                    // the level whose windows the blocks own
  int blocks;
  int c[kMaxLevels + 1];        // values at each level
  int lo[kMaxLevels + 1];       // zero padding in front of each level's windows
  int bounds[kMaxBlocks + 1];   // block b owns windows bounds[b] .. bounds[b + 1] - 1
};

struct Tail {                   // covariance_tail's per-scan operands ([L, 3] and [L])
  const float* cen;
  const float* n_inl;
  long long n_inl_s;
  const float* normal;
  const float* d;
  int vmapped;
  float* out_n;
  float* out_d;
};

// the rows of a (or of a and b) a cluster owns and their outputs
template <int SP, int TP>
struct Tile {
  static constexpr int kRows = SP + TP;
  static constexpr int kOut = TP ? SP * TP : SP;
  // stages of half a unit a warp (rings of ~24 KB a warp whatever the
  // rows measured slower on the flagship and fullscale covariance; PERF.md)
  static constexpr int kStages = 2;
  // shared memory: kWarps times kStages stages, the block's unit sums, the
  // leader's copy of every block's window sums, the final sums
  static constexpr size_t kStage = static_cast<size_t>(kWarps) * kStages * kRows * kStageRow;
  static constexpr size_t kFloats = kStage + kChunk * kOut + kMaxBlocks * kMaxOwned * kOut + 16;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Copy half of one unit into a stage: values 16 h .. 16 h + 15 of each of
// the unit's 32 windows (value slots e0 .. e0 + 1023 of each of R rows),
// window w's 16 at w * 16 with their 16-byte chunks swizzled (chunk q at
// q ^ ((w >> 1) & 3)); slots outside [0, n) are zero-filled.  Not waited
// for: the caller commits the group and waits.
template <int R>
__device__ __forceinline__ void stage_half(float* stage, const float* const (&rp)[R],
                                           const long long (&sn)[R], long long e0, int h, int n,
                                           bool vec, int lane) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  if (vec) {  // lane copies chunk 32 m + lane (window ch / 4) of each row
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int ch = 32 * m + lane, w = ch >> 2, q = ch & 3;
        const long long e = e0 + w * kWin + kHalf * h + 4 * q;
        const bool ok = e >= 0 && e < n;
        const float* src = ok ? rp[r] + e : rp[r];
        const unsigned dst = base + 4u * (r * kStageRow + w * kHalf + ((q ^ ((w >> 1) & 3)) << 2));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                     "r"(ok ? 16 : 0));
      }
    }
  } else {  // value lane % 16 of window 2 m + lane / 16, each row
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll 8
      for (int m = 0; m < kWin / 2; ++m) {
        const int w = 2 * m + (lane >> 4), v = lane & 15;
        const long long e = e0 + w * kWin + kHalf * h + v;
        const bool ok = e >= 0 && e < n;
        const float* src = ok ? rp[r] + e * sn[r] : rp[r];
        const unsigned dst = base + 4u * (r * kStageRow + w * kHalf +
                                          (((v >> 2) ^ ((w >> 1) & 3)) << 2) + (v & 3));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                     "r"(ok ? 4 : 0));
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Lane w adds the staged half of window w's values, in order, to its
// running sum of each output (products rounded first).
template <int SP, int TP>
__device__ __forceinline__ void add_half(const float* stage, int lane,
                                         float (&acc)[Tile<SP, TP>::kOut]) {
#pragma unroll
  for (int j = 0; j < kHalf / 4; ++j) {
    const int off = lane * kHalf + ((j ^ ((lane >> 1) & 3)) << 2);
    float4 av[SP];
    float4 bv[TP ? TP : 1];
#pragma unroll
    for (int s = 0; s < SP; ++s) {
      av[s] = *reinterpret_cast<const float4*>(stage + s * kStageRow + off);
    }
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      bv[t] = *reinterpret_cast<const float4*>(stage + (SP + t) * kStageRow + off);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int s = 0; s < SP; ++s) {
        if constexpr (TP == 0) {
          acc[s] = __fadd_rn(acc[s], lane_of(av[s], k));
        } else {
#pragma unroll
          for (int t = 0; t < TP; ++t) {
            acc[s * TP + t] =
                __fadd_rn(acc[s * TP + t], __fmul_rn(lane_of(av[s], k), lane_of(bv[t], k)));
          }
        }
      }
    }
  }
}

// This warp's units u0, u0 + step, ... below u_end, unit u's value slots
// starting at kUnit * u - shift: each unit's sum of each output (lane w
// sums window w's values in order, then lane o output o's 32 window sums
// in order) into dst[(u - base) * O + o].  A ring of kStages stages of
// half a unit each: the next kStages - 1 halves' copies are in flight
// while one is summed.
template <int SP, int TP>
__device__ __forceinline__ void warp_units(float* stages, const float* const (&rp)[SP + TP],
                                           const long long (&sn)[SP + TP], int n, bool vec,
                                           int lane, int u0, int step, int u_end,
                                           long long shift, float* dst, int base) {
  constexpr int R = SP + TP;
  constexpr int O = Tile<SP, TP>::kOut;
  constexpr int NS = Tile<SP, TP>::kStages;
  const int halves = u0 < u_end ? 2 * ((u_end - u0 + step - 1) / step) : 0;
  auto unit_of = [&](int t) { return u0 + (t >> 1) * step; };
  auto stage_of = [&](int t) { return stages + (t % NS) * R * kStageRow; };
  auto copy = [&](int t) {  // one commit group a half, empty past the last
    if (t < halves) {
      stage_half<R>(stage_of(t), rp, sn, static_cast<long long>(kUnit) * unit_of(t) - shift,
                    t & 1, n, vec, lane);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  };
  float acc[O];
  for (int t = 0; t < NS - 1; ++t) copy(t);
  for (int t = 0; t < halves; ++t) {
    float* cur = stage_of(t);
    copy(t + NS - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 1) : "memory");  // half t is in
    __syncwarp();
    if ((t & 1) == 0) {
#pragma unroll
      for (int o = 0; o < O; ++o) acc[o] = 0.0f;
    }
    add_half<SP, TP>(cur, lane, acc);
    __syncwarp();  // the stage is read: the next copy into it, or the sums below, may write it
    if (t & 1) {   // the unit's window sums, through the stage as [O][33]
#pragma unroll
      for (int o = 0; o < O; ++o) cur[o * (kWin + 1) + lane] = acc[o];
      __syncwarp();
      if (lane < O) {
        float v[kWin];
#pragma unroll
        for (int w = 0; w < kWin; ++w) v[w] = cur[lane * (kWin + 1) + w];
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWin; ++w) sum = __fadd_rn(sum, v[w]);
        dst[(unit_of(t) - base) * O + lane] = sum;
      }
      __syncwarp();
    }
  }
}

template <int SP, int TP, bool kTail>
__global__ void __launch_bounds__(kThreads)
xla_sum_cluster(Operand a, Operand b, int rows_a, int rows_b, Plan plan, int vec,
                float* __restrict__ out, Tail tail) {
  using T = Tile<SP, TP>;
  constexpr int R = T::kRows;
  constexpr int O = T::kOut;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                       // [kWarps][kStages][R][kStageRow]
  float* units = smem + T::kStage;           // [kChunk][O]
  float* gath = units + kChunk * O;          // the leader's: [c[level]][O]
  float* res = gath + kMaxBlocks * kMaxOwned * O;  // [O]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this cluster's lead index and tile of rows
  const int tiles_a = (rows_a + SP - 1) / SP;
  constexpr int kT = TP ? TP : 1;
  const int tiles_b = TP ? (rows_b + kT - 1) / kT : 1;
  const int g = blockIdx.x / plan.blocks;
  const int tb = g % tiles_b, ta = (g / tiles_b) % tiles_a;
  const long long l = g / (tiles_b * tiles_a);
  const int s0 = ta * SP, t0 = tb * TP;
  const float* rp[R];
  long long sn[R];
#pragma unroll
  for (int s = 0; s < SP; ++s) {  // rows past the last are read again and not written
    rp[s] = a.p + l * a.s_l + min(s0 + s, rows_a - 1) * a.s_r;
    sn[s] = a.s_n;
  }
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    rp[SP + t] = b.p + l * b.s_l + min(t0 + t, rows_b - 1) * b.s_r;
    sn[SP + t] = b.s_n;
  }
  const int n = plan.n;
  float t_cen[3], t_nrm[3], t_inl = 0.0f, t_d = 0.0f;  // the tail's operands, loaded early
  if (kTail && rank == 0 && tid == 0) {  // (rank 0 of every cluster: its scan l)
    for (int i = 0; i < 3; ++i) {
      t_cen[i] = tail.cen[3 * l + i];
      t_nrm[i] = tail.normal[3 * l + i];
    }
    t_inl = tail.n_inl[l * tail.n_inl_s];
    t_d = tail.d[l];
  }

  if (plan.level == 0) {  // n <= 32: the plain reduce, products fused into its adds
    if (tid < O) {
      float acc = 0.0f;
      if constexpr (TP == 0) {
        for (int e = 0; e < n; ++e) acc = __fadd_rn(acc, rp[tid][e * sn[tid]]);
      } else {
        const int s = tid / TP, t = SP + tid % TP;
        for (int e = 0; e < n; ++e) acc = __fmaf_rn(rp[s][e * sn[s]], rp[t][e * sn[t]], acc);
      }
      res[tid] = acc;
    }
  } else if (plan.level == 1) {  // n <= 1,024: one warp, one unit, its sum the result
    if (warp == 0) {
      warp_units<SP, TP>(stage, rp, sn, n, vec != 0, lane, 0, 1, 1, plan.lo[0], res, 0);
    }
  } else {
    // this block's windows of the plan's level, and the level-2 windows
    // (units) under them
    const int w_lo = plan.bounds[rank], w_hi = plan.bounds[rank + 1];
    int u_lo = w_lo, u_hi = w_hi;
    for (int i = plan.level; i > 2; --i) {
      u_lo = max(0, kWin * u_lo - plan.lo[i - 1]);
      u_hi = min(plan.c[i - 1], kWin * u_hi - plan.lo[i - 1]);
    }
    // every block is running before any writes to the leader's memory
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    float* stages = stage + static_cast<size_t>(warp) * T::kStages * R * kStageRow;
    float* lead_gath = cluster.map_shared_rank(gath, 0);
    float carry[kMaxLevels];  // the open window's running sum at each level above 2
#pragma unroll
    for (int i = 0; i < kMaxLevels; ++i) carry[i] = 0.0f;
    const long long shift = static_cast<long long>(kWin) * plan.lo[1] + plan.lo[0];
    for (int cb = u_lo; cb < u_hi; cb += kChunk) {
      const int ce = min(u_hi, cb + kChunk);
      warp_units<SP, TP>(stages, rp, sn, n, vec != 0, lane, cb + warp, kWarps, ce, shift, units,
                         cb);
      __syncthreads();
      if (cb == u_lo) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      if (tid < O) {  // carry the units' sums up to the plan's level, in order
        for (int u = cb; u < ce; ++u) {
          float v = units[(u - cb) * O + tid];
          int x = u;  // v's index at level i
          bool done = true;
          for (int i = 2; i < plan.level; ++i) {
            carry[i] = __fadd_rn(carry[i], v);
            if ((x + plan.lo[i]) % kWin != kWin - 1 && x != plan.c[i] - 1) {
              done = false;  // level i's window x / 32 is still open
              break;
            }
            v = carry[i];
            carry[i] = 0.0f;
            x = (x + plan.lo[i]) / kWin;
          }
          if (done) lead_gath[x * O + tid] = v;  // this block's window x, into the leader's copy
        }
      }
      __syncthreads();
    }
    cluster.sync();  // every block's window sums are in the leader's copy
    if (rank != 0) return;
    // the levels above the plan's, a thread a window and output
    float* src = gath;
    float* dst = units;  // free now; c[level + 1] <= kMaxBlocks < kChunk
    int count = plan.c[plan.level];
    for (int i = plan.level; i < plan.top; ++i) {
      const int next = plan.c[i + 1], lo = plan.lo[i];
      for (int k = tid; k < next * O; k += kThreads) {
        const int w = k / O, o = k % O;
        float acc = 0.0f;
        for (int j = 0; j < kWin; ++j) {
          const int x = w * kWin - lo + j;
          if (x >= 0 && x < count) acc = __fadd_rn(acc, src[x * O + o]);
        }
        dst[k] = acc;
      }
      __syncthreads();
      float* swap = src;
      src = dst;
      dst = swap;
      count = next;
    }
    if (tid < O) {  // the plain reduce
      float acc = 0.0f;
      for (int x = 0; x < count; ++x) acc = __fadd_rn(acc, src[x * O + tid]);
      res[tid] = acc;
    }
  }
  __syncthreads();
  if (rank != 0) return;
  if constexpr (kTail) {
    if (tid == 0) {
      plane_tail(res, t_cen, t_inl, t_nrm, t_d, tail.vmapped != 0, tail.out_n + 3 * l,
                 tail.out_d + l);
    }
  } else if (tid < O) {
    const int s = s0 + tid / kT, t = t0 + tid % kT;
    const int rb = TP ? rows_b : 1;
    if (s < rows_a && t < rb) out[(l * rows_a + s) * rb + t] = res[tid];
  }
}

// rows of up to 32 values: a thread an output, the plain reduce (products
// fused into its adds)
__global__ void xla_sum_short(Operand a, Operand b, int lead, int rows_a, int rows_b, int n,
                              float* __restrict__ out) {
  const long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= static_cast<long long>(lead) * rows_a * rows_b) return;
  const int t = static_cast<int>(k % rows_b);
  const int s = static_cast<int>((k / rows_b) % rows_a);
  const long long l = k / (static_cast<long long>(rows_a) * rows_b);
  const float* pa = a.p + l * a.s_l + s * a.s_r;
  float acc = 0.0f;
  if (b.p != nullptr) {
    const float* pb = b.p + l * b.s_l + t * b.s_r;
    for (int e = 0; e < n; ++e) acc = __fmaf_rn(pa[e * a.s_n], pb[e * b.s_n], acc);
  } else {
    for (int e = 0; e < n; ++e) acc = __fadd_rn(acc, pa[e * a.s_n]);
  }
  out[k] = acc;
}

// the tree's level sizes and paddings for n values, and the blocks'
// windows from the host's plan; false where the plan does not fit n
bool make_plan(int n, int level, int blocks, const int* bounds, Plan* plan) {
  *plan = Plan{};
  plan->n = n;
  plan->c[0] = n;
  int top = 0;
  while (plan->c[top] > kWin) {
    if (top == kMaxLevels) return false;
    const int c = plan->c[top];
    plan->lo[top] = ((kWin - c % kWin) % kWin) / 2;
    plan->c[top + 1] = (c + kWin - 1) / kWin;
    ++top;
  }
  plan->top = top;
  plan->level = level;
  plan->blocks = blocks;
  if (blocks < 1 || blocks > kMaxBlocks || level < 0 || level > top) return false;
  if (level <= 1 && blocks != 1) return false;
  if (level >= 1 && top >= 2 && level < 2) return false;  // blocks own windows of level >= 2
  for (int i = 0; i <= blocks; ++i) plan->bounds[i] = bounds[i];
  if (level == 0) return top == 0;
  if (bounds[0] != 0 || bounds[blocks] != plan->c[level]) return false;
  for (int i = 0; i < blocks; ++i) {
    const int owned = bounds[i + 1] - bounds[i];
    if (owned < 1 || owned > kMaxOwned) return false;
  }
  return level == top || plan->c[level + 1] <= kChunk;  // the leader's next level fits
}

bool aligned16(const Operand& x, int lead, int rows) {
  return reinterpret_cast<std::uintptr_t>(x.p) % 16 == 0 && x.s_n == 1 &&
         (lead == 1 || x.s_l % 4 == 0) && (rows == 1 || x.s_r % 4 == 0);
}

template <int SP, int TP, bool kTail>
int set_attributes() {  // once a process
  static int err = -1;
  if (err < 0) {
    auto* kernel = xla_sum_cluster<SP, TP, kTail>;
    int e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Tile<SP, TP>::kBytes));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    err = e;
  }
  return err;
}

template <int SP, int TP, bool kTail>
int launch(const Operand& a, const Operand& b, int lead, int rows_a, int rows_b, const Plan& plan,
           float* out, const Tail& tail, cudaStream_t stream) {
  const int e = set_attributes<SP, TP, kTail>();
  if (e != cudaSuccess) return e;
  constexpr int kT = TP ? TP : 1;
  const int tiles = (rows_a + SP - 1) / SP * (TP ? (rows_b + kT - 1) / kT : 1);
  const bool vec = plan.lo[0] % 4 == 0 && plan.n % 4 == 0 && aligned16(a, lead, rows_a) &&
                   (TP == 0 || aligned16(b, lead, rows_b));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(plan.blocks * static_cast<long long>(lead) * tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<SP, TP>::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, xla_sum_cluster<SP, TP, kTail>, a, b, rows_a,
                                             rows_b, plan, static_cast<int>(vec), out, tail);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the largest cluster (16, else 8, ...) of this kernel the card schedules
template <int SP, int TP, bool kTail>
int max_blocks() {
  static int best = -1;
  if (best < 0) {
    best = 1;
    if (set_attributes<SP, TP, kTail>() == cudaSuccess) {
      for (int nb = kMaxBlocks; nb > 1; nb /= 2) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = nb;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(nb);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = Tile<SP, TP>::kBytes;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        if (cudaOccupancyMaxActiveClusters(&clusters, xla_sum_cluster<SP, TP, kTail>, &cfg) ==
                cudaSuccess && clusters > 0) {
          best = nb;
          break;
        }
      }
    }
    cudaGetLastError();
  }
  return best;
}

using LaunchFn = int (*)(const Operand&, const Operand&, int, int, int, const Plan&, float*,
                         const Tail&, cudaStream_t);
using BlocksFn = int (*)();

// the kernel of a tile: one operand, sp rows (1-4); two, sp x tp (1-3 each)
template <bool kTail>
bool pick(int sp, int tp, LaunchFn* fn, BlocksFn* blocks) {
#define PCP_TILE(S, T)                     \
  if (sp == S && tp == T) {                \
    *fn = launch<S, T, kTail>;             \
    *blocks = max_blocks<S, T, kTail>;     \
    return true;                           \
  }
  if constexpr (kTail) {
    PCP_TILE(3, 3)
    return false;
  } else {
    PCP_TILE(1, 0) PCP_TILE(2, 0) PCP_TILE(3, 0) PCP_TILE(4, 0)
  PCP_TILE(1, 1) PCP_TILE(1, 2) PCP_TILE(1, 3)
  PCP_TILE(2, 1) PCP_TILE(2, 2) PCP_TILE(2, 3)
    PCP_TILE(3, 1) PCP_TILE(3, 2) PCP_TILE(3, 3)
    return false;
  }
#undef PCP_TILE
}

// The arguments of pcp_xla_sum and pcp_covariance_tail, every field 8
// bytes, packed by the host in this order (ops._SUM_ARGS): one ctypes
// argument where nineteen cost the host ~10 us a call.
struct SumArgs {
  const float* a;               // [L, S, n] with strides (sa_l, sa_s, sa_n)
  long long sa_l, sa_s, sa_n;
  const float* b;               // [L, T, n] (nullptr: no product, T = 1)
  long long sb_l, sb_s, sb_n;
  long long lead, rows_a, rows_b, n;
  long long tile_a, tile_b;     // rows of a (1-4; 1-3 with b) and of b (1-3) a cluster owns
  long long level, blocks;      // the host's plan (ops.xla_sum_plan): level, cluster size
  long long bounds[kMaxBlocks + 1];
  float* out;                   // [L, S, T] contiguous
  void* stream;
  const float* cen;             // covariance_tail: [L, 3]
  const float* n_inl;           // [L], element stride n_inl_s
  long long n_inl_s;
  const float* normal;          // [L, 3]
  const float* d;               // [L]
  long long vmapped;
  float* out_n;                 // [L, 3]
  float* out_d;                 // [L]
};

bool plan_of(const SumArgs& x, Plan* plan) {
  int bounds[kMaxBlocks + 1] = {};
  if (x.blocks < 1 || x.blocks > kMaxBlocks) return false;
  for (int i = 0; i <= x.blocks; ++i) bounds[i] = static_cast<int>(x.bounds[i]);
  return make_plan(static_cast<int>(x.n), static_cast<int>(x.level), static_cast<int>(x.blocks),
                   bounds, plan);
}

}  // namespace

// The largest cluster the card schedules for a tile of tile_a rows of a
// and tile_b of b (0: one operand; tail: covariance_tail's 3 x 3); 0 for a
// tile with no kernel.
extern "C" int pcp_xla_sum_max_blocks(int tile_a, int tile_b, int tail) {
  LaunchFn fn;
  BlocksFn blocks;
  const bool ok = tail ? pick<true>(tile_a, tile_b, &fn, &blocks)
                       : pick<false>(tile_a, tile_b, &fn, &blocks);
  return ok ? blocks() : 0;
}

// Sums in XLA:CPU's order (ops.sum_like_xla): out [L, S, T] of a (and b).
// Rows of more than 32 values take a cluster a tile of rows, split by the
// host's plan.
extern "C" int pcp_xla_sum(const void* packed) {
  SumArgs x;
  memcpy(&x, packed, sizeof(x));
  const cudaStream_t st = static_cast<cudaStream_t>(x.stream);
  const Operand oa{x.a, x.sa_l, x.sa_s, x.sa_n};
  const Operand ob{x.b, x.sb_l, x.sb_s, x.sb_n};
  const int lead = static_cast<int>(x.lead), rows_a = static_cast<int>(x.rows_a);
  const int rows_b = x.b ? static_cast<int>(x.rows_b) : 1, n = static_cast<int>(x.n);
  if (n <= kWin) {
    const long long outs = static_cast<long long>(lead) * rows_a * rows_b;
    xla_sum_short<<<static_cast<unsigned>((outs + 255) / 256), 256, 0, st>>>(oa, ob, lead, rows_a,
                                                                            rows_b, n, x.out);
    return static_cast<int>(cudaGetLastError());
  }
  Plan plan;
  LaunchFn fn;
  BlocksFn max_fn;
  if (!plan_of(x, &plan) ||
      !pick<false>(static_cast<int>(x.tile_a), x.b ? static_cast<int>(x.tile_b) : 0, &fn,
                   &max_fn)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(oa, ob, lead, rows_a, rows_b, plan, x.out, Tail{}, st);
}

// RANSAC's refinement step for L scans (ops.ransac.covariance_tail): the
// covariance of a [L, 3, n] and b [L, 3, n], then plane_tail on it; one
// cluster a scan, every n.
extern "C" int pcp_covariance_tail(const void* packed) {
  SumArgs x;
  memcpy(&x, packed, sizeof(x));
  Plan plan;
  if (!plan_of(x, &plan)) return static_cast<int>(cudaErrorInvalidValue);
  const Tail tail{x.cen, x.n_inl, x.n_inl_s, x.normal, x.d, static_cast<int>(x.vmapped),
                  x.out_n, x.out_d};
  return launch<3, 3, true>(Operand{x.a, x.sa_l, x.sa_s, x.sa_n},
                            Operand{x.b, x.sb_l, x.sb_s, x.sb_n}, static_cast<int>(x.lead), 3, 3,
                            plan, nullptr, tail, static_cast<cudaStream_t>(x.stream));
}
