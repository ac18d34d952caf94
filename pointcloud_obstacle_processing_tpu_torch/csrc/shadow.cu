// The shadow stage: each cluster slot's shadow line, then the grid's cells.
//
// Replaces no TPU kernel.  It carries the JAX package's plain-XLA shadow
// stage, cast_shadows (pointcloud_obstacle_processing_tpu/ops/shadow.py:
// per_cluster at 100-138, the closed-form sweep raster at 142-203), which
// XLA:CPU runs as one fused computation; in eager PyTorch it was a chain of
// small launches a scan (PERF.md counts them).  Both kernels are bitwise their plain twins
// (ops/shadow.py shadow_slots_plain and shadow_raster_plain): every float
// step is one IEEE operation rounded to nearest in the twins' operand
// order (the _rn intrinsics; the file builds with -fmad=false), each fused
// product of the twins (ops.fma, exact) is __fmaf_rn, and every float ->
// int32 conversion saturates with NaN to 0 (ops.int32_like_xla, XLA's
// convert, which is also cvt.rzi.s32.f32's rule).
//
// shadow_slots: one thread-block cluster a scan (the grid's y), of G
// blocks of 1,024 threads, G = ceil(C / 2,048) up to 8 (C = 16,384: 8
// blocks, 2 points a thread; C <= 2,048: one block).  Each block inverts
// the pose once and reads its share of the scan's ids, valid flags and
// member points once, coalesced; a point of a slot (point_cluster == slot
// in [0, M), valid) is taken to the sensor frame (quat_rotate's fused
// form, ops/transforms.py) and folded into the block's record of the slot
// in shared memory: the first least x as a 64-bit key (order-preserving x
// bits, index; NaN first, -0.0 == +0.0), the greatest x and the least and
// greatest y as order-preserving integers with a NaN flag that wins, the
// count.  A warp whose points all lie in one slot (a cluster's points
// lie together in the buffer) reduces them first (__reduce_*_sync) and
// its first lane takes one set of atomics; in a mixed warp each point
// takes its own (min, max, add, or: the record does not depend on the
// order).  After a cluster barrier, block rank 0 joins the other
// blocks' records through distributed shared memory in rank order, then
// runs the geometry of every slot at once, a thread a slot: vmin (point 0
// for an empty slot, as argmin of an all-inf row), the lengths, the
// reference's tan(asin(a / c)) through libm32.cuh (XLA:CPU's asin and
// glibc's tanf, bit for bit), the end point, both points to the world
// frame and into cells (grid_cell_xy's closed form and fix-up steps,
// ops/occupancy.py), the sweep's shift and line count, and the line's
// steep and back swaps.  Out: [scans, M, 7] int32 (ops.shadow.LINE_FIELDS).
// No global scratch, no memset, one launch.
//
// shadow_raster: a block a tile of 8 x 16 cells of one scan (the grid's y),
// a thread a cell.  The block takes its scan's lines, a line a thread, 128
// at a time: each line's gradient, float x0 and float y0, and the box of
// cells its sweep can hit (steep: rows x0..x1, columns from line_y
// at the two ends widened by n - 1 below and 1 above; shallow: columns
// x0 - (n - 1)..x1 + 1, rows between line_y at the ends; line_y is monotone
// in u, float rounding and the saturating conversion included, so its ends
// bound it).  A line whose per-cell int32 arithmetic could wrap (n =
// INT_MIN, or ends near the int32 limits) goes on every tile's list.  The
// active lines whose box meets the tile are compacted, in order, into a
// list in shared memory (__ballot_sync and a prefix count); each thread ORs
// the steep or shallow hit of the listed lines only (ops/shadow.py's
// closed forms, int32 arithmetic wrapping as PyTorch's does) and writes
// each cell once: the opacity, or the input grid's value.
//
// Bound on the H100: bytes (the cloud's points, ids and valid flags, and
// the grid read and written, over 3.35 TB/s) against operations (B*H*W*M
// raster tests at the float32 rate); at M = 64 both are microseconds, and
// the two launches are latency: a slot's serial geometry on one thread (two
// trigonometric calls, a few dozen dependent steps) and one pass over a
// 12,120-cell grid, where the cull leaves each cell a few lines to test.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "libm32.cuh"

namespace cg = cooperative_groups;

namespace {

using pcp_libm::add;
using pcp_libm::div;
using pcp_libm::mul;
using pcp_libm::sub;

constexpr int kThreads = 256;  // the libm32 test entry's block
constexpr int kFields = 7;  // x0, y0, x1, y1, n_lines, steep, active
// the slot kernel: a cluster of up to kMaxSlotBlocks blocks a scan, one
// block for each kSlotPointsPerThread * kSlotThreads points
constexpr int kSlotThreads = 1024;
constexpr int kSlotPointsPerThread = 2;
constexpr int kMaxSlotBlocks = 8;  // the portable cluster size
constexpr size_t kSlotSmemDefault = 48 * 1024;

// int32 arithmetic that wraps, as PyTorch's does
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wabs(int a) { return a < 0 ? wsub(0, a) : a; }

// ops.int32_like_xla
__device__ __forceinline__ int to_int32(float v) {
  if (v != v) return 0;
  if (v >= 2147483648.0f) return INT_MAX;
  if (v <= -2147483648.0f) return INT_MIN;
  return __float2int_rz(v);
}

struct Vec3 {
  float x, y, z;
};

// ops/transforms.py _cross: component k is fma(a[k+1], b[k+2], -(a[k+2] * b[k+1]))
__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {__fmaf_rn(a.y, b.z, -mul(a.z, b.y)), __fmaf_rn(a.z, b.x, -mul(a.x, b.z)),
          __fmaf_rn(a.x, b.y, -mul(a.y, b.x))};
}

// quat_rotate: fma(w, t, v) + cross(u, t), t = 2 * cross(u, v)
__device__ __forceinline__ Vec3 rotate(Vec3 u, float w, Vec3 v) {
  Vec3 t = cross(u, v);
  t = {mul(2.0f, t.x), mul(2.0f, t.y), mul(2.0f, t.z)};
  const Vec3 c = cross(u, t);
  return {add(__fmaf_rn(w, t.x, v.x), c.x), add(__fmaf_rn(w, t.y, v.y), c.y),
          add(__fmaf_rn(w, t.z, v.z), c.z)};
}

struct Pose {
  Vec3 u;
  float w;
  Vec3 t;
};

__device__ __forceinline__ Vec3 apply(const Pose& p, Vec3 v) {
  const Vec3 r = rotate(p.u, p.w, v);
  return {add(r.x, p.t.x), add(r.y, p.t.y), add(r.z, p.t.z)};
}

// RigidTransform.inverse: the conjugate, and -rotate(conjugate, t)
__device__ __forceinline__ Pose inverse(const Pose& p) {
  Pose q{{-p.u.x, -p.u.y, -p.u.z}, p.w, {0.0f, 0.0f, 0.0f}};
  const Vec3 r = rotate(q.u, q.w, p.t);
  q.t = {-r.x, -r.y, -r.z};
  return q;
}

struct Grid {
  float block, inv_block, y_min, x_max;
};

// ops/occupancy.py grid_cell_xy for a world (x, y)
__device__ void grid_cell(float x, float y, const Grid& g, int* col_out, int* row_out) {
  float cc = sub(ceilf(mul(sub(y, g.y_min), g.inv_block)), 1.0f);
  float rr = sub(ceilf(mul(sub(g.x_max, x), g.inv_block)), 1.0f);
  int col = to_int32(cc < 0.0f ? 0.0f : cc);  // clamp_min(., 0) keeps NaN
  int row = to_int32(rr < 0.0f ? 0.0f : rr);
  for (int i = 0; i < 2; ++i) {  // advance while the loop condition still holds
    const float cf = __int2float_rn(col);
    if (__fmaf_rn(add(cf, 1.0f), g.block, g.y_min) < y) col = wadd(col, 1);
    const float rf = __int2float_rn(row);
    if (__fmaf_rn(-add(rf, 1.0f), g.block, g.x_max) > x) row = wadd(row, 1);
  }
  for (int i = 0; i < 2; ++i) {  // retreat while the previous step's condition fails
    const float cf = __int2float_rn(col);
    if (col > 0 && !(__fmaf_rn(cf, g.block, g.y_min) < y)) col = wsub(col, 1);
    const float rf = __int2float_rn(row);
    if (row > 0 && !(__fmaf_rn(-rf, g.block, g.x_max) > x)) row = wsub(row, 1);
  }
  *col_out = col;
  *row_out = row;
}

// PyTorch's reductions as order-independent integer atomics: a float's
// bits mapped so that unsigned order is float order (-inf lowest, +inf
// highest; NaN apart, as a flag or as key 0)
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// argmin's key of a sensor x at point i: the first least value, a NaN
// before any number, -0.0 == +0.0 (then the lower index wins)
__device__ __forceinline__ unsigned least_key(float x) {
  return x != x ? 0u : ordered(x == 0.0f ? 0.0f : x);
}

constexpr unsigned kNanX = 1, kNanY = 2;  // a NaN wins the max of x, the min and max of y

// a slot's points folded so far, in shared memory
struct SlotRecord {
  unsigned long long least;  // (least_key(x) << 32) | index: the first least sensor x
  unsigned x_max, y_min, y_max;  // ordered()
  int count;
  unsigned nan;  // kNanX | kNanY
};

struct SlotArgs {
  const float* pts;         // [scans, C, 3]
  const bool* valid;        // [scans, C]
  const int* point_cluster; // [scans, C]
  const bool* slot_valid;   // [scans, M]
  const float* quat;        // [P, 4] xyzw
  const float* trans;       // [P, 3]
  int pose_stride;          // 0: one pose for every scan; 1: one a scan
  int c, m;
  Grid grid;
  int* out;                 // [scans, M, 7]
};

// the slot's geometry from its joined record (ops/shadow.py shadow_end,
// slot_lines); vmin is point 0 for an empty slot, as argmin of an all-inf
// row
__device__ void slot_geometry(const SlotArgs& a, int b, int slot, const Pose& world,
                              const Pose& sensor, const SlotRecord& r) {
  const float nan = __int_as_float(0x7fc00000);
  const float x_max = (r.nan & kNanX) ? nan : unordered(r.x_max);
  const float y_min = (r.nan & kNanY) ? nan : unordered(r.y_min);
  const float y_max = (r.nan & kNanY) ? nan : unordered(r.y_max);
  const long long base = static_cast<long long>(b) * a.c;
  const float* p = a.pts + (base + static_cast<unsigned>(r.least & 0xffffffffu)) * 3;
  const Vec3 vmin = apply(sensor, {p[0], p[1], p[2]});
  const float bb = fabsf(vmin.x);
  const float c = __fsqrt_rn(__fmaf_rn(vmin.z, vmin.z, mul(bb, bb)));
  const float v_len =
      __fsqrt_rn(__fmaf_rn(vmin.z, vmin.z, __fmaf_rn(vmin.y, vmin.y, mul(vmin.x, vmin.x))));
  const float e_len = add(sub(fabsf(x_max), bb), __int_as_float(0x3d23d70a));  // + 0.04f
  const float floor_len = __int_as_float(0x1e3ce508);                          // 1e-20f
  const float ratio = div(vmin.z, c < floor_len ? floor_len : c);  // clamp_min keeps NaN
  const float d = __fmaf_rn(pcp_libm::tanf(pcp_libm::asin_like_xla(ratio)), e_len, 0.25f);
  const float len = v_len < floor_len ? floor_len : v_len;
  const Vec3 end{__fmaf_rn(div(vmin.x, len), d, vmin.x), __fmaf_rn(div(vmin.y, len), d, vmin.y),
                 __fmaf_rn(div(vmin.z, len), d, vmin.z)};
  const Vec3 end_w = apply(world, end), start_w = apply(world, vmin);
  int e_col, e_row, s_col, s_row;
  grid_cell(end_w.x, end_w.y, a.grid, &e_col, &e_row);
  grid_cell(start_w.x, start_w.y, a.grid, &s_col, &s_row);

  // the width's sign of zero does not matter: only its magnitude is used
  const float per_block = mul(fabsf(sub(y_max, y_min)), a.grid.inv_block);
  const int shift = to_int32(ceilf(mul(per_block, 0.5f)));
  const int n_lines = wadd(to_int32(ceilf(per_block)), 3);
  int x0 = wadd(s_col, shift), y0 = s_row, x1 = wadd(e_col, shift), y1 = e_row;
  const bool steep = wabs(wsub(y1, y0)) > wabs(wsub(x1, x0));
  if (steep) {
    int t = x0; x0 = y0; y0 = t;
    t = x1; x1 = y1; y1 = t;
  }
  if (x0 > x1) {
    int t = x0; x0 = x1; x1 = t;
    t = y0; y0 = y1; y1 = t;
  }
  const bool active = a.slot_valid[static_cast<long long>(b) * a.m + slot] && r.count >= 2;
  int* o = a.out + (static_cast<long long>(b) * a.m + slot) * kFields;
  o[0] = x0;
  o[1] = y0;
  o[2] = x1;
  o[3] = y1;
  o[4] = n_lines;
  o[5] = steep;
  o[6] = active;
}

__global__ void __launch_bounds__(kSlotThreads) shadow_slots(SlotArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  extern __shared__ SlotRecord rec[];  // [M]

  const float* q = a.quat + static_cast<long long>(b) * a.pose_stride * 4;
  const float* t = a.trans + static_cast<long long>(b) * a.pose_stride * 3;
  const Pose world{{q[0], q[1], q[2]}, q[3], {t[0], t[1], t[2]}};
  const Pose sensor = inverse(world);
  const long long base = static_cast<long long>(b) * a.c;

  // an all-inf row's argmin is point 0: every slot starts there
  for (int s = tid; s < a.m; s += kSlotThreads) {
    const unsigned inf = ordered(__uint_as_float(0x7f800000u));
    const unsigned minus_inf = ordered(__uint_as_float(0xff800000u));
    rec[s] = {static_cast<unsigned long long>(inf) << 32, minus_inf, inf, minus_inf, 0, 0u};
  }
  __syncthreads();

  // this block's share of the scan's points, each read once, folded into
  // the slots' records by min, max, add and or: the records do not depend
  // on the order
  const int share = (a.c + blocks - 1) / blocks;
  const int lo = rank * share, hi = min(a.c, lo + share);
  for (int first = lo; first < hi; first += kSlotThreads) {
    const int i = first + tid;
    int slot = -1;
    if (i < hi && a.valid[base + i]) slot = a.point_cluster[base + i];
    const bool member = slot >= 0 && slot < a.m;
    unsigned kx = ~0u, kx_max = 0u, ky_min = ~0u, ky_max = 0u, nan = 0u;
    if (member) {
      const float* p = a.pts + (base + i) * 3;
      const Vec3 s = apply(sensor, {p[0], p[1], p[2]});
      kx = least_key(s.x);
      if (s.x != s.x) nan |= kNanX; else kx_max = ordered(s.x);
      if (s.y != s.y) nan |= kNanY; else ky_min = ky_max = ordered(s.y);
    }
    // a warp whose points all lie in one slot reduces them first and takes
    // one set of atomics; a mixed warp takes a set a point
    const unsigned members = __ballot_sync(0xffffffffu, member);
    if (!members) continue;
    const int first_lane = __ffs(members) - 1;
    const int s0 = __shfl_sync(0xffffffffu, slot, first_lane);
    const bool uniform = __ballot_sync(0xffffffffu, member && slot == s0) == members;
    unsigned index = static_cast<unsigned>(i);
    int count = 1;
    if (uniform) {  // non-members hold the identities
      const unsigned least_x = __reduce_min_sync(0xffffffffu, kx);
      index = __reduce_min_sync(0xffffffffu, member && kx == least_x ? index : ~0u);
      kx = least_x;
      kx_max = __reduce_max_sync(0xffffffffu, kx_max);
      ky_min = __reduce_min_sync(0xffffffffu, ky_min);
      ky_max = __reduce_max_sync(0xffffffffu, ky_max);
      nan = __reduce_or_sync(0xffffffffu, nan);
      count = __popc(members);
    }
    if (uniform ? lane == first_lane : member) {
      SlotRecord& r = rec[slot];
      atomicMin(&r.least, (static_cast<unsigned long long>(kx) << 32) | index);
      atomicMax(&r.x_max, kx_max);
      atomicMin(&r.y_min, ky_min);
      atomicMax(&r.y_max, ky_max);
      atomicAdd(&r.count, count);
      if (nan) atomicOr(&r.nan, nan);
    }
  }
  cluster.sync();  // every block's records are complete

  // rank 0 joins the other blocks' records in rank order, a thread a slot
  if (rank == 0) {
    for (int s = tid; s < a.m; s += kSlotThreads) {
      SlotRecord r = rec[s];
      for (int k = 1; k < blocks; ++k) {
        const SlotRecord* o = cluster.map_shared_rank(rec, k) + s;
        r.least = min(r.least, o->least);
        r.x_max = max(r.x_max, o->x_max);
        r.y_min = min(r.y_min, o->y_min);
        r.y_max = max(r.y_max, o->y_max);
        r.count += o->count;
        r.nan |= o->nan;
      }
      rec[s] = r;
    }
  }
  cluster.sync();  // the other blocks' records stay until rank 0 has read them
  if (rank != 0) return;
  for (int s = tid; s < a.m; s += kSlotThreads) slot_geometry(a, b, s, world, sensor, rec[s]);
}

struct Line {
  int x0, x1, y0, n;
  int flags;  // 1: steep, 2: active
  float g, fx0, fy0;
};

// the line's y at integer x = u: floor(y0 + g * (u - x0))
__device__ __forceinline__ int line_y(const Line& l, int u) {
  return to_int32(floorf(add(l.fy0, mul(l.g, sub(__int2float_rn(u), l.fx0)))));
}

// whether a cell (row r, column col) lies in the line's sweep
__device__ __forceinline__ bool line_hits(const Line& l, int r, int col) {
  if (l.flags & 1) {  // steep: the column band [fy(r) - (n - 1), fy(r) + 1] of rows x0..x1
    if (r < l.x0 || r > l.x1) return false;
    const int fy = line_y(l, r);
    return col >= wsub(fy, wsub(l.n, 1)) && col <= wadd(fy, 1);
  }
  // shallow: fy over [max(x0, c - 1), min(x1, c + n - 1)] spans these rows
  const int u_lo = max(l.x0, col - 1), u_hi = min(l.x1, wadd(col, wsub(l.n, 1)));
  if (u_lo > u_hi) return false;
  const int lo = line_y(l, u_lo), hi = line_y(l, u_hi);
  return r >= min(lo, hi) && r <= max(lo, hi);
}

// the cells a line's sweep can hit: rows [r0, r1] and columns [c0, c1] (in
// int64: no wrap), or every cell where its per-cell int32 arithmetic could
// wrap, for a grid w columns wide
struct Box {
  long long r0, r1, c0, c1;
  bool all;
};

__device__ __forceinline__ bool fits_int32(long long v) { return v >= INT_MIN && v <= INT_MAX; }

__device__ Box line_box(const Line& l, int w) {
  const long long n1 = static_cast<long long>(l.n) - 1;
  const long long ya = line_y(l, l.x0), yb = line_y(l, l.x1);
  const long long lo_y = min(ya, yb), hi_y = max(ya, yb);
  if (l.flags & 1) {  // wsub(fy, n - 1) and wadd(fy, 1) for fy in [lo_y, hi_y]
    const bool wraps = !fits_int32(n1) || !fits_int32(lo_y - n1) || !fits_int32(hi_y - n1) ||
                       !fits_int32(hi_y + 1);
    return {l.x0, l.x1, lo_y - n1, hi_y + 1, wraps};
  }
  // wadd(col, n - 1) for col in [0, w - 1]
  const bool wraps = !fits_int32(n1) || !fits_int32(w - 1 + n1);
  return {lo_y, hi_y, l.x0 - n1, static_cast<long long>(l.x1) + 1, wraps};
}

constexpr int kTileRows = 8, kTileCols = 16;  // the raster's tile, a thread a cell
constexpr int kRasterThreads = kTileRows * kTileCols;

__global__ void __launch_bounds__(kRasterThreads) shadow_raster(const int8_t* grid,
                                                                const int* lines, int m, int h,
                                                                int w, int tiles_w,
                                                                int8_t opacity, int8_t* out) {
  constexpr int kWarps = kRasterThreads / 32;
  __shared__ Line sl[kRasterThreads];
  __shared__ int listed_before[kWarps + 1];
  const int b = blockIdx.y;
  const int tr = blockIdx.x / tiles_w, tc = blockIdx.x - tr * tiles_w;
  const int r0 = tr * kTileRows, c0 = tc * kTileCols;
  const int r = r0 + threadIdx.x / kTileCols, col = c0 + threadIdx.x % kTileCols;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* lb = lines + static_cast<long long>(b) * m * kFields;
  const bool inside = r < h && col < w;
  const long long cell = (static_cast<long long>(b) * h + r) * w + col;
  const int8_t before = inside ? grid[cell] : 0;  // read early: its latency hides behind the lines
  bool hit = false;
  for (int first = 0; first < m; first += kRasterThreads) {
    // a thread a line: its gradient, float ends and box
    const int k = first + threadIdx.x;
    Line l;
    bool listed = false;
    if (k < m) {
      const int* f = lb + static_cast<long long>(k) * kFields;
      l.x0 = f[0];
      l.y0 = f[1];
      l.x1 = f[2];
      l.n = f[4];
      l.flags = (f[5] != 0) | ((f[6] != 0) << 1);
      const float dx = __int2float_rn(wsub(f[2], f[0]));
      const float dy = __int2float_rn(wsub(f[3], f[1]));
      l.g = dx == 0.0f ? 1.0f : div(dy, dx);
      l.fx0 = __int2float_rn(l.x0);
      l.fy0 = __int2float_rn(l.y0);
      if (l.flags & 2) {
        const Box box = line_box(l, w);
        listed = box.all || (box.r0 <= r0 + kTileRows - 1 && box.r1 >= r0 &&
                             box.c0 <= c0 + kTileCols - 1 && box.c1 >= c0);
      }
    }
    // the tile's lines, compacted in order
    const unsigned ballot = __ballot_sync(0xffffffffu, listed);
    if (lane == 0) listed_before[warp + 1] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      listed_before[0] = 0;
      for (int i = 1; i <= kWarps; ++i) listed_before[i] += listed_before[i - 1];
    }
    __syncthreads();
    if (listed) sl[listed_before[warp] + __popc(ballot & ((1u << lane) - 1u))] = l;
    const int count = listed_before[kWarps];
    __syncthreads();
    for (int i = 0; i < count && !hit; ++i) hit = line_hits(sl[i], r, col);
    __syncthreads();
  }
  if (inside) out[cell] = hit ? opacity : before;
}

// test entry: one libm32.cuh routine over n values (0: asin_like_xla(a),
// 1: tanf(a), 2: atan2f(a, b))
__global__ void libm32_eval(const float* a, const float* b, long long n, int fn, float* out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = a[i];
    out[i] = fn == 0 ? pcp_libm::asin_like_xla(v)
                     : (fn == 1 ? pcp_libm::tanf(v) : pcp_libm::atan2f<false>(v, b[i]));
  }
}

}  // namespace

extern "C" int pcp_shadow_slots(const float* pts, const bool* valid, const int* point_cluster,
                                const bool* slot_valid, const float* quat, const float* trans,
                                int pose_stride, int scans, int c, int m, float block,
                                float inv_block, float y_min, float x_max, int* out, void* stream) {
  if (scans <= 0 || m <= 0) return 0;
  if (scans > 65535 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(m) * sizeof(SlotRecord);
  if (smem > kSlotSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        shadow_slots, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  SlotArgs a{pts, valid, point_cluster, slot_valid, quat, trans, pose_stride, c, m,
             {block, inv_block, y_min, x_max}, out};
  const long long per_block = static_cast<long long>(kSlotThreads) * kSlotPointsPerThread;
  const int blocks = static_cast<int>(
      (c + per_block - 1) / per_block < kMaxSlotBlocks ? (c + per_block - 1) / per_block
                                                       : kMaxSlotBlocks);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, scans);
  cfg.blockDim = dim3(kSlotThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, shadow_slots, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int pcp_shadow_raster(const int8_t* grid, const int* lines, int scans, int m, int h,
                                 int w, int opacity, int8_t* out, void* stream) {
  if (scans <= 0 || h <= 0 || w <= 0) return 0;
  if (scans > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_w = (w + kTileCols - 1) / kTileCols, tiles_h = (h + kTileRows - 1) / kTileRows;
  shadow_raster<<<dim3(tiles_w * tiles_h, scans), kRasterThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(grid, lines, m, h, w, tiles_w,
                                                       static_cast<int8_t>(opacity), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcp_libm32(const float* a, const float* b, long long n, int fn, float* out,
                          void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  libm32_eval<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a, b, n, fn, out);
  return static_cast<int>(cudaGetLastError());
}
