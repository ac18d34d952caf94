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
// product of the twins (ops.fma: the float64 product and sum, rounded once
// to float32) is that same float64 chain, and every float -> int32
// conversion saturates with NaN to 0 (ops.int32_like_xla, XLA's convert,
// which is also cvt.rzi.s32.f32's rule).
//
// shadow_slots: a block a (slot, scan).  Its threads stride over the scan's
// C points; a point of the slot (point_cluster == slot, valid) is taken to
// the sensor frame (the pose's inverse, quat_rotate's fused form,
// ops/transforms.py) and folded into the thread's first-index least x,
// greatest x, least and greatest y and count; a warp and then a block
// reduction join them.  Thread 0 then does the slot's geometry: vmin (point
// 0 for an empty slot, as argmin of an all-inf row), the lengths, the
// reference's tan(asin(a / c)) through libm32.cuh (XLA:CPU's asin and
// glibc's tanf, bit for bit), the end point, both points to the world
// frame and into cells (grid_cell_xy's closed form and fix-up steps,
// ops/occupancy.py), the sweep's shift and line count, and the line's
// steep and back swaps.  Out: [scans, M, 7] int32 (ops.shadow.LINE_FIELDS).
//
// shadow_raster: a thread a cell of [scans, H, W], the grid's y the scan.
// The block stages its scan's lines in shared memory, 256 at a time, with
// each line's gradient, float x0 and float y0; every thread then ORs the
// steep or shallow hit of each active line (ops/shadow.py's closed forms,
// int32 arithmetic wrapping as PyTorch's does) and writes its cell once:
// the opacity, or the input grid's value.
//
// Bound on the H100: bytes (the cloud's points, ids and valid flags, and
// the grid read and written, over 3.35 TB/s) against operations (B*H*W*M
// raster tests at the float32 rate); at M = 64 both are microseconds, and
// the two launches are latency: a block's serial geometry (two
// trigonometric calls, a few dozen dependent float64 steps) and one pass
// over a 12,120-cell grid.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "libm32.cuh"

namespace {

using pcp_libm::add;
using pcp_libm::div;
using pcp_libm::mul;
using pcp_libm::sub;

constexpr int kThreads = 256;
constexpr int kFields = 7;  // x0, y0, x1, y1, n_lines, steep, active

// ops.fma: the float64 product and sum, rounded once to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
}

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
  return {fma64(a.y, b.z, -mul(a.z, b.y)), fma64(a.z, b.x, -mul(a.x, b.z)),
          fma64(a.x, b.y, -mul(a.y, b.x))};
}

// quat_rotate: fma(w, t, v) + cross(u, t), t = 2 * cross(u, v)
__device__ __forceinline__ Vec3 rotate(Vec3 u, float w, Vec3 v) {
  Vec3 t = cross(u, v);
  t = {mul(2.0f, t.x), mul(2.0f, t.y), mul(2.0f, t.z)};
  const Vec3 c = cross(u, t);
  return {add(fma64(w, t.x, v.x), c.x), add(fma64(w, t.y, v.y), c.y),
          add(fma64(w, t.z, v.z), c.z)};
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
    if (fma64(add(cf, 1.0f), g.block, g.y_min) < y) col = wadd(col, 1);
    const float rf = __int2float_rn(row);
    if (fma64(-add(rf, 1.0f), g.block, g.x_max) > x) row = wadd(row, 1);
  }
  for (int i = 0; i < 2; ++i) {  // retreat while the previous step's condition fails
    const float cf = __int2float_rn(col);
    if (col > 0 && !(fma64(cf, g.block, g.y_min) < y)) col = wsub(col, 1);
    const float rf = __int2float_rn(row);
    if (row > 0 && !(fma64(-rf, g.block, g.x_max) > x)) row = wsub(row, 1);
  }
  *col_out = col;
  *row_out = row;
}

// PyTorch's reductions: NaN wins a max or a min; argmin takes the first
// least value (a NaN before any number), -0.0 == +0.0
__device__ __forceinline__ float nan_max(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ bool before(float xa, int ia, float xb, int ib) {
  const bool na = xa != xa, nb = xb != xb;
  if (na != nb) return na;
  if (xa < xb) return true;
  if (xb < xa) return false;
  return ia < ib;
}

struct Extremes {
  float x_least;
  int i_least;
  float x_max, y_min, y_max;
  int count;
};

__device__ __forceinline__ void join(Extremes& a, const Extremes& b) {
  if (before(b.x_least, b.i_least, a.x_least, a.i_least)) {
    a.x_least = b.x_least;
    a.i_least = b.i_least;
  }
  a.x_max = nan_max(a.x_max, b.x_max);
  a.y_min = nan_min(a.y_min, b.y_min);
  a.y_max = nan_max(a.y_max, b.y_max);
  a.count += b.count;
}

__device__ __forceinline__ Extremes shuffle_down(const Extremes& e, int o) {
  return {__shfl_down_sync(0xffffffffu, e.x_least, o), __shfl_down_sync(0xffffffffu, e.i_least, o),
          __shfl_down_sync(0xffffffffu, e.x_max, o), __shfl_down_sync(0xffffffffu, e.y_min, o),
          __shfl_down_sync(0xffffffffu, e.y_max, o), __shfl_down_sync(0xffffffffu, e.count, o)};
}

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

__global__ void __launch_bounds__(kThreads) shadow_slots(SlotArgs a) {
  const int slot = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* q = a.quat + static_cast<long long>(b) * a.pose_stride * 4;
  const float* t = a.trans + static_cast<long long>(b) * a.pose_stride * 3;
  const Pose world{{q[0], q[1], q[2]}, q[3], {t[0], t[1], t[2]}};
  const Pose sensor = inverse(world);
  const long long base = static_cast<long long>(b) * a.c;
  const float inf = __int_as_float(0x7f800000);

  // an all-inf row's argmin is point 0: every thread starts there
  Extremes e{inf, 0, -inf, inf, -inf, 0};
  for (int i = tid; i < a.c; i += kThreads) {
    if (a.point_cluster[base + i] != slot || !a.valid[base + i]) continue;
    const float* p = a.pts + (base + i) * 3;
    const Vec3 s = apply(sensor, {p[0], p[1], p[2]});
    if (before(s.x, i, e.x_least, e.i_least)) {
      e.x_least = s.x;
      e.i_least = i;
    }
    e.x_max = nan_max(e.x_max, s.x);
    e.y_min = nan_min(e.y_min, s.y);
    e.y_max = nan_max(e.y_max, s.y);
    e.count += 1;
  }
  for (int o = 16; o > 0; o >>= 1) join(e, shuffle_down(e, o));
  __shared__ Extremes warps[kThreads / 32];
  if ((tid & 31) == 0) warps[tid / 32] = e;
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) join(e, warps[w]);

  // the slot's geometry (ops/shadow.py shadow_end, slot_lines)
  const float* p = a.pts + (base + e.i_least) * 3;
  const Vec3 vmin = apply(sensor, {p[0], p[1], p[2]});
  const float bb = fabsf(vmin.x);
  const float c = __fsqrt_rn(fma64(vmin.z, vmin.z, mul(bb, bb)));
  const float v_len =
      __fsqrt_rn(fma64(vmin.z, vmin.z, fma64(vmin.y, vmin.y, mul(vmin.x, vmin.x))));
  const float e_len = add(sub(fabsf(e.x_max), bb), __int_as_float(0x3d23d70a));  // + 0.04f
  const float floor_len = __int_as_float(0x1e3ce508);                            // 1e-20f
  const float ratio = div(vmin.z, c < floor_len ? floor_len : c);  // clamp_min keeps NaN
  const float d = fma64(pcp_libm::tanf(pcp_libm::asin_like_xla(ratio)), e_len, 0.25f);
  const float len = v_len < floor_len ? floor_len : v_len;
  const Vec3 end{fma64(div(vmin.x, len), d, vmin.x), fma64(div(vmin.y, len), d, vmin.y),
                 fma64(div(vmin.z, len), d, vmin.z)};
  const Vec3 end_w = apply(world, end), start_w = apply(world, vmin);
  int e_col, e_row, s_col, s_row;
  grid_cell(end_w.x, end_w.y, a.grid, &e_col, &e_row);
  grid_cell(start_w.x, start_w.y, a.grid, &s_col, &s_row);

  const float per_block = mul(fabsf(sub(e.y_max, e.y_min)), a.grid.inv_block);
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
  const bool active = a.slot_valid[static_cast<long long>(b) * a.m + slot] && e.count >= 2;
  int* o = a.out + (static_cast<long long>(b) * a.m + slot) * kFields;
  o[0] = x0;
  o[1] = y0;
  o[2] = x1;
  o[3] = y1;
  o[4] = n_lines;
  o[5] = steep;
  o[6] = active;
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

__global__ void __launch_bounds__(kThreads) shadow_raster(const int8_t* grid, const int* lines,
                                                          int m, int h, int w, int8_t opacity,
                                                          int8_t* out) {
  __shared__ Line sl[kThreads];
  const int b = blockIdx.y;
  const int cell = blockIdx.x * kThreads + threadIdx.x;
  const int r = cell / w, col = cell - r * w;
  const int* lb = lines + static_cast<long long>(b) * m * kFields;
  bool hit = false;
  for (int first = 0; first < m; first += kThreads) {
    const int k = first + threadIdx.x;
    if (k < m) {
      const int* f = lb + static_cast<long long>(k) * kFields;
      Line l;
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
      sl[threadIdx.x] = l;
    }
    __syncthreads();
    const int count = min(kThreads, m - first);
    if (r < h) {
      for (int j = 0; j < count && !hit; ++j) {
        const Line& l = sl[j];
        if (!(l.flags & 2)) continue;
        if (l.flags & 1) {  // steep: the column band [fy(r) - (n - 1), fy(r) + 1] of rows x0..x1
          if (r >= l.x0 && r <= l.x1) {
            const int fy = line_y(l, r);
            hit = col >= wsub(fy, wsub(l.n, 1)) && col <= wadd(fy, 1);
          }
        } else {  // shallow: fy over [max(x0, c - 1), min(x1, c + n - 1)] spans these rows
          const int u_lo = max(l.x0, col - 1), u_hi = min(l.x1, wadd(col, wsub(l.n, 1)));
          if (u_lo <= u_hi) {
            const int lo = line_y(l, u_lo), hi = line_y(l, u_hi);
            hit = r >= min(lo, hi) && r <= max(lo, hi);
          }
        }
      }
    }
    __syncthreads();
  }
  if (r < h) {
    const long long i = static_cast<long long>(b) * h * w + cell;
    out[i] = hit ? opacity : grid[i];
  }
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
  SlotArgs a{pts, valid, point_cluster, slot_valid, quat, trans, pose_stride, c, m,
             {block, inv_block, y_min, x_max}, out};
  shadow_slots<<<dim3(m, scans), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcp_shadow_raster(const int8_t* grid, const int* lines, int scans, int m, int h,
                                 int w, int opacity, int8_t* out, void* stream) {
  if (scans <= 0 || h <= 0 || w <= 0) return 0;
  if (scans > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((static_cast<long long>(h) * w + kThreads - 1) / kThreads);
  shadow_raster<<<dim3(blocks, scans), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grid, lines, m, h, w, static_cast<int8_t>(opacity), out);
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
