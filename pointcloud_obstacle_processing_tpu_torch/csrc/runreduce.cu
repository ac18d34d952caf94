// Sorted-run segmented reduce + compaction (kernel K1).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/pallas_runreduce.py:
// _kernel, _kernel2w and _kernel8 (launched by _pallas_batched,
// _pallas_batched2w and _pallas_batched8; entry point sorted_run_reduce).
//
// Input: a batch of B key-sorted buffers, one a scan, each reduced on its
// own (B = 1 for one scan; the reference's _kernel8 reduced eight batch
// rows a grid step to fill the TPU's sublanes, here the scan is a grid
// dimension).  Each buffer (sentinel keys for invalid rows, sorted last)
// and its payloads: three float32 offset buffers, or two int32 buffers with
// 16-bit fixed-point offsets (x in pxy's high half, y in its low half, z in
// pz) decoded here with a logical shift.  Counts mode (the reference's fourth
// value buffer, _kernel :162-163, _kernel2w :488, _xla_fallback :693; the
// voxel-table merges): a fourth float32 buffer of per-row counts, which the
// count channel loads (0 for invalid rows) where it otherwise takes an
// implicit 1; the same launch, one more pointer, every add unchanged, so
// all-ones counts give the three-buffer result bit for bit.  Output: for each run of equal keys,
// (key as f32, sum_x, sum_y, sum_z, count) at slot = rank of the run, for
// the first `capacity` runs, and the run count `num`.  Slots at or past
// `num` are not written.
//
// The bits are those of the reference's _xla_fallback: windows of W rows,
// a Hillis-Steele shift+add scan inside each window (step d adds
// `f_i ? 0 : v_{i-d}`, the "+ 0.0" of masked steps included), and one carry
// add for each row before the window's first head, the carries chained
// window after window (c_{t+1} = lastcol_t + (window t has no head ? c_t :
// 0)).  The TPU kernel walked the windows in grid order; here one launch
// does it all, one block per window:
//   * a block takes its window from one atomic ticket over the whole batch,
//     scan-major (ticket T is window T % steps of scan T / steps), so every
//     window before it in its scan is running or done; the look-back never
//     leaves the block's scan;
//   * head and end flags come from skey[g-1], skey[g], skey[g+1].  The
//     flag of row i at step d is "a head in (i-d, i]", i.e. the last head
//     at or before i lies past i-d, from one block-wide max-scan;
//   * each thread holds R consecutive rows in registers.  The steps d < R
//     run in the thread over its rows and the R-1 rows before them (loaded
//     again, not exchanged: those rows' values are exact wherever a row of
//     the thread reads them); the wider steps go through shared memory,
//     laid out row-in-thread major so the float4 accesses do not collide
//     (two buffers in turn, one barrier a step instead of two, measured
//     no faster);
//   * decoupled look-back over windows: each window publishes its run-end
//     count at once and its exclusive prefix when known (one warp reads 32
//     predecessors at a time); and its carry, at once where the window
//     holds a head (c_{t+1} = lastcol_t + 0 does not depend on earlier
//     windows), else its last column, from which a successor that needs
//     the carry evaluates the reference's chain in its order;
//   * each run end is written from registers to slot = run ends before the
//     window + its rank in the window.
// The workspace (one ticket; count and carry status for each window of
// each scan) is cleared by one memset on the stream before the launch.  Built with -fmad=false; every add is
// __fadd_rn in the reference's operand order.
//
// Bound on the H100: keys and payloads are read once and [cap, 5] written
// (2.4 MB flagship, 30 MB fullscale, 0.7 / 9 us at HBM rate).  The scan's
// shared-memory traffic, W * 32 bytes a wide step, the block's barriers
// (64 registers a thread at W = 4096: one 1024-thread block an SM) and the
// look-back's L2 round trips set the time above that.  The flagship batch
// of 32 (3,136 windows) reads 38.5 MB, 0.016 ms at HBM rate; it took
// 0.062 ms of device time on an H100 80GB HBM3 at 700 W (chip_smoke.py).

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

struct Workspace {
  float4* carry_agg;                 // [steps] last column of a window with no head
  float4* carry_inc;                 // [steps] carry into the next window
  unsigned long long* count_status;  // [steps] flag << 32 | run ends
  int* carry_flag;                   // [steps] 0 none, 1 carry_agg set, 2 carry_inc set
  int* ticket;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 load_row(const void* pay_a, const void* pay_b,
                                           const float* pay_c, const float* pay_d, int packed,
                                           float quantum, int g, bool valid) {
  if (packed) {
    const unsigned pxy = static_cast<unsigned>(static_cast<const int*>(pay_a)[g]);
    const int pz = static_cast<const int*>(pay_b)[g];
    return make_float4(__fmul_rn(static_cast<float>(pxy >> 16), quantum),
                       __fmul_rn(static_cast<float>(pxy & 0xFFFFu), quantum),
                       __fmul_rn(static_cast<float>(pz), quantum), valid ? 1.0f : 0.0f);
  }
  const float count = pay_d ? (valid ? pay_d[g] : 0.0f) : (valid ? 1.0f : 0.0f);
  return make_float4(static_cast<const float*>(pay_a)[g], static_cast<const float*>(pay_b)[g],
                     pay_c[g], count);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

template <int R>
__global__ void __launch_bounds__(1024)
rr_window(const int* __restrict__ skey, const void* __restrict__ pay_a,
          const void* __restrict__ pay_b, const float* __restrict__ pay_c,
          const float* __restrict__ pay_d, int packed, float quantum, int n, int w,
          int sentinel, int capacity, Workspace ws,
          float* __restrict__ out, int* __restrict__ num) {
  extern __shared__ float4 sval[];  // [R][T]: row i0 + r of thread tid at r * T + tid
  __shared__ int s_t, s_excl;
  __shared__ int s_wcnt[32], s_wmax[32], s_wfh[32], s_wfe[32];
  __shared__ float4 s_last, s_carry;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  if (tid == 0) s_t = atomicAdd(ws.ticket, 1);
  __syncthreads();
  // scan b, window t: the scan's buffers, outputs and status words
  const int steps = n / w;
  const int b = s_t / steps;
  const int t = s_t % steps;
  const size_t row0 = static_cast<size_t>(b) * n;
  skey += row0;
  pay_a = static_cast<const int*>(pay_a) + row0;  // int32 or float32: 4 bytes a row
  pay_b = static_cast<const int*>(pay_b) + row0;
  if (pay_c) pay_c += row0;
  if (pay_d) pay_d += row0;
  out += static_cast<size_t>(b) * capacity * 5;
  num += b;
  ws.carry_agg += b * steps;
  ws.carry_inc += b * steps;
  ws.count_status += b * steps;
  ws.carry_flag += b * steps;
  const int base = t * w;
  const int i0 = tid * R;  // first local row of this thread

  // keys of local rows i0 - R .. i0 + R; array row m is local row i0 - R + m
  int key[2 * R + 1];
#pragma unroll
  for (int m = 0; m < 2 * R + 1; ++m) {
    const int g = base + i0 - R + m;
    key[m] = g < 0 ? -1 : (g >= n ? -2 : skey[g]);
  }
  float4 v[2 * R - 1];
  int lh[2 * R - 1];
  bool own_end[R];
  int cnt = 0, tmax = -1, tfh = w, tfe = w;
  int last = -1;  // last head among the R-1 rows before the thread's rows
#pragma unroll
  for (int m = 0; m < 2 * R - 1; ++m) {
    const int loc = i0 - (R - 1) + m;
    const int k = key[m + 1];
    const bool valid = k < sentinel;
    const bool head = loc >= 0 && valid && k != key[m];
    v[m] = loc >= 0 ? load_row(pay_a, pay_b, pay_c, pay_d, packed, quantum, base + loc, valid)
                    : zero;
    if (m < R - 1) {
      if (head) last = loc;
      lh[m] = last;
    } else {
      const bool end = valid && k != key[m + 2];
      own_end[m - (R - 1)] = end;
      if (head) {
        tmax = loc;
        tfh = min(tfh, loc);
      }
      if (end) {
        ++cnt;
        tfe = min(tfe, loc);
      }
    }
  }

  // block scan: exclusive run-end count and last head before each thread;
  // window totals, first head, first run end
  int incl_cnt = cnt, incl_max = tmax;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int c = __shfl_up_sync(0xffffffffu, incl_cnt, o);
    const int mx = __shfl_up_sync(0xffffffffu, incl_max, o);
    if (lane >= o) {
      incl_cnt += c;
      incl_max = max(incl_max, mx);
    }
  }
  const int wfh = __reduce_min_sync(0xffffffffu, static_cast<unsigned>(tfh));
  const int wfe = __reduce_min_sync(0xffffffffu, static_cast<unsigned>(tfe));
  if (lane == 31) {
    s_wcnt[warp] = incl_cnt;
    s_wmax[warp] = incl_max;
    s_wfh[warp] = wfh;
    s_wfe[warp] = wfe;
  }
  __syncthreads();
  int pre_cnt = 0, pre_max = -1, total = 0, first_head = w, first_end = w, whole_max = -1;
  for (int k = 0; k < nwarps; ++k) {
    if (k < warp) {
      pre_cnt += s_wcnt[k];
      pre_max = max(pre_max, s_wmax[k]);
    }
    total += s_wcnt[k];
    whole_max = max(whole_max, s_wmax[k]);
    first_head = min(first_head, s_wfh[k]);
    first_end = min(first_end, s_wfe[k]);
  }
  const int excl_cnt = pre_cnt + incl_cnt - cnt;
  int excl_max = __shfl_up_sync(0xffffffffu, incl_max, 1);
  excl_max = lane ? max(pre_max, excl_max) : pre_max;
  const bool has_head = whole_max >= 0;

  // publish this window's run-end count before any wait
  if (tid == 0) {
    volatile unsigned long long* st = ws.count_status + t;
    *st = (t == 0 ? kInclusive : kAggregate) | static_cast<unsigned>(total);
  }

  // last head at or before each of the thread's rows
  {
    int run = excl_max;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int loc = i0 + r;
      const int k = key[R + r];
      if (k < sentinel && k != key[R - 1 + r]) run = loc;
      lh[R - 1 + r] = run;
    }
  }

  // steps d < R inside the thread (descending rows: each reads the step before)
#pragma unroll
  for (int d = 1; d < R; d <<= 1) {
#pragma unroll
    for (int m = 2 * R - 2; m >= d; --m) {
      const int loc = i0 - (R - 1) + m;
      v[m] = add4(v[m], lh[m] > loc - d ? zero : v[m - d]);
    }
  }
  float4 o[R];
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] = v[R - 1 + r];
  // steps d >= R through shared memory; d is a multiple of R, so row i - d
  // sits at the same r in thread tid - d / R
  for (int d = R; d < w; d <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) sval[r * T + tid] = o[r];
    __syncthreads();
    const int back = tid - d / R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 s = back >= 0 ? sval[r * T + back] : zero;
      o[r] = add4(o[r], lh[R - 1 + r] > i0 + r - d ? zero : s);
    }
    __syncthreads();
  }
  if (tid == T - 1) s_last = o[R - 1];
  __syncthreads();

  if (warp == 0) {
    // carry out: at once where the window holds a head (or is the first)
    if (tid == 0) {
      if (has_head || t == 0) {
        ws.carry_inc[t] = add4(s_last, zero);
        __threadfence();
        *reinterpret_cast<volatile int*>(ws.carry_flag + t) = 2;
      } else {
        ws.carry_agg[t] = s_last;
        __threadfence();
        *reinterpret_cast<volatile int*>(ws.carry_flag + t) = 1;
      }
    }
    // run ends before this window: look back 32 windows at a time
    int excl = 0;
    for (int p = t - 1; p >= 0; p -= 32) {
      const int q = p - lane;
      unsigned long long st = kInclusive;
      if (q >= 0) {
        do {
          st = load_status(ws.count_status + q);
        } while ((st >> 32) == 0);
      }
      const unsigned inc = __ballot_sync(0xffffffffu, (st >> 32) == 2);
      const int stop = inc ? __ffs(inc) - 1 : 32;
      int val = lane <= stop ? static_cast<int>(st & 0xffffffffu) : 0;
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) val += __shfl_xor_sync(0xffffffffu, val, o2);
      excl += val;
      if (inc) break;
    }
    if (tid == 0) {
      s_excl = excl;
      if (t > 0) {
        volatile unsigned long long* st = ws.count_status + t;
        *st = kInclusive | static_cast<unsigned>(excl + total);
      }
      if (t == steps - 1) *num = excl + total;
      // the carry into this window, where a run end before the first head needs it
      float4 c = zero;
      if (t > 0 && first_end < first_head) {
        int q = t - 1;
        while (true) {
          int f;
          do {
            f = *reinterpret_cast<volatile int*>(ws.carry_flag + q);
          } while (f == 0);
          if (f == 2) break;
          --q;
        }
        __threadfence();
        const volatile float4* inc_v = ws.carry_inc;
        const volatile float4* agg_v = ws.carry_agg;
        c = make_float4(inc_v[q].x, inc_v[q].y, inc_v[q].z, inc_v[q].w);
        for (int j = q + 1; j < t; ++j) {
          c = add4(make_float4(agg_v[j].x, agg_v[j].y, agg_v[j].z, agg_v[j].w), c);
        }
        if (!has_head) {
          ws.carry_inc[t] = add4(s_last, c);
          __threadfence();
          *reinterpret_cast<volatile int*>(ws.carry_flag + t) = 2;
        }
      }
      s_carry = c;
    }
  }
  __syncthreads();

  // each run end from registers to its slot
  const float4 c = s_carry;
  int slot = s_excl + excl_cnt;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!own_end[r]) continue;
    if (slot < capacity) {
      const int loc = i0 + r;
      const float4 add = loc < first_head ? c : zero;
      float* dst = out + static_cast<size_t>(slot) * 5;
      dst[0] = static_cast<float>(key[R + r]);
      dst[1] = __fadd_rn(o[r].x, add.x);
      dst[2] = __fadd_rn(o[r].y, add.y);
      dst[3] = __fadd_rn(o[r].z, add.z);
      dst[4] = __fadd_rn(o[r].w, add.w);
    }
    ++slot;
  }
}

template <int R>
int launch(const int* skey, const void* pay_a, const void* pay_b, const void* pay_c,
           const void* pay_d, int packed, float quantum, int batch, int n, int w, int sentinel,
           int capacity, const Workspace& ws, float* out, int* num, cudaStream_t s) {
  const int threads = w / R;
  const size_t smem = static_cast<size_t>(w) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rr_window<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rr_window<R><<<batch * (n / w), threads, smem, s>>>(
      skey, pay_a, pay_b, static_cast<const float*>(pay_c), static_cast<const float*>(pay_d),
      packed, quantum, n, w, sentinel, capacity, ws, out, num);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// skey and the payloads [batch, n] (row-major; pay_d the counts, or null),
// out [batch, capacity, 5],
// num [batch]; workspace: at least batch * steps * 44 + 4 bytes (the
// wrapper allocates them), laid out as carry_agg, carry_inc, count_status,
// carry_flag (batch * steps each), ticket
extern "C" int pcp_runreduce(const int* skey, const void* pay_a, const void* pay_b,
                             const void* pay_c, const void* pay_d, int packed, float quantum,
                             int batch, int n, int w, int sentinel, int capacity,
                             void* workspace, float* out, int* num, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int steps = batch * (n / w);  // windows of the whole batch
  char* p = static_cast<char*>(workspace);
  Workspace ws;
  ws.carry_agg = reinterpret_cast<float4*>(p);
  ws.carry_inc = ws.carry_agg + steps;
  ws.count_status = reinterpret_cast<unsigned long long*>(ws.carry_inc + steps);
  ws.carry_flag = reinterpret_cast<int*>(ws.count_status + steps);
  ws.ticket = ws.carry_flag + steps;
  // clear the status words, carry flags and ticket (contiguous)
  const cudaError_t err = cudaMemsetAsync(
      ws.count_status, 0, static_cast<size_t>(steps) * 12 + 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w >= 512) return launch<4>(skey, pay_a, pay_b, pay_c, pay_d, packed, quantum, batch, n,
                                 w, sentinel, capacity, ws, out, num, s);
  if (w == 256) return launch<2>(skey, pay_a, pay_b, pay_c, pay_d, packed, quantum, batch, n,
                                 w, sentinel, capacity, ws, out, num, s);
  return launch<1>(skey, pay_a, pay_b, pay_c, pay_d, packed, quantum, batch, n, w, sentinel,
                   capacity, ws, out, num, s);
}
