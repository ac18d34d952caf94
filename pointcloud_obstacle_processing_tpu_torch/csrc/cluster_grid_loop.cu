// The whole full-sweep cluster loop in one grid-wide launch, for cluster
// buffers above the loop kernel's capacity (kernel K4, grid form).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/cluster.py:
// _pallas_sweep_jump (the sweep) and the lax.while_loop around it in
// euclidean_cluster, as cluster_loop.cu does, but for any capacity: the
// points stay in global memory (L2) instead of every block's shared
// memory.  Each sweep is the contract of the reference's _xla_sweep_jump:
// for every row i
//
//   nbr[i] = min(labels[i], lc[labels[i]],
//                min{lc[j] : d2(i, j) <= tol2, valid[i]}),  lc[j] = valid[j] ? labels[j] : C
//
// then the hook upd[r] = min{nbr[i] : labels[i] == r}, new = min(labels,
// upd, nbr), and a scan stops after a sweep that changed none of its
// labels.  Everything but d2 is an integer min, exact in any order; d2 is
// the reference's tree as XLA:CPU evaluates it, cross = fma(qz, cz,
// fma(qx, cx, qy*cy)), d2 = (q_sq + c_sq) - 2*cross (the doubling is exact,
// so the subtraction is one fma(-2, cross, q_sq + c_sq) with the same
// rounding).
//
// Design: a cooperative launch that fills every SM (the occupancy API
// sizes the grid; the launch fails rather than run a grid that is not
// co-resident), with two grid-wide barriers a sweep:
//   A. the sweep, split over work items (scan, 512-row query tile, column
//      chunk of at most 256) of each scan's valid prefix [0, last valid row]
//      (the compacted buffer puts every valid row there; the prefix is read
//      on the device): a block stages the chunk's points ([C, 4] rows,
//      16-byte loads) and labels in shared memory, each thread scores its
//      two rows against the chunk, and the chunk's minimum meets the other
//      chunks' by atomicMin in global memory (an integer minimum: exact in
//      any order);
//   B. the hook: each row's minimum, with its own label and pointer jump,
//      atomicMin'd onto its label's root and onto itself; a hook below the
//      target's label marks the scan changed, so the change test is known
//      at the barrier that ends the sweep.
// The labels of sweep k are never written in place: they are
// min(labels of sweep k - 1, hook minima of sweep k - 1), read as such
// (both arrays double-buffered by sweep parity), and written out during
// phase B, into the buffer the sweep after next reads.  Labels, hook minima
// and flags live in global memory (a 16,384-point scan's are in L2); loads
// of what other blocks write go through L2 (__ldcg).  A batch takes the
// scan as a further coordinate of the work items; each scan stops at its
// own convergence and writes its own `unconverged` and `sweeps`.  Nothing
// is read back by the host.
//
// Bound on the H100: a sweep scores V^2 pairs of the V valid points at 9
// operations a pair (V = 7,069, the fullscale window's non-plane points:
// ~0.0067 ms at 67 TFLOP/s fp32), plus two grid barriers a sweep.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // threads a block
constexpr int kRows = 2;          // query rows a thread
constexpr int kTileRows = kThreads * kRows;  // query rows a work item
constexpr int kChunk = 256;       // most columns a work item
constexpr int kBlocksPerSm = 3;   // blocks a multiprocessor (capped at the co-resident limit)
constexpr int kMaxScans = 1024;   // scans a launch

__global__ void __launch_bounds__(kThreads)
cluster_grid_loop(const float4* __restrict__ pts, const unsigned char* __restrict__ valid,
                  const int* __restrict__ labels_in, int batch, int c, float tol2,
                  int max_iters, int* __restrict__ labels_out,
                  unsigned char* __restrict__ unconverged, int* __restrict__ sweeps, int* lab,
                  int* upd, int* nbr, int* hi1, int* changed) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 sp[kChunk];
  __shared__ int slc[kChunk];
  __shared__ int s_items[kMaxScans + 1];  // first work item of each scan this sweep
  __shared__ int s_hi[kMaxScans];         // rows [0, s_hi) hold every valid row
  __shared__ unsigned char s_act[kMaxScans];
  __shared__ int s_nsw[kMaxScans];        // sweeps each scan has run
  const long long total = static_cast<long long>(batch) * c;
  const long long gtid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long gthreads = static_cast<long long>(gridDim.x) * kThreads;
  int* lab0 = lab;
  int* lab1 = lab + total;
  int* upd0 = upd;
  int* upd1 = upd + total;

  // the labels before sweep 0, the hook minima and the row minima; the
  // last valid row + 1 of each scan; the change flags (three slots by sweep)
  for (long long k = gtid; k < total; k += gthreads) {
    lab1[k] = labels_in[k];
    upd1[k] = c;  // so that sweep 0's labels min(lab1, upd1) are the input
    nbr[k] = c;
  }
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < batch; b += kThreads) {
      hi1[b] = 0;
      changed[b] = changed[batch + b] = changed[2 * batch + b] = 0;
    }
  }
  grid.sync();
  for (long long k = gtid; k < total; k += gthreads) {
    if (valid[k]) atomicMax(&hi1[k / c], static_cast<int>(k % c) + 1);
  }
  grid.sync();
  for (int b = threadIdx.x; b < batch; b += kThreads) {
    s_hi[b] = __ldcg(&hi1[b]);
    s_act[b] = 1;
    s_nsw[b] = 0;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // the labels of this sweep: min(prev, hprev), both complete and
    // unwritten until the sweep after this one; its hooks go to hcur,
    // which held the minima of two sweeps back and is reset in phase A
    const int* prev = (it & 1) ? lab0 : lab1;
    const int* hprev = (it & 1) ? upd0 : upd1;
    int* cur = (it & 1) ? lab1 : lab0;
    int* hcur = (it & 1) ? upd1 : upd0;
    auto label = [&](long long k) { return min(__ldcg(&prev[k]), __ldcg(&hprev[k])); };
    if (threadIdx.x == 0) {
      int acc = 0;
      for (int b = 0; b < batch; ++b) {
        s_items[b] = acc;
        const int h = s_hi[b];
        if (s_act[b]) acc += ((h + kTileRows - 1) / kTileRows) * ((h + kChunk - 1) / kChunk);
      }
      s_items[batch] = acc;
    }
    __syncthreads();

    // A. the sweep: each row's minimum over one chunk of columns
    for (long long k = gtid; k < total; k += gthreads) {
      if (s_act[k / c]) hcur[k] = c;
    }
    const int n_items = s_items[batch];
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      int b = 0;
      while (s_items[b + 1] <= item) ++b;
      const int h = s_hi[b];
      const int chunks = (h + kChunk - 1) / kChunk;
      const int local = item - s_items[b];
      const int j0 = (local % chunks) * kChunk;
      const int len = min(kChunk, h - j0);
      const long long base = static_cast<long long>(b) * c;
      __syncthreads();  // the previous item's reads of sp and slc are done
      for (int j = threadIdx.x; j < len; j += kThreads) {
        sp[j] = pts[base + j0 + j];
        slc[j] = valid[base + j0 + j] ? label(base + j0 + j) : c;
      }
      __syncthreads();
      const int i0 = (local / chunks) * kTileRows + threadIdx.x;
      const bool q0 = i0 < h && valid[base + i0];
      const bool q1 = i0 + kThreads < h && valid[base + i0 + kThreads];
      if (q0 || q1) {
        const float4 a = q0 ? pts[base + i0] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float4 e = q1 ? pts[base + i0 + kThreads] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int best0 = c, best1 = c;
        for (int j = 0; j < len; ++j) {
          const float4 p = sp[j];
          const int l = slc[j];
          const float x0 = __fmaf_rn(a.z, p.z, __fmaf_rn(a.x, p.x, __fmul_rn(a.y, p.y)));
          const float x1 = __fmaf_rn(e.z, p.z, __fmaf_rn(e.x, p.x, __fmul_rn(e.y, p.y)));
          // (q_sq + c_sq) - 2*cross in one rounding: 2*cross is exact
          const float d0 = __fmaf_rn(-2.0f, x0, __fadd_rn(a.w, p.w));
          const float d1 = __fmaf_rn(-2.0f, x1, __fadd_rn(e.w, p.w));
          if (d0 <= tol2) best0 = min(best0, l);
          if (d1 <= tol2) best1 = min(best1, l);
        }
        if (q0 && best0 < c) atomicMin(&nbr[base + i0], best0);
        if (q1 && best1 < c) atomicMin(&nbr[base + i0 + kThreads], best1);
      }
    }
    grid.sync();

    // B. the hook: each row's minimum (its neighbours', its own label and
    //    its pointer jump) onto its label's root and onto itself; a minimum
    //    below the target's label is a change.  This sweep's labels are
    //    written out for the sweep after next to read.
    for (long long k = gtid; k < total; k += gthreads) {
      const int b = static_cast<int>(k / c);
      const int i = static_cast<int>(k % c);
      if (!s_act[b]) continue;
      const long long base = static_cast<long long>(b) * c;
      const int l = label(k);
      cur[k] = l;
      if (i >= s_hi[b]) continue;  // past the last valid row: its own label, no neighbour
      const int jump_l = valid[base + l] ? label(base + l) : c;
      const int m = min(min(l, jump_l), __ldcg(&nbr[k]));
      nbr[k] = c;
      int* flag = &changed[(it % 3) * batch + b];
      if (m < l) {
        atomicMin(&hcur[k], m);
        *flag = 1;
      }
      if (valid[base + l] && m < jump_l) {  // jump_l: the label of l
        atomicMin(&hcur[base + l], m);
        *flag = 1;
      }
    }
    if (blockIdx.x == 0) {  // read at the start of this sweep, written two sweeps on
      for (int b = threadIdx.x; b < batch; b += kThreads) {
        changed[((it + 2) % 3) * batch + b] = 0;
      }
    }
    grid.sync();

    bool any = false;
    for (int b = 0; b < batch; ++b) {
      const bool ch = __ldcg(&changed[(it % 3) * batch + b]) != 0;
      if (s_act[b] && blockIdx.x == 0 && threadIdx.x == 0) {
        unconverged[b] = ch;
        sweeps[b] = it + 1;
      }
      any |= s_act[b] && ch;
    }
    __syncthreads();  // every thread has read s_act before it changes
    for (int b = threadIdx.x; b < batch; b += kThreads) {
      s_nsw[b] += s_act[b];
      s_act[b] = s_act[b] && __ldcg(&changed[(it % 3) * batch + b]) != 0;
    }
    __syncthreads();
    if (!any) break;
  }
  // the labels after each scan's last sweep: those its next sweep would read
  for (long long k = gtid; k < total; k += gthreads) {
    const int n = s_nsw[k / c];
    labels_out[k] = min(__ldcg(&((n & 1) ? lab0 : lab1)[k]), __ldcg(&((n & 1) ? upd0 : upd1)[k]));
  }
  if (max_iters <= 0 && blockIdx.x == 0) {
    for (int b = threadIdx.x; b < batch; b += kThreads) {
      unconverged[b] = c > 0;
      sweeps[b] = 0;
    }
  }
}

int grid_blocks() {
  int dev = 0, sms = 0, occ = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cluster_grid_loop, kThreads, 0) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * min(occ, kBlocksPerSm);
}

}  // namespace

// pts [batch, c, 4], valid, labels and labels_out [batch, c]; unconverged
// and sweeps [batch]; scratch: 5 * batch * c + 4 * batch ints
extern "C" int pcp_cluster_grid_loop(const float* pts, const unsigned char* valid,
                                     const int* labels, int batch, int c, float tol2,
                                     int max_iters, int* labels_out,
                                     unsigned char* unconverged, int* sweeps, int* scratch,
                                     void* stream) {
  if (batch <= 0 || batch > kMaxScans) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = grid_blocks();
  if (blocks <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float4* p4 = reinterpret_cast<const float4*>(pts);
  const size_t total = static_cast<size_t>(batch) * c;
  int* lab = scratch;           // [2, batch, c] labels by sweep parity
  int* upd = lab + 2 * total;   // [2, batch, c] hook minima by sweep parity
  int* nbr = upd + 2 * total;   // [batch, c] row minima
  int* hi1 = nbr + total;       // [batch]
  int* chg = hi1 + batch;       // [3, batch]
  void* args[] = {&p4, &valid, &labels, &batch, &c, &tol2, &max_iters, &labels_out,
                  &unconverged, &sweeps, &lab, &upd, &nbr, &hi1, &chg};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(cluster_grid_loop),
                                                dim3(blocks), dim3(kThreads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
