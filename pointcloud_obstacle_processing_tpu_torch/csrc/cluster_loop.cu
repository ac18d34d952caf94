// The whole full-sweep cluster loop in one launch (kernel K4, loop form).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/cluster.py:
// _pallas_sweep_jump (the sweep) and the lax.while_loop around it in
// euclidean_cluster (sweep -> hook -> change test, up to max_iters sweeps).
// Each sweep is the contract of the reference's _xla_sweep_jump, as in
// cluster_sweep.cu: for every row i
//
//   nbr[i] = min(labels[i], lc[labels[i]],
//                min{lc[j] : d2(i, j) <= tol2, valid[i]}),  lc[j] = valid[j] ? labels[j] : C
//
// then the hook upd[r] = min{nbr[i] : labels[i] == r}, new = min(labels,
// upd, nbr), and the loop stops after a sweep that changed no label.
// Everything but d2 is an integer min, so the result is the plain loop's
// in any order; d2 is the reference's tree as XLA:CPU evaluates it, cross =
// fma(qz, cz, fma(qx, cx, qy*cy)), d2 = (q_sq + c_sq) - 2*cross.
//
// A batch of B buffers (one a scan) runs as B thread-block clusters in one
// launch, cluster b on scan b (blockIdx.x / kBlocks); each stops at its own
// convergence, and nothing crosses from one cluster to another.
//
// Design: one thread-block cluster of kBlocks blocks a scan (for one scan
// 16, the non-portable size, where the card schedules it, else 8; for a
// batch the size chosen from chip_smoke.py's table of 1-16 blocks at B =
// 32, ops/cluster.py's LOOP_BATCH_BLOCKS).  Every block holds all C
// points (float4 x, y, z, |p|^2) and a copy of lc in shared memory, and
// owns C / kBlocks rows (their labels and upd).  The sweep's query rows,
// [0, last valid row], are split evenly over the blocks apart from that
// (the buffer is front-compacted: every block gets valid rows).  A block's
// 1024 threads split the columns of that range into groups (columns past
// the last valid row cannot lower a minimum), a warp reading one column at
// a time (a broadcast); the groups' minima meet by shared-memory atomicMin.
// Each sweep:
//   1. every row's minimum is hooked onto its label and onto itself by
//      atomicMin into the owning blocks' upd slices (distributed shared
//      memory): the pointer jump and own label by the owner, the
//      neighbour minimum by the block that swept the row, so upd[i] ends
//      as min(hook minimum of i, row i's minimum);
//   2. cluster barrier;
//   3. new labels min(labels, upd) of the owned rows, written into every
//      block's lc copy;
//      a block whose labels changed sets the "changed" flag of this sweep
//      in every block;
//   4. cluster barrier; every block reads its own flag and stops alike.
// Outputs stay on the device: labels, whether the last sweep changed a
// label (the loop's `unconverged`) and the number of sweeps run.
//
// Bound on the H100: a sweep scores V^2 pairs of the V valid points at 9
// operations a pair (0.05 us for V = 600 on the whole card); the loop runs
// on kBlocks SMs, so a sweep takes about V^2 * 9 / (kBlocks * 128 lanes)
// cycles, plus two cluster barriers and C * kBlocks label stores across
// the cluster.  It replaces one launch, five PyTorch operations and one
// host sync a sweep.  In a batch, clusters of 16 fit about 8 scans on the
// card at once; the flagship batch of 32 (136 sweeps) took 0.047 ms of
// device time at 4 blocks a scan and 0.075-0.107 at 16 on an H100 80GB
// HBM3 at 700 W (chip_smoke.py's "loop blocks" lines).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads, 1)
cluster_loop(const float4* __restrict__ pts, const unsigned char* __restrict__ valid,
             const int* __restrict__ labels_in, int c, float tol2, int max_iters,
             int* __restrict__ labels_out, unsigned char* __restrict__ unconverged,
             int* __restrict__ sweeps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  {  // this cluster's scan
    const size_t scan = blockIdx.x / nb;
    pts += scan * c;
    valid += scan * c;
    labels_in += scan * c;
    labels_out += scan * c;
    unconverged += scan;
    sweeps += scan;
  }
  const int rows_per = (c + nb - 1) / nb;
  const int row0 = rank * rows_per;
  const int rows = max(0, min(c, row0 + rows_per) - row0);

  extern __shared__ float4 smem[];
  float4* sp = smem;                               // [c] points
  int* lc = reinterpret_cast<int*>(sp + c);        // [c] valid ? labels : C
  int* lab = lc + c;                               // [rows_per] owned labels
  int* upd = lab + rows_per;                       // [rows_per] hook minima of owned rows
  int* nbr = upd + rows_per;                       // [rows_per] sweep minima / new lc entries
  __shared__ int chg[2];
  __shared__ int s_hi;

  const int tid = threadIdx.x;
  if (tid == 0) s_hi = -1;
  __syncthreads();
  for (int j = tid; j < c; j += kThreads) {
    const bool v = valid[j] != 0;
    sp[j] = pts[j];
    lc[j] = v ? labels_in[j] : c;
    if (v) atomicMax(&s_hi, j);
  }
  for (int k = tid; k < rows; k += kThreads) {
    lab[k] = labels_in[row0 + k];
    upd[k] = c;
  }
  if (tid < 2) chg[tid] = 0;
  cluster.sync();  // every block's copies are set before any remote write
  // upd entry of point l, in the block that owns it
  auto upd_of = [&](int l) { return cluster.map_shared_rank(upd, l / rows_per) + l % rows_per; };

  // the sweep's query rows: [0, hi) split evenly, so that a front-compacted
  // buffer keeps every block busy; this thread's row and column group
  const int hi = s_hi + 1;
  const int sweep_per = (hi + nb - 1) / nb;
  const int srow0 = rank * sweep_per;
  const int srows = max(0, min(hi, srow0 + sweep_per) - srow0);
  const int groups = sweep_per > 0 ? max(1, kThreads / sweep_per) : 1;
  const int r = sweep_per > 0 ? tid % sweep_per : 0;
  const int g = sweep_per > 0 ? tid / sweep_per : 0;
  // columns at or past hi are invalid (lc = C) and never lower a minimum
  const int chunk = (hi + groups - 1) / groups;
  const int j0 = min(hi, g * chunk);
  const int j1 = min(hi, j0 + chunk);
  const int i = srow0 + r;
  const bool qv = r < srows && g < groups && valid[i] != 0;
  const float4 q = qv ? sp[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  int changed = c > 0;
  int it = 0;
  for (; it < max_iters; ++it) {
    // 1. each owned row's pointer jump and own label, hooked onto its label
    //    and kept for its own update; then each swept row's neighbour
    //    minimum, likewise (upd[i] ends as min(hook minimum, row i's minimum))
    for (int k = tid; k < rows; k += kThreads) {
      const int m = min(lc[lab[k]], lab[k]);
      atomicMin(upd_of(lab[k]), m);
      atomicMin(&upd[k], m);
    }
    for (int k = tid; k < srows; k += kThreads) nbr[k] = c;
    __syncthreads();
    if (qv) {
      int best = c;
      for (int j = j0; j < j1; ++j) {
        const float4 p = sp[j];
        const float cross = __fmaf_rn(q.z, p.z, __fmaf_rn(q.x, p.x, __fmul_rn(q.y, p.y)));
        const float d2 = __fsub_rn(__fadd_rn(q.w, p.w), __fmul_rn(2.0f, cross));
        const int l = lc[j];
        if (d2 <= tol2 && l < best) best = l;
      }
      if (best < c) atomicMin(&nbr[r], best);
    }
    __syncthreads();
    for (int k = tid; k < srows; k += kThreads) {
      if (nbr[k] < c) {  // a valid row, whose label is lc[row]
        const int row = srow0 + k;
        atomicMin(upd_of(lc[row]), nbr[k]);
        atomicMin(upd_of(row), nbr[k]);
      }
    }
    cluster.sync();

    // 2. new labels of the owned rows, into every block's copy
    int mine = 0;
    for (int k = tid; k < rows; k += kThreads) {
      const int old = lab[k];
      const int nw = min(old, upd[k]);
      mine |= nw != old;
      lab[k] = nw;
      upd[k] = c;
      nbr[k] = lc[row0 + k] < c ? nw : c;  // the new lc entry
    }
    const int block_changed = __syncthreads_or(mine);
    for (int k = tid; k < rows * nb; k += kThreads) {
      const int row = k % rows;
      cluster.map_shared_rank(lc, k / rows)[row0 + row] = nbr[row];
    }
    if (block_changed && tid < nb) cluster.map_shared_rank(chg, tid)[it & 1] = 1;
    cluster.sync();
    changed = chg[it & 1];
    if (tid == 0) chg[(it + 1) & 1] = 0;  // no peer writes it before the next barrier
    if (!changed) {
      ++it;
      break;
    }
  }
  for (int k = tid; k < rows; k += kThreads) labels_out[row0 + k] = lab[k];
  if (rank == 0 && tid == 0) {
    *unconverged = changed ? 1 : 0;
    *sweeps = it;
  }
}

size_t smem_bytes(int c, int nb) {
  const int rows_per = (c + nb - 1) / nb;
  return static_cast<size_t>(c) * (sizeof(float4) + sizeof(int)) + 3 * sizeof(int) * rows_per;
}

// whether a cluster of nb blocks, each holding c points, can be scheduled on
// this card with this shared memory (and no block sweeps more rows than it
// has threads)
bool fits(int c, int nb) {
  if (nb < 1 || nb > 16 || (c + nb - 1) / nb > kThreads) return false;
  const size_t smem = smem_bytes(c, nb);
  if (cudaFuncSetAttribute(cluster_loop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  if (nb > 8 && cudaFuncSetAttribute(cluster_loop, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                     1) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, cluster_loop, &cfg) == cudaSuccess &&
      clusters > 0) {
    return true;
  }
  cudaGetLastError();
  return false;
}

}  // namespace

// Blocks a scan at capacity c: with nb = 0 the one-scan choice, 16 where
// such a cluster fits the card, else 8; with nb > 0, nb where it fits.  0
// where none fits.
extern "C" int pcp_cluster_loop_blocks(int c, int nb) {
  if (nb > 0) return fits(c, nb) ? nb : 0;
  return fits(c, 16) ? 16 : (fits(c, 8) ? 8 : 0);
}

// pts [batch, c, 4], valid, labels and labels_out [batch, c]; unconverged
// and sweeps [batch]; `blocks` a scan
extern "C" int pcp_cluster_loop(const float* pts, const unsigned char* valid, const int* labels,
                                int batch, int c, float tol2, int max_iters, int blocks,
                                int* labels_out, unsigned char* unconverged, int* sweeps,
                                void* stream) {
  const size_t smem = smem_bytes(c, blocks);
  cudaError_t err = cudaFuncSetAttribute(cluster_loop, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 8) {
    err = cudaFuncSetAttribute(cluster_loop, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(batch * blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cluster_loop, reinterpret_cast<const float4*>(pts), valid,
                           labels, c, tol2, max_iters, labels_out, unconverged, sweeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
