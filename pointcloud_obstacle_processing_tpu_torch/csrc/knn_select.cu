// Banded k-nearest mean distance (kernel K3).
//
// Replaces pointcloud_obstacle_processing_tpu/ops/outliers.py:
// _sortnet_mean_pallas (both forms, with and without the q_valid skip),
// including the mean it ends in (_sortnet_mean_from_sorted).
//
// For query tile t (row_tile queries) the candidates are the `width`
// columns starting at starts[t] of the lattice-ordered cloud.  A batch of
// B clouds (one a scan, each [n] channels, the same starts) takes the scan
// as the grid's z dimension; nothing crosses from one scan to another.  For every
// query the kernel selects the 16 smallest squared distances and writes
// the mean of the square roots of the k smallest of them that lie below
// `half` (out[q], a [n_q] vector).  The mean is the plain version's to the
// bit: correctly rounded roots (__fsqrt_rn, as torch.sqrt on the card), a
// float32 sum in ascending order, the count as float32, one correctly
// rounded division by max(count, 1).
//
// The TPU version took a [16, nc, T] plane tile of precomputed squared
// distances from HBM and ran a Batcher/bitonic network on it.  Here the
// distances are computed in registers and each query keeps its 16 smallest
// values in a sorted register array.  Any exact selection yields the same
// sorted 16, so neither the network nor the column order is copied.  The
// distance is the reference's expression tree as XLA:CPU evaluates it:
// cross = fma(qz, cz, fma(qx, cx, qy*cy)) with explicit fused multiply-adds
// (-fmad=false leaves the intrinsics alone); d2 = (q_sq + c_sq) - 2*cross,
// clamped at 0.  Invalid and self columns are never inserted (the plain
// version gives them `big`, which no comparison with the list admits).
// Tiles with no valid query write 0, the plain mean of `big` rows.
//
// Design for the H100.  A block scores a slice of kQ * kRowThreads rows of
// one tile with kGroups column groups of kRowThreads threads: thread t of
// each group holds kQ queries, and group g scores the window columns
// j = g (mod kGroups).  The flagship's 24,576 queries take four groups, so
// that a query has four threads and the card enough warps (a thread per
// query leaves it at ~3 warps an SM, latency-bound); the fullscale's
// 262,144 fill it with one.  The window is staged through shared memory in
// chunks of kChunk columns, each column one float4 (x, y, z, |p|^2),
// double-buffered with cp.async (four 4-byte copies a column, straight
// from the channel vectors); an invalid column's |p|^2 is set to +inf
// after its copy lands, so its d2 is +inf and fails every comparison
// without a validity load in the loop.  One broadcast LDS.128 serves kQ
// pairs.  A thread computes four columns' distances before it compares
// any (instruction-level parallelism), and takes the candidate path, on
// which a warp diverges, only when one of the four is below its limit.
// Candidates wait in shared memory (kDefer a query) and are inserted when
// some lane's buffer is nearly full, so the warp runs the insertion
// (new[s] = max(top[s-1], min(top[s], d)), depth two) once for many
// lanes' candidates.  The limit is the least of the query's 16th value
// and the bounds below:
//   - the groups first score each query's kLocal rank neighbours (its own
//     slab of the lattice, read from global memory), each group every
//     kGroups-th of them, into their lists, which brings the 16th value
//     near its final value; the window pass skips those columns (and the
//     self column, which lies among them);
//   - after that and at each chunk the groups publish their 4th values in
//     shared memory: four lists hold at least 16 values up to the largest
//     of them, so a larger value is never among the 16 smallest;
//   - the window's chunks are taken centre-out: the tile's own columns
//     first, then alternately left and right.
// Selection is order-free, so none of this changes the selected values.
// At the end groups 1..3 hand their lists to group 0 through shared
// memory, which merges them (each list is sorted: a merge stops at the
// first value not below the 16th) and writes the mean.  Over six tiles
// each of the flagship and fullscale voxel clouds the rank neighbours and
// the centre-out order cut insertions from ~120 / ~206 per query (columns
// in order) to ~20 / ~19 (scripts/knn_insertion_sim.py, on the CPU).
//
// A launch may take a range of the query tiles (the point-sharded path's
// shard, the reference's _map_query_tiles over [s*T/S, (s+1)*T/S),
// outliers.py:407-416): tile_first offsets the tile index, the output holds
// the range's rows only; each query's arithmetic is unchanged, so the
// gathered ranges equal the whole call bit for bit.
//
// Bound on the H100: the fullscale call scores ~600 M pairs (163 live
// tiles x 1,024 rows x 3,584 columns) of ~9 operations each, 0.08 ms at
// the fp32 rate; it reads ~4.5 MB and writes 1 MB.  The loop issues about
// 8-10 instructions a pair, so instruction issue, not memory, bounds it.
// The flagship batch of 32 scans ~1 G pairs, 0.13 ms at the fp32 rate; it
// took 0.73 ms of device time on an H100 80GB HBM3 at 700 W (chip_smoke.py).

#include <cuda_runtime.h>

namespace {

constexpr int kSel = 16;
constexpr int kQ = 2;       // queries per thread
constexpr int kChunk = 256;  // window columns per staged chunk
constexpr int kBatch = 4;    // columns a thread scores before it compares
constexpr int kDefer = 8;    // candidates a query buffers before it inserts them
constexpr int kLocal = 32;   // rank neighbours each query scores first

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float qsq, float cx,
                                       float cy, float cz, float csq) {
  const float cross = __fmaf_rn(qz, cz, __fmaf_rn(qx, cx, __fmul_rn(qy, cy)));
  return __fsub_rn(__fadd_rn(qsq, csq), __fmul_rn(2.0f, cross));
}

// d < top[kSel - 1]: the sorted 16 with d in and the largest out
__device__ __forceinline__ void insert(float (&top)[kSel], float d) {
#pragma unroll
  for (int s = kSel - 1; s > 0; --s) top[s] = fmaxf(top[s - 1], fminf(top[s], d));
  top[0] = fminf(top[0], d);
}

// Chunk c of the centre-out order over the window [0, width): the chunks
// right of `off` (the tile's first row) from off upwards, and the chunks
// left of it from off downwards; the `own` right chunks that cover the
// tile's rows first, then left and right in turns.
struct Chunk {
  int begin;
  int len;
};

__device__ __forceinline__ Chunk chunk_at(int c, int off, int width, int n_right, int n_left,
                                          int own) {
  int side, idx;  // side 0: right, 1: left
  if (c < own) {
    side = 0;
    idx = c;
  } else {
    const int k = c - own;
    const int rest_right = n_right - own;
    const int pairs = rest_right < n_left ? rest_right : n_left;
    if (k < 2 * pairs) {
      side = k & 1 ? 0 : 1;
      idx = k & 1 ? own + k / 2 : k / 2;
    } else if (rest_right > n_left) {
      side = 0;
      idx = own + pairs + (k - 2 * pairs);
    } else {
      side = 1;
      idx = pairs + (k - 2 * pairs);
    }
  }
  Chunk ch;
  if (side == 0) {
    ch.begin = off + idx * kChunk;
    ch.len = width - ch.begin < kChunk ? width - ch.begin : kChunk;
  } else {
    const int end = off - idx * kChunk;
    ch.begin = end - kChunk > 0 ? end - kChunk : 0;
    ch.len = end - ch.begin;
  }
  return ch;
}

// kGroups column groups of kRowThreads threads; a block scores
// kQ * kRowThreads rows of one tile
template <int kGroups, int kRowThreads>
__global__ void __launch_bounds__(kGroups * kRowThreads)
    knn_mean(const float* __restrict__ px, const float* __restrict__ py,
             const float* __restrict__ pz, const float* __restrict__ psq,
             const unsigned char* __restrict__ valid, const int* __restrict__ starts, int n,
             int tile_first, int row_tile, int width, int k, float big, float half,
             float* __restrict__ out) {
  {  // this block's scan
    const size_t scan = blockIdx.z;
    px += scan * n;
    py += scan * n;
    pz += scan * n;
    psq += scan * n;
    valid += scan * n;
    out += scan * gridDim.x * row_tile;
  }
  constexpr int kThreads = kGroups * kRowThreads;
  constexpr int kRows = kQ * kRowThreads;
  constexpr int kColsPerThread = (kChunk + kThreads - 1) / kThreads;
  constexpr int kStep = kBatch * kGroups;  // chunks are padded to a multiple
  constexpr int kListFloats = (kGroups - 1) * kRows * (kSel + 1);  // +1: no bank conflicts
  constexpr int kPendFloats = kDefer * kQ * kThreads;
  __shared__ float4 buf[2][kChunk];
  // the buffered candidates during the window pass, then the lists handed
  // to group 0
  __shared__ float spare[kListFloats > kPendFloats ? kListFloats : kPendFloats];
  __shared__ float fourth[kGroups][kRows];  // each group's 4th value
  const int t = tile_first + blockIdx.x;  // the query tile (of a range: sharded queries)
  const int tile0 = t * row_tile;
  const int o0 = blockIdx.x * row_tile;  // its first row of the output
  const int tid = threadIdx.x;
  const int g = tid / kRowThreads;
  const int rt = tid % kRowThreads;
  const int r0 = blockIdx.y * kRows;  // first row of this block's slice

  // the tile's skip (uniform over the block, and alike in every slice)
  int any = 0;
  for (int r = tid; r < row_tile && !any; r += kThreads) {
    const int q = tile0 + r;
    any = q < n && valid[q];
  }
  if (!__syncthreads_or(any)) {
    if (g == 0) {
#pragma unroll
      for (int m = 0; m < kQ; ++m) {
        const int r = r0 + rt + m * kRowThreads;
        if (r < row_tile) out[o0 + r] = 0.0f;
      }
    }
    return;
  }

  const int start = starts[t];
  const int nl = width < kLocal ? width : kLocal;
  const float inf = __int_as_float(0x7f800000);
  float qx[kQ], qy[kQ], qz[kQ], qsq[kQ], lim[kQ], cap[kQ];
  int lo[kQ];
  float top[kQ][kSel];
#pragma unroll
  for (int m = 0; m < kQ; ++m) {
    const int q = tile0 + r0 + rt + m * kRowThreads;
    const bool real = q < n;  // padded queries sit at 0
    qx[m] = real ? px[q] : 0.0f;
    qy[m] = real ? py[q] : 0.0f;
    qz[m] = real ? pz[q] : 0.0f;
    qsq[m] = real ? psq[q] : 0.0f;
    // the rank neighbours: nl window columns around the query's own (the
    // self column, where the window holds it, lies among them)
    int l = q - start - nl / 2;
    l = l < 0 ? 0 : l;
    lo[m] = l > width - nl ? width - nl : l;
#pragma unroll
    for (int s = 0; s < kSel; ++s) top[m][s] = big;
    for (int j = g; j < nl; j += kGroups) {  // group g takes every kGroups-th
      const int col = start + lo[m] + j;
      if (col == q || !valid[col]) continue;
      float d = dist2(qx[m], qy[m], qz[m], qsq[m], px[col], py[col], pz[col], psq[col]);
      d = d < 0.0f ? 0.0f : d;
      if (d < top[m][kSel - 1]) insert(top[m], d);
    }
    cap[m] = inf;
    lim[m] = top[m][kSel - 1];
    fourth[g][rt + m * kRowThreads] = top[m][3];
  }

  // candidates below lim wait in shared memory (kDefer a query) and are
  // inserted together, so a warp runs the insertion once for many lanes
  int npend[kQ];
#pragma unroll
  for (int m = 0; m < kQ; ++m) npend[m] = 0;
  auto pend = [&](int i, int m) -> float& { return spare[(i * kQ + m) * kThreads + tid]; };
  auto flush = [&]() {
#pragma unroll
    for (int m = 0; m < kQ; ++m) {
      for (int i = 0; i < npend[m]; ++i) {
        const float v = pend(i, m);
        if (v < top[m][kSel - 1]) insert(top[m], v);
      }
      npend[m] = 0;
      lim[m] = fminf(top[m][kSel - 1], cap[m]);
    }
  };
  // the groups' lists together hold at least 16 values up to the largest
  // of their 4th values: a bound every group may use (a larger value is
  // never among the 16 smallest)
  auto share = [&]() {
    if constexpr (kGroups > 1) {
#pragma unroll
      for (int m = 0; m < kQ; ++m) {
        const int row = rt + m * kRowThreads;
        fourth[g][row] = top[m][3];
        float b = 0.0f;
#pragma unroll
        for (int h = 0; h < kGroups; ++h) b = fmaxf(b, fourth[h][row]);
        cap[m] = fminf(cap[m], nextafterf(b, inf));
        lim[m] = fminf(top[m][kSel - 1], cap[m]);
      }
    }
  };
  if constexpr (kGroups > 1) {
    __syncthreads();  // every group's rank neighbours are in
    share();
  }

  const int off = tile0 - start;  // the tile's first row, as a window column
  const int n_right = (width - off + kChunk - 1) / kChunk;
  const int n_left = (off + kChunk - 1) / kChunk;
  const int own_max = (row_tile + kChunk - 1) / kChunk;
  const int own = own_max < n_right ? own_max : n_right;
  const int n_chunks = n_right + n_left;

  unsigned char vreg[kColsPerThread];
  auto stage = [&](int c, int b) {
    const Chunk ch = chunk_at(c, off, width, n_right, n_left, own);
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int j = tid + i * kThreads;
      if (j < ch.len) {
        const int col = start + ch.begin + j;
        cp_async4(&buf[b][j].x, px + col);
        cp_async4(&buf[b][j].y, py + col);
        cp_async4(&buf[b][j].z, pz + col);
        cp_async4(&buf[b][j].w, psq + col);
        vreg[i] = valid[col];
      } else if (j < (ch.len + kStep - 1) / kStep * kStep) {
        buf[b][j] = make_float4(0.0f, 0.0f, 0.0f, inf);  // padding: d2 = +inf
      }
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    const Chunk ch = chunk_at(c, off, width, n_right, n_left, own);
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {  // this thread's own copies have landed
      const int j = tid + i * kThreads;
      if (j < ch.len && !vreg[i]) buf[b][j].w = inf;
    }
    __syncthreads();  // chunk c is visible; every thread is done with chunk c - 1
    if (c + 1 < n_chunks) stage(c + 1, b ^ 1);
    if (c > 0) share();
    for (int j0 = g; j0 < ch.len; j0 += kStep) {  // reads up to the padded length
      float d[kBatch][kQ];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        const float4 col = buf[b][j0 + e * kGroups];
#pragma unroll
        for (int m = 0; m < kQ; ++m)
          d[e][m] = dist2(qx[m], qy[m], qz[m], qsq[m], col.x, col.y, col.z, col.w);
      }
      bool full = false;
#pragma unroll
      for (int m = 0; m < kQ; ++m) {
        const float least = fminf(fminf(d[0][m], d[1][m]), fminf(d[2][m], d[3][m]));
        if (least < lim[m]) {  // rare: buffer the candidates
#pragma unroll
          for (int e = 0; e < kBatch; ++e) {
            const int w = ch.begin + j0 + e * kGroups;
            float v = d[e][m];
            if (v < lim[m] && static_cast<unsigned>(w - lo[m]) >= static_cast<unsigned>(nl)) {
              v = v < 0.0f ? 0.0f : v;
              if (v < lim[m]) pend(npend[m]++, m) = v;
            }
          }
        }
        full |= npend[m] > kDefer - kBatch;
      }
      if (__any_sync(0xffffffffu, full)) flush();
    }
  }
  flush();

  // groups 1..3 hand their lists to group 0, which merges and writes the mean
  auto list = [&](int h, int row) { return spare + (h * kRows + row) * (kSel + 1); };
  if (kGroups > 1) {
    __syncthreads();  // every flush has read its candidates
    if (g > 0) {
#pragma unroll
      for (int m = 0; m < kQ; ++m) {
#pragma unroll
        for (int s = 0; s < kSel; ++s) list(g - 1, rt + m * kRowThreads)[s] = top[m][s];
      }
    }
    __syncthreads();
    if (g > 0) return;
  }
#pragma unroll
  for (int m = 0; m < kQ; ++m) {
    for (int h = 0; h < kGroups - 1; ++h) {
      const float* other = list(h, rt + m * kRowThreads);
      for (int s = 0; s < kSel; ++s) {
        const float v = other[s];
        if (!(v < top[m][kSel - 1])) break;
        insert(top[m], v);
      }
    }
    const int r = r0 + rt + m * kRowThreads;
    if (r >= row_tile) continue;
    float sum = 0.0f;
    float cnt = 0.0f;
#pragma unroll
    for (int i = 0; i < kSel; ++i) {
      if (i < k && top[m][i] < half) {
        sum = __fadd_rn(sum, __fsqrt_rn(top[m][i]));
        cnt = __fadd_rn(cnt, 1.0f);
      }
    }
    out[o0 + r] = __fdiv_rn(sum, cnt < 1.0f ? 1.0f : cnt);
  }
}

}  // namespace

// Launch shape: four column groups of 32 threads (64-row slices) where
// the queries alone would leave the card short of warps (the flagship's
// 24,576), one group of 128 threads (256-row slices) where they fill it
// (the fullscale's 262,144).
constexpr int kManyRows = 65536;

// At most kResident one-group blocks an SM, for one scan.  The block
// dispatcher fills an SM up to what its registers allow (six blocks at 80
// registers) and spreads a call's live slices unevenly over the SMs, and
// the call lasts as long as its busiest SM.  Five blocks keep an SM as busy
// as six, so the launch asks for the dynamic shared memory that leaves room
// for five and no more: the fullscale window's live slices then fit the 132
// SMs in one even wave.  That argument holds for one wave only: a batch of
// B > 1 such clouds launches B times the blocks, many waves whose balance
// the cap does not set, so a batch launches without the pad (six an SM).
// The instantiation is chosen by the queries of one scan, so a scan's
// blocks are the same alone and in a batch.
constexpr int kResident = 5;

static int residency_pad(int* pad) {
  int dev = 0, per_sm = 0, reserved = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, knn_mean<1, 128>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int room = per_sm / kResident - reserved - static_cast<int>(attr.sharedSizeBytes);
  *pad = room > 0 ? room / 1024 * 1024 : 0;
  return 0;
}

// channels, psq and valid [batch, n]; starts [all tiles]; the query tiles
// tile_first .. tile_first + tiles - 1 (all of them, or one shard's range);
// out [batch, tiles * row_tile]
extern "C" int pcp_knn_mean(const float* px, const float* py, const float* pz, const float* psq,
                            const unsigned char* valid, const int* starts, int batch, int n,
                            int tile_first, int tiles, int row_tile, int width, int k, float big,
                            float half, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles * row_tile >= kManyRows) {
    static int pad = -1;  // set at the first launch
    if (pad < 0) {
      const int err = residency_pad(&pad);
      if (err) return err;
    }
    dim3 grid(tiles, (row_tile + kQ * 128 - 1) / (kQ * 128), batch);
    knn_mean<1, 128><<<grid, 128, batch == 1 ? pad : 0, s>>>(
        px, py, pz, psq, valid, starts, n, tile_first, row_tile, width, k, big, half, out);
  } else {
    dim3 grid(tiles, (row_tile + kQ * 32 - 1) / (kQ * 32), batch);
    knn_mean<4, 32><<<grid, 128, 0, s>>>(px, py, pz, psq, valid, starts, n, tile_first,
                                         row_tile, width, k, big, half, out);
  }
  return static_cast<int>(cudaGetLastError());
}
