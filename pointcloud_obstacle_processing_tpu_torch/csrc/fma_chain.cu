// XLA:CPU's contracted multiply-add chains: ops.fma, ops.sum_sq3, ops.dot3,
// ops.add_sq3 (ops.fma_chain), one elementwise launch a call.
//
// Replaces no TPU kernel.  It carries XLA:CPU's contraction of a multiply
// into the add it feeds, which the JAX package leaves to plain XLA: the
// reference's float32 sums of products (the voxel key, |p|^2, the distance
// kernels' cross term, RANSAC's hypotheses and plane distance, the outlier
// gate, the transforms, the shadow, the grid cells) are fused chains on
// XLA:CPU.  Per element, in the chain's order, one of two forms:
//
//   fma:    acc = __fmaf_rn(a, b, c)
//   chain:  acc = __fmul_rn(a0, b0); acc = __fmaf_rn(a1, b1, acc);
//           acc = __fmaf_rn(a2, b2, acc)
//
// Each step is one IEEE rounding, so the result is bitwise the plain form
// (ops.fma_chain_plain: ops.fma_plain a step, the correctly rounded fused
// result on the CPU).  It replaces the float64 form the port ran on the card
// before: three casts, a multiply, an add and a cast a fma, four to six
// launches and float64 temporaries, which rounded twice on ties.
//
// Operands are float32, read in place: each by its strides over the
// output's broadcast shape (0 on a broadcast dim; the host merges the dims
// that every operand steps through as one, at most kMaxDims remain), or by
// value (a 0-d CPU tensor: a constant of the reference).  The output is
// contiguous.  A grid-stride loop; a thread takes four consecutive results
// wherever the innermost size allows (one index decomposition for the
// four, one 16-byte store), else one; 32-bit index arithmetic wherever the
// element count allows.
//
// Bound on the H100: bytes, the operands read once and 4 bytes an element
// written, over 3.35 TB/s (a chain's few steps are far below the float32
// rate).  At RANSAC's scoring shapes ([B, N, 1] points against [B, 1, K]
// planes) the output dominates: 4 bytes an element.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxDims = 8;
constexpr int kMaxOperands = 6;  // three pairs, or a pair and the addend
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

// ops._FMA_ARGS: every field 8 bytes; dims outermost first
struct OperandArgs {
  long long ptr;   // 0: by value
  long long bits;  // the value's float32 bits
  long long stride[kMaxDims];
};

struct ChainArgs {
  long long n, dims, pairs, addend;
  long long size[kMaxDims];
  OperandArgs op[kMaxOperands];
  long long out, stream;
};

// the kernel's view of a call, dims innermost first
struct Chain {
  const float* ptr[kMaxOperands];
  float value[kMaxOperands];
  long long stride[kMaxOperands][kMaxDims];
  long long size[kMaxDims];
  int dims;
};

// V consecutive elements a thread (V divides the innermost size, so they
// share their outer coordinates): one index decomposition for V results,
// stored together
template <int P, bool kAddend, typename Idx, int V>
__global__ void __launch_bounds__(kThreads) fma_chain(Chain ch, Idx groups, float* __restrict__ out) {
  constexpr int K = 2 * P + (kAddend ? 1 : 0);
  const Idx step = static_cast<Idx>(gridDim.x) * kThreads;
  for (Idx g = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += step) {
    long long off[K];
#pragma unroll
    for (int k = 0; k < K; ++k) off[k] = 0;
    Idx rest = g * V;
#pragma unroll
    for (int j = 0; j < kMaxDims; ++j) {
      if (j >= ch.dims) break;
      const Idx size = static_cast<Idx>(ch.size[j]);
      const Idx q = j + 1 < ch.dims ? rest / size : 0;
      const long long coord = static_cast<long long>(rest - q * size);
      rest = q;
#pragma unroll
      for (int k = 0; k < K; ++k) off[k] += coord * ch.stride[k][j];
    }
    // each operand's V values: a constant, one load where the operand is
    // broadcast along the innermost dim, one 16-byte load where it is
    // contiguous there and aligned, else V loads
    float v[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* p = ch.ptr[k];
      const long long st = ch.stride[k][0];
      if (!p) {
#pragma unroll
        for (int u = 0; u < V; ++u) v[k][u] = ch.value[k];
      } else if (st == 0) {
        const float x = p[off[k]];
#pragma unroll
        for (int u = 0; u < V; ++u) v[k][u] = x;
      } else if (V == 4 && st == 1 && (reinterpret_cast<uintptr_t>(p + off[k]) & 15) == 0) {
        const float4 x = *reinterpret_cast<const float4*>(p + off[k]);
        v[k][0] = x.x;
        v[k][V > 1 ? 1 : 0] = x.y;
        v[k][V > 2 ? 2 : 0] = x.z;
        v[k][V > 3 ? 3 : 0] = x.w;
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) v[k][u] = p[off[k] + u * st];
      }
    }
    float res[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float acc = kAddend ? v[K - 1][u] : __fmul_rn(v[0][u], v[1][u]);
#pragma unroll
      for (int k = kAddend ? 0 : 1; k < P; ++k) {
        acc = __fmaf_rn(v[2 * k][u], v[2 * k + 1][u], acc);
      }
      res[u] = acc;
    }
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(out)[g] = make_float4(res[0], res[1], res[2], res[3]);
    } else {
      out[g] = res[0];
    }
  }
}

template <int P, bool kAddend, int V>
cudaError_t launch_v(const Chain& ch, long long n, float* out, cudaStream_t st) {
  const long long groups = n / V;
  const long long blocks = (groups + kThreads - 1) / kThreads < kMaxBlocks
                               ? (groups + kThreads - 1) / kThreads
                               : kMaxBlocks;
  // 32-bit indices where the last step cannot pass 2^32
  if (n + blocks * kThreads * V < (1ll << 32)) {
    fma_chain<P, kAddend, unsigned, V><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        ch, static_cast<unsigned>(groups), out);
  } else {
    fma_chain<P, kAddend, unsigned long long, V>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
            ch, static_cast<unsigned long long>(groups), out);
  }
  return cudaGetLastError();
}

template <int P, bool kAddend>
cudaError_t launch(const Chain& ch, long long n, float* out, cudaStream_t st) {
  // four results a thread where the innermost size allows (the output is
  // a fresh allocation, so 16-byte aligned)
  if (ch.dims >= 1 && ch.size[0] % 4 == 0) return launch_v<P, kAddend, 4>(ch, n, out, st);
  return launch_v<P, kAddend, 1>(ch, n, out, st);
}

}  // namespace

extern "C" int pcp_fma_chain(const void* packed) {
  ChainArgs x;
  memcpy(&x, packed, sizeof(x));
  if (x.n <= 0) return 0;
  // the two forms: a fma (one pair and the addend), a three-pair chain
  const bool fma = x.pairs == 1 && x.addend == 1, chain3 = x.pairs == 3 && x.addend == 0;
  if (x.dims < 0 || x.dims > kMaxDims || !(fma || chain3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dims = static_cast<int>(x.dims);
  const int operands = static_cast<int>(2 * x.pairs + x.addend);
  Chain ch;
  memset(&ch, 0, sizeof(ch));
  ch.dims = dims;
  for (int j = 0; j < dims; ++j) ch.size[j] = x.size[dims - 1 - j];
  for (int k = 0; k < operands; ++k) {
    ch.ptr[k] = reinterpret_cast<const float*>(x.op[k].ptr);
    const int32_t bits = static_cast<int32_t>(x.op[k].bits);
    memcpy(&ch.value[k], &bits, sizeof(float));
    for (int j = 0; j < dims; ++j) ch.stride[k][j] = x.op[k].stride[dims - 1 - j];
  }
  float* out = reinterpret_cast<float*>(x.out);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(x.stream);
  return static_cast<int>(fma ? launch<1, true>(ch, x.n, out, st)
                              : launch<3, false>(ch, x.n, out, st));
}
