// The reference's float32 arcsin and tan, bit for bit, on the card.
//
// Device forms of ops/libm.py (see its docstring): XLA:CPU evaluates
// jnp.arcsin(x) as 2 * atan2f(x, 1 + sqrt((1 - x) * (1 + x))) under
// flush-to-zero, and jnp.tan as the C library's tanf; on the x86-64 Linux
// hosts the reference runs on (glibc 2.36) those are fdlibm's e_atan2f.c
// and s_atanf.c, and glibc's s_tanf.c (the argument reduced in float64,
// reduce_fast / reduce_large of s_sincosf.h) over fdlibm's k_tanf.c.  Every
// step is one IEEE operation rounded to nearest, written with the _rn
// intrinsics in the library's operand order, so nothing is contracted
// whatever the flags; the constants are the library's bit patterns.  One
// thread evaluates one value: the branches are the library's own.

#pragma once

#include <cstdint>

namespace pcp_libm {

__device__ __forceinline__ float bf(unsigned bits) { return __uint_as_float(bits); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// a subnormal as a zero of its sign (XLA:CPU's flush-to-zero mode)
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < bf(0x00800000u) ? mul(v, 0.0f) : v;
}

// s_atanf.c
__device__ inline float atanf(float x) {
  const int hx = __float_as_int(x);
  const int ix = hx & 0x7fffffff;
  if (ix >= 0x4c000000) {  // |x| >= 2^25
    if (ix > 0x7f800000) return add(x, x);
    return hx > 0 ? add(bf(0x33a22168u), bf(0x3fc90fdau)) : sub(bf(0xbfc90fdau), bf(0x33a22168u));
  }
  int id;
  if (ix < 0x3ee00000) {  // |x| < 7/16
    if (ix < 0x31000000) return x;  // |x| < 2^-29
    id = -1;
  } else {
    const float ax = fabsf(x);
    if (ix < 0x3f980000) {
      if (ix < 0x3f300000) {
        id = 0;
        x = div(sub(add(ax, ax), 1.0f), add(ax, 2.0f));
      } else {
        id = 1;
        x = div(sub(ax, 1.0f), add(ax, 1.0f));
      }
    } else if (ix < 0x401c0000) {
      id = 2;
      x = div(sub(ax, 1.5f), add(mul(ax, 1.5f), 1.0f));
    } else {
      id = 3;
      x = div(-1.0f, ax);
    }
  }
  const float z = mul(x, x);
  const float w = mul(z, z);
  float s1 = bf(0x3c8569d7u);  // aT[10], aT[8], ... aT[0]
  s1 = add(mul(s1, w), bf(0x3d4bda59u));
  s1 = add(mul(s1, w), bf(0x3d886b35u));
  s1 = add(mul(s1, w), bf(0x3dba2e6eu));
  s1 = add(mul(s1, w), bf(0x3e124925u));
  s1 = add(mul(s1, w), bf(0x3eaaaaabu));
  s1 = mul(s1, z);
  float s2 = mul(w, bf(0xbd15a221u));  // aT[9]; then -aT[7], -aT[5], -aT[3], -aT[1] subtracted
  s2 = mul(sub(s2, bf(0x3d6ef16bu)), w);
  s2 = mul(sub(s2, bf(0x3d9d8795u)), w);
  s2 = mul(sub(s2, bf(0x3de38e38u)), w);
  s2 = mul(sub(s2, bf(0x3e4ccccdu)), w);
  const float s = mul(add(s1, s2), x);
  if (id < 0) return sub(x, s);
  const unsigned hi[4] = {0x3eed6338u, 0x3f490fdau, 0x3f7b985eu, 0x3fc90fdau};
  const unsigned lo[4] = {0x31ac3769u, 0x33222168u, 0x33140fb4u, 0x33a22168u};
  const float r = sub(bf(hi[id]), sub(sub(s, bf(lo[id])), x));
  return hx < 0 ? -r : r;
}

// e_atan2f.c; FLUSH: as under XLA:CPU's flush-to-zero mode, where a
// quotient y / x below the least normal is zero
template <bool FLUSH>
__device__ inline float atan2f(float y, float x) {
  const float pi = bf(0x40490fdbu), pi_o_2 = bf(0x3fc90fdbu), pi_o_4 = bf(0x3f490fdbu);
  const float tiny = bf(0x0da24260u), neg_pi_lo = bf(0x33bbbd2eu);
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return add(x, y);
  if (hx == 0x3f800000) return atanf(y);
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);
  if (iy == 0) {
    if (m == 2) return add(tiny, pi);
    if (m == 3) return sub(-pi, tiny);
    return y;
  }
  if (ix == 0) return hy < 0 ? sub(-pi_o_2, tiny) : add(tiny, pi_o_2);
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      switch (m) {
        case 0: return add(tiny, pi_o_4);
        case 1: return sub(-pi_o_4, tiny);
        case 2: return add(mul(3.0f, pi_o_4), tiny);
        default: return sub(mul(-3.0f, pi_o_4), tiny);
      }
    }
    switch (m) {
      case 0: return 0.0f;
      case 1: return -0.0f;
      case 2: return add(tiny, pi);
      default: return sub(-pi, tiny);
    }
  }
  if (iy == 0x7f800000) return hy < 0 ? sub(-pi_o_2, tiny) : add(tiny, pi_o_2);
  const int k = (iy - ix) >> 23;
  float z;
  if (k > 60) {
    z = sub(pi_o_2, bf(0x333bbd2eu));
  } else if (hx < 0 && k < -60) {
    z = 0.0f;
  } else {
    float q = div(y, x);
    // x86 detects the underflow before rounding: a quotient that rounds up
    // to the least normal is flushed too (the float64 quotient decides)
    if (FLUSH && fabs(__ddiv_rn(static_cast<double>(y), static_cast<double>(x))) <
                     static_cast<double>(bf(0x00800000u)))
      q = mul(q, 0.0f);
    z = atanf(fabsf(q));
  }
  switch (m) {
    case 0: return z;
    case 1: return -z;
    case 2: return sub(pi, add(z, neg_pi_lo));
    default: return sub(add(z, neg_pi_lo), pi);
  }
}

// k_tanf.c as glibc 2.36 builds it: tan(x + y) for iy = 1, -1/tan(x + y)
// for iy = -1, |x + y| <= pi/4
__device__ inline float kernel_tanf(float x, float y, int iy) {
  const int hx = __float_as_int(x);
  const int ix = hx & 0x7fffffff;
  if (ix < 0x39000000) {  // |x| < 2^-13
    if ((ix | (iy + 1)) == 0) return div(1.0f, fabsf(x));
    if (iy == 1) return x;
    return div(-1.0f, x);
  }
  const bool big = ix >= 0x3f2ca140;  // |x| >= 0.6744
  const float sign = static_cast<float>(1 - ((hx >> 30) & 2));
  if (big) {
    if (hx < 0) {
      x = -x;
      y = -y;
    }
    const float z = sub(bf(0x3f490fdau), x);  // pio4 - x
    x = add(sub(bf(0x33222168u), y), z);      // (pio4lo - y) + z
    y = 0.0f;
    if (fabsf(x) < bf(0x39000000u))  // glibc's short cut near pi/4
      return mul(mul(sign, static_cast<float>(iy)), sub(1.0f, mul(static_cast<float>(2 * iy), x)));
  }
  const float z = mul(x, x);
  const float w = mul(z, z);
  const float s = mul(x, z);
  float r = bf(0xb79bae5fu);  // T[11], T[9], ... T[1]
  r = add(mul(r, w), bf(0x38a3f445u));
  r = add(mul(r, w), bf(0x3a1a26c8u));
  r = add(mul(r, w), bf(0x3b6b6916u));
  r = add(mul(r, w), bf(0x3cb327a4u));
  r = add(mul(r, w), bf(0x3e088889u));
  float v = bf(0x37d95384u);  // T[12], T[10], ... T[2]
  v = add(mul(v, w), bf(0x3895c07au));
  v = add(mul(v, w), bf(0x398137b9u));
  v = add(mul(v, w), bf(0x3abede48u));
  v = add(mul(v, w), bf(0x3c11371fu));
  v = add(mul(v, w), bf(0x3d5d0dd1u));
  r = add(y, mul(add(mul(add(mul(v, z), r), s), y), z));
  r = add(mul(s, bf(0x3eaaaaabu)), r);  // + T[0] * s
  const float wx = add(x, r);
  if (big) {
    const float fy = static_cast<float>(iy);
    const float t = sub(x, sub(div(mul(wx, wx), add(wx, fy)), r));
    return mul(sign, sub(fy, add(t, t)));
  }
  if (iy == 1) return wx;
  // -1/wx to full precision through the parts with 12 mantissa bits cleared
  const float zt = __int_as_float(__float_as_int(wx) & ~0xfff);
  const float vv = sub(r, sub(zt, x));
  const float a = div(-1.0f, wx);
  const float t = __int_as_float(__float_as_int(a) & ~0xfff);
  return add(t, mul(add(mul(vv, t), add(mul(zt, t), 1.0f)), a));
}

// s_sincosf.h's reduce_large: x - n * pi/2 for |x| >= 120, from the bits of
// 2/pi
__device__ inline double reduce_large(unsigned xi, int* np) {
  const unsigned inv_pio4[24] = {
      0x000000a2u, 0x0000a2f9u, 0x00a2f983u, 0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u,
      0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u,
      0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u,
      0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};
  const unsigned* arr = &inv_pio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  const unsigned m = ((xi & 0xffffffu) | 0x800000u) << shift;
  uint64_t res0 = m * arr[0];
  const uint64_t res1 = static_cast<uint64_t>(m) * arr[4];
  const uint64_t res2 = static_cast<uint64_t>(m) * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  *np = static_cast<int>(n);
  return __dmul_rn(__ll2double_rn(static_cast<long long>(res0)),
                   __longlong_as_double(0x3c1921fb54442d18ll));  // pi/2 * 2^-62
}

// s_tanf.c
__device__ inline float tanf(float x) {
  const int hx = __float_as_int(x);
  const int ix = hx & 0x7fffffff;
  if (ix <= 0x3f490fda) return kernel_tanf(x, 0.0f, 1);  // |x| <~ pi/4
  if (ix >= 0x7f800000) return sub(x, x);
  double r;
  int n;
  if (((hx >> 20) & 0x7ff) < 0x42f) {  // |x| < 120: reduce_fast
    const double dx = static_cast<double>(x);
    const double q = __dmul_rn(dx, __longlong_as_double(0x41645f306dc9c883ll));  // 2^24 * 2/pi
    n = (__double2int_rz(q) + 0x800000) >> 24;
    r = __dsub_rn(dx, __dmul_rn(static_cast<double>(n),
                                __longlong_as_double(0x3ff921fb54442d18ll)));  // pi/2
  } else {
    r = reduce_large(static_cast<unsigned>(hx), &n);
    if (hx < 0) r = -r;
  }
  const float y0 = __double2float_rn(r);
  const float y1 = __double2float_rn(__dsub_rn(r, static_cast<double>(y0)));
  return kernel_tanf(y0, y1, 1 - ((n & 1) << 1));
}

// XLA:CPU's arcsin: 2 * atan2f(x, 1 + sqrt((1 - x) * (1 + x))) with
// subnormals flushed to zero, in and out
__device__ inline float asin_like_xla(float x) {
  x = flush(x);
  const float s = __fsqrt_rn(mul(sub(1.0f, x), add(1.0f, x)));
  return mul(2.0f, atan2f<true>(x, add(1.0f, s)));
}

}  // namespace pcp_libm
