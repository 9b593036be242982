// glibc's `log` and `pow` for Hopper (sm_90a), bit for bit.
//
// The reference's compiled CPU code calls glibc's log and pow for SQL's
// ln and power; the card's own log and pow round elsewhere in the last
// bit. Since glibc 2.28 both are Arm optimized-routines' algorithms: a
// 128-entry table and a polynomial for log, and for pow a double-double
// log (its own table) followed by a table-driven exp. On a CPU with FMA
// and AVX2, glibc's ifunc picks the build compiled with -mfma
// (`__log_fma`, `__pow_fma`), in which GCC contracted most adds into
// FMAs. Every `fma` below is one FMA instruction of that build, read
// from `objdump -d` of libm; every other operation rounds on its own,
// which is why this file is compiled with -fmad=false
// (ops/cuda_build.py). The tables are libm's own data
// (glibc_math_tables.h, written by tools/extract_glibc_math_tables.py).
// ops/project.py `glibc_log_plain` / `glibc_pow_plain` are the plain
// torch versions of the same steps.
//
// The special cases keep glibc's branches: log of 0, a negative number,
// inf, NaN and a subnormal; pow's zero/inf/NaN operands, a negative base
// (checked for an integral exponent), |y| < 2^-65 or >= 2^63, a
// subnormal base, and exp's overflow, underflow and the rounding into
// the subnormal range. The caller (ops/project.pow_like_reference)
// applies the reference's flush of subnormals around the call.
//
// What bounds it: operations. One thread per element, 8 or 16 bytes in
// and 8 out; about 30 double operations for log and 70 for pow, from
// tables that stay in L1.

#include <cuda_runtime.h>
#include <stdint.h>

#define GLIBC_TABLE_QUAL __device__
#include "glibc_math_tables.h"

namespace {

__device__ __forceinline__ double dbl(uint64_t b) {
  return __longlong_as_double((long long)b);
}
__device__ __forceinline__ uint64_t bits(double x) {
  return (uint64_t)__double_as_longlong(x);
}

__device__ double log_fma(double x, const unsigned long long* T) {
  const double ln2hi = dbl(T[0]), ln2lo = dbl(T[1]);
  const unsigned long long* A = T + 2;   // poly[5]
  const unsigned long long* B = T + 7;   // poly1[11]
  const unsigned long long* tab = T + 18;
  uint64_t ix = bits(x);
  uint32_t top = (uint32_t)(ix >> 48);
  const uint64_t LO = 0x3fee000000000000ull, HI = 0x3ff1090000000000ull;
  if (ix - LO < HI - LO) {
    if (ix == 0x3ff0000000000000ull) return 0.0;
    double r = x - 1.0;
    double r2 = r * r;
    double r3 = r * r2;
    double p1 = fma(r2, dbl(B[3]), fma(r, dbl(B[2]), dbl(B[1])));
    double p2 = fma(r2, dbl(B[6]), fma(r, dbl(B[5]), dbl(B[4])));
    double p3 = fma(r3, dbl(B[10]),
                    fma(r2, dbl(B[9]), fma(r, dbl(B[8]), dbl(B[7]))));
    double q = fma(fma(p3, r3, p2), r3, p1);
    double rhi = fma(-0x1p27, r, fma(r, 0x1p27, r));
    double rlo = r - rhi;
    double rhi2 = rhi * rhi;
    double hi = fma(rhi2, dbl(B[0]), r);
    double lo = fma(rhi2, dbl(B[0]), r - hi);
    lo = fma(dbl(B[0]) * rlo, r + rhi, lo);
    return hi + fma(q, r3, lo);
  }
  if (top - 0x0010 >= 0x7ff0 - 0x0010) {
    if ((ix << 1) == 0) return -__longlong_as_double(0x7ff0000000000000ll);
    if (ix == 0x7ff0000000000000ull) return x;
    if ((top & 0x8000) || (top & 0x7ff0) == 0x7ff0)
      return __longlong_as_double(0x7ff8000000000000ll);
    ix = bits(x * 0x1p52);
    ix -= 52ull << 52;
  }
  uint64_t tmp = ix - 0x3fe6000000000000ull;
  int i = (int)((tmp >> 45) % 128);
  double kd = (double)((int64_t)tmp >> 52);
  double z = dbl(ix - (tmp & (0xfffull << 52)));
  double invc = dbl(tab[2 * i]), logc = dbl(tab[2 * i + 1]);
  double r = fma(z, invc, -1.0);
  double w = fma(kd, ln2hi, logc);
  double hi = w + r;
  double lo = fma(kd, ln2lo, (w - hi) + r);
  double r2 = r * r;
  double p = fma(fma(r, dbl(A[4]), dbl(A[3])), r2,
                 fma(r, dbl(A[2]), dbl(A[1])));
  return fma(r * r2, p, fma(r2, dbl(A[0]), lo)) + hi;
}

// log_inline: log(x) = hi + lo for x > 0 normal, given by its bits
__device__ double pow_log(uint64_t ix, double* tail,
                          const unsigned long long* T) {
  const double ln2hi = dbl(T[0]), ln2lo = dbl(T[1]);
  const unsigned long long* A = T + 2;   // poly[7]
  const unsigned long long* tab = T + 9;  // {invc, pad, logc, logctail}
  uint64_t tmp = ix - 0x3fe6955500000000ull;
  int i = (int)((tmp >> 45) % 128);
  double kd = (double)((int64_t)tmp >> 52);
  double z = dbl(ix - (tmp & (0xfffull << 52)));
  double invc = dbl(tab[4 * i]), logc = dbl(tab[4 * i + 2]);
  double logctail = dbl(tab[4 * i + 3]);
  double r = fma(z, invc, -1.0);
  double t1 = fma(kd, ln2hi, logc);
  double lo1 = fma(kd, ln2lo, logctail);
  double t2 = t1 + r;
  double lo2 = (t1 - t2) + r;
  double ar = r * dbl(A[0]);
  double ar2 = r * ar;
  double ar3 = r * ar2;
  double lo3 = fma(ar, r, -ar2);
  double hi = t2 + ar2;
  double lo4 = (t2 - hi) + ar2;
  double q = fma(ar2, fma(fma(r, dbl(A[6]), dbl(A[5])), ar2,
                          fma(r, dbl(A[4]), dbl(A[3]))),
                 fma(r, dbl(A[2]), dbl(A[1])));
  double lo = fma(ar3, q, ((lo1 + lo2) + lo3) + lo4);
  double y = hi + lo;
  *tail = (hi - y) + lo;
  return y;
}

#define SIGN_BIAS (0x800u << 7)

// exp_inline: exp(x + xtail), negated when sign_bias is set
__device__ double pow_exp(double x, double xtail, uint32_t sign_bias,
                          const unsigned long long* T) {
  const double invln2n = dbl(T[0]), neghi = dbl(T[1]), neglo = dbl(T[2]);
  const unsigned long long* C = T + 3;   // poly[4]: C2..C5
  const double shift = dbl(T[7]);
  const unsigned long long* tab = T + 14;
  uint32_t abstop = (uint32_t)(bits(x) >> 52) & 0x7ff;
  if (abstop - 0x3c9 >= 0x408 - 0x3c9) {
    if (abstop - 0x3c9 >= 0x80000000u) {
      double one = 1.0 + x;
      return sign_bias ? -one : one;
    }
    if (abstop >= 0x409) {
      const double inf = __longlong_as_double(0x7ff0000000000000ll);
      double big = (bits(x) >> 63) ? 0.0 : inf;
      return sign_bias ? -big : big;
    }
    abstop = 0;
  }
  double kraw = fma(x, invln2n, shift);
  uint64_t ki = bits(kraw);
  double kd = kraw - shift;
  double r = xtail + fma(kd, neglo, fma(kd, neghi, x));
  uint64_t idx = 2 * (ki % 128);
  uint64_t top = (ki + sign_bias) << 45;
  double tail = dbl(tab[idx]);
  uint64_t sbits = tab[idx + 1] + top;
  double r2 = r * r;
  double tmp = fma(fma(r, dbl(C[3]), dbl(C[2])), r2 * r2,
                   fma(fma(r, dbl(C[1]), dbl(C[0])), r2, r + tail));
  if (abstop == 0) {
    if ((ki & 0x80000000u) == 0) {
      double scale = dbl(sbits - (1009ull << 52));
      return fma(scale, tmp, scale) * 0x1p1009;
    }
    sbits += 1022ull << 52;
    double scale = dbl(sbits);
    double t = tmp * scale;
    double y = scale + t;
    if (fabs(y) < 1.0) {
      double one = y < 0.0 ? -1.0 : 1.0;
      double lo = (scale - y) + t;
      double hi = y + one;
      y = ((((one - hi) + y) + lo) + hi) - one;
      if (y == 0) y = dbl(sbits & 0x8000000000000000ull);
    }
    return y * 0x1p-1022;
  }
  double scale = dbl(sbits);
  return fma(tmp, scale, scale);
}

__device__ int checkint(uint64_t iy) {
  int e = (int)(iy >> 52 & 0x7ff);
  if (e < 0x3ff) return 0;
  if (e > 0x3ff + 52) return 2;
  if (iy & ((1ull << (0x3ff + 52 - e)) - 1)) return 0;
  if (iy & (1ull << (0x3ff + 52 - e))) return 1;
  return 2;
}

__device__ __forceinline__ bool zeroinfnan(uint64_t i) {
  return 2 * i - 1 >= 2 * 0x7ff0000000000000ull - 1;
}

__device__ double pow_fma(double x, double y, const unsigned long long* LT,
                            const unsigned long long* ET) {
  const double inf = __longlong_as_double(0x7ff0000000000000ll);
  uint32_t sign_bias = 0;
  uint64_t ix = bits(x), iy = bits(y);
  uint32_t topx = (uint32_t)(ix >> 52), topy = (uint32_t)(iy >> 52);
  if (topx - 0x001 >= 0x7ff - 0x001 ||
      (topy & 0x7ff) - 0x3be >= 0x43e - 0x3be) {
    if (zeroinfnan(iy)) {
      if (2 * iy == 0) return 1.0;
      if (ix == 0x3ff0000000000000ull) return 1.0;
      if (2 * ix > 2 * 0x7ff0000000000000ull ||
          2 * iy > 2 * 0x7ff0000000000000ull)
        return x + y;
      if (2 * ix == 2 * 0x3ff0000000000000ull) return 1.0;
      if ((2 * ix < 2 * 0x3ff0000000000000ull) == !(iy >> 63)) return 0.0;
      return y * y;
    }
    if (zeroinfnan(ix)) {
      double x2 = x * x;
      if ((ix >> 63) && checkint(iy) == 1) {
        x2 = -x2;
        sign_bias = 1;
      }
      if (2 * ix == 0 && (iy >> 63)) return sign_bias ? -inf : inf;
      return (iy >> 63) ? 1.0 / x2 : x2;
    }
    if (ix >> 63) {
      int yint = checkint(iy);
      if (yint == 0) return __longlong_as_double(0x7ff8000000000000ll);
      if (yint == 1) sign_bias = SIGN_BIAS;
      ix &= 0x7fffffffffffffffull;
      topx &= 0x7ff;
    }
    if ((topy & 0x7ff) - 0x3be >= 0x43e - 0x3be) {
      if (ix == 0x3ff0000000000000ull) return 1.0;
      if ((topy & 0x7ff) < 0x3be)
        return ix > 0x3ff0000000000000ull ? 1.0 + y : 1.0 - y;
      return (ix > 0x3ff0000000000000ull) == (topy < 0x800) ? inf : 0.0;
    }
    if (topx == 0) {
      ix = bits(x * 0x1p52);
      ix &= 0x7fffffffffffffffull;
      ix -= 52ull << 52;
    }
  }
  double lo;
  double hi = pow_log(ix, &lo, LT);
  double ehi = y * hi;
  double elo = fma(y, lo, fma(hi, y, -ehi));
  return pow_exp(ehi, elo, sign_bias, ET);
}

__global__ void log_kernel(const double* __restrict__ x,
                           double* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = log_fma(__ldg(x + i), GLIBC_LOG_DATA_BITS);
}

__global__ void pow_kernel(const double* __restrict__ x,
                           const double* __restrict__ y,
                           double* __restrict__ out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    out[i] = pow_fma(__ldg(x + i), __ldg(y + i), GLIBC_POW_LOG_DATA_BITS,
                       GLIBC_EXP_DATA_BITS);
}

constexpr int THREADS = 256;

}  // namespace

extern "C" int glibc_log(const double* x, double* out, int64_t n,
                         cudaStream_t stream) {
  log_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
               stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

extern "C" int glibc_pow(const double* x, const double* y, double* out,
                         int64_t n, cudaStream_t stream) {
  pow_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
               stream>>>(x, y, out, n);
  return (int)cudaGetLastError();
}
