// Leaf evaluation shared by K1 (masked_product_sum.cu) and K2
// (fused_filter_agg.cu): a column-vs-literal comparison over float32 or int32
// columns, in Spark's NaN-greatest order or in IEEE order. K2 tests each
// leaf a row (leaf_code, leaf_passes); K1 folds a column's leaves into one
// interval on the host (Interval, narrow, interval_bits).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

namespace leaves {

enum ColType : int32_t { kF32 = 0, kI32 = 1 };
enum Op : int32_t { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4 };

__host__ __device__ __forceinline__ bool is_nan(double x) { return x != x; }

// A leaf as an interval test: for a non-NaN x, r = x < b ? 0 : x == b ? 1 : 2
// indexes `mask` (bit 0 lt, bit 1 eq, bit 2 gt of op); a NaN x takes
// `nanpass`. A NaN bound compares every x as 2, so its mask's bit 2 holds
// the answer for a non-NaN x. code = slot | mask << 4 | nanpass << 7.
template <bool NanGreatest>
__host__ __device__ __forceinline__ int leaf_code(int slot, int op, double b) {
  const int mask = op == kLt ? 1 : op == kLe ? 3 : op == kGt ? 4
                 : op == kGe ? 6 : 2;
  const bool bn = is_nan(b);
  int m = mask, nanpass = 0;
  if (NanGreatest) {
    // a NaN x is the greatest value, and equal to a NaN bound; a NaN
    // bound is greater than every other x
    nanpass = bn ? (mask >> 1) & 1 : (mask >> 2) & 1;
    if (bn) m = (mask & 1) << 2;
  } else if (bn) {
    m = 0;  // IEEE: every comparison with NaN is false
  }
  return slot | (m << 4) | (nanpass << 7);
}

__device__ __forceinline__ bool leaf_passes(double x, double b, int code) {
  if (is_nan(x)) return (code >> 7) & 1;
  const int r = x < b ? 0 : (x == b ? 1 : 2);
  return (code >> (4 + r)) & 1;
}

// The leaves on one column as one closed interval of the column's own type,
// built on the host: a non-NaN x passes every leaf on the column when
// lo <= x <= hi, compared as float32 or as int32, and a NaN x when nanpass.
// This is exact: for a float32 x and a double bound b, x < b is x < c and
// x > b is x > d, where c and d are the float32 values nearest b from above
// and below (equal where b is a float32); for an int32 x, c and d are
// ceil(b) and floor(b). An empty interval is lo = +inf, hi = -inf (float32)
// or lo = INT32_MAX, hi = INT32_MIN.
struct Interval {
  double lo = -INFINITY, hi = INFINITY;
  bool nanpass = true;
  bool empty = false;
};

inline float float_above(double b) {  // least float32 >= b
  float f = (float)b;
  return (double)f < b ? nextafterf(f, INFINITY) : f;
}

inline float float_below(double b) {  // greatest float32 <= b
  float f = (float)b;
  return (double)f > b ? nextafterf(f, -INFINITY) : f;
}

// Narrow `iv` by one leaf, given as leaf_code's answers: bits 4-6 hold the
// answer for x below, at and above the bound, bit 7 the answer for NaN x.
inline void narrow(Interval& iv, int code, double b, bool is_float) {
  const int m = (code >> 4) & 7;
  iv.nanpass = iv.nanpass && ((code >> 7) & 1);
  double lo, hi;
  if (is_nan(b)) {  // every non-NaN x compares as above a NaN bound
    lo = -INFINITY;
    hi = INFINITY;
    iv.empty = iv.empty || !((m >> 2) & 1);
  } else if (is_float) {
    const double c = float_above(b), d = float_below(b);
    // x > b is x >= the float32 after d; x < b is x <= the one before c
    lo = (m & 1) ? -INFINITY : (m & 2) ? c
       : (d == INFINITY ? NAN : (double)nextafterf((float)d, INFINITY));
    hi = (m & 4) ? INFINITY : (m & 2) ? d
       : (c == -INFINITY ? NAN : (double)nextafterf((float)c, -INFINITY));
  } else {
    lo = (m & 1) ? -INFINITY : (m & 2) ? ceil(b) : floor(b) + 1;
    hi = (m & 4) ? INFINITY : (m & 2) ? floor(b) : ceil(b) - 1;
  }
  if (!(lo <= hi)) {  // NaN ends too
    iv.empty = true;
    return;
  }
  iv.lo = lo > iv.lo ? lo : iv.lo;
  iv.hi = hi < iv.hi ? hi : iv.hi;
}

// The interval's ends as 32-bit words of the column's type.
inline void interval_bits(const Interval& iv, bool is_float, uint32_t* lo,
                          uint32_t* hi) {
  const bool empty = iv.empty || !(iv.lo <= iv.hi);
  if (is_float) {
    const float l = empty ? INFINITY : (float)iv.lo;
    const float h = empty ? -INFINITY : (float)iv.hi;
    memcpy(lo, &l, 4);
    memcpy(hi, &h, 4);
    return;
  }
  const double l = iv.lo < -2147483648.0 ? -2147483648.0 : iv.lo;
  const double h = iv.hi > 2147483647.0 ? 2147483647.0 : iv.hi;
  const bool none = empty || l > h;
  *lo = (uint32_t)(none ? INT32_MAX : (int32_t)l);
  *hi = (uint32_t)(none ? INT32_MIN : (int32_t)h);
}

}  // namespace leaves
