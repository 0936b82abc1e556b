// Leaf evaluation shared by K1 (masked_product_sum.cu) and K2
// (fused_filter_agg.cu): a column-vs-literal comparison over float32 or int32
// columns, in Spark's NaN-greatest order or in IEEE order.
#pragma once

#include <stdint.h>

namespace leaves {

enum ColType : int32_t { kF32 = 0, kI32 = 1 };
enum Op : int32_t { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4 };

__device__ __forceinline__ double pick(double v0, double v1, double v2,
                                       double v3, int s) {
  return s == 0 ? v0 : s == 1 ? v1 : s == 2 ? v2 : v3;
}

__device__ __forceinline__ bool is_nan(double x) { return x != x; }

// float32 and int32 values are exact in double, so comparing there gives the
// column type's own result.
template <bool NanGreatest>
__device__ __forceinline__ bool compare(double x, int op, double b) {
  if (NanGreatest) {
    const bool xn = is_nan(x), bn = is_nan(b);
    const bool lt = !xn && (bn || x < b);
    const bool gt = !bn && (xn || b < x);
    const bool eq = (x == b) || (xn && bn);
    switch (op) {
      case kLt: return lt;
      case kLe: return lt || eq;
      case kGt: return gt;
      case kGe: return gt || eq;
      default: return eq;
    }
  }
  switch (op) {
    case kLt: return x < b;
    case kLe: return x <= b;
    case kGt: return x > b;
    case kGe: return x >= b;
    default: return x == b;
  }
}

// A leaf as an interval test: for a non-NaN x, r = x < b ? 0 : x == b ? 1 : 2
// indexes `mask` (bit 0 lt, bit 1 eq, bit 2 gt of op); a NaN x takes
// `nanpass`. A NaN bound compares every x as 2, so its mask's bit 2 holds
// the answer for a non-NaN x. code = slot | mask << 4 | nanpass << 7.
template <bool NanGreatest>
__device__ __forceinline__ int leaf_code(int slot, int op, double b) {
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

__device__ __forceinline__ double load(const void* col, int32_t type,
                                       int64_t i) {
  if (type == kF32) return (double)__ldg(static_cast<const float*>(col) + i);
  return (double)__ldg(static_cast<const int32_t*>(col) + i);
}

}  // namespace leaves
