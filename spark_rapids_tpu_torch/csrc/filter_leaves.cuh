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

__device__ __forceinline__ double load(const void* col, int32_t type,
                                       int64_t i) {
  if (type == kF32) return (double)__ldg(static_cast<const float*>(col) + i);
  return (double)__ldg(static_cast<const int32_t*>(col) + i);
}

}  // namespace leaves
