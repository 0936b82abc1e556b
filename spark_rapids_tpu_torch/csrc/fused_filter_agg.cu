// K2 for Hopper: filter conjuncts, then a float32 product, then a sum per
// group of a small keyspace, in one pass over a batch.
//
// Replaces fused_filter_agg_pallas (spark_rapids_tpu/ops/pallas_kernels.py:225,
// body _fused_agg_kernel at :205), the hand-written form of the grouped
// partial-aggregate tail of the scan-rooted fused chain: decode -> filter ->
// project(a * b) -> sum per key. One template gives two editions:
//   <double, true>  engine edition: Spark semantics. A row is live when it is
//                   below row_count and the selection keeps it; it passes
//                   when every leaf column is valid and every leaf compares
//                   true in NaN-greatest order. Its group is key - base for a
//                   key in [base, base + groups), the extra slot `groups` for
//                   a null key; a live passing row whose key lies outside the
//                   range adds nothing and is counted in `oor` (the caller
//                   raises on it). Per group: the float64 sum of a * b
//                   (rounded in float32 first) over rows whose product is
//                   non-null, their count, and the count of passing rows.
//   <float, false>  K2-contract edition: exactly fused_filter_agg_xla
//                   (pallas_kernels.py:189): q6's leaves in IEEE order, an
//                   int32 key, float32 sums over the 8 groups 0..7; rows whose
//                   key is outside 0..7 add nothing.
//
// Bound: memory. Each row reads 4 B per used column (16 B for q6's four),
// its key (4 or 8 B), and 1 B per validity mask and of selection where
// present; the work is a few compares, one multiply and one add per row. A
// q6 batch of 750,152 rows with an int32 key reads 15.0 MB: about 4.5 us at
// 3.35 TB/s.
//
// Design, simple first: a grid-stride loop in which neighbouring threads read
// neighbouring rows; each thread keeps groups + 1 sums and counts in registers
// (the group is picked by an unrolled compare, so no local-memory indexing);
// warp shuffles then shared memory leave one partial per block and group in
// scratch that the caller allocates; a one-block second pass sums the
// partials in a fixed order. No float atomics, so one input gives the same
// bits on every run. The Pallas edition needed n % (2048 * 128) == 0; the
// loop stops at row_count, so any length works. The leaf comparisons are in
// filter_leaves.cuh, shared with K1.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_leaves.cuh"

extern "C" {

struct FfaLeaf {
  double bound;
  int32_t slot;
  int32_t op;
};

struct FfaArgs {
  const void* col[4];
  const uint8_t* valid[4];
  const uint8_t* sel;
  const void* key;
  const uint8_t* key_valid;
  int64_t row_count;
  int64_t base;
  int32_t col_type[4];
  int32_t key_type;  // 0: int32, 1: int64
  int32_t groups;    // 1..8; slot `groups` holds the null key
  int32_t n_leaves;
  int32_t a_slot;
  int32_t b_slot;
  int32_t pad_;
  FfaLeaf leaf[8];
};

}  // extern "C"

namespace {

constexpr int kSlots = 4;
constexpr int kGroupSlots = 9;  // at most 8 groups and the null slot
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kFinalThreads = 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over the block, valid in thread 0. blockDim.x is a multiple
// of 32 and at most 1024.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? part[lane] : T(0);
    v = warp_sum(v);
  }
  __syncthreads();  // part is reused by the next call
  return v;
}

template <bool NanGreatest>
__device__ __forceinline__ bool row_passes(const FfaArgs& a, int64_t i,
                                           double* v) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    v[k] = a.col[k] == nullptr ? 0.0 : leaves::load(a.col[k], a.col_type[k], i);
  for (int j = 0; j < a.n_leaves; ++j) {
    const int s = a.leaf[j].slot;
    if (a.valid[s] != nullptr && !__ldg(a.valid[s] + i)) return false;
    const double x = leaves::pick(v[0], v[1], v[2], v[3], s);
    if (!leaves::compare<NanGreatest>(x, a.leaf[j].op, a.leaf[j].bound))
      return false;
  }
  return true;
}

template <typename Acc, bool Engine>
__global__ void __launch_bounds__(kThreads)
ffa_partial(const FfaArgs a, Acc* __restrict__ part_sum,
            long long* __restrict__ part_nonnull,
            long long* __restrict__ part_rows,
            long long* __restrict__ part_oor) {
  Acc s[kGroupSlots];
  long long nn[kGroupSlots], rows[kGroupSlots];
#pragma unroll
  for (int q = 0; q < kGroupSlots; ++q) {
    s[q] = Acc(0);
    nn[q] = 0;
    rows[q] = 0;
  }
  long long oor = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.row_count; i += stride) {
    if (a.sel != nullptr && !__ldg(a.sel + i)) continue;
    double v[kSlots];
    if (!row_passes<Engine>(a, i, v)) continue;
    int g;
    if (a.key_valid != nullptr && !__ldg(a.key_valid + i)) {
      g = a.groups;
    } else {
      const int64_t k = a.key_type == 0
          ? (int64_t)__ldg(static_cast<const int32_t*>(a.key) + i)
          : (int64_t)__ldg(static_cast<const long long*>(a.key) + i);
      const int64_t gg = k - a.base;
      if (gg < 0 || gg >= a.groups) {
        ++oor;
        continue;
      }
      g = (int)gg;
    }
    const bool prod_ok =
        (a.valid[a.a_slot] == nullptr || __ldg(a.valid[a.a_slot] + i)) &&
        (a.valid[a.b_slot] == nullptr || __ldg(a.valid[a.b_slot] + i));
    // __fmul_rn is never contracted into an FMA: the product is rounded to
    // float32 before it is added, as the engine's Multiply produces it
    const Acc p = prod_ok
        ? (Acc)__fmul_rn((float)leaves::pick(v[0], v[1], v[2], v[3], a.a_slot),
                         (float)leaves::pick(v[0], v[1], v[2], v[3], a.b_slot))
        : Acc(0);
#pragma unroll
    for (int q = 0; q < kGroupSlots; ++q) {
      if (q == g) {
        s[q] += p;
        nn[q] += prod_ok ? 1 : 0;
        rows[q] += 1;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kGroupSlots; ++q) {
    const Acc bs = block_sum(s[q]);
    const long long bn = block_sum(nn[q]);
    const long long br = block_sum(rows[q]);
    if (threadIdx.x == 0) {
      part_sum[blockIdx.x * kGroupSlots + q] = bs;
      part_nonnull[blockIdx.x * kGroupSlots + q] = bn;
      part_rows[blockIdx.x * kGroupSlots + q] = br;
    }
  }
  const long long bo = block_sum(oor);
  if (threadIdx.x == 0) part_oor[blockIdx.x] = bo;
}

template <typename Acc>
__global__ void __launch_bounds__(kFinalThreads)
ffa_final(const Acc* __restrict__ part_sum,
          const long long* __restrict__ part_nonnull,
          const long long* __restrict__ part_rows,
          const long long* __restrict__ part_oor, int blocks,
          Acc* __restrict__ out_sum, long long* __restrict__ out_nonnull,
          long long* __restrict__ out_rows, long long* __restrict__ out_oor) {
  for (int q = 0; q < kGroupSlots; ++q) {
    Acc s = Acc(0);
    long long n = 0, r = 0;
    for (int b = threadIdx.x; b < blocks; b += blockDim.x) {
      s += part_sum[b * kGroupSlots + q];
      n += part_nonnull[b * kGroupSlots + q];
      r += part_rows[b * kGroupSlots + q];
    }
    s = block_sum(s);
    n = block_sum(n);
    r = block_sum(r);
    if (threadIdx.x == 0) {
      out_sum[q] = s;
      out_nonnull[q] = n;
      out_rows[q] = r;
    }
  }
  long long o = 0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) o += part_oor[b];
  o = block_sum(o);
  if (threadIdx.x == 0) *out_oor = o;
}

template <typename Acc, bool Engine>
int launch(const FfaArgs& a, void* part_sum, void* part_nonnull,
           void* part_rows, void* part_oor, int blocks, void* out_sum,
           void* out_nonnull, void* out_rows, void* out_oor,
           cudaStream_t st) {
  ffa_partial<Acc, Engine><<<blocks, kThreads, 0, st>>>(
      a, static_cast<Acc*>(part_sum), static_cast<long long*>(part_nonnull),
      static_cast<long long*>(part_rows), static_cast<long long*>(part_oor));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ffa_final<Acc><<<1, kFinalThreads, 0, st>>>(
      static_cast<const Acc*>(part_sum),
      static_cast<const long long*>(part_nonnull),
      static_cast<const long long*>(part_rows),
      static_cast<const long long*>(part_oor), blocks,
      static_cast<Acc*>(out_sum), static_cast<long long*>(out_nonnull),
      static_cast<long long*>(out_rows), static_cast<long long*>(out_oor));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spark_ffa_args_size() { return (int)sizeof(FfaArgs); }

int spark_ffa_max_blocks() { return kMaxBlocks; }

int spark_ffa_group_slots() { return kGroupSlots; }

// edition 0: engine (double sums, NaN-greatest); 1: K2 contract (float sums,
// IEEE). part_* hold blocks x kGroupSlots entries (part_oor `blocks`); out_*
// kGroupSlots (out_oor one).
int spark_ffa_launch(const void* args, int edition, void* part_sum,
                     void* part_nonnull, void* part_rows, void* part_oor,
                     int blocks, void* out_sum, void* out_nonnull,
                     void* out_rows, void* out_oor, void* stream) {
  if (args == nullptr || blocks < 1 || blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const FfaArgs a = *static_cast<const FfaArgs*>(args);
  if (a.n_leaves < 0 || a.n_leaves > 8 || a.groups < 1 ||
      a.groups >= kGroupSlots || a.key == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (edition == 0)
    return launch<double, true>(a, part_sum, part_nonnull, part_rows,
                                part_oor, blocks, out_sum, out_nonnull,
                                out_rows, out_oor, st);
  if (edition == 1)
    return launch<float, false>(a, part_sum, part_nonnull, part_rows,
                                part_oor, blocks, out_sum, out_nonnull,
                                out_rows, out_oor, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
