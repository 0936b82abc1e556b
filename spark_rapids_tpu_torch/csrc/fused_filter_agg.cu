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
// Design: one launch.
//   - The grid is sized to the card, not to the rows: as many blocks as fit
//     on every SM at once (at most 4 an SM, read once a device with the
//     occupancy calculator; 2 for either edition's 128 registers), fewer
//     where the rows are few. Each thread steps
//     over 4-row groups: one 16-byte load a used column and of an int32 key
//     (two for an int64 key) and one 4-byte load a validity or selection
//     mask. A scalar loop takes the rows past the last whole group, and every
//     row where the wrapper's `aligned` flag is 0 (a column or key not 16-byte
//     aligned, or a mask not 4-byte aligned); it runs the same code on a
//     group that holds one row.
//   - The leaf table is read once into registers, each leaf as its bound
//     and the answers of its op for x below, at and above it and for a NaN
//     x (leaves::leaf_code): a leaf is then three compares in double, exact
//     for float32 and int32 columns, and no switch.
//   - A group is filtered leaf by leaf over its 4 rows at once (four
//     independent compares a leaf), and stops at the first leaf that no
//     row of it passes: most q6 groups stop after the ship-date leaves.
//   - A thread keeps 9 Acc sums and two 32-bit counts a slot (it sees far
//     fewer than 2^31 rows); counts widen to int64 at the block level.
//   - One reduction a block: warp shuffles (a warp-wide integer add for the
//     32-bit counts) bring the 28 values to lane 0, which writes its warp's
//     row of a shared array; after one barrier one warp sums the rows in
//     warp order and writes the block's partial row.
//   - The finish in the same launch: each block writes its partial, fences,
//     and takes a ticket from a counter; the block that draws the last ticket
//     sums every block's partial (read through L2 with __ldcg) with the same
//     fixed-order reduction, writes the outputs and resets the counter to 0.
//     No float atomics, and the grid depends only on the card and the row
//     count, so one input gives the same bits on every run.
//   - The counter lives in a workspace the wrapper keeps per (device,
//     stream), with the partials: launches on one stream run in order, so
//     the last block's reset is seen by the next launch, and launches on two
//     streams never share a counter. That needs no memset launch per call,
//     which zeroing the counter in the entry point would.
// The Pallas edition needed n % (2048 * 128) == 0; any length works here.
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
  int32_t aligned;   // 1: columns and key 16-byte, masks 4-byte aligned
  FfaLeaf leaf[8];
};

}  // extern "C"

namespace {

constexpr int kSlots = 4;
constexpr int kLeaves = 8;
constexpr int kGroupSlots = 9;  // at most 8 groups and the null slot
constexpr int kCounts = 2 * kGroupSlots + 1;  // non-null, rows, outside
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // rows a thread loads at once
constexpr int kMaxBlocks = 1024;
constexpr int kBlocksPerSm = 4;
constexpr uint32_t kAllValid = 0x01010101u;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// 32-bit counts: one warp-wide add
__device__ __forceinline__ int32_t warp_sum(int32_t v) {
  return (int32_t)__reduce_add_sync(0xffffffffu, (unsigned)v);
}

// A thread's state: the sums and counts of each slot and the outside count.
template <typename Acc, typename C>
struct State {
  Acc sum[kGroupSlots];
  C nonnull[kGroupSlots];
  C rows[kGroupSlots];
  C oor;

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < kGroupSlots; ++q) {
      sum[q] = Acc(0);
      nonnull[q] = 0;
      rows[q] = 0;
    }
    oor = 0;
  }
};

template <typename Acc>
struct Shared {
  Acc sum[kWarps][kGroupSlots];
  long long count[kWarps][kCounts];
  int last;
};

// The block's totals: lane q < 9 of warp 0 returns slot q's sum in *sum, lane
// 9 + k < 28 count k (non-null counts, row counts, outside) in *count. One
// barrier; every thread of the block calls it.
template <typename Acc, typename C>
__device__ __forceinline__ void block_totals(Shared<Acc>& sh,
                                             const State<Acc, C>& st,
                                             Acc* sum, long long* count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kGroupSlots; ++q) {
    const Acc s = warp_sum(st.sum[q]);
    const C n = warp_sum(st.nonnull[q]);
    const C r = warp_sum(st.rows[q]);
    if (lane == 0) {
      sh.sum[warp][q] = s;
      sh.count[warp][q] = n;
      sh.count[warp][kGroupSlots + q] = r;
    }
  }
  const C o = warp_sum(st.oor);
  if (lane == 0) sh.count[warp][2 * kGroupSlots] = o;
  __syncthreads();
  *sum = Acc(0);
  *count = 0;
  if (warp == 0) {
    if (lane < kGroupSlots) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) *sum += sh.sum[w][lane];
    } else if (lane < kGroupSlots + kCounts) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        *count += sh.count[w][lane - kGroupSlots];
    }
  }
}

// The leaf table, read once a thread into registers: bound and
// leaves::leaf_code (slot, the ops' answers, the answer for NaN).
struct LeafTable {
  double bound[kLeaves];
  int code[kLeaves];
  int n;
};

__device__ __forceinline__ uint32_t lane32(const uint4& x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

__device__ __forceinline__ uint4 pick4(const uint4 (&c)[kSlots], int s) {
  return s == 0 ? c[0] : s == 1 ? c[1] : s == 2 ? c[2] : c[3];
}

__device__ __forceinline__ uint32_t pick1(const uint32_t (&c)[kSlots], int s) {
  return s == 0 ? c[0] : s == 1 ? c[1] : s == 2 ? c[2] : c[3];
}

// One 4-row group's loads: each used column, the key, and the masks (byte q
// of a mask is row q's).
struct Group {
  uint4 col[kSlots];
  uint4 key[2];  // int32 keys in key[0]; int64 keys in both
  uint32_t valid[kSlots];
  uint32_t sel, key_valid;
};

__device__ __forceinline__ void load_group(const FfaArgs& a, int64_t g,
                                           Group& x) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    x.col[k] = a.col[k] == nullptr ? make_uint4(0, 0, 0, 0)
        : __ldg(static_cast<const uint4*>(a.col[k]) + g);
    x.valid[k] = a.valid[k] == nullptr ? kAllValid
        : __ldg(reinterpret_cast<const uint32_t*>(a.valid[k]) + g);
  }
  x.sel = a.sel == nullptr ? kAllValid
      : __ldg(reinterpret_cast<const uint32_t*>(a.sel) + g);
  x.key_valid = a.key_valid == nullptr ? kAllValid
      : __ldg(reinterpret_cast<const uint32_t*>(a.key_valid) + g);
  const uint4* kp = static_cast<const uint4*>(a.key);
  if (a.key_type == 0) {
    x.key[0] = __ldg(kp + g);
  } else {
    x.key[0] = __ldg(kp + 2 * g);
    x.key[1] = __ldg(kp + 2 * g + 1);
  }
}

// Row i alone, in row 0 of a group.
__device__ __forceinline__ void load_row(const FfaArgs& a, int64_t i,
                                         Group& x) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    x.col[k] = make_uint4(a.col[k] == nullptr ? 0u
        : __ldg(static_cast<const uint32_t*>(a.col[k]) + i), 0, 0, 0);
    x.valid[k] = a.valid[k] == nullptr ? 1u : __ldg(a.valid[k] + i);
  }
  x.sel = a.sel == nullptr ? 1u : __ldg(a.sel + i);
  x.key_valid = a.key_valid == nullptr ? 1u : __ldg(a.key_valid + i);
  const int64_t k = a.key_type == 0
      ? (int64_t)__ldg(static_cast<const int32_t*>(a.key) + i)
      : (int64_t)__ldg(static_cast<const long long*>(a.key) + i);
  x.key[0] = make_uint4((uint32_t)k, (uint32_t)((uint64_t)k >> 32), 0, 0);
}

__device__ __forceinline__ bool byte_set(uint32_t m, int q) {
  return ((m >> (8 * q)) & 0xFFu) != 0;
}

// The rows of `rows` (bit q: row q is live) of one group: every leaf over
// the group's rows at once, leaf after leaf while a row still passes, then
// each passing row's product into its group's slot.
template <typename Acc>
__device__ __forceinline__ void add_group(const FfaArgs& a, const LeafTable& L,
                                          int float_cols, const Group& x,
                                          unsigned rows,
                                          State<Acc, int32_t>& st) {
#pragma unroll
  for (int j = 0; j < kLeaves; ++j) {
    if (j >= L.n || rows == 0) break;
    const int code = L.code[j], s = code & 3;
    const double b = L.bound[j];
    const uint4 col = pick4(x.col, s);
    const uint32_t valid = pick1(x.valid, s);
    if ((float_cols >> s) & 1) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (((rows >> q) & 1u) && !(byte_set(valid, q) &&
              leaves::leaf_passes((double)__uint_as_float(lane32(col, q)), b,
                                  code)))
          rows &= ~(1u << q);
    } else {
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (((rows >> q) & 1u) && !(byte_set(valid, q) &&
              leaves::leaf_passes((double)(int32_t)lane32(col, q), b, code)))
          rows &= ~(1u << q);
    }
  }
  if (rows == 0) return;
  const uint4 ca = pick4(x.col, a.a_slot), cb = pick4(x.col, a.b_slot);
  const uint32_t va = pick1(x.valid, a.a_slot), vb = pick1(x.valid, a.b_slot);
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    if (!((rows >> q) & 1u)) continue;
    int g = a.groups;
    if (byte_set(x.key_valid, q)) {
      const int64_t key = a.key_type == 0
          ? (int64_t)(int32_t)lane32(x.key[0], q)
          : (int64_t)(((uint64_t)lane32(x.key[q >> 1], 2 * (q & 1) + 1) << 32)
                      | lane32(x.key[q >> 1], 2 * (q & 1)));
      const int64_t gg = key - a.base;
      if (gg < 0 || gg >= a.groups) {
        ++st.oor;
        continue;
      }
      g = (int)gg;
    }
    const bool prod_ok = byte_set(va, q) && byte_set(vb, q);
    // __fmul_rn is never contracted into an FMA: the product is rounded to
    // float32 before it is added, as the engine's Multiply produces it
    const Acc p = prod_ok ? (Acc)__fmul_rn(__uint_as_float(lane32(ca, q)),
                                           __uint_as_float(lane32(cb, q)))
                          : Acc(0);
#pragma unroll
    for (int k = 0; k < kGroupSlots; ++k) {
      if (k == g) {
        st.sum[k] += p;
        st.nonnull[k] += prod_ok ? 1 : 0;
        st.rows[k] += 1;
      }
    }
  }
}

template <typename Acc, bool Engine>
__global__ void __launch_bounds__(kThreads, 2)
ffa_kernel(const FfaArgs a, Acc* __restrict__ part_sum,
           long long* __restrict__ part_count, unsigned int* ticket,
           Acc* __restrict__ out_sum, long long* __restrict__ out_nonnull,
           long long* __restrict__ out_rows, long long* __restrict__ out_oor) {
  __shared__ Shared<Acc> sh;
  LeafTable L;
#pragma unroll
  for (int j = 0; j < kLeaves; ++j) {
    L.bound[j] = a.leaf[j].bound;
    L.code[j] = leaves::leaf_code<Engine>(a.leaf[j].slot, a.leaf[j].op,
                                          a.leaf[j].bound);
  }
  L.n = a.n_leaves;
  int float_cols = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    float_cols |= (a.col_type[k] == leaves::kF32 ? 1 : 0) << k;
  State<Acc, int32_t> st;
  st.zero();
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t groups = a.aligned ? a.row_count / kGroup : 0;
  for (int64_t g = tid; g < groups; g += nthreads) {
    Group x;
    load_group(a, g, x);
    unsigned rows = 0;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) rows |= byte_set(x.sel, q) ? 1u << q : 0u;
    add_group<Acc>(a, L, float_cols, x, rows, st);
  }
  // the rows past the last whole group, or every row off alignment
  for (int64_t i = groups * kGroup + tid; i < a.row_count; i += nthreads) {
    Group x;
    load_row(a, i, x);
    add_group<Acc>(a, L, float_cols, x, x.sel != 0 ? 1u : 0u, st);
  }

  // this block's partial row, then a ticket
  const int lane = threadIdx.x & 31;
  Acc bsum;
  long long bcount;
  block_totals(sh, st, &bsum, &bcount);
  if (threadIdx.x < 32) {
    if (lane < kGroupSlots) part_sum[blockIdx.x * kGroupSlots + lane] = bsum;
    else if (lane < kGroupSlots + kCounts)
      part_count[blockIdx.x * kCounts + lane - kGroupSlots] = bcount;
    __threadfence();  // the partial is visible before the ticket is taken
    __syncwarp();
    if (lane == 0)
      sh.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh.last) return;

  // the last block: every partial, in block order
  __threadfence();
  State<Acc, long long> tot;
  tot.zero();
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
#pragma unroll
    for (int q = 0; q < kGroupSlots; ++q) {
      tot.sum[q] += __ldcg(part_sum + b * kGroupSlots + q);
      tot.nonnull[q] += __ldcg(part_count + b * kCounts + q);
      tot.rows[q] += __ldcg(part_count + b * kCounts + kGroupSlots + q);
    }
    tot.oor += __ldcg(part_count + b * kCounts + 2 * kGroupSlots);
  }
  __syncthreads();  // sh is reused
  block_totals(sh, tot, &bsum, &bcount);
  if (threadIdx.x < 32) {
    if (lane < kGroupSlots) {
      out_sum[lane] = bsum;
    } else if (lane < 2 * kGroupSlots) {
      out_nonnull[lane - kGroupSlots] = bcount;
    } else if (lane < 3 * kGroupSlots) {
      out_rows[lane - 2 * kGroupSlots] = bcount;
    } else if (lane == 3 * kGroupSlots) {
      *out_oor = bcount;
      *ticket = 0;  // for the next launch on this stream
    }
  }
}

// Blocks a launch: all that fit on the card at once (at most kBlocksPerSm an
// SM), fewer where there are fewer 4-row groups a thread; read once a device.
template <typename Acc, bool Engine>
int grid_for(int64_t rows, int* blocks) {
  static int per_device[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    int sms = 0, fit = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fit, ffa_kernel<Acc, Engine>, kThreads, 0)) != cudaSuccess)
      return (int)e;
    fit = fit < 1 ? 1 : (fit > kBlocksPerSm ? kBlocksPerSm : fit);
    const int card = sms * fit;
    per_device[dev] = card < kMaxBlocks ? card : kMaxBlocks;
  }
  const int64_t need = (rows + kThreads * kGroup - 1) / (kThreads * kGroup);
  *blocks = need < 1 ? 1 : (need < per_device[dev] ? (int)need
                                                    : per_device[dev]);
  return 0;
}

template <typename Acc, bool Engine>
int launch(const FfaArgs& a, void* part_sum, void* part_count, void* ticket,
           void* out_sum, void* out_nonnull, void* out_rows, void* out_oor,
           cudaStream_t st) {
  int blocks = 0;
  const int e = grid_for<Acc, Engine>(a.row_count, &blocks);
  if (e != 0) return e;
  ffa_kernel<Acc, Engine><<<blocks, kThreads, 0, st>>>(
      a, static_cast<Acc*>(part_sum), static_cast<long long*>(part_count),
      static_cast<unsigned int*>(ticket), static_cast<Acc*>(out_sum),
      static_cast<long long*>(out_nonnull), static_cast<long long*>(out_rows),
      static_cast<long long*>(out_oor));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spark_ffa_args_size() { return (int)sizeof(FfaArgs); }

int spark_ffa_max_blocks() { return kMaxBlocks; }

int spark_ffa_group_slots() { return kGroupSlots; }

int spark_ffa_counts() { return kCounts; }

// edition 0: engine (double sums, NaN-greatest); 1: K2 contract (float sums,
// IEEE). The workspace of the caller's stream: part_sum holds kMaxBlocks x
// kGroupSlots doubles, part_count kMaxBlocks x kCounts int64, ticket one
// uint32 that is 0 between launches. out_* hold kGroupSlots entries (out_oor
// one).
int spark_ffa_launch(const void* args, int edition, void* part_sum,
                     void* part_count, void* ticket, void* out_sum,
                     void* out_nonnull, void* out_rows, void* out_oor,
                     void* stream) {
  if (args == nullptr || part_sum == nullptr || part_count == nullptr ||
      ticket == nullptr)
    return (int)cudaErrorInvalidValue;
  const FfaArgs a = *static_cast<const FfaArgs*>(args);
  if (a.n_leaves < 0 || a.n_leaves > kLeaves || a.groups < 1 ||
      a.groups >= kGroupSlots || a.key == nullptr || a.row_count < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (edition == 0)
    return launch<double, true>(a, part_sum, part_count, ticket, out_sum,
                                out_nonnull, out_rows, out_oor, st);
  if (edition == 1)
    return launch<float, false>(a, part_sum, part_count, ticket, out_sum,
                                out_nonnull, out_rows, out_oor, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
