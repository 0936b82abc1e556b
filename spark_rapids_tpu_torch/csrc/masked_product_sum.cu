// K1 for Hopper: filter conjuncts, then a float32 product, then a sum, in
// one launch over a batch.
//
// Replaces masked_product_sum_pallas (spark_rapids_tpu/ops/pallas_kernels.py:58,
// body _kernel at :43), the hand-written form of TPC-H q6's
// filter -> project -> sum chain. One template gives two editions:
//   <double, true>  engine edition: Spark semantics, a float64 sum and
//                   NaN-greatest comparisons; the engine launches it once per
//                   batch for a Filter(And of column-vs-literal comparisons)
//                   -> Project(a * b) -> ungrouped Sum chain.
//   <float, false>  K1-contract edition: exactly masked_product_sum_xla
//                   (pallas_kernels.py:33), a float32 sum with IEEE
//                   comparisons.
// A row counts when it is live (row < row_count and the selection, if any,
// keeps it), every used column is valid at it, and every leaf compares
// true: the Kleene AND of the leaves, kept only where TRUE, as the engine's
// filter does. It adds (Acc)(a * b), the product rounded in float32 first,
// and the int64 count of the rows that count.
//
// Bound: memory. Each row reads 4 B per used column (16 B for q6's four
// columns) plus 1 B per validity mask and 1 B of selection where present;
// the work is a few compares and one multiply-add per row. A q6 batch of
// 750,152 live rows reads 12.0 MB: 3.6 us at the H100's 3.35 TB/s. At that
// size the latency of the first loads and the launch's finish weigh as
// much as the stream itself, so the design asks for the whole batch's
// bytes at once and ends in the same launch.
//
// Design: one launch.
//   - The grid is sized to the card, not to the rows: as many blocks as fit
//     on every SM at once (3 an SM, 256 threads each, read once a device
//     with the occupancy calculator), fewer where the rows are few.
//   - Every byte a block reads is requested before its first compare: each
//     thread issues the loads of kAhead = 2 4-row groups, at a stride of the
//     grid's threads, before it filters any: one 16-byte streaming load
//     (__ldcs: each byte is read once) a used column and one 4-byte load a
//     mask a group. At a q6 batch the grid's first round (396 blocks,
//     811,008 rows) covers every row, so the whole batch is requested at
//     once. (One-dimensional TMA bulk copies of each block's 1024-row slices
//     into shared memory, two stages in flight, were tried in place of the
//     registers and were slower at a q6 batch: PERF.md.)
//     A scalar loop takes the rows past the last whole group (at most 3),
//     and every row where the wrapper's `aligned` flag is 0 (a column off
//     16-byte alignment, a mask off 4-byte alignment); it runs the same
//     code on a group that holds one row.
//   - The leaves are turned on the host, in the entry point, into one test
//     a column (leaves::narrow): the closed interval of the column's own
//     type that a non-NaN value must lie in to pass every leaf on it, and
//     whether a NaN passes. This is exact for float32 and int32 columns
//     under both orders, and a test is two float32 or int32 compares a
//     row, read from the kernel's parameters: no double compare, no
//     conversion, no switch, no branch a row. (Leaf codes compared in
//     double a row and leaf, as K2 does, took over a third of the kernel's
//     time at a q6 batch in a trial build.) The plan puts
//     the columns in the order of their first leaves, so test t reads the
//     group's column t. A group is tested column by column over its 4 rows
//     at once and stops at the first column that no row of it passes: most
//     q6 groups stop after the ship date's.
//   - A thread keeps its sum and a 32-bit count (it sees far fewer than
//     2^31 rows); counts widen to int64 at the block. One reduction a
//     block: warp shuffles (a warp-wide integer add for the count) leave
//     one row a warp in shared memory, and after one barrier thread 0 sums
//     the rows in warp order.
//   - The finish in the same launch: each block writes its partial and
//     takes a ticket from a counter with one acquire-release atomic; the
//     block that draws the last ticket sums every block's partial in block
//     order (read through L2 with __ldcg), writes the outputs and resets
//     the counter to 0. No
//     float atomics, and the grid depends only on the card and the row
//     count, so one input gives the same bits on every run.
//   - The counter lives in a workspace the wrapper keeps per (device,
//     stream), with the partials: launches on one stream run in order, so
//     the last block's reset is seen by the next launch, and launches on
//     two streams never share a counter.
// The Pallas edition needed n % (2048 * 128) == 0; any length works here.
//
// The leaf comparisons are in filter_leaves.cuh, shared with K2.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_leaves.cuh"

extern "C" {

struct FpsLeaf {
  double bound;
  int32_t slot;
  int32_t op;
};

struct FpsArgs {
  const void* col[4];
  const uint8_t* valid[4];
  const uint8_t* sel;
  int64_t row_count;
  int32_t col_type[4];
  int32_t n_leaves;
  int32_t a_slot;
  int32_t b_slot;
  int32_t aligned;  // 1: columns at 16 bytes, masks at 4
  FpsLeaf leaf[8];
};

}  // extern "C"

namespace {

constexpr int kSlots = 4;
constexpr int kMasks = kSlots + 1;  // each slot's validity, then the selection
constexpr int kLeaves = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;         // rows of one 16-byte load
constexpr int kAhead = 2;         // groups a thread loads at once
constexpr int kBlockRows = kThreads * kGroup;  // a block's rows a round
constexpr int kMaxBlocks = 1024;
constexpr int kBlocksPerSm = 4;
constexpr int kMinBlocks = 3;    // an SM, for the register budget
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

template <typename Acc>
struct Shared {
  Acc sum[kWarps];
  long long count[kWarps];
  int last;
};

// The block's sum and count, in thread 0's *sum and *count. One barrier;
// every thread of the block calls it.
template <typename Acc, typename C>
__device__ __forceinline__ void block_total(Shared<Acc>& sh, Acc s, C c,
                                            Acc* sum, long long* count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  c = warp_sum(c);
  if (lane == 0) {
    sh.sum[warp] = s;
    sh.count[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc ts = Acc(0);
    long long tc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ts += sh.sum[w];
      tc += sh.count[w];
    }
    *sum = ts;
    *count = tc;
  }
}

// One column's leaves: lo <= x <= hi (float32 or int32 words), or a NaN x
// where nanpass.
struct ColTest {
  uint32_t lo, hi;
  int32_t flags;  // bit 0: float32 column, bit 1: a NaN passes
};

// What the kernel reads, built on the host from FpsArgs. The columns are
// in the order of their first leaves, then the untested ones: test t reads
// column t.
struct Plan {
  const void* col[kSlots];
  const uint8_t* mask[kMasks];  // the columns' validity, then the selection
  int64_t row_count;
  ColTest test[kSlots];
  int32_t n_tests;
  int32_t a_slot, b_slot;  // the product's columns, in the plan's order
  int32_t has_masks;
  int32_t aligned;
};

template <bool NanGreatest>
int build_plan(const FpsArgs& a, Plan* p) {
  *p = Plan{};
  leaves::Interval iv[kSlots];
  int order[kSlots], n = 0;
  for (int j = 0; j < a.n_leaves; ++j) {
    const FpsLeaf& f = a.leaf[j];
    if (f.slot < 0 || f.slot >= kSlots) return (int)cudaErrorInvalidValue;
    bool seen = false;
    for (int t = 0; t < n; ++t) seen = seen || order[t] == f.slot;
    if (!seen) order[n++] = f.slot;
    leaves::narrow(iv[f.slot],
                   leaves::leaf_code<NanGreatest>(f.slot, f.op, f.bound),
                   f.bound, a.col_type[f.slot] == leaves::kF32);
  }
  for (int t = 0; t < n; ++t) {
    const int s = order[t];
    const bool is_float = a.col_type[s] == leaves::kF32;
    leaves::interval_bits(iv[s], is_float, &p->test[t].lo, &p->test[t].hi);
    p->test[t].flags = (is_float ? 1 : 0) | (iv[s].nanpass ? 2 : 0);
  }
  p->n_tests = n;
  int m = n, at[kSlots];  // at[slot]: the slot's place in the plan
  for (int s = 0; s < kSlots; ++s) {
    at[s] = -1;
    for (int t = 0; t < n; ++t)
      if (order[t] == s) at[s] = t;
    if (at[s] < 0) at[s] = m++;
    p->col[at[s]] = a.col[s];
    p->mask[at[s]] = a.valid[s];
  }
  p->mask[kSlots] = a.sel;
  for (int k = 0; k < kMasks; ++k)
    p->has_masks |= p->mask[k] != nullptr ? 1 : 0;
  p->row_count = a.row_count;
  p->a_slot = at[a.a_slot];
  p->b_slot = at[a.b_slot];
  p->aligned = a.aligned;
  return 0;
}

__device__ __forceinline__ uint32_t lane32(const uint4& x, int q) {
  return q == 0 ? x.x : q == 1 ? x.y : q == 2 ? x.z : x.w;
}

__device__ __forceinline__ uint4 pick4(const uint4 (&c)[kSlots], int s) {
  return s == 0 ? c[0] : s == 1 ? c[1] : s == 2 ? c[2] : c[3];
}

// One 4-row group as loaded: each used column (zero where unused) and each
// mask (byte q is row q's flag; all set where the mask is absent).
struct Raw {
  uint4 col[kSlots];
  uint32_t mask[kMasks];
};

__device__ __forceinline__ void load_group(const Plan& p, int64_t g,
                                           Raw& x) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    x.col[k] = p.col[k] == nullptr ? make_uint4(0, 0, 0, 0)
        : __ldcs(static_cast<const uint4*>(p.col[k]) + g);
#pragma unroll
  for (int k = 0; k < kMasks; ++k)
    x.mask[k] = p.mask[k] == nullptr ? kAllValid
        : __ldcs(reinterpret_cast<const uint32_t*>(p.mask[k]) + g);
}

// Row i alone, in row 0 of a group.
__device__ __forceinline__ void load_row(const Plan& p, int64_t i, Raw& x) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    x.col[k] = make_uint4(p.col[k] == nullptr ? 0u
        : __ldg(static_cast<const uint32_t*>(p.col[k]) + i), 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kMasks; ++k)
    x.mask[k] = p.mask[k] == nullptr ? 1u : __ldg(p.mask[k] + i);
}

// The live rows of a group (bit q: row q), from its masks.
__device__ __forceinline__ unsigned live_rows(const Plan& p, const Raw& x) {
  if (!p.has_masks) return 0xFu;
  uint32_t all = 0xFFFFFFFFu;  // byte q: 0xFF while row q is live
#pragma unroll
  for (int k = 0; k < kMasks; ++k) all &= __vcmpne4(x.mask[k], 0u);
  return (all & 1u) | ((all >> 7) & 2u) | ((all >> 14) & 4u) |
         ((all >> 21) & 8u);
}

// The rows of a group (bit q) that pass test t.
__device__ __forceinline__ unsigned test_rows(const ColTest& t,
                                              const uint4& c) {
  unsigned ok = 0;
  if (t.flags & 1) {
    const float lo = __uint_as_float(t.lo), hi = __uint_as_float(t.hi);
    const bool nan_ok = (t.flags >> 1) & 1;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const float x = __uint_as_float(lane32(c, q));
      ok |= ((x >= lo && x <= hi) || (nan_ok && x != x) ? 1u : 0u) << q;
    }
  } else {
    const int32_t lo = (int32_t)t.lo, hi = (int32_t)t.hi;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int32_t x = (int32_t)lane32(c, q);
      ok |= (x >= lo && x <= hi ? 1u : 0u) << q;
    }
  }
  return ok;
}

// The rows of `rows` of one group: each column's test over the group's
// rows at once, column after column while a row still passes, then each
// passing row's product.
template <typename Acc>
__device__ __forceinline__ void add_group(const Plan& p, const Raw& x,
                                          unsigned rows, Acc& sum,
                                          int32_t& count) {
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    if (t >= p.n_tests || rows == 0) break;
    rows &= test_rows(p.test[t], x.col[t]);
  }
  if (rows == 0) return;
  const uint4 ca = pick4(x.col, p.a_slot), cb = pick4(x.col, p.b_slot);
#pragma unroll
  for (int q = 0; q < kGroup; ++q) {
    if (!((rows >> q) & 1u)) continue;
    // __fmul_rn is never contracted into an FMA: the product is rounded to
    // float32 before it is added, as the engine's Multiply produces it
    sum += (Acc)__fmul_rn(__uint_as_float(lane32(ca, q)),
                          __uint_as_float(lane32(cb, q)));
    ++count;
  }
}

// The whole 4-row groups, kAhead of them a thread at a stride of the
// grid's threads, every load issued before the first test (streaming
// loads: each byte is read once). Returns the rows it covered.
template <typename Acc>
__device__ __forceinline__ int64_t rows_registers(const Plan& p, Acc& sum,
                                                  int32_t& count) {
  const int64_t groups = p.aligned ? p.row_count / kGroup : 0;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  for (int64_t g0 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       g0 < groups; g0 += kAhead * nthreads) {
    Raw x[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (g0 + k * nthreads < groups) load_group(p, g0 + k * nthreads, x[k]);
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (g0 + k * nthreads < groups)
        add_group<Acc>(p, x[k], live_rows(p, x[k]), sum, count);
  }
  return groups * kGroup;
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fps_kernel(const Plan p, Acc* __restrict__ part_sum,
           long long* __restrict__ part_count, unsigned int* ticket,
           Acc* __restrict__ out_sum, long long* __restrict__ out_count) {
  __shared__ Shared<Acc> sh;
  Acc sum = Acc(0);
  int32_t count = 0;
  const int64_t done = rows_registers<Acc>(p, sum, count);
  // the rows past the last whole group, or every row off alignment
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  for (int64_t i = done + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < p.row_count; i += nthreads) {
    Raw x;
    load_row(p, i, x);
    add_group<Acc>(p, x, live_rows(p, x) & 1u, sum, count);
  }

  // this block's partial, then a ticket
  Acc bsum;
  long long bcount;
  block_total(sh, sum, count, &bsum, &bcount);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = bsum;
    part_count[blockIdx.x] = bcount;
    // release: the partial is visible before the ticket; acquire: the last
    // block sees every partial (its other threads through the barrier)
    unsigned int before;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(ticket) : "memory");
    sh.last = before == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh.last) return;

  // the last block: every partial, in block order
  Acc tsum = Acc(0);
  long long tcount = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    tsum += __ldcg(part_sum + b);
    tcount += __ldcg(part_count + b);
  }
  __syncthreads();  // sh is reused
  block_total(sh, tsum, tcount, &bsum, &bcount);
  if (threadIdx.x == 0) {
    *out_sum = bsum;
    *out_count = bcount;
    *ticket = 0;  // for the next launch on this stream
  }
}

// Blocks a launch: all that fit on the card at once (at most kBlocksPerSm an
// SM), fewer where the rows are fewer than that many blocks' kBlockRows;
// read once a device.
template <typename Acc>
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
             &fit, fps_kernel<Acc>, kThreads, 0)) != cudaSuccess)
      return (int)e;
    fit = fit < 1 ? 1 : (fit > kBlocksPerSm ? kBlocksPerSm : fit);
    const int card = sms * fit;
    per_device[dev] = card < kMaxBlocks ? card : kMaxBlocks;
  }
  const int64_t need = (rows + kBlockRows - 1) / kBlockRows;
  *blocks = need < 1 ? 1 : (need < per_device[dev] ? (int)need
                                                    : per_device[dev]);
  return 0;
}

template <typename Acc, bool NanGreatest>
int launch(const FpsArgs& a, void* part_sum, void* part_count, void* ticket,
           void* out_sum, void* out_count, cudaStream_t st) {
  Plan p;
  int e = build_plan<NanGreatest>(a, &p);
  if (e != 0) return e;
  int blocks = 0;
  if ((e = grid_for<Acc>(p.row_count, &blocks)) != 0) return e;
  fps_kernel<Acc><<<blocks, kThreads, 0, st>>>(
      p, static_cast<Acc*>(part_sum), static_cast<long long*>(part_count),
      static_cast<unsigned int*>(ticket), static_cast<Acc*>(out_sum),
      static_cast<long long*>(out_count));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spark_fps_args_size() { return (int)sizeof(FpsArgs); }

int spark_fps_max_blocks() { return kMaxBlocks; }

// The geometry, for the checks that walk its edges: a block's rows in the
// grid's size, the groups a thread asks for at once, and the blocks of a
// launch over `rows` on the current device (or a negative CUDA error).
int spark_fps_block_rows() { return kBlockRows; }

int spark_fps_ahead() { return kAhead; }

int spark_fps_grid(int edition, long long rows) {
  int blocks = 0;
  const int e = edition == 0 ? grid_for<double>(rows, &blocks)
                             : grid_for<float>(rows, &blocks);
  return e != 0 ? -e : blocks;
}

// edition 0: engine (double sum, NaN-greatest); 1: K1 contract (float sum,
// IEEE). The workspace of the caller's stream:
// part_sum holds kMaxBlocks doubles, part_count kMaxBlocks int64, ticket
// one uint32 that is 0 between launches. out_* hold one value each.
int spark_fps_launch(const void* args, int edition, void* part_sum,
                     void* part_count, void* ticket, void* out_sum,
                     void* out_count, void* stream) {
  if (args == nullptr || part_sum == nullptr || part_count == nullptr ||
      ticket == nullptr || out_sum == nullptr || out_count == nullptr)
    return (int)cudaErrorInvalidValue;
  const FpsArgs a = *static_cast<const FpsArgs*>(args);
  if (a.n_leaves < 0 || a.n_leaves > kLeaves || a.row_count < 0 ||
      a.a_slot < 0 || a.a_slot >= kSlots || a.b_slot < 0 ||
      a.b_slot >= kSlots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (edition == 0)
    return launch<double, true>(a, part_sum, part_count, ticket, out_sum,
                                out_count, st);
  if (edition == 1)
    return launch<float, false>(a, part_sum, part_count, ticket, out_sum,
                                out_count, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
