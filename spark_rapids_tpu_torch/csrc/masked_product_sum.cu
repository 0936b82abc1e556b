// K1 for Hopper: filter conjuncts, then a float32 product, then a sum, in
// one pass over a batch.
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
// filter does. It adds (Acc)(a * b), the product rounded in float32 first.
//
// Bound: memory. Each row reads 4 B per used column (16 B for q6's four
// columns) plus 1 B per validity mask and 1 B of selection where present;
// the work is a few compares and one multiply-add per row. q6 at SF1 is
// 6,001,215 rows x 16 B = 96.0 MB a query, about 29 us at the H100's
// 3.35 TB/s.
//
// Design, simple first: a grid-stride loop in which neighbouring threads
// read neighbouring rows (coalesced 4 B loads); each thread keeps an Acc sum
// and an int64 count; a warp-shuffle then shared-memory reduction leaves one
// partial per block in scratch that the caller allocates; a second one-block
// pass sums the partials in a fixed order. No float atomics, so one input
// gives the same bits on every run. The ragged tail needs no padding: the
// loop stops at row_count.
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
  int32_t pad_;
  FpsLeaf leaf[8];
};

}  // extern "C"

namespace {

constexpr int kSlots = 4;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

using leaves::compare;
using leaves::pick;

__device__ __forceinline__ double load(const FpsArgs& a, int k, int64_t i) {
  return leaves::load(a.col[k], a.col_type[k], i);
}

template <bool NanGreatest>
__device__ __forceinline__ bool row_passes(const FpsArgs& a, int64_t i,
                                           float* x, float* y) {
  if (a.sel != nullptr && !__ldg(a.sel + i)) return false;
  double v[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    v[k] = 0.0;
    if (a.col[k] == nullptr) continue;
    if (a.valid[k] != nullptr && !__ldg(a.valid[k] + i)) return false;
    v[k] = load(a, k, i);
  }
  for (int j = 0; j < a.n_leaves; ++j) {
    const double x = pick(v[0], v[1], v[2], v[3], a.leaf[j].slot);
    if (!compare<NanGreatest>(x, a.leaf[j].op, a.leaf[j].bound)) return false;
  }
  // the product slots hold float32 columns: the round trip through double
  // is exact
  *x = (float)pick(v[0], v[1], v[2], v[3], a.a_slot);
  *y = (float)pick(v[0], v[1], v[2], v[3], a.b_slot);
  return true;
}

// Sum of s and c over the block, left in thread 0. blockDim.x is a multiple
// of 32 and at most 1024.
template <typename Acc>
__device__ __forceinline__ void block_reduce(Acc& s, long long& c) {
  __shared__ Acc ss[32];
  __shared__ long long sc[32];
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    c += __shfl_down_sync(0xffffffffu, c, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    ss[warp] = s;
    sc[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    s = lane < nwarps ? ss[lane] : Acc(0);
    c = lane < nwarps ? sc[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      c += __shfl_down_sync(0xffffffffu, c, o);
    }
  }
}

template <typename Acc, bool NanGreatest>
__global__ void __launch_bounds__(kThreads)
fps_partial(const FpsArgs a, Acc* __restrict__ part_sum,
            long long* __restrict__ part_cnt) {
  Acc s = Acc(0);
  long long c = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.row_count; i += stride) {
    float x, y;
    if (row_passes<NanGreatest>(a, i, &x, &y)) {
      // __fmul_rn is never contracted into an FMA: the product is rounded
      // to float32 before it is added, as the engine's Multiply produces it
      s += (Acc)__fmul_rn(x, y);
      ++c;
    }
  }
  block_reduce(s, c);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = s;
    part_cnt[blockIdx.x] = c;
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kMaxBlocks)
fps_final(const Acc* __restrict__ part_sum,
          const long long* __restrict__ part_cnt, int n,
          Acc* __restrict__ out_sum, long long* __restrict__ out_cnt) {
  Acc s = Acc(0);
  long long c = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s += part_sum[i];
    c += part_cnt[i];
  }
  block_reduce(s, c);
  if (threadIdx.x == 0) {
    *out_sum = s;
    *out_cnt = c;
  }
}

template <typename Acc, bool NanGreatest>
int launch(const FpsArgs& a, void* part_sum, void* part_cnt, int blocks,
           void* out_sum, void* out_cnt, cudaStream_t st) {
  fps_partial<Acc, NanGreatest><<<blocks, kThreads, 0, st>>>(
      a, static_cast<Acc*>(part_sum), static_cast<long long*>(part_cnt));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fps_final<Acc><<<1, kMaxBlocks, 0, st>>>(
      static_cast<const Acc*>(part_sum),
      static_cast<const long long*>(part_cnt), blocks,
      static_cast<Acc*>(out_sum), static_cast<long long*>(out_cnt));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spark_fps_args_size() { return (int)sizeof(FpsArgs); }

int spark_fps_max_blocks() { return kMaxBlocks; }

// edition 0: engine (double sum, NaN-greatest); 1: K1 contract (float sum,
// IEEE). part_* hold `blocks` entries; out_* one.
int spark_fps_launch(const void* args, int edition, void* part_sum,
                     void* part_cnt, int blocks, void* out_sum,
                     void* out_cnt, void* stream) {
  if (args == nullptr || blocks < 1 || blocks > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const FpsArgs a = *static_cast<const FpsArgs*>(args);
  if (a.n_leaves < 0 || a.n_leaves > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (edition == 0)
    return launch<double, true>(a, part_sum, part_cnt, blocks, out_sum,
                                out_cnt, st);
  if (edition == 1)
    return launch<float, false>(a, part_sum, part_cnt, blocks, out_sum,
                                out_cnt, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
