// K3 for Hopper: a bitonic sort of (uint64 key, int32 payload) pairs.
//
// Replaces sort_pallas (spark_rapids_tpu/ops/pallas_kernels.py:156, body
// _sort_kernel at :131), a grid-free bitonic compare-exchange network over
// one power-of-two key array held in VMEM (at most 2^16 keys). Here it backs
// every sort of the join + group-by path: the engine packs its key lanes
// (live, then per key a null bit and an order-preserving value lane) into
// uint64 words and sorts them with the row index as payload.
//
// Contract: pairs compare on (key, payload), keys as unsigned. With distinct
// payloads (the engine passes row positions) that is a strict total order,
// so the result is deterministic and equals a stable sort by key. Any length
// n <= 2^30 works: the sort runs over N = the next power of two >= n, and the
// kernel pads positions [n, N) itself with (UINT64_MAX, INT32_MAX) sentinels,
// which sort last; the first n pairs of the output are the answer.
//
// Bound: memory. A sort must at least read and write every pair once:
// 24 B a pair, so 50.3 MB and about 15 us at 2^21 pairs, 201 MB and about
// 60 us at 2^23, at the H100's 3.35 TB/s. The comparisons (n log2 n) are far
// below the card's integer rate.
//
// Design, simple first. A bitonic network of log2(N)(log2(N)+1)/2 stages:
//   sort_tiles   one block sorts each tile of kTile = 4096 pairs in shared
//                memory (48 KB: the keys and payloads), every stage with
//                stride < 4096 of the merges up to size 4096, and loads the
//                input (or the sentinel) on its way in;
//   merge_global one launch per merge stage whose stride is a tile or more:
//                each thread compare-exchanges one pair in device memory;
//   merge_tiles  for each merge size above a tile, the stages with stride
//                below a tile, in shared memory, one launch.
// At 2^23 pairs that is 1 + 66 + 11 launches; the global stages each read
// and write every pair, so the kernel moves about 70x its bound. That is the
// price of the simple first version: a later one merges several global
// strides per pass in registers, or replaces the network by a radix sort.
// Directions follow the standard network: at merge size s the pair whose
// lower position is i sorts ascending iff (i & s) == 0.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// the entry point returns the first cudaGetLastError() that is not success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;
constexpr int kTileThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr uint64_t kKeySentinel = 0xffffffffffffffffull;
constexpr int32_t kPaySentinel = 0x7fffffff;

__device__ __forceinline__ bool pair_greater(uint64_t ka, int32_t pa,
                                             uint64_t kb, int32_t pb) {
  return ka > kb || (ka == kb && pa > pb);
}

// Compare-exchange of positions lo < hi: ascending leaves the smaller pair
// at lo, descending the larger.
__device__ __forceinline__ void cmpx(uint64_t* k, int32_t* p, int lo, int hi,
                                     bool asc) {
  const uint64_t ka = k[lo], kb = k[hi];
  const int32_t pa = p[lo], pb = p[hi];
  const bool swap = asc ? pair_greater(ka, pa, kb, pb)
                        : pair_greater(kb, pb, ka, pa);
  if (swap) {
    k[lo] = kb;
    k[hi] = ka;
    p[lo] = pb;
    p[hi] = pa;
  }
}

// Stages (size, stride) for stride from `stride0` down to 1 over the tile
// held in shared memory; `base` is the tile's first global position.
__device__ __forceinline__ void tile_stages(uint64_t* sk, int32_t* sp,
                                            int tile, int64_t base,
                                            int64_t size, int stride0) {
  for (int stride = stride0; stride > 0; stride >>= 1) {
    for (int c = threadIdx.x; c < tile / 2; c += blockDim.x) {
      const int lo = 2 * stride * (c / stride) + (c % stride);
      const bool asc = ((base + lo) & size) == 0;
      cmpx(sk, sp, lo, lo + stride, asc);
    }
    __syncthreads();
  }
}

// Load each tile (sentinels past n; payload = position when pay_in is
// null), run every merge of size <= tile on it, and store it to the output.
__global__ void __launch_bounds__(kTileThreads)
sort_tiles(const uint64_t* __restrict__ keys_in,
           const int32_t* __restrict__ pay_in, int64_t n, int tile,
           uint64_t* __restrict__ keys, int32_t* __restrict__ pay) {
  __shared__ uint64_t sk[kTile];
  __shared__ int32_t sp[kTile];
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int64_t g = base + t;
    if (g < n) {
      sk[t] = keys_in[g];
      sp[t] = pay_in != nullptr ? pay_in[g] : (int32_t)g;
    } else {
      sk[t] = kKeySentinel;
      sp[t] = kPaySentinel;
    }
  }
  __syncthreads();
  for (int size = 2; size <= tile; size <<= 1)
    tile_stages(sk, sp, tile, base, size, size >> 1);
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    keys[base + t] = sk[t];
    pay[base + t] = sp[t];
  }
}

// One stage (size, stride) with stride >= tile, over all N / 2 pairs.
__global__ void __launch_bounds__(kGlobalThreads)
merge_global(uint64_t* __restrict__ keys, int32_t* __restrict__ pay,
             int64_t half, int64_t size, int log_stride) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= half) return;
  const int64_t stride = (int64_t)1 << log_stride;
  const int64_t lo = ((c >> log_stride) << (log_stride + 1)) + (c & (stride - 1));
  const int64_t hi = lo + stride;
  const bool asc = (lo & size) == 0;
  const uint64_t ka = keys[lo], kb = keys[hi];
  const int32_t pa = pay[lo], pb = pay[hi];
  const bool swap = asc ? pair_greater(ka, pa, kb, pb)
                        : pair_greater(kb, pb, ka, pa);
  if (swap) {
    keys[lo] = kb;
    keys[hi] = ka;
    pay[lo] = pb;
    pay[hi] = pa;
  }
}

// The stages of merge size `size` (> tile) whose stride is below a tile.
__global__ void __launch_bounds__(kTileThreads)
merge_tiles(uint64_t* __restrict__ keys, int32_t* __restrict__ pay, int tile,
            int64_t size) {
  __shared__ uint64_t sk[kTile];
  __shared__ int32_t sp[kTile];
  const int64_t base = (int64_t)blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    sk[t] = keys[base + t];
    sp[t] = pay[base + t];
  }
  __syncthreads();
  tile_stages(sk, sp, tile, base, size, tile >> 1);
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    keys[base + t] = sk[t];
    pay[base + t] = sp[t];
  }
}

int log2_exact(int64_t x) {
  int l = 0;
  while (((int64_t)1 << l) < x) ++l;
  return l;
}

}  // namespace

extern "C" {

int spark_sort_tile() { return kTile; }

// Sort n pairs into keys_out / pay_out, which hold N entries each (N the
// next power of two >= n, 1 <= n <= N <= 2^30). pay_in may be null: the
// payload is then the input position. The launches counted by the caller
// as one sort are 1 + (global stages) + (tile merges).
int spark_sort_pairs(const void* keys_in, const void* pay_in, int64_t n,
                     void* keys_out, void* pay_out, int64_t N,
                     void* stream) {
  if (keys_in == nullptr || keys_out == nullptr || pay_out == nullptr ||
      n < 1 || N < n || N > ((int64_t)1 << 30) || (N & (N - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* keys = static_cast<uint64_t*>(keys_out);
  int32_t* pay = static_cast<int32_t*>(pay_out);
  const int tile = (int)(N < kTile ? N : kTile);
  const int64_t tiles = N / tile;
  const int threads = tile / 2 < kTileThreads ? (tile / 2 > 0 ? tile / 2 : 1)
                                              : kTileThreads;
  sort_tiles<<<(unsigned)tiles, threads, 0, st>>>(
      static_cast<const uint64_t*>(keys_in),
      static_cast<const int32_t*>(pay_in), n, tile, keys, pay);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t half = N / 2;
  const unsigned gblocks =
      (unsigned)((half + kGlobalThreads - 1) / kGlobalThreads);
  const int log_tile = log2_exact(tile);
  for (int64_t size = (int64_t)tile * 2; size <= N; size <<= 1) {
    for (int ls = log2_exact(size) - 1; ls >= log_tile; --ls) {
      merge_global<<<gblocks, kGlobalThreads, 0, st>>>(keys, pay, half, size,
                                                       ls);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    merge_tiles<<<(unsigned)tiles, threads, 0, st>>>(keys, pay, tile, size);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
