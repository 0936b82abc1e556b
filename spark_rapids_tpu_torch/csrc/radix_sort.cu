// K3 for Hopper: a least-significant-digit radix sort of (uint64 key, int32
// payload) pairs that skips every digit in which all keys agree.
//
// Replaces sort_pallas (spark_rapids_tpu/ops/pallas_kernels.py:156, body
// _sort_kernel at :131), a grid-free bitonic compare-exchange network over
// one power-of-two key array held in VMEM (at most 2^16 keys). Here it backs
// every sort of the join + group-by path: the engine packs its key lanes
// (live, then per key a null bit and an order-preserving value lane) into
// uint64 words and sorts them with the row index as payload.
//
// Contract: pairs compare on (key, payload), keys as unsigned, payloads as
// signed. With distinct payloads (the engine passes row positions) that is
// a strict total order, so the result is deterministic and equals a stable
// sort by key. A null payload means the input position. Any length
// 1 <= n <= 2^30 works; the output is n pairs.
//
// Bound: memory. A sort must at least read every input once and write every
// pair once: 8 B a key in and 12 B a pair out, 20 B a pair (24 B with a
// payload), so 2.6 MB and about 0.8 us at 2^17 pairs, 41.9 MB and 12.5 us at
// 2^21, 168 MB and 50 us at 2^23, at the H100's 3.35 TB/s.
//
// Design. The engine's words are right-aligned bit fields (live, null,
// sign-flipped value lane), so in most of their eight 8-bit digits every key
// agrees: the partial aggregate's month words vary in digit 0 only. An LSD
// radix sort can skip such a digit exactly, since its stable pass would be
// the identity. Everything is decided on the device; nothing is read back.
//   radix_histogram  reads the keys (and payloads) once and counts the 256
//                    bins of every digit in shared memory. Per 32 keys a
//                    warp ORs each key's difference from lane 0's
//                    (__reduce_or_sync): a digit all 32 agree on is added
//                    once, by one lane per digit slot, so the constant
//                    digits cost one atomic a warp and no contention; only
//                    the digits that differ add per lane (__match_any_sync
//                    on every digit of every key costs more than the
//                    conflicts it would save).
//   radix_plan       one block, thread b owning bin b of all twelve slots:
//                    the exclusive bucket offsets, whether one bin holds all
//                    n keys (trivial), and the list of non-trivial passes,
//                    payload digits first (payload sign-flipped), then the
//                    key's, each with the buffer it reads (the input, the
//                    output or the alternate) and writes, so that the last
//                    lands in the output.
//   radix_pass       one launch per digit slot (12 with a payload, 8
//                    without); a trivial slot returns at once. Onesweep
//                    style: persistent blocks (three an SM) take tiles of
//                    3072 pairs from an atomic counter (so a tile only ever
//                    waits on tiles already held by running blocks); each
//                    thread holds 12 pairs in registers; a warp multisplit
//                    (__match_any_sync on the digit, per-warp bin counters)
//                    gives each pair its stable rank in the tile; each
//                    tile's global offset per bin comes from decoupled
//                    look-back over 32-bit status words (2-bit flag, 30-bit
//                    count) per (tile, bin); the tile is staged through
//                    shared memory in bin order, so neighbouring threads
//                    write neighbouring addresses of a bucket. The first
//                    pass makes payload = position on the fly when none is
//                    given. Status words alternate between two arrays:
//                    pass r uses array r % 2 and zeroes its tile's words of
//                    the other array for pass r + 1. When every digit is
//                    trivial (all keys equal, n = 1) the last slot's launch
//                    copies the input and its payloads (or positions) to
//                    the output.
// A pass reads 12 B and writes 12 B a pair (the first pass without a payload
// reads 8 B): random 64-bit keys take all 8 passes, the engine's words one to
// three. Inactive passes still cost a launch each (about 2.4 us with the
// gap between launches, on an H100). The reduce-then-scan alternative (per
// tile counts, a scan, a stable scatter: three launches a pass) was not
// needed: the look-back is bounded by a watchdog that traps instead of
// hanging if a predecessor tile were never published.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// the entry point returns the first cudaGetLastError() that is not success.
// The caller allocates the output, an alternate key/payload buffer of n
// pairs and spark_sort_work_bytes(n) bytes of workspace.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kPayDigits = 4;
constexpr int kKeyDigits = 8;
constexpr int kSlots = kPayDigits + kKeyDigits;
constexpr int kThreads = 256;  // one per bin in the pass and plan kernels
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 12;
constexpr int kTile = kThreads * kItems;
constexpr int kHistItems = 8;  // keys a lane loads at once in the histogram
constexpr int kHistBlocksPerSm = 4;
constexpr uint32_t kFlagAgg = 1u << 30;
constexpr uint32_t kFlagInc = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxPairs = (int64_t)1 << 30;
constexpr int64_t kMaxSpins = (int64_t)1 << 26;
constexpr int kLookBack = 8;  // predecessor tiles a look-back step reads

enum Buffer : int32_t { kIn = 0, kOut = 1, kAlt = 2 };

struct Pass {
  int32_t active;
  int32_t src;
  int32_t dst;
  int32_t parity;
};

// The workspace's header; one memset per sort zeroes it together with the
// first status array.
struct Work {
  uint32_t hist[kSlots][kBins];
  uint32_t offset[kSlots][kBins];
  uint32_t tile_counter[kSlots];
  int32_t n_active;
  int32_t pad_[3];
  Pass pass[kSlots];
};

constexpr int64_t kHeaderBytes = (sizeof(Work) + 255) / 256 * 256;

struct PassArgs {
  const uint64_t* keys_in;
  const int32_t* pay_in;  // null: the payload is the position
  uint64_t* keys_out;
  int32_t* pay_out;
  uint64_t* keys_alt;
  int32_t* pay_alt;
  Work* work;
  uint32_t* status0;
  uint32_t* status1;
  int64_t n;
  int64_t tiles;
};

__device__ __forceinline__ uint32_t digit_of(uint64_t k, int32_t p,
                                             int slot) {
  if (slot < kPayDigits)
    return (((uint32_t)p ^ 0x80000000u) >> (8 * slot)) & 0xffu;
  return (uint32_t)(k >> (8 * (slot - kPayDigits))) & 0xffu;
}

__device__ __forceinline__ void store_volatile(uint32_t* p, uint32_t v) {
  *reinterpret_cast<volatile uint32_t*>(p) = v;
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
  return *reinterpret_cast<const volatile uint32_t*>(p);
}

// Exclusive sum of one value per thread over a block of kThreads threads.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  uint32_t add = 0;
  for (int w = 0; w < wid; ++w) add += warp_tot[w];
  __syncthreads();
  return x - v + add;
}

__global__ void __launch_bounds__(kThreads)
radix_histogram(const uint64_t* __restrict__ keys,
                const int32_t* __restrict__ pay, int64_t n, Work* work) {
  __shared__ uint32_t sh[kSlots * kBins];
  for (int t = threadIdx.x; t < kSlots * kBins; t += blockDim.x) sh[t] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int first = pay != nullptr ? 0 : kPayDigits;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t step = (int64_t)32 * kHistItems;
  // the loop bound is warp-uniform, so every lane takes part in the votes
  for (int64_t base = warp * step; base < n; base += warps * step) {
    uint64_t k[kHistItems];
    int32_t p[kHistItems];
#pragma unroll
    for (int r = 0; r < kHistItems; ++r) {
      const int64_t i = base + r * 32 + lane;
      k[r] = i < n ? keys[i] : 0;
      p[r] = (i < n && pay != nullptr) ? pay[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kHistItems; ++r) {
      const bool valid = base + r * 32 + lane < n;
      const unsigned vmask = __ballot_sync(kFull, valid);
      if (vmask == 0) break;  // warp-uniform
      // lane 0 is valid whenever any lane is (positions ascend by lane);
      // the other invalid lanes take its pair, so they differ in nothing
      const uint64_t k0 = __shfl_sync(kFull, k[r], 0);
      const int32_t p0 = __shfl_sync(kFull, p[r], 0);
      const uint64_t kk = valid ? k[r] : k0;
      const int32_t pp = valid ? p[r] : p0;
      const uint64_t dk = kk ^ k0;
      const uint32_t dlo = __reduce_or_sync(kFull, (uint32_t)dk);
      const uint32_t dhi = __reduce_or_sync(kFull, (uint32_t)(dk >> 32));
      const uint32_t dp = __reduce_or_sync(kFull, (uint32_t)(pp ^ p0));
      uint32_t varying = 0;  // slots whose digit differs within the warp
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        varying |= (((dp >> (8 * d)) & 0xffu) != 0) << d;
        varying |= (((dlo >> (8 * d)) & 0xffu) != 0) << (kPayDigits + d);
        varying |= (((dhi >> (8 * d)) & 0xffu) != 0) << (kPayDigits + 4 + d);
      }
      // a digit the warp agrees on: lane `slot` adds the warp's count
      if (lane >= first && lane < kSlots && !((varying >> lane) & 1u))
        atomicAdd(&sh[lane * kBins + digit_of(k0, p0, lane)],
                  (uint32_t)__popc(vmask));
      // a digit that differs: every valid lane adds one
      for (uint32_t todo = varying; todo != 0; todo &= todo - 1) {
        const int slot = __ffs(todo) - 1;
        if (valid) atomicAdd(&sh[slot * kBins + digit_of(kk, pp, slot)], 1u);
      }
    }
  }
  __syncthreads();
  uint32_t* hist = &work->hist[0][0];
  for (int t = first * kBins + threadIdx.x; t < kSlots * kBins;
       t += blockDim.x) {
    const uint32_t c = sh[t];
    if (c != 0) atomicAdd(hist + t, c);
  }
}

// One block: the bucket offsets of every digit slot at once (thread b owns
// bin b of all twelve), the trivial slots, and the plan of passes.
__global__ void __launch_bounds__(kThreads)
radix_plan(Work* work, int64_t n, int has_pay) {
  __shared__ uint32_t warp_tot[kSlots][kWarps];
  __shared__ uint32_t trivial_bits;
  const int b = threadIdx.x, lane = b & 31, wid = b >> 5;
  if (b == 0) trivial_bits = has_pay ? 0u : (1u << kPayDigits) - 1;
  uint32_t c[kSlots], x[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) c[s] = x[s] = work->hist[s][b];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (c[s] == (uint32_t)n) atomicOr(&trivial_bits, 1u << s);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const uint32_t y = __shfl_up_sync(kFull, x[s], o);
      if (lane >= o) x[s] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) warp_tot[s][wid] = x[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    uint32_t add = 0;
    for (int w = 0; w < wid; ++w) add += warp_tot[s][w];
    work->offset[s][b] = x[s] - c[s] + add;
  }
  if (b != 0) return;
  const uint32_t trivial = trivial_bits;
  const int active = kSlots - __popc(trivial);
  int r = 0, prev = kIn;
  for (int s = 0; s < kSlots; ++s) {
    Pass p = {0, kIn, kOut, 0};
    if (!((trivial >> s) & 1u)) {
      p.active = 1;
      p.src = prev;
      p.dst = ((active - 1 - r) % 2 == 0) ? kOut : kAlt;
      p.parity = r & 1;
      prev = p.dst;
      ++r;
    }
    work->pass[s] = p;
  }
  work->n_active = active;
}

// Every digit trivial (all keys equal, n = 1): the output is the input and
// its payloads, or positions.
__device__ __forceinline__ void copy_input(const PassArgs& a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    a.keys_out[i] = a.keys_in[i];
    a.pay_out[i] = a.pay_in != nullptr ? a.pay_in[i] : (int32_t)i;
  }
}

// Three blocks an SM: 80 registers a thread, 47 KB of shared memory a block.
__global__ void __launch_bounds__(kThreads, 3)
radix_pass(const PassArgs a, const int slot) {
  const Pass pass = a.work->pass[slot];
  if (!pass.active) {
    if (slot == kSlots - 1 && a.work->n_active == 0) copy_input(a);
    return;
  }

  __shared__ uint64_t s_key[kTile];
  __shared__ int32_t s_pay[kTile];
  __shared__ uint32_t s_warp[kWarps][kBins];
  __shared__ uint32_t s_start[kBins];
  __shared__ uint32_t s_base[kBins];
  __shared__ uint32_t s_tot[kWarps];
  __shared__ int64_t s_tile;

  const uint64_t* src_k = pass.src == kIn    ? a.keys_in
                          : pass.src == kOut ? a.keys_out
                                             : a.keys_alt;
  const int32_t* src_p = pass.src == kIn    ? a.pay_in
                         : pass.src == kOut ? a.pay_out
                                            : a.pay_alt;
  uint64_t* dst_k = pass.dst == kOut ? a.keys_out : a.keys_alt;
  int32_t* dst_p = pass.dst == kOut ? a.pay_out : a.pay_alt;
  uint32_t* status = pass.parity ? a.status1 : a.status0;
  uint32_t* next_status = pass.parity ? a.status0 : a.status1;
  const uint32_t* bucket = a.work->offset[slot];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const unsigned lower = (1u << lane) - 1;

  for (;;) {
    if (tid == 0) s_tile = atomicAdd(&a.work->tile_counter[slot], 1u);
    for (int b = lane; b < kBins; b += 32) s_warp[wid][b] = 0;
    __syncthreads();
    const int64_t tile = s_tile;
    if (tile >= a.tiles) break;  // block-uniform
    const int64_t base = tile * kTile;
    // warp wid owns positions [wbase, wbase + 32 * kItems) of the tile;
    // item j of a lane is position wbase + 32 j + lane, so (j, lane) order
    // is input order
    const int64_t wbase = base + (int64_t)wid * 32 * kItems;
    uint64_t k[kItems];
    int32_t p[kItems];
    uint32_t rank[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = wbase + j * 32 + lane;
      k[j] = 0;
      p[j] = 0;
      if (i < a.n) {
        k[j] = src_k[i];
        p[j] = src_p != nullptr ? src_p[i] : (int32_t)i;
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool valid = wbase + j * 32 + lane < a.n;
      const uint32_t d = valid ? digit_of(k[j], p[j], slot) : kBins;
      const unsigned peers = __match_any_sync(kFull, d);
      const uint32_t before = valid ? s_warp[wid][d] : 0;
      __syncwarp();
      if (valid && lane == 31 - __clz(peers))
        s_warp[wid][d] = before + __popc(peers);
      __syncwarp();
      rank[j] = before + __popc(peers & lower);
    }
    __syncthreads();
    {
      // thread b owns bin b: per-warp exclusive offsets, the tile's count,
      // its start in the tile, and its global base by look-back
      const int b = tid;
      uint32_t count = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = s_warp[w][b];
        s_warp[w][b] = count;
        count += c;
      }
      uint32_t* mine = status + tile * kBins + b;
      store_volatile(mine, (tile == 0 ? kFlagInc : kFlagAgg) | count);
      s_start[b] = block_exclusive_sum(count, s_tot);
      // look back over kLookBack predecessors at once: sum their counts
      // down to the first inclusive one, or reload from the first that is
      // not published yet
      uint32_t prefix = 0;
      if (tile != 0) {
        int64_t t = tile - 1;
        int64_t spins = 0;
        for (bool done = false; !done;) {
          uint32_t st[kLookBack];
#pragma unroll
          for (int w = 0; w < kLookBack; ++w)
            st[w] = t - w >= 0 ? load_volatile(status + (t - w) * kBins + b)
                               : kFlagInc;
          int w = 0;
          for (; w < kLookBack; ++w) {
            const uint32_t flag = st[w] & ~kCountMask;
            if (flag == 0) break;
            prefix += st[w] & kCountMask;
            if (flag == kFlagInc) {
              done = true;
              break;
            }
          }
          t -= w;
          // a predecessor is seconds late only if it was never published:
          // fail the launch rather than hang the card
          if (!done && w == 0 && ++spins > kMaxSpins) __trap();
        }
        store_volatile(mine, kFlagInc | (prefix + count));
      }
      s_base[b] = bucket[b] + prefix;
      next_status[tile * kBins + b] = 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (wbase + j * 32 + lane < a.n) {
        const uint32_t d = digit_of(k[j], p[j], slot);
        const uint32_t at = s_start[d] + s_warp[wid][d] + rank[j];
        s_key[at] = k[j];
        s_pay[at] = p[j];
      }
    }
    __syncthreads();
    const int count = (int)(a.n - base < kTile ? a.n - base : kTile);
    for (int t = tid; t < count; t += kThreads) {
      const uint64_t kk = s_key[t];
      const int32_t pp = s_pay[t];
      const uint32_t d = digit_of(kk, pp, slot);
      const uint32_t at = s_base[d] + ((uint32_t)t - s_start[d]);
      dst_k[at] = kk;
      dst_p[at] = pp;
    }
    __syncthreads();
  }
}

int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

int64_t status_bytes(int64_t n) { return tiles_for(n) * kBins * 4; }

struct DeviceInfo {
  int sms;          // streaming multiprocessors
  int pass_blocks;  // blocks of radix_pass resident on the whole card
};

// The current device's DeviceInfo, cached per device; sms is 0 on failure.
DeviceInfo device_info() {
  static DeviceInfo cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return DeviceInfo{0, 0};
  if (cached[dev].sms == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radix_pass,
                                                      kThreads, 0) !=
            cudaSuccess)
      return DeviceInfo{0, 0};
    cached[dev] = DeviceInfo{sms, sms * (per_sm > 0 ? per_sm : 1)};
  }
  return cached[dev];
}

}  // namespace

extern "C" {

// Bytes of workspace a sort of n pairs needs: the header and two arrays of
// tile status words.
int64_t spark_sort_work_bytes(int64_t n) {
  return kHeaderBytes + 2 * status_bytes(n);
}

// Sort n pairs into keys_out / pay_out (n entries each). pay_in may be null:
// the payload is then the input position. keys_alt / pay_alt hold n entries
// and work spark_sort_work_bytes(n) bytes; none may alias the input. The
// launches counted by the caller as one sort are a memset, the histogram,
// the plan and one pass a digit slot.
int spark_sort_pairs(const void* keys_in, const void* pay_in, int64_t n,
                     void* keys_out, void* pay_out, void* keys_alt,
                     void* pay_alt, void* work, int64_t work_bytes,
                     void* stream) {
  if (keys_in == nullptr || keys_out == nullptr || pay_out == nullptr ||
      keys_alt == nullptr || pay_alt == nullptr || work == nullptr ||
      n < 1 || n > kMaxPairs || work_bytes < spark_sort_work_bytes(n) ||
      (reinterpret_cast<uintptr_t>(work) & 255) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DeviceInfo info = device_info();
  if (info.sms <= 0) return (int)cudaErrorInvalidDevice;
  Work* w = static_cast<Work*>(work);
  uint8_t* status = static_cast<uint8_t*>(work) + kHeaderBytes;
  cudaError_t e = cudaMemsetAsync(work, 0, kHeaderBytes + status_bytes(n), st);
  if (e != cudaSuccess) return (int)e;
  const uint64_t* kin = static_cast<const uint64_t*>(keys_in);
  const int32_t* pin = static_cast<const int32_t*>(pay_in);
  int64_t hblocks = (n + kThreads * kHistItems - 1) / (kThreads * kHistItems);
  if (hblocks > (int64_t)kHistBlocksPerSm * info.sms)
    hblocks = (int64_t)kHistBlocksPerSm * info.sms;
  radix_histogram<<<(unsigned)hblocks, kThreads, 0, st>>>(kin, pin, n, w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  radix_plan<<<1, kThreads, 0, st>>>(w, n, pin != nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  PassArgs a;
  a.keys_in = kin;
  a.pay_in = pin;
  a.keys_out = static_cast<uint64_t*>(keys_out);
  a.pay_out = static_cast<int32_t*>(pay_out);
  a.keys_alt = static_cast<uint64_t*>(keys_alt);
  a.pay_alt = static_cast<int32_t*>(pay_alt);
  a.work = w;
  a.status0 = reinterpret_cast<uint32_t*>(status);
  a.status1 = reinterpret_cast<uint32_t*>(status + status_bytes(n));
  a.n = n;
  a.tiles = tiles_for(n);
  const unsigned grid = (unsigned)(a.tiles < info.pass_blocks
                                        ? a.tiles
                                        : (int64_t)info.pass_blocks);
  for (int s = pin != nullptr ? 0 : kPayDigits; s < kSlots; ++s) {
    radix_pass<<<grid, kThreads, 0, st>>>(a, s);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
