// K5 for Hopper: Parquet page decode, every device column of a row-group
// batch in one launch from one uploaded blob.
//
// Replaces _decode_device with _expand (spark_rapids_tpu/io/parquet_device.py:
// 1015 and :953), the XLA program the JAX scan runs per row-group batch. The
// host (io/parquet_plan.py) walks only the pages' run headers into a run table
// int64[n_runs][4] = (dense start, meta, value, bit offset); the payload stays
// opaque as uint32 words. For each output row i of each column:
//   valid = i < n_rows && (no nulls in the chunk || definition bit at i)
//   d     = the chunk has nulls ? (valid rows before i) : i   (dense index)
//   run r = the last run whose start <= d (a binary search of the table)
//   bits  = RLE run: its value; identity run: value + (d - start);
//           bit-packed run: width bits at bit offset + (d - start) * width,
//           read through a two-word funnel shift (64-bit PLAIN: a word pair);
//           DELTA run: those bits + the run's min delta, then prefix-summed
//           from the page's first value; plus the merged group's dictionary
//           base in meta bits 16+
//   value = dictionary run: dict[bits]; bool: bits & 1; else the lane's bits,
//           sign-extended where the engine type is wider than the lane
// Null and padding rows hold 0, so the columns are the host-decode scan's bit
// for bit. Meta bits follow parquet_plan.py: 0-7 width, 8 RLE, 9 dictionary,
// 10 identity, 11 DELTA.
//
// Bound: memory. The kernel reads each encoded byte (packed words, run
// tables, dictionaries, definition levels) and writes each decoded byte
// (lane width + 1 B of validity where the chunk has nulls). A q6 batch of
// 750,152 rows decodes 4 columns of 4 B (12.0 MB out) from about 3 MB of
// encoded input: about 4.5 us at 3.35 TB/s.
//
// Design, simple first: a grid-stride loop, one output row a thread,
// blockIdx.y the column; neighbouring threads write neighbouring rows, and
// read neighbouring packed words and the same few runs from L1/L2. A chunk
// with nulls needs the count of valid rows before each row, and a DELTA chunk
// a prefix sum of its deltas that restarts at every page: each is a scan job,
// run before the decode as a three-phase block scan (each block scans 1024
// elements in shared memory, one block scans the block sums, then the sums
// are added back), segmented by a start flag and wrapping like uint64. Where
// no chunk has nulls or DELTA pages (every q6 chunk), the dense index is the
// row index and the decode is the only launch.
//
// Plain C interface for ctypes; every launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

// One device column; offsets are bytes from the start of the blob, -1 none.
struct K5Col {
  int64_t words, n_words, runs, n_runs, dict, n_dict, def_words, n_def_words,
      def_runs, n_def_runs, out, valid, n_rows, dense, delta;
  int32_t lane_bytes, out_bytes, flags, pad_;
};

// One scan: kind 0 counts valid rows of a chunk with nulls (n = rows), kind 1
// sums a DELTA chunk's contributions (n = non-null values).
struct K5Job {
  int64_t col, kind, n, vals, flags, sums, sflags, n_blocks;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;  // one element a thread, 32 warps
constexpr int64_t kMaxGridX = 4096;
constexpr int32_t kHasNulls = 1, kDelta = 2, kBool = 4;
constexpr int64_t kMetaRle = 1 << 8, kMetaDict = 1 << 9, kMetaIdent = 1 << 10,
                  kMetaDelta = 1 << 11;

struct Expanded {
  uint64_t bits;
  bool is_dict;
  bool run_start;  // d is the first position of an RLE run
};

// _expand at dense position d of one run table over its packed words.
__device__ __forceinline__ Expanded expand(const uint8_t* base,
                                           int64_t words_off, int64_t n_words,
                                           int64_t runs_off, int64_t n_runs,
                                           int64_t d) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(base + words_off);
  const int64_t* runs = reinterpret_cast<const int64_t*>(base + runs_off);
  int64_t lo = 0, hi = n_runs;  // the number of starts <= d
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(runs + 4 * mid) <= d) lo = mid + 1;
    else hi = mid;
  }
  const int64_t r = lo > 0 ? lo - 1 : 0;
  const int64_t start = __ldg(runs + 4 * r);
  const int64_t meta = __ldg(runs + 4 * r + 1);
  const uint64_t raw = (uint64_t)__ldg(runs + 4 * r + 2);
  const int64_t width = meta & 0xFF;
  const int64_t off = d - start;
  const int64_t bitpos = __ldg(runs + 4 * r + 3) + off * width;
  int64_t widx = bitpos >> 5;
  widx = widx > n_words - 2 ? n_words - 2 : widx;
  widx = widx < 0 ? 0 : widx;
  const uint64_t w0 = __ldg(words + widx), w1 = __ldg(words + widx + 1);
  const uint32_t sh = (uint32_t)(bitpos & 31);
  const uint64_t window = (w1 << 32) | w0;
  uint64_t bits;
  if (width >= 64) {
    const int64_t w2 = widx + 2 < n_words ? widx + 2 : n_words - 1;
    bits = sh == 0 ? window : (((uint64_t)__ldg(words + w2) << 32) | w1);
  } else {
    bits = (window >> sh) & ((1ull << width) - 1ull);
  }
  if (meta & kMetaRle) bits = raw;
  if (meta & kMetaIdent) bits = raw + (uint64_t)off;
  if (meta & kMetaDelta) bits += raw;
  bits += (uint64_t)(meta >> 16);
  return {bits, (meta & kMetaDict) != 0, (meta & kMetaRle) != 0 && off == 0};
}

__device__ __forceinline__ bool row_valid(const uint8_t* base, const K5Col& c,
                                          int64_t i) {
  if (i >= c.n_rows) return false;
  if (!(c.flags & kHasNulls)) return true;
  return (expand(base, c.def_words, c.n_def_words, c.def_runs, c.n_def_runs,
                 i).bits & 1ull) != 0;
}

__global__ void __launch_bounds__(kThreads)
k5_decode(uint8_t* base, const K5Col* cols, int64_t cap) {
  const K5Col c = cols[blockIdx.y];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += stride) {
    const bool valid = row_valid(base, c, i);
    uint64_t v = 0;
    if (valid) {
      const int64_t d = (c.flags & kHasNulls)
          ? reinterpret_cast<const int64_t*>(base + c.dense)[i] - 1
          : i;
      uint64_t bits;
      bool is_dict = false;
      if (c.flags & kDelta) {
        bits = reinterpret_cast<const uint64_t*>(base + c.delta)[d];
      } else {
        const Expanded e = expand(base, c.words, c.n_words, c.runs, c.n_runs,
                                  d);
        bits = e.bits;
        is_dict = e.is_dict;
      }
      if (is_dict) {
        int64_t k = (int32_t)(uint32_t)bits;
        k = k > c.n_dict - 1 ? c.n_dict - 1 : k;
        k = k < 0 ? 0 : k;
        v = c.lane_bytes == 8
            ? reinterpret_cast<const uint64_t*>(base + c.dict)[k]
            : reinterpret_cast<const uint32_t*>(base + c.dict)[k];
      } else if (c.flags & kBool) {
        v = bits & 1ull;
      } else {
        v = c.lane_bytes == 8 ? bits : (uint32_t)bits;
      }
      // an int32 lane under a wider engine type: sign-extend
      if (c.out_bytes > c.lane_bytes && c.lane_bytes == 4)
        v = (uint64_t)(int64_t)(int32_t)(uint32_t)v;
    }
    uint8_t* out = base + c.out;
    switch (c.out_bytes) {
      case 1: out[i] = (uint8_t)v; break;
      case 2: reinterpret_cast<uint16_t*>(out)[i] = (uint16_t)v; break;
      case 4: reinterpret_cast<uint32_t*>(out)[i] = (uint32_t)v; break;
      default: reinterpret_cast<uint64_t*>(out)[i] = v; break;
    }
    if (c.valid >= 0) base[c.valid + i] = valid ? 1 : 0;
  }
}

// --- the segmented scan -----------------------------------------------------
// Elements are (start flag, uint64 value) pairs under
// (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2), which is associative:
// the inclusive scan restarts its sum at every flagged element.

__global__ void __launch_bounds__(kThreads)
k5_scan_fill(uint8_t* base, const K5Col* cols, const K5Job* jobs) {
  const K5Job j = jobs[blockIdx.y];
  const K5Col c = cols[j.col];
  uint64_t* vals = reinterpret_cast<uint64_t*>(base + j.vals);
  uint8_t* flags = base + j.flags;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < j.n;
       e += stride) {
    if (j.kind == 0) {
      vals[e] = row_valid(base, c, e) ? 1 : 0;
      flags[e] = 0;
    } else {
      const Expanded x = expand(base, c.words, c.n_words, c.runs, c.n_runs,
                                e);
      vals[e] = x.bits;
      flags[e] = x.run_start ? 1 : 0;
    }
  }
}

__device__ __forceinline__ void seg_scan_warp(uint64_t& v, bool& f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t pv = __shfl_up_sync(0xffffffffu, v, o);
    const int pf = __shfl_up_sync(0xffffffffu, (int)f, o);
    if (lane >= o) {
      if (!f) v += pv;
      f = f || pf;
    }
  }
}

// Inclusive segmented scan over the block (kScanThreads threads, one element
// each); returns with (v, f) the scan at this thread.
__device__ __forceinline__ void seg_scan_block(uint64_t& v, bool& f) {
  __shared__ uint64_t wv[32];
  __shared__ int wf[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  seg_scan_warp(v, f);
  if (lane == 31) {
    wv[warp] = v;
    wf[warp] = f;
  }
  __syncthreads();
  if (warp == 0) {
    uint64_t x = wv[lane];
    bool g = wf[lane] != 0;
    seg_scan_warp(x, g);
    wv[lane] = x;
    wf[lane] = g;
  }
  __syncthreads();
  if (warp > 0) {
    if (!f) v += wv[warp - 1];
    f = f || wf[warp - 1];
  }
  __syncthreads();  // wv/wf are reused by the next call
}

// Phase 1: each block scans its tile in place; flags[e] becomes "a segment
// starts in this tile at or before e", and the tile's total goes to sums.
__global__ void __launch_bounds__(kScanThreads)
k5_scan_tiles(uint8_t* base, const K5Job* jobs) {
  const K5Job j = jobs[blockIdx.y];
  if ((int64_t)blockIdx.x >= j.n_blocks) return;
  uint64_t* vals = reinterpret_cast<uint64_t*>(base + j.vals);
  uint8_t* flags = base + j.flags;
  const int64_t e = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  const bool in = e < j.n;
  uint64_t v = in ? vals[e] : 0;
  bool f = in && flags[e] != 0;
  seg_scan_block(v, f);
  if (in) {
    vals[e] = v;
    flags[e] = f ? 1 : 0;
  }
  if (threadIdx.x == kScanThreads - 1) {
    reinterpret_cast<uint64_t*>(base + j.sums)[blockIdx.x] = v;
    base[j.sflags + blockIdx.x] = f ? 1 : 0;
  }
}

// Phase 2: one block a job turns the tile totals into each tile's carry (the
// scan up to the end of the tile before it), in chunks of kScanThreads.
__global__ void __launch_bounds__(kScanThreads)
k5_scan_sums(uint8_t* base, const K5Job* jobs) {
  const K5Job j = jobs[blockIdx.x];
  uint64_t* sums = reinterpret_cast<uint64_t*>(base + j.sums);
  const uint8_t* sflags = base + j.sflags;
  __shared__ uint64_t incl[kScanThreads];
  uint64_t carry = 0;
  for (int64_t b0 = 0; b0 < j.n_blocks; b0 += kScanThreads) {
    const int64_t b = b0 + threadIdx.x;
    const bool in = b < j.n_blocks;
    uint64_t v = in ? sums[b] : 0;
    bool f = in && sflags[b] != 0;
    seg_scan_block(v, f);
    if (!f) v += carry;
    incl[threadIdx.x] = v;
    __syncthreads();
    if (in) sums[b] = threadIdx.x == 0 ? carry : incl[threadIdx.x - 1];
    carry = incl[kScanThreads - 1];
    __syncthreads();
  }
}

// Phase 3: add each tile's carry to its elements that no segment start
// precedes within the tile.
__global__ void __launch_bounds__(kScanThreads)
k5_scan_add(uint8_t* base, const K5Job* jobs) {
  const K5Job j = jobs[blockIdx.y];
  if (blockIdx.x == 0 || (int64_t)blockIdx.x >= j.n_blocks) return;
  const int64_t e = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= j.n || base[j.flags + e] != 0) return;
  reinterpret_cast<uint64_t*>(base + j.vals)[e] +=
      reinterpret_cast<const uint64_t*>(base + j.sums)[blockIdx.x];
}

int64_t blocks_for(int64_t n, int threads, int64_t cap) {
  int64_t b = (n + threads - 1) / threads;
  b = b < 1 ? 1 : b;
  return b > cap ? cap : b;
}

}  // namespace

extern "C" {

int spark_k5_col_size() { return (int)sizeof(K5Col); }

int spark_k5_job_size() { return (int)sizeof(K5Job); }

int spark_k5_scan_tile() { return kScanThreads; }

// blob: the device blob; cols_off/jobs_off: byte offsets of the descriptor
// tables in it; cap: the batch capacity; max_job_n: the longest scan job.
int spark_k5_decode(void* blob, int64_t cols_off, int n_cols, int64_t jobs_off,
                    int n_jobs, int64_t cap, int64_t max_job_n, void* stream) {
  if (blob == nullptr || n_cols < 1 || n_cols > 65535 || n_jobs < 0 ||
      n_jobs > 65535 || cap < 1)
    return (int)cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(blob);
  const K5Col* cols = reinterpret_cast<const K5Col*>(base + cols_off);
  const K5Job* jobs = reinterpret_cast<const K5Job*>(base + jobs_off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (n_jobs > 0 && max_job_n > 0) {
    const int64_t tiles = (max_job_n + kScanThreads - 1) / kScanThreads;
    k5_scan_fill<<<dim3((unsigned)blocks_for(max_job_n, kThreads, kMaxGridX),
                        n_jobs), kThreads, 0, st>>>(base, cols, jobs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    k5_scan_tiles<<<dim3((unsigned)tiles, n_jobs), kScanThreads, 0, st>>>(
        base, jobs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    k5_scan_sums<<<n_jobs, kScanThreads, 0, st>>>(base, jobs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    k5_scan_add<<<dim3((unsigned)tiles, n_jobs), kScanThreads, 0, st>>>(
        base, jobs);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  k5_decode<<<dim3((unsigned)blocks_for(cap, kThreads, kMaxGridX), n_cols),
              kThreads, 0, st>>>(base, cols, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
