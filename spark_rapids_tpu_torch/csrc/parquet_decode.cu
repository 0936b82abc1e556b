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
//   run r = the last run whose start <= d (run 0 where none is)
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
// tables, dictionaries, definition levels) and writes every row of each
// output column up to the capacity (lane width + 1 B of validity where the
// chunk has nulls): padding rows must hold 0 and the blob's device suffix is
// not zeroed. A q6 batch reads 5.23 MB and writes 4 columns x 4 B x 2^20
// rows (16.8 MB): 22.0 MB, about 6.6 us at 3.35 TB/s.
//
// Design: a block decodes a tile of kTileRows = 4096 consecutive rows of one
// column (grid: tiles x columns), 256 threads x 4 consecutive rows x 4 steps.
//   - A tile wholly past n_rows writes zeros with 16-byte stores and returns.
//   - The tile's dense range [lo, hi] is its row range, or, for a chunk with
//     nulls, the dense scan's values at the tile's ends. The block finds the
//     run holding lo with a 256-way search (each thread probes one start:
//     1,501 runs take 2 steps); that is the tile's only search of the run
//     table.
//   - The block then loads a window of at most kWindow run records, those
//     that start at or before hi, into shared memory, and stages the span of
//     packed words those runs cover over [lo, hi] with 16-byte loads (where
//     it fits kWordCap; else the words are read from device memory). Each
//     thread finds its 4-row group's run by a binary search of the window
//     in shared memory, then steps to the next run for the group's later
//     rows. A tile of many short runs walks its runs window by window: a
//     window is replaced once every row it holds is decoded, so the number
//     of runs in a tile never sets the shared memory size.
//   - The window gives each run a 32-bit form (kFast) where the caller needs
//     only the low 32 bits of its values (4-byte lanes, dictionary indices,
//     definition bits) and its words are staged and need none of the
//     reference's clamps: a value is then the run's constant plus one
//     __funnelshift_r of two staged words at a 32-bit bit offset. Other runs
//     (64-bit PLAIN pairs, wide DELTA values, clamped reads) take the
//     64-bit form of the same arithmetic.
//   - A dictionary of at most kDictBytes is staged in shared memory once a
//     block (q6's largest: 2,600 x 4 B), its loads issued before the search;
//     a larger one is read through __ldg.
//   - Each thread stores its 4 rows at once: one 16-byte store for 4-byte
//     lanes, two for 8-byte lanes, and one 4-byte store of validity. This
//     needs the blob's 16-byte alignment and capacity % 4 == 0 (capacities
//     are powers of two of at least 128).
// Shared memory a decode block, static, no opt-in (38,992 B by ptxas):
//   window: run starts (kWindow + 1 x 8 B, the last is the next window's
//   first start), meta, value and bit offset (3 x kWindow x 8 B), and the
//   32-bit form (4 x kWindow x 4 B, one more start): 6.0 KB;
//   staged words: kWordCap x 4 B = 16.0 KB (a tile of 32-bit values plus a
//   funnel-shift word and 16-byte alignment); dictionary: kDictBytes = 16 KB.
// A chunk with nulls needs the count of valid rows through each row (its
// dense index) and a DELTA chunk a prefix sum of its deltas that restarts at
// every page: each is a scan job, run before the decode. k5_scan_fill expands
// the definition levels or the DELTA runs with the same tiled walk; then a
// three-phase block scan (each block scans 1024 elements in shared memory,
// one block scans the block sums, then the sums are added back), segmented
// by a start flag and wrapping like uint64. The decode reads a row's
// validity from the dense scan (the count rises at a valid row). Where no
// chunk has nulls or DELTA pages (every q6 chunk), the decode is the only
// launch.
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
constexpr int kGroup = 4;                      // rows a thread stores at once
constexpr int kStepRows = kThreads * kGroup;   // 1024
constexpr int kSteps = 4;
constexpr int kTileRows = kStepRows * kSteps;  // 4096
constexpr int kWindow = 128;                   // run records a window holds
constexpr int kWordCap = kTileRows + 8;        // staged words
constexpr int kDictBytes = 16384;
constexpr int kScanThreads = 1024;  // one element a thread, 32 warps
constexpr int32_t kHasNulls = 1, kDelta = 2, kBool = 4;
constexpr int64_t kMetaRle = 1 << 8, kMetaDict = 1 << 9, kMetaIdent = 1 << 10,
                  kMetaDelta = 1 << 11;
constexpr int64_t kNoRun = INT64_MAX;  // the start after the last run

// One run table over its packed words.
struct Table {
  const uint32_t* words;
  int64_t n_words;
  const int64_t* runs;
  int64_t n_runs;
};

__device__ __forceinline__ Table table_of(const uint8_t* base, int64_t words,
                                          int64_t n_words, int64_t runs,
                                          int64_t n_runs) {
  return {reinterpret_cast<const uint32_t*>(base + words), n_words,
          reinterpret_cast<const int64_t*>(base + runs), n_runs};
}

// The block's window of run records and the packed words they cover.
struct Window {
  int64_t start[kWindow + 1];  // start[wn]: the next run's start, or kNoRun
  int64_t meta[kWindow];
  int64_t raw[kWindow];
  int64_t bit[kWindow];
  // the 32-bit form of each run, for rows d = lo + dl of the tile:
  int32_t srel[kWindow + 1];   // start - lo, clamped to [-1, kTileRows]
  uint32_t c32[kWindow];       // the low 32 bits added to every value
  int32_t relz[kWindow];       // bit of dl = 0 in the staged words
  int32_t kind[kWindow];       // width | kFast | kRle | kIdent | kIsDict
  __align__(16) uint32_t words[kWordCap];
  int64_t wbase;               // word index of words[0] where staged
  unsigned long long span_lo;  // the window's word span (before staging)
  long long span_hi;
  int wn;                      // runs in the window
  int staged;
};

constexpr int32_t kFast = 1 << 8, kRle = 1 << 9, kIdent = 1 << 10,
                  kIsDict = 1 << 11;

struct Expanded {
  uint64_t bits;
  bool is_dict;
  bool run_start;  // d is the first position of an RLE run
};

// The first word the reference's funnel shift reads at bitpos, clamped as
// its gather clamps (a table of one word reads that word twice).
__device__ __forceinline__ int64_t word0(int64_t bitpos, int64_t n_words) {
  const int64_t w = bitpos >> 5, top = n_words >= 2 ? n_words - 2 : 0;
  return w < 0 ? 0 : (w > top ? top : w);
}

// width bits at bitpos; wp[i - wbase] is word i.
__device__ __forceinline__ uint64_t extract(const uint32_t* wp, int64_t wbase,
                                            int64_t n_words, int64_t bitpos,
                                            int width) {
  if (width == 0) return 0;
  const int64_t i0 = word0(bitpos, n_words);
  const int64_t i1 = i0 + 1 < n_words ? i0 + 1 : n_words - 1;
  const uint32_t sh = (uint32_t)bitpos & 31u;
  const uint32_t w0 = wp[i0 - wbase], w1 = wp[i1 - wbase];
  if (width <= 32) {
    const uint32_t m = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
    return __funnelshift_r(w0, w1, sh) & m;
  }
  const uint64_t window = ((uint64_t)w1 << 32) | w0;
  if (width >= 64) {
    // 64-bit PLAIN values sit on word pairs; a region that starts on an
    // odd word reads the next pair
    const int64_t i2 = i0 + 2 < n_words ? i0 + 2 : n_words - 1;
    return sh == 0 ? window : (((uint64_t)wp[i2 - wbase] << 32) | w1);
  }
  return (window >> sh) & ((1ull << width) - 1ull);
}

// _expand at dense position d = lo + dl, in the window's run j. A run marked
// kFast needs only the low 32 bits of its values and reads its words from
// the staged span without the reference's clamps, so it takes 32-bit
// arithmetic; any other run the 64-bit form.
__device__ __forceinline__ Expanded expand_at(const Window& s,
                                              const uint32_t* wp,
                                              int64_t wbase, int64_t n_words,
                                              int j, int64_t d, int dl) {
  const int kind = s.kind[j];
  if (kind & kFast) {
    uint32_t b = s.c32[j];
    const int width = kind & 0xFF;
    if (kind & kIdent) {
      b += (uint32_t)dl;
    } else if (!(kind & kRle) && width > 0) {
      const int r = s.relz[j] + dl * width;
      const uint32_t m = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
      b += __funnelshift_r(s.words[r >> 5], s.words[(r >> 5) + 1], r) & m;
    }
    return {b, (kind & kIsDict) != 0, (kind & kRle) && s.srel[j] == dl};
  }
  const int64_t meta = s.meta[j];
  const uint64_t raw = (uint64_t)s.raw[j];
  const int64_t off = d - s.start[j];
  const int width = (int)(meta & 0xFF);
  uint64_t bits = (meta & (kMetaRle | kMetaIdent))
      ? 0 : extract(wp, wbase, n_words, s.bit[j] + off * width, width);
  if (meta & kMetaRle) bits = raw;
  if (meta & kMetaIdent) bits = raw + (uint64_t)off;
  if (meta & kMetaDelta) bits += raw;
  bits += (uint64_t)(meta >> 16);
  return {bits, (meta & kMetaDict) != 0, (meta & kMetaRle) != 0 && off == 0};
}

// Loads the window of runs wa.. that start at or before hi (at least one),
// stages the packed words they cover over [lo, hi], and gives each run its
// 32-bit form; `narrow`: the caller uses only the low 32 bits of values that
// are not dictionary indices. Every thread of the block calls it; the window
// is free when it is called.
__device__ void load_window(Window& s, const Table& t, int64_t wa, bool first,
                            int64_t lo, int64_t hi, bool narrow) {
  const int k = threadIdx.x;
  int64_t st = kNoRun, meta = 0, raw = 0, bit = 0;
  if (k <= kWindow && wa + k < t.n_runs) {
    const longlong2* r =
        reinterpret_cast<const longlong2*>(t.runs + 4 * (wa + k));
    const longlong2 r01 = __ldg(r);
    st = r01.x;
    meta = r01.y;
    if (k < kWindow) {
      const longlong2 r23 = __ldg(r + 1);
      raw = r23.x;
      bit = r23.y;
    }
  }
  const bool in = k < kWindow && wa + k < t.n_runs && (k == 0 || st <= hi);
  if (k <= kWindow) {
    s.start[k] = st;
    const int64_t rel = st - lo;
    s.srel[k] = rel < -1 ? -1 : (rel > kTileRows ? kTileRows : (int32_t)rel);
  }
  if (in) {
    s.meta[k] = meta;
    s.raw[k] = raw;
    s.bit[k] = bit;
  }
  if (k == 0) {
    s.span_lo = ~0ull;
    s.span_hi = -1;
  }
  const int wn = __syncthreads_count(in);
  const int width = (int)(meta & 0xFF);
  const bool packed = !(meta & (kMetaRle | kMetaIdent)) && width > 0;
  bool unclamped = true;
  if (in) {
    const int64_t end = s.start[k + 1];
    const int64_t first_d = (first && k == 0) ? lo : (st > lo ? st : lo);
    const int64_t last_d = end - 1 < hi ? end - 1 : hi;
    if (packed && first_d <= last_d) {
      const int64_t b0 = bit + (first_d - st) * width;
      const int64_t b1 = bit + (last_d - st) * width;
      unclamped = b0 >= 0 && (b1 >> 5) <= t.n_words - 2;
      const int64_t w_lo = word0(b0, t.n_words);
      int64_t w_hi = word0(b1, t.n_words) + (width >= 64 ? 2 : 1);
      w_hi = w_hi < t.n_words ? w_hi : t.n_words - 1;
      atomicMin(&s.span_lo, (unsigned long long)w_lo);
      atomicMax(&s.span_hi, (long long)w_hi);
    }
  }
  __syncthreads();
  const int64_t w_lo = (int64_t)(s.span_lo & ~3ull), w_hi = s.span_hi;
  const bool staged = w_hi >= 0 && w_hi - w_lo < kWordCap;
  if (staged) {
    // 16-byte loads: the words start 16-byte aligned in the blob and their
    // region is padded to 16 bytes, so the last vector stays inside it
    const uint4* src = reinterpret_cast<const uint4*>(t.words + w_lo);
    uint4* dst = reinterpret_cast<uint4*>(s.words);
    const int n4 = (int)((w_hi - w_lo) / 4 + 1);
    for (int q = k; q < n4; q += kThreads) dst[q] = __ldg(src + q);
  }
  if (in) {
    const bool is_dict = (meta & kMetaDict) != 0;
    const bool fast = (narrow || is_dict) && !(meta & kMetaDelta) &&
        (!packed || (width <= 32 && staged && unclamped));
    const uint32_t base = (uint32_t)(meta >> 16);
    uint32_t c = base;
    if (meta & kMetaRle) c = (uint32_t)raw + base;
    else if (meta & kMetaIdent)
      c = (uint32_t)raw - (uint32_t)st + (uint32_t)lo + base;
    s.c32[k] = c;
    s.relz[k] = (int32_t)(bit + (lo - st) * width - 32 * w_lo);
    s.kind[k] = width | (fast ? kFast : 0) | ((meta & kMetaRle) ? kRle : 0) |
        ((meta & kMetaIdent) ? kIdent : 0) | (is_dict ? kIsDict : 0);
  }
  if (k == 0) {
    s.wn = wn;
    s.staged = staged;
    s.wbase = staged ? w_lo : 0;
  }
  __syncthreads();
}

// The tile's one search of the run table: the whole block probes 256 starts
// a step (1,501 runs take 2 steps). Returns the run holding lo (run 0 where
// no run starts at or before it). Every thread of the block calls it.
__device__ __forceinline__ int64_t first_run(const Table& t, int64_t lo) {
  int64_t a = 0, b = t.n_runs;  // the count of starts <= lo is in [a, b]
  while (a < b) {
    const int64_t step = (b - a + kThreads - 1) / kThreads;
    const int64_t q = a + (int64_t)(threadIdx.x + 1) * step - 1;
    const bool p = q < b && __ldg(t.runs + 4 * q) <= lo;
    const int64_t n = __syncthreads_count(p);
    const int64_t nb = a + (n + 1) * step - 1;
    b = nb < b ? nb : b;
    a += n * step;
  }
  return a > 0 ? a - 1 : 0;
}

// Expands the table at the dense positions d[q] where want[q] (increasing),
// in the current window and the ones after it; wa is the window's first run.
// Every thread of the block calls it at the same point.
__device__ void expand_group(Window& s, const Table& t, int64_t lo,
                             int64_t hi, bool narrow, int64_t& wa,
                             const int64_t (&d)[kGroup], bool (&want)[kGroup],
                             Expanded (&e)[kGroup]) {
  for (;;) {
    const int wn = s.wn;
    const int32_t next = s.srel[wn];
    const uint32_t* wp = s.staged ? s.words : t.words;
    const int64_t wbase = s.wbase;
    bool pending = false, here[kGroup];
    int dl[kGroup], first = -1, last = -1;  // the rows this window holds
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      dl[q] = (int)(d[q] - lo);
      here[q] = want[q] && dl[q] < next;
      pending = pending || (want[q] && !here[q]);
      if (here[q]) {
        first = first < 0 ? dl[q] : first;
        last = dl[q];
      }
    }
    if (first >= 0) {
      int j = 0, b = wn;  // the first row's run: a search of the window
      while (b - j > 1) {
        const int m = (j + b) >> 1;
        if (s.srel[m] <= first) j = m;
        else b = m;
      }
      const int kind = s.kind[j];
      if ((kind & kFast) && s.srel[j + 1] > last) {
        // the group in one run of 32-bit form: its rows at once
        const uint32_t c = s.c32[j];
        const int relz = s.relz[j], width = kind & 0xFF;
        const uint32_t m = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
        const bool packed = !(kind & (kRle | kIdent)) && width > 0;
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (!here[q]) continue;
          uint32_t v = c;
          if (kind & kIdent) {
            v += (uint32_t)dl[q];
          } else if (packed) {
            const int r = relz + dl[q] * width;
            v += __funnelshift_r(s.words[r >> 5], s.words[(r >> 5) + 1], r) &
                 m;
          }
          e[q] = {v, (kind & kIsDict) != 0,
                  (kind & kRle) && s.srel[j] == dl[q]};
          want[q] = false;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (!here[q]) continue;
          while (j + 1 < wn && s.srel[j + 1] <= dl[q]) ++j;  // the next runs
          e[q] = expand_at(s, wp, wbase, t.n_words, j, d[q], dl[q]);
          want[q] = false;
        }
      }
    }
    if (!__syncthreads_or(pending)) return;
    wa += wn;
    load_window(s, t, wa, false, lo, hi, narrow);
  }
}

__device__ __forceinline__ void zero_fill(uint8_t* p, int64_t nbytes) {
  const int64_t n16 = nbytes >> 4;
  for (int64_t k = threadIdx.x; k < n16; k += kThreads)
    reinterpret_cast<uint4*>(p)[k] = make_uint4(0, 0, 0, 0);
  for (int64_t k = (n16 << 4) + threadIdx.x; k < nbytes; k += kThreads)
    p[k] = 0;
}

__device__ __forceinline__ void store_group(uint8_t* out, int out_bytes,
                                            int64_t i,
                                            const uint64_t (&v)[kGroup]) {
  switch (out_bytes) {
    case 1:
      reinterpret_cast<uint32_t*>(out + i)[0] =
          (uint32_t)(v[0] & 0xFF) | ((uint32_t)(v[1] & 0xFF) << 8) |
          ((uint32_t)(v[2] & 0xFF) << 16) | ((uint32_t)(v[3] & 0xFF) << 24);
      break;
    case 2:
      reinterpret_cast<uint2*>(out + 2 * i)[0] = make_uint2(
          (uint32_t)(v[0] & 0xFFFF) | ((uint32_t)(v[1] & 0xFFFF) << 16),
          (uint32_t)(v[2] & 0xFFFF) | ((uint32_t)(v[3] & 0xFFFF) << 16));
      break;
    case 4:
      reinterpret_cast<uint4*>(out + 4 * i)[0] = make_uint4(
          (uint32_t)v[0], (uint32_t)v[1], (uint32_t)v[2], (uint32_t)v[3]);
      break;
    default:
      reinterpret_cast<ulonglong2*>(out + 8 * i)[0] =
          make_ulonglong2(v[0], v[1]);
      reinterpret_cast<ulonglong2*>(out + 8 * i)[1] =
          make_ulonglong2(v[2], v[3]);
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
k5_decode(uint8_t* base, const K5Col* cols, int64_t cap) {
  __shared__ Window s;
  __shared__ __align__(16) uint8_t dict_s[kDictBytes];
  const K5Col c = cols[blockIdx.y];
  const int64_t t0 = (int64_t)blockIdx.x * kTileRows;
  if (t0 >= cap) return;
  const int64_t t1 = t0 + kTileRows < cap ? t0 + kTileRows : cap;
  uint8_t* out = base + c.out;
  uint8_t* vout = c.valid >= 0 ? base + c.valid : nullptr;
  if (t0 >= c.n_rows) {  // a padding tile
    zero_fill(out + t0 * c.out_bytes, (t1 - t0) * c.out_bytes);
    if (vout != nullptr) zero_fill(vout + t0, t1 - t0);
    return;
  }
  const bool nulls = (c.flags & kHasNulls) != 0;
  const bool delta = (c.flags & kDelta) != 0;
  const bool is_bool = (c.flags & kBool) != 0;
  const int64_t live_end = t1 < c.n_rows ? t1 : c.n_rows;
  const uint64_t* dense = nulls
      ? reinterpret_cast<const uint64_t*>(base + c.dense) : nullptr;
  int64_t lo = t0, hi = live_end - 1;
  if (nulls) {
    lo = t0 > 0 ? (int64_t)__ldg(dense + t0 - 1) : 0;
    hi = (int64_t)__ldg(dense + live_end - 1) - 1;
  }
  const Table t = table_of(base, c.words, c.n_words, c.runs, c.n_runs);
  const bool expand = !delta && hi >= lo && t.n_runs > 0;  // block-uniform
  const bool narrow = c.lane_bytes <= 4;
  const int64_t dict_bytes = c.n_dict * c.lane_bytes;
  const bool dict_staged = expand && !is_bool && dict_bytes <= kDictBytes;
  const uint8_t* dict = base + c.dict;
  int64_t wa = 0;
  if (expand) {
    // the dictionary's loads go out before the search's, and land while
    // the search waits
    constexpr int kDictLoads = kDictBytes / 16 / kThreads;
    const int n16 = dict_staged ? (int)((dict_bytes + 15) >> 4) : 0;
    uint4 dict_regs[kDictLoads];
#pragma unroll
    for (int r = 0; r < kDictLoads; ++r) {
      const int q = threadIdx.x + r * kThreads;
      if (q < n16)
        dict_regs[r] = __ldg(reinterpret_cast<const uint4*>(dict) + q);
    }
    wa = first_run(t, lo);
#pragma unroll
    for (int r = 0; r < kDictLoads; ++r) {
      const int q = threadIdx.x + r * kThreads;
      if (q < n16) reinterpret_cast<uint4*>(dict_s)[q] = dict_regs[r];
    }
    if (dict_staged) dict = dict_s;
    load_window(s, t, wa, true, lo, hi, narrow);  // its barriers cover dict_s
  }
  const uint64_t* deltas = reinterpret_cast<const uint64_t*>(base + c.delta);
  for (int step = 0; step < kSteps; ++step) {
    if (t0 + step * kStepRows >= t1) break;  // a tile shorter than kTileRows
    const int64_t i0 = t0 + step * kStepRows + kGroup * threadIdx.x;
    bool valid[kGroup], want[kGroup];
    int64_t d[kGroup];
    uint64_t prev = (nulls && i0 > 0 && i0 <= live_end) ? __ldg(dense + i0 - 1)
                                                        : 0;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int64_t i = i0 + q;
      valid[q] = i < live_end;
      d[q] = i;
      if (nulls && valid[q]) {
        const uint64_t cur = __ldg(dense + i);
        valid[q] = cur != prev;
        d[q] = (int64_t)cur - 1;
        prev = cur;
      }
      want[q] = valid[q] && expand;
    }
    Expanded e[kGroup] = {};
    if (expand) expand_group(s, t, lo, hi, narrow, wa, d, want, e);
    if (i0 >= t1) continue;
    uint64_t v[kGroup];
    uint32_t vbytes = 0;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      v[q] = 0;
      if (!valid[q]) continue;
      vbytes |= 1u << (8 * q);
      const uint64_t bits = delta ? __ldg(deltas + d[q]) : e[q].bits;
      if (!delta && e[q].is_dict) {
        int64_t k = (int32_t)(uint32_t)bits;
        k = k > c.n_dict - 1 ? c.n_dict - 1 : k;
        k = k < 0 ? 0 : k;
        if (is_bool) v[q] = 0;  // the plain version's one-entry dictionary
        else if (c.lane_bytes == 8)
          v[q] = dict_staged
              ? reinterpret_cast<const uint64_t*>(dict)[k]
              : __ldg(reinterpret_cast<const uint64_t*>(dict) + k);
        else
          v[q] = dict_staged
              ? reinterpret_cast<const uint32_t*>(dict)[k]
              : __ldg(reinterpret_cast<const uint32_t*>(dict) + k);
      } else if (is_bool) {
        v[q] = bits & 1ull;
      } else {
        v[q] = c.lane_bytes == 8 ? bits : (uint32_t)bits;
      }
      // an int32 lane under a wider engine type: sign-extend
      if (c.out_bytes > c.lane_bytes && c.lane_bytes == 4)
        v[q] = (uint64_t)(int64_t)(int32_t)(uint32_t)v[q];
    }
    store_group(out, c.out_bytes, i0, v);
    if (vout != nullptr) reinterpret_cast<uint32_t*>(vout + i0)[0] = vbytes;
  }
}

// --- the segmented scan -----------------------------------------------------
// Elements are (start flag, uint64 value) pairs under
// (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2), which is associative:
// the inclusive scan restarts its sum at every flagged element.

// Fills a scan job's elements, a tile a block: kind 0 the definition bit of
// each row, kind 1 each DELTA contribution and whether it starts a page.
__global__ void __launch_bounds__(kThreads)
k5_scan_fill(uint8_t* base, const K5Col* cols, const K5Job* jobs) {
  __shared__ Window s;
  const K5Job j = jobs[blockIdx.y];
  const int64_t t0 = (int64_t)blockIdx.x * kTileRows;
  if (t0 >= j.n) return;
  const int64_t t1 = t0 + kTileRows < j.n ? t0 + kTileRows : j.n;
  const K5Col c = cols[j.col];
  const Table t = j.kind == 0
      ? table_of(base, c.def_words, c.n_def_words, c.def_runs, c.n_def_runs)
      : table_of(base, c.words, c.n_words, c.runs, c.n_runs);
  const bool expand = t.n_runs > 0;  // block-uniform
  // the definition bit is bit 0; DELTA contributions need all 64 bits
  const bool narrow = j.kind == 0;
  int64_t wa = 0;
  if (expand) {
    wa = first_run(t, t0);
    load_window(s, t, wa, true, t0, t1 - 1, narrow);
  }
  uint64_t* vals = reinterpret_cast<uint64_t*>(base + j.vals);
  uint8_t* flags = base + j.flags;
  for (int step = 0; step < kSteps; ++step) {
    if (t0 + step * kStepRows >= t1) break;
    const int64_t i0 = t0 + step * kStepRows + kGroup * threadIdx.x;
    int64_t d[kGroup];
    bool want[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      d[q] = i0 + q;
      want[q] = expand && i0 + q < t1;
    }
    Expanded e[kGroup] = {};
    if (expand) expand_group(s, t, t0, t1 - 1, narrow, wa, d, want, e);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      if (i0 + q >= t1) break;
      vals[i0 + q] = j.kind == 0 ? (e[q].bits & 1ull) : e[q].bits;
      flags[i0 + q] = j.kind != 0 && e[q].run_start ? 1 : 0;
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

}  // namespace

extern "C" {

int spark_k5_col_size() { return (int)sizeof(K5Col); }

int spark_k5_job_size() { return (int)sizeof(K5Job); }

int spark_k5_scan_tile() { return kScanThreads; }

int spark_k5_tile_rows() { return kTileRows; }

// blob: the device blob; cols_off/jobs_off: byte offsets of the descriptor
// tables in it; cap: the batch capacity (a multiple of 4); max_job_n: the
// longest scan job.
int spark_k5_decode(void* blob, int64_t cols_off, int n_cols, int64_t jobs_off,
                    int n_jobs, int64_t cap, int64_t max_job_n, void* stream) {
  if (blob == nullptr || n_cols < 1 || n_cols > 65535 || n_jobs < 0 ||
      n_jobs > 65535 || cap < 1 || cap % kGroup != 0)
    return (int)cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(blob);
  const K5Col* cols = reinterpret_cast<const K5Col*>(base + cols_off);
  const K5Job* jobs = reinterpret_cast<const K5Job*>(base + jobs_off);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (n_jobs > 0 && max_job_n > 0) {
    const int64_t tiles = (max_job_n + kScanThreads - 1) / kScanThreads;
    const int64_t fill = (max_job_n + kTileRows - 1) / kTileRows;
    k5_scan_fill<<<dim3((unsigned)fill, n_jobs), kThreads, 0, st>>>(
        base, cols, jobs);
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
  const int64_t tiles = (cap + kTileRows - 1) / kTileRows;
  k5_decode<<<dim3((unsigned)tiles, n_cols), kThreads, 0, st>>>(base, cols,
                                                                 cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
