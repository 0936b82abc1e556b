// K8 for Hopper: each row's non-overlapping leftmost-longest match spans of
// a compiled regex, for regexp_replace and regexp_extract.
//
// Replaces regex_find_spans_device (spark_rapids_tpu/ops/regex.py:475),
// which the reference runs as one XLA program of two lax.while_loops over
// every row at once: a backward walk over byte positions up to the longest
// row (:536), each step an (n, S) x (S, S) product with the transposed
// follow relation, and a forward walk (:607) with the same product a step
// and a scatter a step, its in-span mask kept as +1/-1 deltas and decoded
// by a segmented prefix sum after the loop.
//
// Function, over the position automaton of ops/regex.compile_pattern (at
// most 64 positions, one uint64 set; first = first_anchored |
// first_floating), for each row i < n (bytes chars[s : s + L], s =
// offsets[i], L = offsets[i + 1] - s; a null row, where a validity is
// given, has L = 0 here):
//   phase 1, j from L - 1 down to 0 (R = 0 past the end):
//     R = acc[byte j] & (accept_any | (j == L - 1 ? accept_end : 0)
//                        | the positions whose follow set meets R)
//     start[j] = (R & first) != 0 (and j == 0 where the pattern is
//                anchored at its start)
//   phase 2, j from 0: where start[j], run the automaton from first over
//     bytes j, j + 1, ... (fired = active & acc[byte], active = follow of
//     fired), keeping the last k + 1 where fired met an accept, until
//     active is empty or the row ends; a span [j, last) when there was an
//     accept, the walk going on from last (from j + 1 otherwise); with
//     first_only the row stops after its first span.
//   in_match[s + k] = k lies in a span; match_start[s + k] = a span starts
//   at k; n_matches[i]; first_s[i], first_e[i] = the first span (-1, -1
//   when none).
// The answers equal the reference's, whose forward walk commits the same
// spans.
//
// One thread a row runs both phases over its own bytes. The rows' byte
// ranges are disjoint, so the thread writes its row's in_match and
// match_start bytes directly: no atomics and no delta decode. Phase 1
// keeps its start flags in the row's in_match bytes, which phase 2 reads
// a position before it overwrites it (a span's bytes are past every flag
// it still needs). Bytes outside every row, and a null row's, stay as the
// caller zeroed them.
//
// Tables (ops/regex.span_tables), staged in shared memory by each block:
// acc[256] (the positions each byte may fire), then K = ceil(S / 8) follow
// byte tables of 256 sets and K transposed ones: the follow set of a fired
// set f is the OR over k of follow[k][(f >> 8k) & 255], so a step costs K
// lookups whatever the number of fired positions. At most 34 KB.
//
// Bound: the bytes the function must move: each row's bytes read once (a
// row of 20-120 B fits on chip, so reading it in both phases, as this
// kernel does, is the design's cost), both byte lanes written once, the
// offsets (4 B a row) and 12 B a row out (the count and the first span);
// at 2^20 rows of 20-120 B that is about 238 MB, 0.071 ms at 3.35 TB/s.
// The kernel is far from it: a step is a chain of dependent shared loads,
// a warp waits for its longest row, a row is read twice, and a span's
// look-ahead past its last accept is read again.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct SpanArgs {
  const void* tables;  // uint64: acc[256], follow[K][256], follow_t[K][256]
  const int32_t* offsets;  // n + 1
  const uint8_t* validity;  // n, or null
  const uint8_t* chars;
  uint8_t* in_match;     // n_chars (at least 1), zeroed by the caller
  uint8_t* match_start;  // n_chars (at least 1), zeroed by the caller
  int32_t* n_matches;    // n
  int32_t* first_s;      // n
  int32_t* first_e;      // n
  int64_t n;
  int64_t n_chars;
  uint64_t first;
  uint64_t accept_any;
  uint64_t accept_end;
  int32_t n_tables;  // K, 1..8
  int32_t anchored;
  int32_t first_only;
  int32_t pad;
};

}  // extern "C"

extern __shared__ __align__(16) unsigned char smem[];

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTables = 8;

__device__ __forceinline__ uint64_t step(const uint64_t* tabs, int k_tables,
                                         uint64_t set) {
  uint64_t out = 0;
  for (int k = 0; k < k_tables; ++k) {
    const uint32_t b = (uint32_t)(set >> (8 * k)) & 255u;
    if (b) out |= tabs[k * 256 + b];
  }
  return out;
}

__global__ void __launch_bounds__(kThreads) spans_rows(const SpanArgs a) {
  uint64_t* tabs = reinterpret_cast<uint64_t*>(smem);
  const int words = 256 * (1 + 2 * a.n_tables);
  const uint64_t* g = static_cast<const uint64_t*>(a.tables);
  for (int t = threadIdx.x; t < words; t += kThreads) tabs[t] = g[t];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const uint64_t* acc = tabs;
  const uint64_t* follow = tabs + 256;
  const uint64_t* follow_t = tabs + 256 * (1 + a.n_tables);
  const int k_tables = a.n_tables;
  const int64_t s = a.offsets[i];
  int64_t len = (int64_t)a.offsets[i + 1] - s;
  if (a.validity != nullptr && !a.validity[i]) len = 0;
  const uint8_t* row = a.chars + s;
  uint8_t* flag = a.in_match + s;  // phase 1's start flags, then in_match
  uint8_t* mstart = a.match_start + s;

  // phase 1: where can a match start
  uint64_t r = 0;
  for (int64_t j = len - 1; j >= 0; --j) {
    const uint64_t here =
        a.accept_any | (j == len - 1 ? a.accept_end : 0ull);
    r = acc[row[j]] & (here | step(follow_t, k_tables, r));
    flag[j] = (r & a.first) != 0 && (!a.anchored || j == 0);
  }

  // phase 2: commit the greedy spans left to right
  int32_t count = 0, fs = -1, fe = -1;
  int64_t j = 0;
  while (j < len) {
    if (!flag[j]) {
      flag[j] = 0;
      ++j;
      continue;
    }
    int64_t last = -1;
    uint64_t active = a.first;
    for (int64_t k = j; k < len; ++k) {
      const uint64_t fired = active & acc[row[k]];
      const uint64_t here =
          a.accept_any | (k == len - 1 ? a.accept_end : 0ull);
      if (fired & here) last = k + 1;
      active = step(follow, k_tables, fired);
      if (active == 0) break;
    }
    if (last > j) {
      for (int64_t k = j; k < last; ++k) flag[k] = 1;
      mstart[j] = 1;
      if (count == 0) {
        fs = (int32_t)j;
        fe = (int32_t)last;
      }
      ++count;
      j = last;
      if (a.first_only) {
        for (int64_t k = j; k < len; ++k) flag[k] = 0;
        break;
      }
    } else {
      flag[j] = 0;
      ++j;
    }
  }
  a.n_matches[i] = count;
  a.first_s[i] = fs;
  a.first_e[i] = fe;
}

}  // namespace

extern "C" {

int spark_spans_args_size() { return (int)sizeof(SpanArgs); }

int spark_spans_launch(const void* args, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const SpanArgs a = *static_cast<const SpanArgs*>(args);
  if (a.n <= 0) return (int)cudaSuccess;
  if (a.tables == nullptr || a.offsets == nullptr || a.in_match == nullptr ||
      a.match_start == nullptr || a.n_matches == nullptr ||
      a.first_s == nullptr || a.first_e == nullptr || a.n_chars < 0 ||
      (a.chars == nullptr && a.n_chars > 0) || a.n_tables < 1 ||
      a.n_tables > kMaxTables)
    return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(uint64_t) * 256 * (1 + 2 * a.n_tables);
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  spans_rows<<<(unsigned)blocks, kThreads, shared,
               static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
