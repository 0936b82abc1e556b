// K6 for Hopper: a compiled regex automaton run over each row's bytes.
//
// Replaces regex_match_device (spark_rapids_tpu/ops/regex.py:378), which
// the reference runs as one XLA program: a lax.while_loop over byte
// positions up to the longest live string, each step an (n, S) x (S, S)
// transition product over every row. It carries LIKE patterns beyond the
// simple shapes (NDS q_like's i_category LIKE '%o%s%', 32 positions) and
// RLIKE.
//
// Function, for each row i < n (start s_i, length l_i; a null row, where a
// validity is given, steps as an empty one; bytes read at clamp(s_i + j,
// 0, n_chars - 1) as the reference's gather does, an empty buffer as one
// zero byte), over the position automaton of ops/regex.compile_pattern:
//   matched = always_match || (empty_only_match && l_i == 0)
//   active  = first_anchored | first_floating
//   for j < live length, while !matched and active != 0:
//     fired    = active & acc[byte j]
//     matched |= (fired & accept_any) != 0
//     matched |= j == last byte && (fired & accept_end) != 0
//     active   = OR of follow[s] over the set bits s of fired
//                | first_floating
//   out[i] = matched
// A matched row stays matched, and once no position is active none can
// fire again, so a row stops at its first match or at the empty set; the
// answer equals the reference's loop. The caller masks validity.
//
// Two routes, chosen on the host by the size of the program's tables
// (ops/regex.program_tables), both one thread a row:
//   A (route 0), a DFA from the subset construction over the position
//     sets (ops/regex.build_dfa): tables = the class of each byte (256 B)
//     then n_states x n_classes uint16 entries (next state in bits 0-13,
//     bit 14: the byte fired accept_any, bit 15: it fired accept_end). A
//     step is two shared-memory lookups, the class one off the state's
//     chain. The host caps states x classes at 2^15 (64 KB), so three
//     blocks fit an SM.
//   B (route 1), position sets as uint64 bit sets (at most 64 positions),
//     for a program whose DFA passes that cap: tables = acc[256] and
//     follow[64]; the kernel's first step, one acc lookup and one follow
//     lookup a set bit of fired (__ffsll), a byte at a time.
//
// Bound. The bytes a call must move are each row's bytes up to where it
// stops, its 4 B start, 4 B length, 1 B validity and 1 B result, and the
// tables; at 2^20 rows of 20-120 B that is 0.023 ms at 3.35 TB/s. Neither
// route gets near it: a step is a chain of dependent instructions (the
// entry's shared load, then the next index), a warp waits for its longest
// row, and route B walks fired's bits. Route A therefore reads its row as
// aligned 16-byte loads (__ldg of a uint4, one load instruction for 16
// bytes) and steps the full chunks unrolled and without a branch, testing
// for a decision once a chunk; the row's partial first and last chunks
// step a byte at a time (unrolled and guarded they cost a short row, such
// as q_like's 4-11 bytes, 16 steps each). A row whose bytes are not all
// inside [0, n_chars) steps a byte at a time with the reference's clamp.
// Route B kept the kernel's first loop: with 16-byte loads and
// branch-free steps it ran slower on the card (PERF.md section 6).
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct RegexArgs {
  const void* tables;  // 16-byte aligned, table_bytes long
  const int32_t* starts;
  const int32_t* lengths;
  const uint8_t* validity;
  const uint8_t* chars;
  uint8_t* out;
  int64_t n;
  int64_t n_chars;
  int64_t table_bytes;  // a multiple of 16
  uint64_t first_anchored;  // route B's masks
  uint64_t first_floating;
  uint64_t accept_any;
  uint64_t accept_end;
  int32_t route;          // 0: A (DFA), 1: B (position sets)
  int32_t n_classes;      // A
  int32_t dead;           // A: the empty set's state, or -1
  int32_t flags;          // bit 0 always_match, bit 1 empty_only_match
};

}  // extern "C"

// the route's tables, staged by each block (stage_tables); the kernels
// index this array itself, so their lookups compile to shared loads
extern __shared__ __align__(16) unsigned char smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 64;
// the class map and 2^15 entries; acc and follow
constexpr int64_t kMaxDfaBytes = 256 + 2 * 32768;
constexpr int64_t kMaxPositionBytes = 8 * (256 + 64);
constexpr uint32_t kAny = 1u << 14;  // and kEnd = 1u << 15
constexpr uint32_t kStateMask = kAny - 1;

// Route A's DFA over one row. feed (any byte but the last) and feed_last
// (the last byte) do not branch: a row is tested for a decision
// (matched, or the dead state) once a 16-byte chunk, and a byte stepped
// after it changes no answer, since a match is kept and the dead state
// keeps itself.
struct DfaMachine {
  int n_classes;
  int dead;
  int state;
  uint32_t seen;  // the OR of the entries taken (kAny: matched)

  // the class map at smem[0:256], the entries from smem[256]
  __device__ __forceinline__ uint32_t entry(uint32_t c) const {
    return reinterpret_cast<const uint16_t*>(
        smem + 256)[state * n_classes + smem[c]];
  }
  __device__ __forceinline__ void feed(uint32_t c) {
    const uint32_t e = entry(c);
    seen |= e;
    state = (int)(e & kStateMask);
  }
  // the last byte: an end accept counts too (kEnd shifted onto kAny)
  __device__ __forceinline__ void feed_last(uint32_t c) {
    const uint32_t e = entry(c);
    seen |= e | (e >> 1);
  }
  __device__ __forceinline__ bool matched() const {
    return (seen & kAny) != 0;
  }
  __device__ __forceinline__ bool decided() const {
    return matched() || state == dead;
  }
};

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int b) {
  const uint32_t w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return (w >> (8 * (b & 3))) & 0xFFu;
}

// The byte of the row at offset j, clamped into [0, n_chars) as the
// reference's gather does; an empty buffer reads as one zero byte.
__device__ __forceinline__ uint32_t clamped_byte(const uint8_t* chars,
                                                 int64_t n_chars,
                                                 int32_t start, int32_t j) {
  int64_t at = (int64_t)start + j;
  at = at < 0 ? 0 : (at >= n_chars ? n_chars - 1 : at);
  return n_chars == 0 ? 0u : chars[at];
}

// Steps the DFA over row bytes [start, start + live) until it decides the
// row or the bytes end: 16-byte chunks, the full ones unrolled, the
// row's first and last partial chunks a byte at a time.
__device__ __forceinline__ void walk(const uint8_t* chars, int64_t n_chars,
                                     int32_t start, int32_t live,
                                     DfaMachine& m) {
  if (live <= 0 || m.decided()) return;
  if (start < 0 || (int64_t)start + live > n_chars) {
    for (int32_t j = 0; j < live - 1; ++j) {
      m.feed(clamped_byte(chars, n_chars, start, j));
      if (m.decided()) return;
    }
    m.feed_last(clamped_byte(chars, n_chars, start, live - 1));
    return;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(chars + start);
  const uint4* q = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  // j: the offset in the row of q's first byte. The chunks before the one
  // that holds the row's last byte:
  int64_t j = -(int64_t)(addr & 15);
  for (; j + 16 < live; j += 16, ++q) {
    const uint4 v = __ldg(q);
    if (j < 0) {
#pragma unroll 1
      for (int b = (int)-j; b < 16; ++b) m.feed(byte_of(v, b));
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b) m.feed(byte_of(v, b));
    }
    if (m.decided()) return;
  }
  // the last chunk: the row's bytes [lo, hi), hi - 1 its last
  const uint4 v = __ldg(q);
  const int hi = (int)(live - j);
#pragma unroll 1
  for (int b = j < 0 ? (int)-j : 0; b < hi - 1; ++b) m.feed(byte_of(v, b));
  m.feed_last(byte_of(v, hi - 1));
}

__device__ __forceinline__ void stage_tables(const void* tables,
                                             int64_t table_bytes) {
  const uint4* src = static_cast<const uint4*>(tables);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int64_t k = threadIdx.x; k < table_bytes / 16; k += kThreads)
    dst[k] = __ldg(src + k);
  __syncthreads();
}

// A row's start and live length, and whether the flags decide it before
// its first byte.
struct Row {
  int32_t start, live;
  bool decided;
};

__device__ __forceinline__ Row row_at(const int32_t* starts,
                                      const int32_t* lengths,
                                      const uint8_t* validity, int32_t flags,
                                      int64_t i) {
  const int32_t len = lengths[i];
  const bool valid = validity == nullptr || validity[i] != 0;
  return Row{starts[i], valid ? len : 0,
             (flags & 1) != 0 || ((flags & 2) != 0 && len == 0)};
}

__global__ void __launch_bounds__(kThreads)
    regex_match_dfa(const RegexArgs a) {
  stage_tables(a.tables, a.table_bytes);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * kThreads) {
    const Row r = row_at(a.starts, a.lengths, a.validity, a.flags, i);
    DfaMachine m{a.n_classes, a.dead, 0, r.decided ? kAny : 0u};
    walk(a.chars, a.n_chars, r.start, r.live, m);
    a.out[i] = m.matched() ? 1 : 0;
  }
}

// Route B: the kernel's first step, a byte at a time (whole-chunk loads and
// branch-free steps made it slower on the card: the follow loop, not the
// loads, holds it).
__global__ void __launch_bounds__(kThreads)
    regex_match_positions(const RegexArgs a) {
  stage_tables(a.tables, a.table_bytes);
  const uint64_t* acc = reinterpret_cast<const uint64_t*>(smem);
  const uint64_t* follow = acc + 256;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * kThreads) {
    const Row r = row_at(a.starts, a.lengths, a.validity, a.flags, i);
    bool matched = r.decided;
    uint64_t active = a.first_anchored | a.first_floating;
    for (int32_t j = 0; j < r.live && !matched && active != 0; ++j) {
      const uint64_t fired =
          active & acc[clamped_byte(a.chars, a.n_chars, r.start, j)];
      if ((fired & a.accept_any) != 0 ||
          (j == r.live - 1 && (fired & a.accept_end) != 0))
        matched = true;
      uint64_t nxt = a.first_floating;
      for (uint64_t f = fired; f != 0; f &= f - 1)
        nxt |= follow[__ffsll((long long)f) - 1];
      active = nxt;
    }
    a.out[i] = matched ? 1 : 0;
  }
}

// Allows dynamic shared memory above 48 KB (once a size), then launches
// a block of 256 rows, one a thread (a grid of fewer blocks, each
// striding over more rows, ran slower on the card on every case).
template <class K>
cudaError_t launch(K kernel, const RegexArgs& a, cudaStream_t stream,
                   int64_t& allowed) {
  const int smem_bytes = (int)a.table_bytes;
  cudaError_t err = cudaSuccess;
  if (smem_bytes > 48 * 1024 && smem_bytes > allowed) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    allowed = smem_bytes;
  }
  const int64_t want = (a.n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  kernel<<<blocks, kThreads, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int spark_regex_args_size() { return (int)sizeof(RegexArgs); }

int spark_regex_launch(const void* args, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const RegexArgs a = *static_cast<const RegexArgs*>(args);
  if (a.n <= 0) return (int)cudaSuccess;
  const int64_t max_bytes = a.route == 0 ? kMaxDfaBytes : kMaxPositionBytes;
  if (a.tables == nullptr || a.starts == nullptr || a.lengths == nullptr ||
      a.out == nullptr || a.n_chars < 0 ||
      (a.chars == nullptr && a.n_chars > 0) || a.table_bytes <= 0 ||
      a.table_bytes % 16 != 0 || a.table_bytes > max_bytes ||
      (reinterpret_cast<uintptr_t>(a.tables) & 15) != 0 ||
      (a.route == 0 && (a.n_classes <= 0 || a.n_classes > 256)) ||
      (a.route != 0 && a.route != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int64_t allowed[2] = {0, 0};
  if (a.route == 0) return (int)launch(regex_match_dfa, a, s, allowed[0]);
  return (int)launch(regex_match_positions, a, s, allowed[1]);
}

}  // extern "C"
