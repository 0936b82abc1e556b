// K6 for Hopper: a compiled position automaton run over each row's bytes.
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
// zero byte):
//   matched = always_match || (empty_only_match && l_i == 0)
//   active  = first_anchored | first_floating
//   for j < live length, while !matched and active != 0:
//     fired    = active & acc[byte j]
//     matched |= (fired & accept_any) != 0
//     matched |= j == last byte && (fired & accept_end) != 0
//     active   = OR of follow[s] over the set bits s of fired
//                | first_floating
//   out[i] = matched
// The position sets are uint64 bit sets (bit s for position s; the compiler
// allows at most 64 positions). The answer equals the reference's loop: a
// matched row stays matched, and once no position is active none can
// fire again, so stopping a row there changes nothing. The caller masks
// validity.
//
// Tables (one int64 array from ops/regex.program_tables): acc[256],
// follow[64], then first_anchored, first_floating, accept_any, accept_end
// and the flags (bit 0 always_match, bit 1 empty_only_match).
//
// Bound: memory. A row's bytes are read once, and its 4 B start, 4 B
// length, 1 B validity and 1 B result move once; the tables (2.5 KB) are
// read from L2 once a block into shared memory. At q_like's item batch,
// 32,768 strings of 4-11 bytes, that is under 0.6 MB, a fraction of a
// microsecond at 3.35 TB/s, so a launch there costs its fixed overhead.
//
// Design (simple and right first): one thread a row, 256 threads a block.
// The block stages acc and follow in shared memory; each step is one byte
// load, one shared acc lookup, and one shared follow lookup a set bit of
// fired (__ffsll). A row stops early when it has matched or its active set
// is empty. A thread reads its row's bytes one at a time, so a warp's loads
// do not coalesce; rows of a warp differ in length and stop apart. Both
// wait for a later PR.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct RegexArgs {
  const uint64_t* tables;
  const int32_t* starts;
  const int32_t* lengths;
  const uint8_t* validity;
  const uint8_t* chars;
  uint8_t* out;
  int64_t n;
  int64_t n_chars;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kStates = 64;
constexpr int kMasks = 256 + kStates;  // index of first_anchored

__global__ void __launch_bounds__(kThreads)
    regex_match_kernel(const RegexArgs a) {
  __shared__ uint64_t acc[256];
  __shared__ uint64_t follow[kStates];
  for (int k = threadIdx.x; k < 256 + kStates; k += kThreads) {
    const uint64_t v = __ldg(a.tables + k);
    if (k < 256)
      acc[k] = v;
    else
      follow[k - 256] = v;
  }
  __syncthreads();
  const uint64_t first_a = __ldg(a.tables + kMasks);
  const uint64_t first_f = __ldg(a.tables + kMasks + 1);
  const uint64_t accept_any = __ldg(a.tables + kMasks + 2);
  const uint64_t accept_end = __ldg(a.tables + kMasks + 3);
  const uint64_t flags = __ldg(a.tables + kMasks + 4);

  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < a.n;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t len = a.lengths[i];
    const bool valid = a.validity == nullptr || a.validity[i] != 0;
    const int64_t live = valid ? len : 0;
    bool matched = (flags & 1) != 0 || ((flags & 2) != 0 && len == 0);
    uint64_t active = first_a | first_f;
    const int64_t start = a.starts[i];
    for (int64_t j = 0; j < live && !matched && active != 0; ++j) {
      int64_t at = start + j;
      at = at < 0 ? 0 : (at >= a.n_chars ? a.n_chars - 1 : at);
      // an empty chars buffer reads as one zero byte, as the reference's
      const uint8_t c = a.n_chars == 0 ? 0 : a.chars[at];
      const uint64_t fired = active & acc[c];
      if ((fired & accept_any) != 0 ||
          (j == live - 1 && (fired & accept_end) != 0))
        matched = true;
      uint64_t nxt = 0;
      for (uint64_t f = fired; f != 0; f &= f - 1)
        nxt |= follow[__ffsll((long long)f) - 1];
      active = nxt | first_f;
    }
    a.out[i] = matched ? 1 : 0;
  }
}

}  // namespace

extern "C" {

int spark_regex_args_size() { return (int)sizeof(RegexArgs); }

int spark_regex_launch(const void* args, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const RegexArgs a = *static_cast<const RegexArgs*>(args);
  if (a.n <= 0) return (int)cudaSuccess;
  if (a.tables == nullptr || a.starts == nullptr || a.lengths == nullptr ||
      a.out == nullptr || a.n_chars < 0 ||
      (a.chars == nullptr && a.n_chars > 0))
    return (int)cudaErrorInvalidValue;
  const int64_t want = (a.n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  regex_match_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
