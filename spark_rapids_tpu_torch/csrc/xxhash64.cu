// K7 for Hopper: Spark's XXH64 (seed threaded through the columns) of each
// row of a string column.
//
// Replaces xxhash64_bytes_device_seeded (spark_rapids_tpu/ops/hash.py:363),
// which the reference runs as one XLA program: a lax.while_loop (:412) over
// 32-byte stripes up to the longest row, every row stepping each round
// under a mask, then three 8-byte, one 4-byte and three 1-byte masked tail
// steps. It carries xxhash64() over a string column (expr/hashes.XxHash64).
//
// Function, for each row i < n (bytes chars[offsets[i] : offsets[i + 1]],
// length L, incoming seed seed[i], all arithmetic wrapping in uint64):
//   if validity is given and validity[i] is false: out[i] = seed[i]
//   else, XXH64 as Spark's XXH64.hashUnsafeBytes defines it:
//     L >= 32: four accumulators (seed + P1 + P2, seed + P2, seed,
//       seed - P1), each 32-byte stripe's four little-endian words taken
//       round(acc, w) = rotl(acc + w * P2, 31) * P1; then
//       h = rotl(a1, 1) + rotl(a2, 7) + rotl(a3, 12) + rotl(a4, 18) and
//       each accumulator merged, h = (h ^ round(0, acc)) * P1 + P4
//     L < 32: h = seed + P5
//     h += L; then every whole 8-byte word left,
//       h = rotl(h ^ round(0, w), 27) * P1 + P4; a 4-byte word,
//       h = rotl(h ^ (w32 * P1), 23) * P2 + P3; each byte left,
//       h = rotl(h ^ (b * P5), 11) * P1; and the avalanche
//     out[i] = h (as int64)
//
// One thread a row walks its own bytes, so there is no mask and no step
// past a row's end: a warp waits for its longest row only. An 8-byte word
// at any byte address is two aligned 8-byte loads (__ldg) joined by a
// shift, so a row's bytes cost a load per word, not per byte. Both aligned
// words hold a byte of the row, so neither leaves the buffer's
// allocation; the 4-byte word and the last bytes are read a byte at a
// time.
//
// Bound: the bytes a call must move, each row's bytes once, its two
// offsets (4 B each, shared with the next row), the 8 B seed in, the 1 B
// validity and the 8 B hash out; at 2^20 rows of 0-100 B that is about
// 0.02 ms at 3.35 TB/s.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;
constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t round0(uint64_t acc, uint64_t w) {
  return rotl(acc + w * P2, 31) * P1;
}

// the little-endian 8-byte word at p, any alignment
__device__ __forceinline__ uint64_t word64(const uint8_t* p) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const unsigned off = (unsigned)(addr & 7);
  const uint64_t* w = reinterpret_cast<const uint64_t*>(addr - off);
  const uint64_t lo = __ldg(w);
  if (off == 0) return lo;
  const uint64_t hi = __ldg(w + 1);
  return (lo >> (8 * off)) | (hi << (64 - 8 * off));
}

__global__ void __launch_bounds__(kThreads)
xxhash64_rows(const int32_t* __restrict__ offsets,
              const uint8_t* __restrict__ chars,
              const int64_t* __restrict__ seed,
              const uint8_t* __restrict__ validity,
              int64_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint64_t sd = (uint64_t)seed[i];
  if (validity != nullptr && !validity[i]) {
    out[i] = (int64_t)sd;
    return;
  }
  const int64_t start = offsets[i];
  const int64_t len = (int64_t)offsets[i + 1] - start;
  const uint8_t* p = chars + start;
  uint64_t h;
  int64_t pos = 0;
  if (len >= 32) {
    uint64_t a1 = sd + P1 + P2, a2 = sd + P2, a3 = sd, a4 = sd - P1;
    for (; pos + 32 <= len; pos += 32) {
      a1 = round0(a1, word64(p + pos));
      a2 = round0(a2, word64(p + pos + 8));
      a3 = round0(a3, word64(p + pos + 16));
      a4 = round0(a4, word64(p + pos + 24));
    }
    h = rotl(a1, 1) + rotl(a2, 7) + rotl(a3, 12) + rotl(a4, 18);
    h = (h ^ round0(0, a1)) * P1 + P4;
    h = (h ^ round0(0, a2)) * P1 + P4;
    h = (h ^ round0(0, a3)) * P1 + P4;
    h = (h ^ round0(0, a4)) * P1 + P4;
  } else {
    h = sd + P5;
  }
  h += (uint64_t)len;
  for (; pos + 8 <= len; pos += 8) {
    h = rotl(h ^ round0(0, word64(p + pos)), 27) * P1 + P4;
  }
  if (pos + 4 <= len) {
    const uint64_t w = (uint64_t)p[pos] | ((uint64_t)p[pos + 1] << 8) |
                       ((uint64_t)p[pos + 2] << 16) |
                       ((uint64_t)p[pos + 3] << 24);
    h = rotl(h ^ (w * P1), 23) * P2 + P3;
    pos += 4;
  }
  for (; pos < len; ++pos) {
    h = rotl(h ^ ((uint64_t)p[pos] * P5), 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  out[i] = (int64_t)h;
}

}  // namespace

extern "C" {

int spark_xxhash64_launch(const int32_t* offsets, const uint8_t* chars,
                          const int64_t* seed, const uint8_t* validity,
                          int64_t* out, int64_t n, int64_t n_chars,
                          void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (offsets == nullptr || seed == nullptr || out == nullptr ||
      n_chars < 0 || (chars == nullptr && n_chars > 0))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  xxhash64_rows<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      offsets, chars, seed, validity, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
