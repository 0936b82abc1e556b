// K4 for Hopper: a row gather of up to kMaxCols fixed-width columns in one
// launch.
//
// Replaces gather_pallas (spark_rapids_tpu/ops/pallas_kernels.py:259, body
// _gather_kernel at :104), out[i] = table[idx[i]] with the whole table in
// VMEM and len(idx) a multiple of 2^17; on the TPU Mosaic never lowered it.
// Here it backs every fixed-width column gather of the join + group-by path:
// the probe's gather of the build columns into match positions, and the
// group-by's permutation of keys and values and its gather of each segment's
// first row.
//
// Function, for each output row i < n and column c (1, 2, 4 or 8 bytes):
//   j = clamp(idx[i], 0, table_rows - 1)   (read only where the row is live)
//   out[c][i]       = live[i] ? src[c][j] : 0
//   out_valid[c][i] = live[i] && (src_valid[c] ? src_valid[c][j] : 1)
// A null `live` means every row is live; a null out_valid[c] is not
// written. The copy is bit for bit. The clamp gives jnp.take's in-bounds
// answer for an index out of range, as the reference's gathers do.
//
// Bound: memory. Each output row reads its 4 B index and, where given, its
// 1 B live flag, and writes each column's width plus 1 B of validity where
// one is written; each source element is read at most once from device
// memory. The join probe at 2^21 rows gathering two int32 build columns of
// 2^17 rows moves 2^21 x 13 B + 1 MB = 28.3 MB, about 8.4 us at 3.35 TB/s.
// The build columns (2^17 x 4 B each) stay in the 50 MB L2, so what limits
// the kernel in practice is the rate of random L2 sector reads: one 32 B
// sector per row and column.
//
// Design: each thread owns kRows = 4 consecutive rows. It loads their
// indices as one int4 and their live flags as one 32-bit word (scalar loads
// on a ragged tail or an unaligned pointer), then issues every column's
// source loads for the four rows before any store, so that 4 x columns
// random reads are in flight per thread, and stores each column's four
// values with one vector store (int4 for 4-byte columns, two for 8-byte
// ones) and the validity bytes as one 32-bit word. When all columns share
// one width and there are at most kFastCols of them (the path's case:
// int32 and float32 columns) the kernel is templated on the width and the
// column count, so no width switch sits in the inner loop and every load is
// unrolled. Other calls (the final aggregate's int32 key and float64 sum)
// take a generic kernel of one row a thread with a width switch per column:
// holding four rows of four mixed columns as 8 bytes each took 80 registers
// and ran slower there than one row a thread.
//
// On an H100 the four rows a thread gain little over one row a thread: the
// gather is bound by random L2 sector reads, not by latency, so its time
// grows with the columns gathered (one random sector a row and column),
// while torch.index_select of the columns stacked reads one sector a row.
//
// Plain C interface for ctypes; the launch goes on the caller's stream and
// the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" {

struct GatherArgs {
  const void* src[16];
  void* dst[16];
  const uint8_t* src_valid[16];
  uint8_t* dst_valid[16];
  int32_t width[16];
  int32_t n_cols;
  int32_t pad_;
  const int32_t* idx;
  const uint8_t* live;
  int64_t n;
  int64_t table_rows;
};

}  // extern "C"

namespace {

constexpr int kMaxCols = 16;
constexpr int kFastCols = 4;
constexpr int kRows = 4;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <int W>
struct Word;
template <>
struct Word<1> {
  using T = uint8_t;
  using Vec = uint32_t;
};
template <>
struct Word<2> {
  using T = uint16_t;
  using Vec = uint2;
};
template <>
struct Word<4> {
  using T = uint32_t;
  using Vec = uint4;
};
template <>
struct Word<8> {
  using T = unsigned long long;
  using Vec = ulonglong2;  // two of them hold the four rows
};

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (uintptr_t)(bytes - 1)) == 0;
}

// The four rows' clamped source rows and live flags; `full` when all four
// rows exist.
struct Rows {
  int64_t j[kRows];
  bool live[kRows];
};

__device__ __forceinline__ Rows load_rows(const GatherArgs& a, int64_t i0,
                                          bool full) {
  Rows r;
  int32_t idx[kRows] = {0, 0, 0, 0};
  bool live[kRows];
  if (full && a.live != nullptr && aligned(a.live + i0, 4)) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(a.live + i0));
#pragma unroll
    for (int k = 0; k < kRows; ++k) live[k] = ((w >> (8 * k)) & 0xffu) != 0;
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      live[k] = i0 + k < a.n && (a.live == nullptr || a.live[i0 + k] != 0);
  }
  if (full && aligned(a.idx + i0, 16)) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(a.idx + i0));
    idx[0] = v.x;
    idx[1] = v.y;
    idx[2] = v.z;
    idx[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (i0 + k < a.n) idx[k] = __ldg(a.idx + i0 + k);
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    r.live[k] = live[k] && a.table_rows > 0;
    int64_t j = idx[k];
    j = j < 0 ? 0 : (j >= a.table_rows ? a.table_rows - 1 : j);
    r.j[k] = r.live[k] ? j : 0;
  }
  return r;
}

template <int W>
__device__ __forceinline__ void load_col(const GatherArgs& a, int c,
                                         const Rows& r,
                                         typename Word<W>::T (&v)[kRows]) {
  using T = typename Word<W>::T;
  const T* src = static_cast<const T*>(a.src[c]);
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    v[k] = r.live[k] ? __ldg(src + r.j[k]) : T(0);
}

__device__ __forceinline__ void load_valid(const GatherArgs& a, int c,
                                           const Rows& r,
                                           uint8_t (&v)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    v[k] = (r.live[k] && (a.src_valid[c] == nullptr ||
                          __ldg(a.src_valid[c] + r.j[k]) != 0))
               ? 1
               : 0;
}

template <int W>
__device__ __forceinline__ void store_col(
    const GatherArgs& a, int c, int64_t i0, bool full,
    const typename Word<W>::T (&v)[kRows]) {
  using T = typename Word<W>::T;
  using Vec = typename Word<W>::Vec;
  T* dst = static_cast<T*>(a.dst[c]) + i0;
  constexpr int kVecBytes = W == 8 ? 16 : W * kRows;
  if (full && aligned(dst, kVecBytes)) {
    if constexpr (W == 8) {
      Vec* d = reinterpret_cast<Vec*>(dst);
      d[0] = make_ulonglong2(v[0], v[1]);
      d[1] = make_ulonglong2(v[2], v[3]);
    } else if constexpr (W == 4) {
      *reinterpret_cast<Vec*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else if constexpr (W == 2) {
      *reinterpret_cast<Vec*>(dst) =
          make_uint2((uint32_t)v[0] | ((uint32_t)v[1] << 16),
                     (uint32_t)v[2] | ((uint32_t)v[3] << 16));
    } else {
      *reinterpret_cast<Vec*>(dst) = (uint32_t)v[0] | ((uint32_t)v[1] << 8) |
                                     ((uint32_t)v[2] << 16) |
                                     ((uint32_t)v[3] << 24);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (i0 + k < a.n) dst[k] = v[k];
  }
}

__device__ __forceinline__ void store_valid(const GatherArgs& a, int c,
                                            int64_t i0, bool full,
                                            const uint8_t (&v)[kRows]) {
  uint8_t* dst = a.dst_valid[c] + i0;
  if (full && aligned(dst, 4)) {
    *reinterpret_cast<uint32_t*>(dst) =
        (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16) |
        ((uint32_t)v[3] << 24);
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (i0 + k < a.n) dst[k] = v[k];
  }
}

// Every column has width W and there are exactly NC of them: all loads of
// the four rows, then all stores.
template <int W, int NC>
__global__ void __launch_bounds__(kThreads)
gather_rows_fast(const GatherArgs a) {
  using T = typename Word<W>::T;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kRows;
  for (int64_t i0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kRows;
       i0 < a.n; i0 += stride) {
    const bool full = i0 + kRows <= a.n;
    const Rows r = load_rows(a, i0, full);
    T v[NC][kRows];
    uint8_t ok[NC][kRows];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      load_col<W>(a, c, r, v[c]);
      if (a.dst_valid[c] != nullptr) load_valid(a, c, r, ok[c]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store_col<W>(a, c, i0, full, v[c]);
      if (a.dst_valid[c] != nullptr) store_valid(a, c, i0, full, ok[c]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int64_t j, int64_t i, bool live) {
  static_cast<T*>(dst)[i] =
      live ? __ldg(static_cast<const T*>(src) + j) : T(0);
}

// Any mix of widths, any column count: one row a thread, a width switch per
// column.
__global__ void __launch_bounds__(kThreads)
gather_rows_any(const GatherArgs a) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < a.n;
       i += stride) {
    const bool live = (a.live == nullptr || a.live[i] != 0) &&
                      a.table_rows > 0;
    int64_t j = 0;
    if (live) {
      j = (int64_t)__ldg(a.idx + i);
      j = j < 0 ? 0 : (j >= a.table_rows ? a.table_rows - 1 : j);
    }
    for (int c = 0; c < a.n_cols; ++c) {
      switch (a.width[c]) {
        case 1: copy_elem<uint8_t>(a.src[c], a.dst[c], j, i, live); break;
        case 2: copy_elem<uint16_t>(a.src[c], a.dst[c], j, i, live); break;
        case 4: copy_elem<uint32_t>(a.src[c], a.dst[c], j, i, live); break;
        default:
          copy_elem<unsigned long long>(a.src[c], a.dst[c], j, i, live);
          break;
      }
      if (a.dst_valid[c] != nullptr) {
        const bool v = live && (a.src_valid[c] == nullptr ||
                                __ldg(a.src_valid[c] + j) != 0);
        a.dst_valid[c][i] = v ? 1 : 0;
      }
    }
  }
}

template <int W>
cudaError_t launch_fast(const GatherArgs& a, unsigned blocks,
                        cudaStream_t st) {
  switch (a.n_cols) {
    case 1: gather_rows_fast<W, 1><<<blocks, kThreads, 0, st>>>(a); break;
    case 2: gather_rows_fast<W, 2><<<blocks, kThreads, 0, st>>>(a); break;
    case 3: gather_rows_fast<W, 3><<<blocks, kThreads, 0, st>>>(a); break;
    default: gather_rows_fast<W, 4><<<blocks, kThreads, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int spark_gather_args_size() { return (int)sizeof(GatherArgs); }

int spark_gather_max_cols() { return kMaxCols; }

int spark_gather_launch(const void* args, void* stream) {
  if (args == nullptr) return (int)cudaErrorInvalidValue;
  const GatherArgs a = *static_cast<const GatherArgs*>(args);
  if (a.n_cols < 1 || a.n_cols > kMaxCols || a.n < 0 || a.table_rows < 0 ||
      (a.idx == nullptr && a.n > 0))
    return (int)cudaErrorInvalidValue;
  bool same_width = true;
  for (int c = 0; c < a.n_cols; ++c) {
    const int w = a.width[c];
    if ((w != 1 && w != 2 && w != 4 && w != 8) || a.dst[c] == nullptr ||
        (a.src[c] == nullptr && a.table_rows > 0))
      return (int)cudaErrorInvalidValue;
    same_width = same_width && w == a.width[0];
  }
  if (a.n == 0) return (int)cudaSuccess;
  int64_t blocks = (a.n + kThreads * kRows - 1) / (kThreads * kRows);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (same_width && a.n_cols <= kFastCols) {
    switch (a.width[0]) {
      case 1: return (int)launch_fast<1>(a, (unsigned)blocks, st);
      case 2: return (int)launch_fast<2>(a, (unsigned)blocks, st);
      case 4: return (int)launch_fast<4>(a, (unsigned)blocks, st);
      default: return (int)launch_fast<8>(a, (unsigned)blocks, st);
    }
  }
  int64_t any_blocks = (a.n + kThreads - 1) / kThreads;
  if (any_blocks > kMaxBlocks) any_blocks = kMaxBlocks;
  gather_rows_any<<<(unsigned)any_blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
