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
// The build columns (2^17 x 4 B each) stay in the 50 MB L2.
//
// Design, simple first: a grid-stride loop, one row a thread, neighbouring
// threads on neighbouring output rows, so the index, live and output
// accesses coalesce; the reads of the sources are random but land in L2 for
// a build-sized table. The column loop runs inside the row loop, so a row's
// index is read once for all columns. Widths switch per column; no
// vectorised stores yet.
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
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int64_t j, int64_t i, bool live) {
  static_cast<T*>(dst)[i] =
      live ? __ldg(static_cast<const T*>(src) + j) : T(0);
}

__global__ void __launch_bounds__(kThreads) gather_rows(const GatherArgs a) {
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
  for (int c = 0; c < a.n_cols; ++c) {
    const int w = a.width[c];
    if ((w != 1 && w != 2 && w != 4 && w != 8) || a.dst[c] == nullptr ||
        (a.src[c] == nullptr && a.table_rows > 0))
      return (int)cudaErrorInvalidValue;
  }
  if (a.n == 0) return (int)cudaSuccess;
  int64_t blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
