// Row scatter-add: out[ids[i], :] += rows[i, :] into a zeroed [N, D] float32
// table, the backward of a table gather (ops/scatter.py::table_gather).
//
// Replaces furusato_recommend_tpu/ops/pallas_scatter.py::scatter_add_rows
// (the pl.pallas_call of _make_scatter_kernel). The TPU kernel keeps the whole
// accumulator resident in VMEM (up to 13 MB) and streams the ids through SMEM
// in 2048-id chunks, one grid step after another. A Hopper block has at most
// 227 KB of shared memory and blocks run in no order, so the table stays in
// device memory here and every update is a global atomic add; the entry point
// zeroes the table first (cudaMemsetAsync on the same stream).
//
// What bounds it on the H100: bytes. Each update row is read once
// (4 * R * (D + 1) bytes with its id) and the table is written once
// (4 * N * D bytes, the zeroing); there is one add per element.
// Design: one warp per update row, lanes over the columns, so the loads of a
// row and the adds into its table row are each one coalesced 128-byte access
// per 32 columns. The adds' results are unused, so atomicAdd compiles to a
// fire-and-forget reduction (RED) that the L2 performs; repeated ids (hub
// items occur hundreds of times in a batch) contend there. The order of the
// float32 sums into one row is not fixed, so results vary in the last bits
// from run to run. Ids (int32 or int64) outside [0, N) are clamped into it on
// the device, never written outside the table, and never checked on the host.
// On the card the device work is 1.5x the bytes bound at the bench step's user
// gather and 2.8x at its item gather, where hub items contend; what a call
// costs beyond that is host work (allocation, the ctypes call), so the zeroing
// is a memset issued here rather than a separate framework fill, and the ids
// are read in whatever integer width they come.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 132 * 32;  // enough to fill the card; the loop strides

__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const void* __restrict__ ids, int ids_i64,
                        const float* __restrict__ rows, int64_t r, int d, int n,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t i = warp; i < r; i += n_warps) {
    const long long raw = ids_i64 ? __ldg(static_cast<const long long*>(ids) + i)
                                  : __ldg(static_cast<const int*>(ids) + i);
    const int id = static_cast<int>(min(max(raw, 0LL), static_cast<long long>(n - 1)));
    const float* src = rows + i * d;
    float* dst = out + (int64_t)id * d;
    for (int c = lane; c < d; c += 32) {
      atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

}  // namespace

// ids [r] int64 when ids_i64, else int32; rows [r, d] float32 row-major;
// out [n, d] float32, any contents: it is zeroed here, on `stream`, before
// the adds. Every call launches, r = 0 included (one block that adds
// nothing). Returns the first CUDA error (0 on success).
extern "C" int scatter_add_rows_launch(const void* ids, int ids_i64, const float* rows,
                                       long long r, int d, int n, float* out,
                                       cudaStream_t stream) {
  if (r < 0 || d < 0 || n < 0 || (r > 0 && n == 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * (size_t)d, stream);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (r + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_add_rows_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(ids, ids_i64, rows, r, d,
                                                                     n, out);
  return (int)cudaGetLastError();
}
