// The product tiling that both masked top-k kernels share (streaming_topk.cu
// for k <= 128, streaming_topk_wide.cu for any k): a block owns kBU users x a
// segment of kTI-item tiles, item tiles stream through a kStages-stage
// shared-memory ring filled with cp.async, and each thread accumulates a
// kPU x kPI patch of scores in registers.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBU = 32;          // users per block
constexpr int kTI = 128;         // items per tile
constexpr int kDK = 64;          // columns per chunk of the K-loop
constexpr int kLd = kDK + 4;     // shared row stride of a staged chunk (floats)
constexpr int kSLd = kTI + 8;    // shared row stride of the score tile
// A thread accumulates kPU users x kPI items; a warp covers 16 users x 32
// items (lanes: 4 along users, 8 along items), the 8 warps 2 x 4 of those.
// A warp's float4 loads then touch 8 item rows and 4 user rows, each one
// shared-memory wavefront. That is still 2 bytes loaded per FMA, so shared
// memory and not the FMAs sets the product's pace; a larger patch needs more
// registers and shared memory than two blocks per SM leave.
constexpr int kPU = 4;
constexpr int kPI = 4;
constexpr int kWin = 32;         // train-row ids staged per user
constexpr int kSlots = kBU / kWarps;  // users per warp in the selection
constexpr int kStages = 2;       // ring stages: copies run kStages - 1 steps ahead
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaskSentinel = -1024.0f;

static_assert(kBU * kSLd <= kTI * kLd, "the score tile must fit in a ring stage");
// the thread layout above; the selection reads a tile row as 32 lanes x 4
static_assert(kBU == 32 && kTI == 128 && kThreads == 256, "the thread layout");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy columns [c0, c0 + 4 * g4) of n_rows rows of a row-major [*, d] float
// matrix into dst[r * kLd + c - c0]. Row r is src row row_of(r), or zeros when
// row_of(r) < 0; columns at or past d are zeros.
template <class RowOf>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n_rows, int d,
                                           int c0, int g4, bool vec4, RowOf row_of) {
  const int n = n_rows * g4;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / g4;
    const int g = e - r * g4;
    const int row = row_of(r);
    const int c = c0 + 4 * g;
    float* out = dst + r * kLd + 4 * g;
    if (vec4) {  // d % 4 == 0, so a group is all in or all out
      const float* in = row >= 0 ? src + static_cast<size_t>(row) * d + c : src;
      cp_async16(out, in, row >= 0 ? 16 : 0);
    } else {
      for (int t = 0; t < 4; ++t) {
        const bool ok = row >= 0 && c + t < d;
        const float* in = ok ? src + static_cast<size_t>(row) * d + c + t : src;
        cp_async4(out + t, in, ok ? 4 : 0);
      }
    }
  }
}

// Shared memory words of one ring stage: the item chunk, and the user chunk
// when the user rows are not resident (d > kDK).
__host__ __device__ constexpr int stage_words(bool resident) {
  return (kTI + (resident ? 0 : kBU)) * kLd;
}

}  // namespace
