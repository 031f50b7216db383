// Fused full-catalog score + train-positive mask + top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel furusato_recommend_tpu/ops/pallas_topk.py::streaming_topk
// (body `_kernel`) and the masked top-k of furusato_recommend_tpu/serve.py
// (Recommender._topk). For each requested row b, with u = users[b]:
//
//     s[j] = <U[u], I[j]>                  float32, fused multiply-adds written here
//     s[j] = 1 / (1 + exp(-s[j]))          if sigmoid
//     s[j] = -1024                         if j is in u's sorted train row
//
// and the k best of s, ordered by value descending, then item id ascending on
// ties (the lax.top_k contract). Masked items are not removed: they still rank
// when fewer than k items score above -1024. The [B, M] score matrix is never
// written to device memory.
//
// What bounds it on this card. One call must read the item table once,
// M * d * 4 bytes (5.1 MB at M = 20000, d = 64; it stays in the 50 MB L2 between
// requests), and issue 2 * B * M * d float32 operations on the CUDA cores
// (no tensor cores in this version). At 3.35 TB/s against 67 TFLOP/s the two
// meet at B = 40: a request of fewer rows is bound by the table's bytes, a
// larger one by FMA issue.
//
// Design. The TPU kernel carries a running top-k in scratch memory across a
// sequential item-tile grid axis. Blocks on Hopper run in parallel and in no
// order, so this is two passes:
//   pass 1  grid (B rows, S item segments). A block stages its user row, and its
//           train row when it fits, in shared memory. Each thread scores one item
//           per round. An item enters a shared candidate buffer only if it beats
//           the block's current k-th best; when the buffer could overflow, the
//           block bitonic-sorts the running top-k with the buffer and keeps the
//           first k. Once the running top-k is warm most items cost one compare,
//           so the work is the dot products. Each block writes its segment's k best.
//   pass 2  one block per row merges the S * k candidates by the same routine.
// Against the bound: S is chosen by the caller so that B * S blocks fill the
// 132 SMs at small B, where the call is bound by reading the table; one block
// per row would leave a 1-user request reading all of it from one SM. At large
// B (S = 1) the call is bound by its FMAs, and this version issues them far
// below the card's rate: every block re-reads the table from L2, one item row
// per thread, with no reuse across rows (PERF.md has the measured gap). Tiling
// several rows per block and tensor cores are the next steps.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCap = 2048;      // running top-k + candidate buffer, entries
constexpr int kMaskCap = 2048;  // train-row ids staged in shared memory
constexpr float kMaskSentinel = -1024.0f;

// Total order of (value, id) keys: larger value first, smaller id on ties.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sort val/idx[0, n) best first; n is a power of two; every thread calls.
__device__ void bitonic_sort(float* val, int* idx, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const float vi = val[i], vj = val[j];
        const int ii = idx[i], ij = idx[j];
        const bool swap = up ? better(vj, ij, vi, ii) : better(vi, ii, vj, ij);
        if (swap) {
          val[i] = vj;
          val[j] = vi;
          idx[i] = ij;
          idx[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

struct Selection {
  float* val;  // [kCap]: running top-k in [0, k), candidates after it
  int* idx;
  int k;
  int* count;  // candidates appended since the last merge
  float* thr_v;  // the running k-th best key
  int* thr_i;

  // Keep the k best of the running top-k and the appended candidates.
  __device__ void merge() const {
    __syncthreads();
    const int total = k + *count;
    int n = 1;
    while (n < total) n <<= 1;
    for (int t = total + threadIdx.x; t < n; t += blockDim.x) {
      val[t] = -CUDART_INF_F;
      idx[t] = INT_MAX;
    }
    __syncthreads();
    bitonic_sort(val, idx, n);
    if (threadIdx.x == 0) {
      *count = 0;
      *thr_v = val[k - 1];
      *thr_i = idx[k - 1];
    }
    __syncthreads();
  }

  // The k best keys of score(j) over j in [begin, end), left sorted in
  // val/idx[0, k). score(j, v, id) writes the key of element j.
  template <class Score>
  __device__ void run(int begin, int end, Score score) const {
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
      val[t] = -CUDART_INF_F;
      idx[t] = INT_MAX;
    }
    if (threadIdx.x == 0) {
      *count = 0;
      *thr_v = -CUDART_INF_F;
      *thr_i = INT_MAX;
    }
    __syncthreads();
    const int room = kCap - k;
    for (int base = begin; base < end; base += blockDim.x) {
      // every thread reads the count before any thread appends this round
      const bool full = *count + static_cast<int>(blockDim.x) > room;
      __syncthreads();
      if (full) merge();
      const int j = base + threadIdx.x;
      if (j < end) {
        float v;
        int id;
        score(j, v, id);
        if (better(v, id, *thr_v, *thr_i)) {
          const int slot = atomicAdd(count, 1);
          val[k + slot] = v;
          idx[k + slot] = id;
        }
      }
      __syncthreads();
    }
    merge();
  }
};

// Is j in the sorted row[0, len)?
__device__ __forceinline__ bool row_contains(const int* row, int len, int j) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < len && row[lo] == j;
}

__global__ void __launch_bounds__(kThreads) score_segments(
    const float* __restrict__ user_emb, const float* __restrict__ item_emb,
    const int* __restrict__ users, int m, int d, int k,
    const int* __restrict__ indptr, const int* __restrict__ indices, int sigmoid,
    int seg_len, int vec4, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];
  float* val = reinterpret_cast<float*>(smem4);
  int* idx = reinterpret_cast<int*>(val + kCap);
  int* mrow = idx + kCap;
  float* urow = reinterpret_cast<float*>(mrow + kMaskCap);  // 16-byte aligned
  __shared__ int count;
  __shared__ float thr_v;
  __shared__ int thr_i;

  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const int u = users[b];
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    urow[t] = user_emb[static_cast<size_t>(u) * d + t];
  }
  int lo = 0, len = 0;
  if (indptr != nullptr) {
    lo = indptr[u];
    len = indptr[u + 1] - lo;
  }
  const bool staged = len <= kMaskCap;
  if (staged) {
    for (int t = threadIdx.x; t < len; t += blockDim.x) mrow[t] = indices[lo + t];
  }
  const int* row = staged ? mrow : indices + lo;
  __syncthreads();

  const Selection sel{val, idx, k, &count, &thr_v, &thr_i};
  const int begin = s * seg_len;
  const int end = min(m, begin + seg_len);
  sel.run(begin, end, [&](int j, float& v, int& id) {
    const float* item = item_emb + static_cast<size_t>(j) * d;
    float acc = 0.0f;
    if (vec4) {
      const float4* a = reinterpret_cast<const float4*>(urow);
      const float4* x = reinterpret_cast<const float4*>(item);
      for (int c = 0; c < (d >> 2); ++c) {
        const float4 p = a[c];
        const float4 q = __ldg(x + c);
        acc = fmaf(p.x, q.x, acc);
        acc = fmaf(p.y, q.y, acc);
        acc = fmaf(p.z, q.z, acc);
        acc = fmaf(p.w, q.w, acc);
      }
    } else {
      for (int c = 0; c < d; ++c) acc = fmaf(urow[c], __ldg(item + c), acc);
    }
    if (sigmoid) acc = 1.0f / (1.0f + expf(-acc));
    if (len > 0 && row_contains(row, len, j)) acc = kMaskSentinel;
    v = acc;
    id = j;
  });

  const size_t out = (static_cast<size_t>(b) * gridDim.y + s) * k;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    cand_v[out + t] = val[t];
    cand_i[out + t] = idx[t];
  }
}

__global__ void __launch_bounds__(kThreads) merge_segments(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i, int n_cand,
    int k, float* __restrict__ out_v, long long* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* val = reinterpret_cast<float*>(smem4);
  int* idx = reinterpret_cast<int*>(val + kCap);
  __shared__ int count;
  __shared__ float thr_v;
  __shared__ int thr_i;

  const size_t base = static_cast<size_t>(blockIdx.x) * n_cand;
  const Selection sel{val, idx, k, &count, &thr_v, &thr_i};
  sel.run(0, n_cand, [&](int j, float& v, int& id) {
    v = cand_v[base + j];
    id = cand_i[base + j];
  });
  const size_t out = static_cast<size_t>(blockIdx.x) * k;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_v[out + t] = val[t];
    out_i[out + t] = idx[t];
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; indptr
// and indices are null when there is no mask. cand_v / cand_i hold
// n_rows * n_seg * k entries. Launches on `stream` and does not synchronise;
// returns cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int masked_topk_launch(const float* user_emb, const float* item_emb,
                                  const int* users, int n_rows, int m, int d, int k,
                                  const int* indptr, const int* indices, int sigmoid,
                                  int n_seg, int seg_len, float* cand_v, int* cand_i,
                                  float* out_v, long long* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(item_emb) % 16 == 0);
  const size_t smem1 = sizeof(float) * (2 * kCap + kMaskCap + d);
  score_segments<<<dim3(n_rows, n_seg), kThreads, smem1, st>>>(
      user_emb, item_emb, users, m, d, k, indptr, indices, sigmoid, seg_len, vec4,
      cand_v, cand_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem2 = sizeof(float) * 2 * kCap;
  merge_segments<<<n_rows, kThreads, smem2, st>>>(cand_v, cand_i, n_seg * k, k, out_v,
                                                  out_i);
  return static_cast<int>(cudaGetLastError());
}
