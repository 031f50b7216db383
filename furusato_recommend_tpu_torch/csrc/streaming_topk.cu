// Fused full-catalog score + train-positive mask + top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel furusato_recommend_tpu/ops/pallas_topk.py::streaming_topk
// (body `_kernel`) and the masked top-k of furusato_recommend_tpu/serve.py
// (Recommender._topk). For each requested row b, with u = users[b] clamped into
// [0, N) (a deviation for ids outside it: JAX wraps negative ids once and takes
// their mask row from another row; ops/streaming_topk.py says how):
//
//     s[j] = <U[u], I[j]>                  float32, fmaf over c = 0..d-1 in order
//     s[j] = 1 / (1 + exp(-s[j]))          if sigmoid
//     s[j] = -1024                         if j is in u's sorted train row
//
// and the k best of s, ordered by value descending, then item id ascending on
// ties (the lax.top_k contract). Masked items are not removed: they still rank
// when fewer than k items score above -1024. The [B, M] score matrix is never
// written to device memory. A launch takes k <= 128 (the selection lists below
// live in registers and shared memory); ops/streaming_topk.py sends a larger k
// to the radix select of streaming_topk_wide.cu, one call for any k.
//
// What bounds it on this card. One call must read the item table once,
// M * d * 4 bytes (5.1 MB at M = 20000, d = 64; it stays in the 50 MB L2 between
// calls), and issue 2 * B * M * d float32 operations on the CUDA cores. At
// 3.35 TB/s against 67 TFLOP/s the two meet at B = 40: a call of fewer rows is
// bound by the table's bytes, a larger one by FMA issue. The first version had
// one user per block, so every block read the whole table from L2 and every
// FMA needed its own load, and its selection sorted 2048-entry buffers
// block-wide. What sets the pace of this one at B >= 512 (PERF.md has the
// measured split) is, in order: the selection's shared-memory round trips,
// the shared-memory loads of the score product (a 4 x 4 register patch loads
// 2 bytes per FMA, and an SM's shared memory delivers 128 bytes a cycle, so
// FMAs run at about half rate), and the L2 copies of the item tiles.
//
// Design. Two passes, because Hopper blocks run in parallel and in no order:
//   pass 1  score_segments, grid (S item segments, ceil(B / 32) user tiles),
//           two blocks per SM. A block owns 32 users x one segment of whole
//           128-item tiles. Item tiles stream through a two-stage
//           shared-memory ring filled with cp.async, so the next tile's copy
//           overlaps this tile's work; each item row is read from L2 once per
//           32 users. The user rows stay resident in shared memory when
//           d <= 64; for larger d both operands go through the ring in chunks
//           of 64 columns (the GEMM K-loop). Each thread accumulates a 4 x 4
//           patch in registers from float4 shared loads laid out so that a
//           warp's load touches 8 item rows and 4 user rows, one wavefront
//           each. The finished tile of scores goes to shared memory (over the
//           ring stage it was computed from), with the sigmoid; each user's
//           cursor into its sorted train row, fed from a 32-id window in shared
//           memory, writes -1024 over the ids in the tile: O(degree) per user
//           and segment. Selection, after WarpSelect (Johnson, Douze and
//           Jegou, 2017): each warp owns 4 users and handles them together. A
//           score is a candidate only if it beats the user's running k-th
//           (value, id) key (one compare, a warp vote when any lane has one);
//           a full candidate buffer is sorted and merged into the user's
//           sorted running list in registers (a bitonic sort of the
//           candidates, then a bitonic merge of the list with them reversed).
//   pass 2  merge_segments, one block of 16 warps per row. Each warp folds a
//           strided subset of the row's S sorted lists into its own list in
//           registers (a list whose best key does not beat the running k-th is
//           skipped; the next list loads while the current one merges), then
//           the warps' lists merge in a tree.
// The segment count is chosen per call (ops/streaming_topk.py::plan_tiles):
// at least two blocks per SM, and the fewest waves times tiles per block, a
// wave being the blocks per SM that masked_topk_blocks_per_sm reports for the
// instantiation (two for k <= 32, one above, where the lists are longer).
// No tensor cores: 1xTF32 or bf16 keep about three decimal digits, which
// breaks the float32 contract and the tie order at near-ties.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

#include "topk_tile.cuh"

namespace {

// Timing switches for tools/topk_ablation.py, 0 in the port's builds: bit 0
// drops pass 1's selection (the mask, the candidate scan and the merges), bit
// 1 its score product. A build with either bit set gives wrong answers.
#ifndef TOPK_ABLATE
#define TOPK_ABLATE 0
#endif

// Total order of (value, id) keys: larger value first, smaller id on ties.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Warp-wide sorting networks over (value, id) keys held in registers: entry
// e = lane * KL + t of a 32 * KL list sits in register t of lane `lane`.
// One compare-exchange stage of a bitonic network: entry e meets e ^ STRIDE and
// the pair is ordered best first when (e & SIZE) == 0, worst first otherwise.
template <int KL, int SIZE, int STRIDE>
__device__ __forceinline__ void bitonic_stage(float (&v)[KL], int (&id)[KL], int lane) {
  if constexpr (STRIDE < KL) {
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      if ((t & STRIDE) == 0) {
        const int p = t | STRIDE;
        const bool up = ((lane * KL + t) & SIZE) == 0;
        const bool sw = up ? better(v[p], id[p], v[t], id[t]) : better(v[t], id[t], v[p], id[p]);
        if (sw) {
          const float fv = v[t];
          const int fi = id[t];
          v[t] = v[p];
          id[t] = id[p];
          v[p] = fv;
          id[p] = fi;
        }
      }
    }
  } else {
    constexpr int ls = STRIDE / KL;
    const bool lower = (lane & ls) == 0;
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      const float ov = __shfl_xor_sync(kFull, v[t], ls);
      const int oi = __shfl_xor_sync(kFull, id[t], ls);
      const bool up = ((lane * KL + t) & SIZE) == 0;
      // the lower entry of the pair keeps the better key when `up`
      if (better(ov, oi, v[t], id[t]) == (lower == up)) {
        v[t] = ov;
        id[t] = oi;
      }
    }
  }
}

template <int KL, int SIZE, int STRIDE>
__device__ __forceinline__ void bitonic_pass(float (&v)[KL], int (&id)[KL], int lane) {
  bitonic_stage<KL, SIZE, STRIDE>(v, id, lane);
  if constexpr (STRIDE > 1) bitonic_pass<KL, SIZE, STRIDE / 2>(v, id, lane);
}

// Sort a warp's 32 * KL entries best first.
template <int KL, int SIZE = 2>
__device__ __forceinline__ void warp_sort(float (&v)[KL], int (&id)[KL], int lane) {
  bitonic_pass<KL, SIZE, SIZE / 2>(v, id, lane);
  if constexpr (SIZE < 32 * KL) warp_sort<KL, SIZE * 2>(v, id, lane);
}

// lv/li <- the best 32 * KL entries of the two sorted lists lv/li and cv/ci,
// sorted best first: keep the better of lv[e] and cv[n - 1 - e] (a bitonic
// sequence that holds the best half of the union), then a bitonic merge.
template <int KL>
__device__ __forceinline__ void warp_merge(float (&lv)[KL], int (&li)[KL], const float (&cv)[KL],
                                           const int (&ci)[KL], int lane) {
#pragma unroll
  for (int t = 0; t < KL; ++t) {
    const float ov = __shfl_sync(kFull, cv[KL - 1 - t], 31 - lane);
    const int oi = __shfl_sync(kFull, ci[KL - 1 - t], 31 - lane);
    if (better(ov, oi, lv[t], li[t])) {
      lv[t] = ov;
      li[t] = oi;
    }
  }
  bitonic_pass<KL, 64 * KL, 16 * KL>(lv, li, lane);
}

// Entry e of a warp list, read by every lane.
template <int KL>
__device__ __forceinline__ void warp_entry(const float (&v)[KL], const int (&id)[KL], int e,
                                           float& ev, int& ei) {
  float sv = v[0];
  int si = id[0];
#pragma unroll
  for (int t = 1; t < KL; ++t) {
    if (e % KL == t) {
      sv = v[t];
      si = id[t];
    }
  }
  ev = __shfl_sync(kFull, sv, e / KL);
  ei = __shfl_sync(kFull, si, e / KL);
}

__host__ __device__ constexpr int cand_cap(int kl) { return 32 * kl < 64 ? 32 * kl : 64; }

// Shared memory of pass 1, in 4-byte words.
__host__ __device__ constexpr size_t score_smem_words(bool resident, int kl) {
  return kStages * stage_words(resident) + (resident ? kBU * kLd : 0) +
         2 * kBU * (32 * kl + cand_cap(kl)) + kBU * kWin + 7 * kBU;
}

// Pass 1. A user's running list holds its best 32 * KL keys so far, sorted, in
// shared memory; its first k are exact. Candidates wait in a buffer of
// cand_cap(KL) entries; a merge sorts them in registers and merges them in.
template <int KL>
__global__ void __launch_bounds__(kThreads, 2) score_segments(
    const float* __restrict__ user_emb, const float* __restrict__ item_emb,
    const void* __restrict__ users, int users_i64, int n_rows, int n_users, int m, int d,
    int k, const int* __restrict__ indptr, const int* __restrict__ indices, int sigmoid,
    int seg_len, int vec4, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int kN = 32 * KL;
  constexpr int kCB = cand_cap(KL);
  extern __shared__ float4 smem4[];
  const bool resident = d <= kDK;
  float* ring = reinterpret_cast<float*>(smem4);
  const int stage_len = stage_words(resident);
  float* ures = ring + kStages * stage_len;  // resident user rows [kBU][kLd]
  float* top_v = ures + (resident ? kBU * kLd : 0);
  int* top_i = reinterpret_cast<int*>(top_v + kBU * kN);
  float* cbuf_v = reinterpret_cast<float*>(top_i + kBU * kN);
  int* cbuf_i = reinterpret_cast<int*>(cbuf_v + kBU * kCB);
  int* s_uid = cbuf_i + kBU * kCB;
  int* s_ncand = s_uid + kBU;
  float* s_thr_v = reinterpret_cast<float*>(s_ncand + kBU);
  int* s_thr_i = reinterpret_cast<int*>(s_thr_v + kBU);
  int* s_cur = s_thr_i + kBU;
  int* s_rend = s_cur + kBU;
  int* s_wbase = s_rend + kBU;  // train-row index of s_win[u][0]
  int* s_win = s_wbase + kBU;   // [kBU][kWin] train-row ids from s_wbase[u] on

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = blockIdx.x;
  const int b0 = blockIdx.y * kBU;
  const int rows = min(kBU, n_rows - b0);
  const int seg_start = seg * seg_len;
  const int seg_end = min(m, seg_start + seg_len);
  const int n_tiles = (seg_end - seg_start + kTI - 1) / kTI;
  const int nk = (d + kDK - 1) / kDK;
  const int n_steps = n_tiles * nk;

  // per-user state: clamped id, empty list, cursor into the train row
  for (int r = tid; r < kBU; r += kThreads) {
    int u = -1;
    if (r < rows) {
      const long long raw = users_i64 ? static_cast<const long long*>(users)[b0 + r]
                                      : static_cast<const int*>(users)[b0 + r];
      u = static_cast<int>(min(max(raw, 0LL), static_cast<long long>(n_users - 1)));
    }
    s_uid[r] = u;
    s_ncand[r] = 0;
    s_thr_v[r] = -CUDART_INF_F;
    s_thr_i[r] = INT_MAX;
    int lo = 0, hi = 0;
    if (indptr != nullptr && u >= 0) {
      lo = indptr[u];
      hi = indptr[u + 1];
      int a = lo, z = hi;  // first entry >= seg_start
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (indices[mid] < seg_start) a = mid + 1; else z = mid;
      }
      lo = a;
    }
    s_cur[r] = lo;
    s_rend[r] = hi;
    s_wbase[r] = lo;
  }
  __syncthreads();
  if (indptr != nullptr) {
    for (int e = tid; e < kBU * kWin; e += kThreads) {
      const int r = e / kWin;
      const int x = s_cur[r] + e % kWin;
      s_win[e] = x < s_rend[r] ? __ldg(indices + x) : INT_MAX;
    }
  }
  for (int t = tid; t < kBU * kN; t += kThreads) {
    top_v[t] = -CUDART_INF_F;
    top_i[t] = INT_MAX;
  }
  __syncthreads();

  const auto user_row = [&](int r) { return s_uid[r]; };
  const auto stage_step = [&](int q) {
    const int tile = q / nk;
    const int kc = q - tile * nk;
    const int c0 = kc * kDK;
    const int g4 = (min(kDK, d - c0) + 3) >> 2;
    const int t0 = seg_start + tile * kTI;
    float* st = ring + (q % kStages) * stage_len;
    stage_rows(st, item_emb, kTI, d, c0, g4, vec4, [&](int r) {
      return t0 + r < seg_end ? t0 + r : -1;
    });
    if (!resident) stage_rows(st + kTI * kLd, user_emb, kBU, d, c0, g4, vec4, user_row);
  };
  // Merge user u's candidate buffer into its list; returns the new k-th key.
  const auto merge_user = [&](int u, int nc, float& thr_v, int& thr_i) {
    __syncwarp();
    float lv[KL], cv[KL];
    int li[KL], ci[KL];
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      const int e = lane * KL + t;
      lv[t] = top_v[u * kN + e];
      li[t] = top_i[u * kN + e];
      const bool has = e < nc;
      cv[t] = has ? cbuf_v[u * kCB + e] : -CUDART_INF_F;
      ci[t] = has ? cbuf_i[u * kCB + e] : INT_MAX;
    }
    warp_sort<KL>(cv, ci, lane);
    warp_merge<KL>(lv, li, cv, ci, lane);
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      top_v[u * kN + lane * KL + t] = lv[t];
      top_i[u * kN + lane * KL + t] = li[t];
    }
    warp_entry<KL>(lv, li, k - 1, thr_v, thr_i);
    __syncwarp();
  };

  if (resident) stage_rows(ures, user_emb, kBU, d, 0, (d + 3) >> 2, vec4, user_row);
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {  // one commit group per step, empty past the end
    if (q < n_steps) stage_step(q);
    cp_async_commit();
  }

  // this thread's users u0 + 4 * r and items i0 + 8 * p of the tile
  const int u0 = (warp >> 2) * 16 + (lane >> 3);
  const int i0 = (warp & 3) * 32 + (lane & 7);
  const bool active = !(TOPK_ABLATE & 2) && u0 < rows;
  float acc[kPU][kPI];

  for (int q = 0; q < n_steps; ++q) {
    if (q + kStages - 1 < n_steps) stage_step(q + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // step q's group has landed
    __syncthreads();

    const int tile = q / nk;
    const int kc = q - tile * nk;
    float* st = ring + (q % kStages) * stage_len;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < kPU; ++r)
#pragma unroll
        for (int p = 0; p < kPI; ++p) acc[r][p] = 0.0f;
    }
    if (active) {
      const float* ib = st;
      const float* ub = resident ? ures : st + kTI * kLd;
      const int g4 = (min(kDK, d - kc * kDK) + 3) >> 2;
#pragma unroll 2
      for (int g = 0; g < g4; ++g) {
        float4 a[kPU], x[kPI];
#pragma unroll
        for (int r = 0; r < kPU; ++r)
          a[r] = *reinterpret_cast<const float4*>(ub + (u0 + 4 * r) * kLd + 4 * g);
#pragma unroll
        for (int p = 0; p < kPI; ++p)
          x[p] = *reinterpret_cast<const float4*>(ib + (i0 + 8 * p) * kLd + 4 * g);
#pragma unroll
        for (int r = 0; r < kPU; ++r)
#pragma unroll
          for (int p = 0; p < kPI; ++p) {
            acc[r][p] = fmaf(a[r].x, x[p].x, acc[r][p]);
            acc[r][p] = fmaf(a[r].y, x[p].y, acc[r][p]);
            acc[r][p] = fmaf(a[r].z, x[p].z, acc[r][p]);
            acc[r][p] = fmaf(a[r].w, x[p].w, acc[r][p]);
          }
      }
    }

    if (kc == nk - 1) {
      // the finished tile: scores into shared memory over this stage
      __syncthreads();
      float* S = st;
      if (active) {
#pragma unroll
        for (int r = 0; r < kPU; ++r)
#pragma unroll
          for (int p = 0; p < kPI; ++p) {
            float v = acc[r][p];
            if (sigmoid) v = 1.0f / (1.0f + expf(-v));
            S[(u0 + 4 * r) * kSLd + i0 + 8 * p] = v;
          }
      }
      __syncthreads();

      // Selection. Warp w owns users w + kWarps * x (x < kSlots); each step
      // below runs for all of them before the next, so their shared-memory
      // round trips overlap instead of queueing one user behind another.
      const int t0 = seg_start + tile * kTI;
      const int t_end = min(t0 + kTI, seg_end);
      if (!(TOPK_ABLATE & 1) && indptr != nullptr) {  // -1024 over the row's ids in [t0, t_end)
        int cur[kSlots], wb[kSlots], hi[kSlots];
        bool more[kSlots];
#pragma unroll
        for (int x = 0; x < kSlots; ++x) {
          const int u = warp + kWarps * x;
          const bool ok = u < rows;
          cur[x] = ok ? s_cur[u] : 0;
          wb[x] = ok ? s_wbase[u] : 0;
          hi[x] = ok ? s_rend[u] : 0;
        }
#pragma unroll
        for (int x = 0; x < kSlots; ++x) {  // one round over each window
          const int u = warp + kWarps * x;
          const int e = cur[x] + lane;
          const int j = e < min(hi[x], wb[x] + kWin) ? s_win[u * kWin + e - wb[x]] : INT_MAX;
          const bool in = j < t_end;
          if (in) S[u * kSLd + j - t0] = kMaskSentinel;
          cur[x] += __popc(__ballot_sync(kFull, in));
          more[x] = cur[x] >= wb[x] + kWin && cur[x] < hi[x];
        }
#pragma unroll
        for (int x = 0; x < kSlots; ++x) {
          const int u = warp + kWarps * x;
          while (more[x]) {  // a window used up in range: refill at the cursor
            __syncwarp();
            s_win[u * kWin + lane] =
                cur[x] + lane < hi[x] ? __ldg(indices + cur[x] + lane) : INT_MAX;
            wb[x] = cur[x];
            __syncwarp();
            const int e = cur[x] + lane;
            const int j = e < min(hi[x], wb[x] + kWin) ? s_win[u * kWin + e - wb[x]] : INT_MAX;
            const bool in = j < t_end;
            if (in) S[u * kSLd + j - t0] = kMaskSentinel;
            cur[x] += __popc(__ballot_sync(kFull, in));
            more[x] = cur[x] >= wb[x] + kWin && cur[x] < hi[x];
          }
          if (lane == 0 && u < rows) {
            s_cur[u] = cur[x];
            s_wbase[u] = wb[x];
          }
        }
        __syncwarp();
      }
      float thr_v[kSlots];
      int thr_i[kSlots], nc[kSlots];
#pragma unroll
      for (int x = 0; x < kSlots; ++x) {
        const int u = min(warp + kWarps * x, kBU - 1);
        thr_v[x] = s_thr_v[u];
        thr_i[x] = s_thr_i[u];
        nc[x] = s_ncand[u];
      }
      // (value, id) of item j beats the running k-th key
      const auto takes = [&](int x, float v, int j) { return better(v, j, thr_v[x], thr_i[x]); };
      if (!(TOPK_ABLATE & 1)) {  // each lane tests 4 scores of each user against its k-th key
        float sv[kSlots][4];
        bool any[kSlots];
#pragma unroll
        for (int x = 0; x < kSlots; ++x) {
          const int u = min(warp + kWarps * x, kBU - 1);
          const float4 f = *reinterpret_cast<const float4*>(S + u * kSLd + 4 * lane);
          sv[x][0] = f.x;
          sv[x][1] = f.y;
          sv[x][2] = f.z;
          sv[x][3] = f.w;
          bool a = false;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = t0 + 4 * lane + t;
            a |= j < t_end && takes(x, sv[x][t], j);
          }
          any[x] = __any_sync(kFull, a) && warp + kWarps * x < rows;
        }
#pragma unroll
        for (int x = 0; x < kSlots; ++x) {
          if (!any[x]) continue;
          const int u = warp + kWarps * x;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = t0 + 4 * lane + t;
            const bool take = j < t_end && takes(x, sv[x][t], j);
            const unsigned bal = __ballot_sync(kFull, take);
            if (bal == 0) continue;
            if (nc[x] + __popc(bal) > kCB) {  // no room for this round: merge first
              merge_user(u, nc[x], thr_v[x], thr_i[x]);
              nc[x] = 0;
            }
            if (take) {
              const int pos = nc[x] + __popc(bal & ((1u << lane) - 1u));
              cbuf_v[u * kCB + pos] = sv[x][t];
              cbuf_i[u * kCB + pos] = j;
            }
            nc[x] += __popc(bal);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int x = 0; x < kSlots; ++x) {
        const int u = warp + kWarps * x;
        if (lane == 0 && u < rows) {
          s_ncand[u] = nc[x];
          s_thr_v[u] = thr_v[x];
          s_thr_i[u] = thr_i[x];
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next step
  }
  cp_async_wait<0>();

  // the segment's k best of each valid row
  for (int u = warp; u < rows; u += kWarps) {
    float thr_v;
    int thr_i;
    if (s_ncand[u] > 0) merge_user(u, s_ncand[u], thr_v, thr_i);
    const size_t out = (static_cast<size_t>(b0 + u) * gridDim.x + seg) * k;
    for (int e = lane; e < k; e += 32) {
      cand_v[out + e] = top_v[u * kN + e];
      cand_i[out + e] = top_i[u * kN + e];
    }
  }
}

// Pass 2: one block of kMergeWarps warps per row folds the row's n_seg sorted
// k-lists.
constexpr int kMergeWarps = 16;

template <int KL>
__global__ void __launch_bounds__(32 * kMergeWarps) merge_segments(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i, int n_seg, int k,
    float* __restrict__ out_v, long long* __restrict__ out_i) {
  constexpr int kN = 32 * KL;
  __shared__ float part_v[kMergeWarps * kN];
  __shared__ int part_i[kMergeWarps * kN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n_seg * k;

  float lv[KL], nv[KL], cv[KL];
  int li[KL], ni[KL], ci[KL];
  const auto load = [&](int s, float (&v)[KL], int (&id)[KL]) {
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      const int e = lane * KL + t;
      const bool has = e < k;
      v[t] = has ? cand_v[base + static_cast<size_t>(s) * k + e] : -CUDART_INF_F;
      id[t] = has ? cand_i[base + static_cast<size_t>(s) * k + e] : INT_MAX;
    }
  };
#pragma unroll
  for (int t = 0; t < KL; ++t) {
    lv[t] = -CUDART_INF_F;
    li[t] = INT_MAX;
  }
  int s = warp;
  if (s < n_seg) load(s, cv, ci);
  for (; s < n_seg; s += kMergeWarps) {
    if (s + kMergeWarps < n_seg) load(s + kMergeWarps, nv, ni);  // in flight while this one merges
    float tv, hv;
    int ti, hi;
    warp_entry<KL>(lv, li, k - 1, tv, ti);
    warp_entry<KL>(cv, ci, 0, hv, hi);
    if (better(hv, hi, tv, ti)) warp_merge<KL>(lv, li, cv, ci, lane);
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      cv[t] = nv[t];
      ci[t] = ni[t];
    }
  }
  // tree over the warps' lists
  for (int step = 1; step < kMergeWarps; step <<= 1) {
    if (warp % step == 0) {
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        part_v[warp * kN + lane * KL + t] = lv[t];
        part_i[warp * kN + lane * KL + t] = li[t];
      }
    }
    __syncthreads();
    if (warp % (2 * step) == 0) {
#pragma unroll
      for (int t = 0; t < KL; ++t) {
        cv[t] = part_v[(warp + step) * kN + lane * KL + t];
        ci[t] = part_i[(warp + step) * kN + lane * KL + t];
      }
      warp_merge<KL>(lv, li, cv, ci, lane);
    }
    __syncthreads();
  }
  if (warp == 0) {
    const size_t out = static_cast<size_t>(blockIdx.x) * k;
#pragma unroll
    for (int t = 0; t < KL; ++t) {
      const int e = lane * KL + t;
      if (e < k) {
        out_v[out + e] = lv[t];
        out_i[out + e] = li[t];
      }
    }
  }
}

// Pass 1's dynamic shared memory at this d, opted in on the current device:
// above 48 KB a kernel needs the opt-in, set once per device for the largest
// size asked. Returns a CUDA error code.
template <int KL>
int prepare_pass1(int d, size_t* smem) {
  const size_t smem1 = 4 * score_smem_words(d <= kDK, KL);
  *smem = smem1;
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || smem1 > opted[dev]) {
    err = cudaFuncSetAttribute(score_segments<KL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem1));
    if (err != cudaSuccess) return static_cast<int>(err);
    // all of L1 as shared memory, so that two blocks fit on an SM where they can
    err = cudaFuncSetAttribute(score_segments<KL>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted[dev] = smem1;
  }
  return 0;
}

template <int KL>
int blocks_per_sm(int d, int* out) {
  size_t smem1 = 0;
  const int err = prepare_pass1<KL>(d, &smem1);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, score_segments<KL>, kThreads, smem1));
}

template <int KL>
int launch_passes(const float* user_emb, const float* item_emb, const void* users,
                  int users_i64, int n_rows, int n_users, int m, int d, int k,
                  const int* indptr, const int* indices, int sigmoid, int n_seg, int seg_len,
                  int vec4, float* cand_v, int* cand_i, float* out_v, long long* out_i,
                  cudaStream_t st) {
  size_t smem1 = 0;
  cudaError_t err = static_cast<cudaError_t>(prepare_pass1<KL>(d, &smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1(n_seg, (n_rows + kBU - 1) / kBU);
  score_segments<KL><<<grid1, kThreads, smem1, st>>>(user_emb, item_emb, users, users_i64, n_rows,
                                                     n_users, m, d, k, indptr, indices, sigmoid,
                                                     seg_len, vec4, cand_v, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_segments<KL><<<n_rows, 32 * kMergeWarps, 0, st>>>(cand_v, cand_i, n_seg, k, out_v,
                                                          out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; users
// are int64 when users_i64, else int32; indptr and indices are null when there
// is no mask. cand holds 2 * n_rows * n_seg * k 4-byte words (values, then
// ids). Launches both passes on `stream` and does not synchronise; returns the
// first CUDA error (0 = cudaSuccess).
extern "C" int masked_topk_launch(const float* user_emb, const float* item_emb,
                                  const void* users, int users_i64, int n_rows, int n_users,
                                  int m, int d, int k, const int* indptr, const int* indices,
                                  int sigmoid, int n_seg, int seg_len, void* cand, float* out_v,
                                  long long* out_i, void* stream) {
  if (n_rows <= 0 || n_users <= 0 || m <= 0 || d <= 0 || k < 1 || k > 128 || n_seg <= 0 ||
      seg_len <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(item_emb) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(user_emb) % 16 == 0);
  float* cand_v = static_cast<float*>(cand);
  int* cand_i = reinterpret_cast<int*>(cand_v + static_cast<size_t>(n_rows) * n_seg * k);
  if (k <= 32)
    return launch_passes<1>(user_emb, item_emb, users, users_i64, n_rows, n_users, m, d, k,
                            indptr, indices, sigmoid, n_seg, seg_len, vec4, cand_v, cand_i,
                            out_v, out_i, st);
  if (k <= 64)
    return launch_passes<2>(user_emb, item_emb, users, users_i64, n_rows, n_users, m, d, k,
                            indptr, indices, sigmoid, n_seg, seg_len, vec4, cand_v, cand_i,
                            out_v, out_i, st);
  return launch_passes<4>(user_emb, item_emb, users, users_i64, n_rows, n_users, m, d, k,
                          indptr, indices, sigmoid, n_seg, seg_len, vec4, cand_v, cand_i,
                          out_v, out_i, st);
}

// How many pass-1 blocks of the instantiation for k, at this d, one SM of the
// current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *out. Returns a CUDA error code.
extern "C" int masked_topk_blocks_per_sm(int k, int d, int* out) {
  if (k < 1 || k > 128 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 32) return blocks_per_sm<1>(d, out);
  if (k <= 64) return blocks_per_sm<2>(d, out);
  return blocks_per_sm<4>(d, out);
}
