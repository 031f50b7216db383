// Fused full-catalog score + train-positive mask + top-k for any k, for Hopper
// (sm_90a): one radix select over an order-preserving key, after AIR Top-K
// (Zhang et al., "Parallel Top-K Algorithms on GPU", SC'23).
//
// Replaces, for k > 128, the TPU kernel furusato_recommend_tpu/ops/pallas_topk.py::
// streaming_topk (body `_kernel`, whose emit loop answers any k in one call) and
// the masked top-k of furusato_recommend_tpu/serve.py (Recommender._topk,
// lax.top_k). It computes what streaming_topk.cu computes, for any 1 <= k <= M:
//
//     s[j] = <U[u], I[j]>                  float32, fmaf over c = 0..d-1 in order
//     s[j] = 1 / (1 + exp(-s[j]))          if sigmoid
//     s[j] = -1024                         if j is in u's sorted train row
//
// with u = users[b] clamped into [0, N), and the k best of s by value
// descending, then item id ascending. The [B, M] score matrix is never written
// to device memory, and nothing is read back by the host: every buffer is
// sized from B, k, M and d.
//
// The key. Each score becomes a 64-bit key whose unsigned order is the order
// of the result: the high word is the float's bits made order-preserving (sign
// bit set for non-negative values, all bits flipped for negative ones; -0.0
// keyed as +0.0, so that the two tie by id as the float compare ties them),
// the low word M - 1 - j, so that a smaller id is a larger key. Keys are
// unique, so the k best keys are exactly the keys >= the k-th best.
//
// What bounds it on this card. As for streaming_topk.cu: the item table's
// bytes at small B, the 2 * B * M * d FMAs on the CUDA cores above B = 40. The
// select needs the product once per digit it reads, so the design reads as few
// digits as it can and lets a pass that has nothing to do for a block return
// at once.
//
// Design. Per-row select state lives in a zeroed scratch buffer (prefix, keys
// known to be above it, whether and when the row is done, a write cursor, a
// 256-bin histogram), and the wrapper launches:
//   wide_radix_pass, levels L = 0 .. n_levels (n_levels = 4 value digits + the id
//           digits, ceil(bits(M - 1) / 8)), grid (S item segments, ceil(B / 32)
//           user tiles), two blocks per SM. A block recomputes its 32 users x
//           segment of scores with pass 1's tiling (topk_tile.cuh: the
//           cp.async ring, the 4 x 4 register patch, the train-row cursor; its
//           first item tile copies while the rows' state and train rows load,
//           and a warp finds a row's first train id in the segment from one
//           32-entry load) and then, per row:
//           - not done: counts the 8-bit digit at level L of every key that
//             matches the row's prefix into a shared histogram (16-bit counts,
//             two to a word, a segment being at most 65535 items; lanes with
//             the same digit add once, __match_any_sync), flushed to the row's
//             global histogram with integer atomics (exact whatever the order
//             of the blocks). The last block of the user tile to finish (a
//             ticket counter, after __threadfence) reads the histograms, picks
//             the bin that holds the k-th key, extends the prefix and zeroes the
//             histogram. A row is done as soon as the keys >= its prefix number
//             at most `cap` (a power of two >= k + 256): at the latest after the
//             last id digit, where exactly k keys are >= the prefix. While the
//             keys >= its prefix fit the candidate row (`stride`, up to 8192),
//             the row also writes them as it counts (through an atomic cursor),
//             so that a row done at this level needs no pass to collect them;
//           - done at level L - 1 without them written: writes every key >= its
//             prefix (k to cap of them);
//           a block whose rows have nothing to do at this level returns before
//           the product. Gaussian scores over 10,000 items are done after two
//           levels (the first digit holds sign and exponent; the second splits
//           the k-th key's octave 256 ways, and its keys were written as it
//           counted), so a call scores the catalog twice.
//   wide_sort_rows, a block a row: the row's candidates at or above its prefix (in
//           any order: the blocks' writes race) ordered, descending: up to 1024
//           by counting the keys above each, up to 8192 by a bitonic sort in
//           shared memory, above that in device memory with every stride below
//           4096 taken in shared-memory chunks; writes the first k as (value,
//           id). The keys are unique, so the result is the same in every run.
// No tensor cores: 1xTF32 or bf16 keep about three decimal digits, which
// breaks the float32 contract and the tie order at near-ties.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "topk_tile.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kBins = 256;             // an 8-bit digit
constexpr int kHalfBins = kBins / 2;   // 16-bit counts, two to a word
constexpr int kValueLevels = 4;        // digits of a key's value word
constexpr int kMaxSegment = 65535;     // items a block counts: its 16-bit counts do not wrap
constexpr int kSortShared = 8192;      // keys a row's sort holds in shared memory
constexpr int kRankMax = 1024;         // candidates a row orders by counting, not sorting
constexpr int kChunk = 4096;           // keys a device-memory sort takes into shared memory at once
constexpr int kSortThreads = 1024;

// The select state of every row, in one zeroed scratch buffer.
struct Select {
  u64* prefix;        // [B] the row's key prefix (bits above the current digit)
  unsigned* hist;     // [B][kBins] the current digit's counts
  int* taken;         // [B] keys known to be above the prefix
  int* done;          // [B] 0; the level whose digit finished the row, plus one; or
                      // n_levels + 2 when its keys were written at that level
  int* filter;        // [B] 1: the row writes its keys >= the prefix while it counts
  int* cursor;        // [B] candidates written
  unsigned* ticket;   // [user tiles] blocks of the tile that have flushed
  u64* cand;          // [B][stride] candidate keys
};

__host__ __device__ constexpr size_t wide_smem_words(bool resident) {
  return 2 * kBU + kStages * stage_words(resident) + (resident ? kBU * kLd : 0) +
         kBU * kHalfBins + 5 * kBU + kBU * kWin + 4;
}

// Order-preserving 32-bit key of a float; -0.0 keys as +0.0.
__device__ __forceinline__ unsigned value_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__global__ void __launch_bounds__(kThreads, 2) wide_radix_pass(
    const float* __restrict__ user_emb, const float* __restrict__ item_emb,
    const void* __restrict__ users, int users_i64, int n_rows, int n_users, int m, int d,
    int k, const int* __restrict__ indptr, const int* __restrict__ indices, int sigmoid,
    int seg_len, int vec4, int level, int n_levels, int shift, int cap, int stride, Select sel) {
  extern __shared__ float4 smem4[];
  const bool resident = d <= kDK;
  u64* s_prefix = reinterpret_cast<u64*>(smem4);
  float* ring = reinterpret_cast<float*>(s_prefix + kBU);
  const int stage_len = stage_words(resident);
  float* ures = ring + kStages * stage_len;  // resident user rows [kBU][kLd]
  unsigned* hist_s = reinterpret_cast<unsigned*>(ures + (resident ? kBU * kLd : 0));
  int* s_mode = reinterpret_cast<int*>(hist_s + kBU * kHalfBins);
  int* s_uid = s_mode + kBU;
  int* s_cur = s_uid + kBU;
  int* s_rend = s_cur + kBU;
  int* s_wbase = s_rend + kBU;  // train-row index of s_win[u][0]
  int* s_win = s_wbase + kBU;   // [kBU][kWin] train-row ids from s_wbase[u] on
  int* s_last = s_win + kBU * kWin;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.y * kBU;
  const int rows = min(kBU, n_rows - b0);
  const int seg_start = blockIdx.x * seg_len;
  const int seg_end = min(m, seg_start + seg_len);
  const int n_tiles = (seg_end - seg_start + kTI - 1) / kTI;
  const int nk = (d + kDK - 1) / kDK;
  const int n_steps = n_tiles * nk;
  const u64 hi_mask = shift + 8 >= 64 ? 0ull : ~0ull << (shift + 8);

  // Each row's part at this level (warp w sets up rows w + kWarps * x): bit 0
  // count its digit, bit 1 write its keys >= its prefix; 0 nothing (done, or
  // past the last row). The loads of the four rows go out together, so the
  // setup waits for about three round trips to memory.
  int mode[kSlots], uid[kSlots];
  u64 prefix[kSlots];
  bool any = false;
#pragma unroll
  for (int x = 0; x < kSlots; ++x) {
    const int r = warp + kWarps * x;
    mode[x] = 0;
    uid[x] = -1;
    prefix[x] = 0ull;
    if (r < rows) {
      const int done = sel.done[b0 + r];
      const int filter = sel.filter[b0 + r];
      prefix[x] = sel.prefix[b0 + r];
      const long long raw = users_i64 ? static_cast<const long long*>(users)[b0 + r]
                                      : static_cast<const int*>(users)[b0 + r];
      if (done == 0) {  // at level 0 every key is under the prefix: written if M fit
        mode[x] = level < n_levels ? 1 | (filter || (level == 0 && m <= stride) ? 2 : 0) : 0;
      } else {
        mode[x] = done == level ? 2 : 0;
      }
      if (mode[x] != 0) uid[x] = static_cast<int>(min(max(raw, 0LL), static_cast<long long>(n_users - 1)));
    }
    any |= mode[x] != 0;
  }
  int counting = 0;
#pragma unroll
  for (int x = 0; x < kSlots; ++x) counting |= mode[x] & 1;
  counting = __syncthreads_or(lane == 0 && counting);
  if (!counting && !__syncthreads_or(lane == 0 && any)) return;  // the whole block: nothing to do

  const auto stage_items = [&](int q) {
    const int tile = q / nk;
    const int c0 = (q - tile * nk) * kDK;
    const int g4 = (min(kDK, d - c0) + 3) >> 2;
    const int t0 = seg_start + tile * kTI;
    stage_rows(ring + (q % kStages) * stage_len, item_emb, kTI, d, c0, g4, vec4, [&](int r) {
      return t0 + r < seg_end ? t0 + r : -1;
    });
  };
  const auto user_row = [&](int r) { return s_uid[r]; };
  const auto stage_users = [&](int q) {  // d > kDK: the users' chunk of step q
    const int c0 = (q % nk) * kDK;
    stage_rows(ring + (q % kStages) * stage_len + kTI * kLd, user_emb, kBU, d, c0,
               (min(kDK, d - c0) + 3) >> 2, vec4, user_row);
  };
  // step 0's item rows copy while the rows are set up; its users' rows join
  // the same commit group below
  stage_items(0);

  int lo[kSlots], hi[kSlots];
#pragma unroll
  for (int x = 0; x < kSlots; ++x) {
    lo[x] = hi[x] = 0;
    if (uid[x] >= 0 && indptr != nullptr) {
      lo[x] = indptr[uid[x]];
      hi[x] = indptr[uid[x] + 1];
    }
  }
  int chunk[kSlots];
#pragma unroll
  for (int x = 0; x < kSlots; ++x) chunk[x] = lo[x] + lane < hi[x] ? __ldg(indices + lo[x] + lane) : INT_MAX;
#pragma unroll
  for (int x = 0; x < kSlots; ++x) {
    const int r = warp + kWarps * x;
    if (r >= kBU) continue;
    // the row's first train id >= seg_start: in its first 32 entries, else by
    // a binary search over the rest
    const unsigned ge = __ballot_sync(kFull, chunk[x] >= seg_start);
    int pos;
    if (ge != 0u || hi[x] - lo[x] <= 32) {
      pos = lo[x] + (ge != 0u ? __ffs(ge) - 1 : hi[x] - lo[x]);
    } else {
      int a = lo[x] + 32, z = hi[x];
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (__ldg(indices + mid) < seg_start) a = mid + 1; else z = mid;
      }
      pos = a;
    }
    // the window of kWin ids from pos on: from the loaded entries where it can
    const int src = pos - lo[x] + lane;
    const int got = __shfl_sync(kFull, chunk[x], src & 31);
    s_win[r * kWin + lane] = pos + lane >= hi[x] ? INT_MAX : src < 32 ? got : __ldg(indices + pos + lane);
    if (lane == 0) {
      s_mode[r] = mode[x];
      s_uid[r] = uid[x];
      s_cur[r] = pos;
      s_wbase[r] = pos;
      s_rend[r] = hi[x];
      s_prefix[r] = prefix[x];
    }
  }
  for (int e = tid; e < kBU * kHalfBins; e += kThreads) hist_s[e] = 0u;
  __syncthreads();

  const auto stage_step = [&](int q) {
    stage_items(q);
    if (!resident) stage_users(q);
  };
  if (resident) {
    stage_rows(ures, user_emb, kBU, d, 0, (d + 3) >> 2, vec4, user_row);
  } else {
    stage_users(0);
  }
  cp_async_commit();  // step 0's group (kStages = 2: the only step ahead)

  // this thread's users u0 + 4 * r and items i0 + 8 * p of the tile
  const int u0 = (warp >> 2) * 16 + (lane >> 3);
  const int i0 = (warp & 3) * 32 + (lane & 7);
  const bool active = u0 < rows;
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

      // Warp w owns users w + kWarps * x (x < kSlots), as pass 1's selection.
      const int t0 = seg_start + tile * kTI;
      const int t_end = min(t0 + kTI, seg_end);
      if (indptr != nullptr) {  // -1024 over the row's ids in [t0, t_end)
#pragma unroll
        for (int x = 0; x < kSlots; ++x) {
          const int u = warp + kWarps * x;
          if (u >= rows || s_mode[u] == 0) continue;  // warp-uniform
          int cur = s_cur[u], wb = s_wbase[u];
          const int hi = s_rend[u];
          bool more = true;
          bool first = true;
          while (more) {
            if (!first) {  // a window used up in range: refill at the cursor
              __syncwarp();
              s_win[u * kWin + lane] = cur + lane < hi ? __ldg(indices + cur + lane) : INT_MAX;
              wb = cur;
              __syncwarp();
            }
            first = false;
            const int e = cur + lane;
            const int j = e < min(hi, wb + kWin) ? s_win[u * kWin + e - wb] : INT_MAX;
            const bool in = j < t_end;
            if (in) S[u * kSLd + j - t0] = kMaskSentinel;
            cur += __popc(__ballot_sync(kFull, in));
            more = cur >= wb + kWin && cur < hi;
          }
          if (lane == 0) {
            s_cur[u] = cur;
            s_wbase[u] = wb;
          }
        }
        __syncwarp();
      }
      // Each lane keys 4 scores of each of the warp's users. The writes of a
      // tile take one cursor add per user, all four issued before any returns.
      u64 key[kSlots][4];
      unsigned take_bal[kSlots][4];
      int base[kSlots];
#pragma unroll
      for (int x = 0; x < kSlots; ++x) {
        const int u = warp + kWarps * x;
        const int md = u < rows ? s_mode[u] : 0;  // warp-uniform
        const u64 prefix = s_prefix[min(u, kBU - 1)];
        const float4 f = *reinterpret_cast<const float4*>(S + min(u, kBU - 1) * kSLd + 4 * lane);
        const float sv[4] = {f.x, f.y, f.z, f.w};
        int n_take = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = t0 + 4 * lane + t;
          key[x][t] = (static_cast<u64>(value_key(sv[t])) << 32) | static_cast<unsigned>(m - 1 - j);
          take_bal[x][t] = __ballot_sync(kFull, (md & 2) && j < t_end && key[x][t] >= prefix);
          n_take += __popc(take_bal[x][t]);
          if (md & 1) {  // the digit of a key under the prefix
            const bool in = j < t_end && (key[x][t] & hi_mask) == prefix;
            const unsigned bal = __ballot_sync(kFull, in);
            if (in) {
              const unsigned digit = static_cast<unsigned>(key[x][t] >> shift) & (kBins - 1);
              const unsigned peers = __match_any_sync(bal, digit);
              if (lane == __ffs(peers) - 1)
                atomicAdd(hist_s + u * kHalfBins + (digit >> 1),
                          static_cast<unsigned>(__popc(peers)) << ((digit & 1) * 16));
            }
          }
        }
        base[x] = 0;
        if (lane == 0 && n_take > 0) base[x] = atomicAdd(sel.cursor + b0 + u, n_take);
      }
#pragma unroll
      for (int x = 0; x < kSlots; ++x) {  // keys at or above the prefix, to the row's candidates
        const int u = warp + kWarps * x;
        int pos = __shfl_sync(kFull, base[x], 0);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const unsigned bal = take_bal[x][t];
          const int at = pos + __popc(bal & ((1u << lane) - 1u));
          if (((bal >> lane) & 1u) && at < stride) sel.cand[static_cast<size_t>(b0 + u) * stride + at] = key[x][t];
          pos += __popc(bal);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next step
  }
  cp_async_wait<0>();
  if (!counting) return;

  // this block's counts into the rows' histograms, then its ticket
  for (int e = tid; e < kBU * kHalfBins; e += kThreads) {
    const unsigned w = hist_s[e];
    if (w == 0u) continue;
    unsigned* g = sel.hist + static_cast<size_t>(b0 + e / kHalfBins) * kBins + 2 * (e % kHalfBins);
    if (w & 0xffffu) atomicAdd(g, w & 0xffffu);
    if (w >> 16) atomicAdd(g + 1, w >> 16);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(sel.ticket + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  // The last block of the user tile: each counting row's digit. Lane l holds
  // bins 255 - 8 l - t (t < 8), the highest first.
  for (int u = warp; u < rows; u += kWarps) {
    const int md = s_mode[u];
    if (!(md & 1)) continue;
    unsigned* g = sel.hist + static_cast<size_t>(b0 + u) * kBins;
    unsigned c[8];
    unsigned sum = 0;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      c[t] = __ldcg(g + kBins - 1 - 8 * lane - t);
      sum += c[t];
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) g[kBins - 1 - 8 * lane - t] = 0u;  // for the next level
    unsigned inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    const int taken = sel.taken[b0 + u];
    const unsigned need = static_cast<unsigned>(k - taken);  // >= 1
    const unsigned ex = inc - sum;
    const unsigned owner = __ballot_sync(kFull, ex < need && need <= inc);
    if (owner != 0u && lane == __ffs(owner) - 1) {
      unsigned above = ex, in_bin = 0;
      int bin = 0;
      bool found = false;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (!found) {
          if (above + c[t] >= need) {
            found = true;
            bin = kBins - 1 - 8 * lane - t;
            in_bin = c[t];
          } else {
            above += c[t];
          }
        }
      }
      const u64 prefix = s_prefix[u] | (static_cast<u64>(bin) << shift);
      sel.prefix[b0 + u] = prefix;
      // the keys >= prefix: those above it at earlier digits, above its bin at
      // this one, and in its bin
      const long long ge = static_cast<long long>(taken) + above + in_bin;
      if (ge <= cap || level == n_levels - 1) {
        // a row that wrote its keys >= the old prefix at this level holds
        // those >= the new one: it needs no pass of its own to collect them
        sel.done[b0 + u] = (md & 2) ? n_levels + 2 : level + 1;
      } else {
        sel.taken[b0 + u] = taken + static_cast<int>(above);
        // the next level writes the keys >= the new prefix, if they fit
        sel.filter[b0 + u] = ge <= stride;
        if (md & 2) sel.cursor[b0 + u] = 0;
      }
    }
  }
  if (tid == 0) sel.ticket[blockIdx.y] = 0u;
}

// One compare-exchange stage of a bitonic sort over keys a[0, len), which hold
// the row's keys from index `base` on: pairs (i, i + stride) with bit `stride`
// of i clear, ordered descending where bit `size` of base + i is clear and
// ascending elsewhere.
__device__ __forceinline__ void bitonic_stage(u64* a, int len, int base, int size, int stride) {
  for (int q = threadIdx.x; q < len / 2; q += blockDim.x) {
    const int i = 2 * q - (q & (stride - 1));
    const int j = i + stride;
    const u64 x = a[i];
    const u64 y = a[j];
    if ((x < y) == (((base + i) & size) == 0)) {
      a[i] = y;
      a[j] = x;
    }
  }
  __syncthreads();
}

// Strides stride_hi .. 1 of every size from size_lo to size_hi, on the chunk
// of kChunk keys at buf + c0, through shared memory.
__device__ void sort_chunk(u64* buf, u64* keys, int c0, int size_lo, int size_hi, int stride_hi) {
  for (int e = threadIdx.x; e < kChunk; e += blockDim.x) keys[e] = buf[c0 + e];
  __syncthreads();
  for (int size = size_lo; size <= size_hi; size <<= 1)
    for (int stride = min(size >> 1, stride_hi); stride > 0; stride >>= 1)
      bitonic_stage(keys, kChunk, c0, size, stride);
  for (int e = threadIdx.x; e < kChunk; e += blockDim.x) buf[c0 + e] = keys[e];
  __syncthreads();
}

// A block per row: its candidates at or above its final prefix (k to cap of
// them, among the cursor[row] it wrote in a row of `stride`) in order; the
// first k written as (value, id). Up to kRankMax candidates each find their
// place by counting the candidates above them (the keys are unique), more by a
// bitonic sort; above kSortShared (stride == cap, every candidate at or above
// the prefix) the sort runs in device memory.
__global__ void __launch_bounds__(kSortThreads) wide_sort_rows(const u64* __restrict__ prefix,
                                                           u64* __restrict__ cand,
                                                           const int* __restrict__ cursor,
                                                           int cap, int stride, int k, int m,
                                                           float* __restrict__ out_v,
                                                           long long* __restrict__ out_i) {
  extern __shared__ u64 keys[];
  __shared__ int s_n;
  const int row = blockIdx.x;
  u64* buf = cand + static_cast<size_t>(row) * stride;
  const int n = min(cursor[row], stride);
  const auto put = [&](int place, u64 key) {
    out_v[static_cast<size_t>(row) * k + place] = key_value(static_cast<unsigned>(key >> 32));
    out_i[static_cast<size_t>(row) * k + place] = m - 1 - static_cast<long long>(key & 0xffffffffull);
  };
  const u64* sorted = keys;
  if (stride <= kSortShared) {
    const u64 p = prefix[row];
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const u64 key = buf[e];
      if (key >= p) {
        const int at = atomicAdd(&s_n, 1);
        if (at < cap) keys[at] = key;
      }
    }
    __syncthreads();
    const int c = min(s_n, cap);
    if (c <= kRankMax) {
      for (int e = threadIdx.x; e < c; e += blockDim.x) {
        const u64 key = keys[e];
        int place = 0;
        for (int q = 0; q < c; ++q) place += keys[q] > key;
        if (place < k) put(place, key);
      }
      return;
    }
    const int len = 1 << (32 - __clz(c - 1));
    for (int e = c + threadIdx.x; e < len; e += blockDim.x) keys[e] = 0ull;
    __syncthreads();
    for (int size = 2; size <= len; size <<= 1)
      for (int st = size >> 1; st > 0; st >>= 1) bitonic_stage(keys, len, 0, size, st);
  } else {  // stride is a multiple of kChunk
    for (int e = n + threadIdx.x; e < stride; e += blockDim.x) buf[e] = 0ull;
    __syncthreads();
    for (int c0 = 0; c0 < stride; c0 += kChunk) sort_chunk(buf, keys, c0, 2, kChunk, kChunk);
    for (int size = 2 * kChunk; size <= stride; size <<= 1) {
      for (int st = size >> 1; st >= kChunk; st >>= 1) bitonic_stage(buf, stride, 0, size, st);
      for (int c0 = 0; c0 < stride; c0 += kChunk) sort_chunk(buf, keys, c0, size, size, kChunk >> 1);
    }
    sorted = buf;
  }
  for (int e = threadIdx.x; e < k; e += blockDim.x) put(e, sorted[e]);
}

// Dynamic shared memory of both kernels opted in on the current device, once
// per device for the largest size asked. Returns a CUDA error code.
int prepare(int d, int cap, int stride, size_t* smem_pass, size_t* smem_sort) {
  *smem_pass = 4 * wide_smem_words(d <= kDK);
  *smem_sort = 8 * static_cast<size_t>(stride <= kSortShared ? cap : kChunk);
  static size_t opted[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || *smem_pass > opted[dev][0]) {
    err = cudaFuncSetAttribute(wide_radix_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem_pass));
    if (err != cudaSuccess) return static_cast<int>(err);
    // all of L1 as shared memory, so that two blocks fit on an SM
    err = cudaFuncSetAttribute(wide_radix_pass, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted[dev][0] = *smem_pass;
  }
  if (dev >= 64 || *smem_sort > opted[dev][1]) {
    err = cudaFuncSetAttribute(wide_sort_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(*smem_sort));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted[dev][1] = *smem_sort;
  }
  return 0;
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers; users
// are int64 when users_i64, else int32; indptr and indices are null when there
// is no mask. scratch: zeroed, 8-byte aligned, 262 * n_rows + ceil(n_rows / 32)
// 4-byte words (a row's prefix 2, histogram 256, keys above, level, filter flag
// and cursor 1 each; a ticket a user tile). cap, a power of two >= k, is the most keys a row may
// hold at or above its prefix once it is done (the wrapper takes the power of
// two at or above k + 256); stride, a power of two >= cap and, when above it,
// <= 8192, the candidates a row may write while it still counts; cand: n_rows *
// stride 8-byte words. A segment is a whole number of 128-item tiles and at
// most 65535 items. Launches every pass on `stream` and does not synchronise;
// returns the first CUDA error (0 = cudaSuccess).
extern "C" int masked_topk_wide_launch(const float* user_emb, const float* item_emb,
                                       const void* users, int users_i64, int n_rows, int n_users,
                                       int m, int d, int k, const int* indptr, const int* indices,
                                       int sigmoid, int n_seg, int seg_len, int cap, int stride,
                                       void* scratch, void* cand, float* out_v, long long* out_i,
                                       void* stream) {
  const auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  if (n_rows <= 0 || n_users <= 0 || m <= 0 || d <= 0 || k < 1 || k > m || n_seg <= 0 ||
      seg_len <= 0 || seg_len > kMaxSegment || seg_len % kTI != 0 || cap < k || !pow2(cap) ||
      !pow2(stride) || stride < cap || (stride > cap && stride > kSortShared) ||
      static_cast<long long>(n_seg) * seg_len < m || reinterpret_cast<uintptr_t>(scratch) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(item_emb) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(user_emb) % 16 == 0);
  size_t smem_pass = 0, smem_sort = 0;
  cudaError_t err = static_cast<cudaError_t>(prepare(d, cap, stride, &smem_pass, &smem_sort));
  if (err != cudaSuccess) return static_cast<int>(err);
  Select sel;
  sel.prefix = static_cast<u64*>(scratch);
  sel.hist = reinterpret_cast<unsigned*>(sel.prefix + n_rows);
  sel.taken = reinterpret_cast<int*>(sel.hist + static_cast<size_t>(kBins) * n_rows);
  sel.done = sel.taken + n_rows;
  sel.filter = sel.done + n_rows;
  sel.cursor = sel.filter + n_rows;
  sel.ticket = reinterpret_cast<unsigned*>(sel.cursor + n_rows);
  sel.cand = static_cast<u64*>(cand);
  int id_bits = 0;
  while (id_bits < 31 && (static_cast<long long>(m - 1) >> id_bits) != 0) ++id_bits;
  const int id_levels = (id_bits + 7) / 8;
  const int n_levels = kValueLevels + id_levels;
  const dim3 grid(n_seg, (n_rows + kBU - 1) / kBU);
  for (int level = 0; level <= n_levels; ++level) {
    // the digit's lowest bit: 56, 48, 40, 32 in the value word, then the id's
    // bytes from the highest that M - 1 uses
    const int shift = level < kValueLevels ? 56 - 8 * level
                      : level < n_levels ? 8 * (id_levels - 1 - (level - kValueLevels)) : 0;
    wide_radix_pass<<<grid, kThreads, smem_pass, st>>>(user_emb, item_emb, users, users_i64, n_rows,
                                                  n_users, m, d, k, indptr, indices, sigmoid,
                                                  seg_len, vec4, level, n_levels, shift, cap, stride,
                                                  sel);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = cap <= 2048 ? 256 : kSortThreads;
  wide_sort_rows<<<n_rows, threads, smem_sort, st>>>(sel.prefix, sel.cand, sel.cursor, cap, stride, k, m,
                                                out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

// How many wide_radix_pass blocks one SM of the current device holds at once at
// this d (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *out. Returns a
// CUDA error code.
extern "C" int masked_topk_wide_blocks_per_sm(int d, int* out) {
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem_pass = 0, smem_sort = 0;
  const int err = prepare(d, 2, 2, &smem_pass, &smem_sort);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, wide_radix_pass, kThreads, smem_pass));
}
