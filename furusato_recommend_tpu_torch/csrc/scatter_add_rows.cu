// Row scatter-add: out[ids[i], :] += rows[i, :] into a zeroed [N, D] float32
// table, the backward of a table gather (ops/scatter.py::table_gather).
//
// Replaces furusato_recommend_tpu/ops/pallas_scatter.py::scatter_add_rows
// (the pl.pallas_call of _make_scatter_kernel). The TPU kernel keeps the whole
// accumulator resident in VMEM (up to 13 MB), streams the ids through SMEM in
// 2048-id chunks and adds in place, so a repeated id costs it nothing more than
// a spread one. A Hopper block has at most 227 KB of shared memory and blocks
// run in no order, so here the table lives in device memory and the entry point
// zeroes it first (cudaMemsetAsync on the same stream); the TPU kernel's idea,
// every repeated id added in fast memory, is kept per tile of rows.
//
// What bounds it on the H100: bytes. Each update row is read once (4 * R *
// (D + 1) bytes with its id) and the table is written once (4 * N * D bytes, the
// zeroing). What keeps a plain design from that bound is contention: the adds
// into one table address are performed by the L2 one after another, and in the
// sampled trees of a SAGE step one hub item holds about a tenth of the rows, so
// with one global add per row element its 32 addresses take some 27,700 adds
// each in turn, and that chain alone is 8x the bytes bound.
//
// Two modes, chosen on the host from (N, R, D, SMs) alone (ops/scatter.py::
// plan_scatter; the ids are never read there):
//  - tile: rows in tiles of T consecutive rows (T a multiple of 32, up to
//    kMaxTile), one persistent block per tile where the card holds them. The
//    block clamps the tile's ids and inserts them into an open-addressing hash
//    of 2T slots in shared memory (atomicCAS, empty key -1, which no clamped id
//    equals); the slots' counts sort the tile's rows by id (a counting sort).
//    Each lane group walks an equal span of the sorted rows, sums the rows of
//    one id in registers and adds each id once into the table, one global add a
//    column; an id cut by a span's end is summed through shared memory first.
//    So a hub's chain falls to one add per tile, spread ids pay only for the id
//    pass in shared memory, and no float is added in shared memory by an atomic
//    (sm_90 has none: a float atomicAdd there is a compare-and-swap loop). A
//    small table (a categorical field's 40 rows) is served the same way: each
//    tile adds each of its ids once. (Private copies of such a table in shared
//    memory, the TPU kernel's own design, measured slower on the H100 in every
//    form tried: the copies are added into by CAS loops, or one copy per lane
//    group leaves a block too few loads in flight.) Wide D goes in column
//    chunks, so every D has a plan.
//  - row: one warp per update row, lanes over the columns, one global add per
//    element (the first port's design). The plan takes it where R is too small
//    for tiles of useful length and ids spread over a large table: the LightGCN
//    steps' gathers (R = 8192 and 16384 rows into 50,000 and 20,000).
// Where D % 4 == 0 and the rows are 16-byte aligned (checked in the wrapper),
// loads and global adds move float4s: sm_90 has a 16-byte atomicAdd on global
// memory. The adds' results are unused, so they compile to fire-and-forget
// reductions (RED). The order of the float32 sums into one element is not
// fixed, so results vary in the last bits from run to run. Ids (int32 or int64)
// outside [0, N) are clamped into it on the device, never written outside the
// table, and never checked on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 2048;                   // rows of a tile: 8 ids a thread
constexpr int kIdsPerThread = kMaxTile / kThreads;
constexpr int kUnroll = 8;                       // rows whose loads a lane keeps in flight
constexpr int kEmpty = -1;                       // an empty hash slot
constexpr int kMaxDynamicSmem = 232448;          // 227 KB, a block's most on sm_90
enum Mode { kRow = 0, kTile = 1 };

__device__ __forceinline__ int load_id(const void* ids, int ids_i64, int64_t i, int n) {
  const long long raw = ids_i64 ? __ldg(static_cast<const long long*>(ids) + i)
                                : __ldg(static_cast<const int*>(ids) + i);
  return static_cast<int>(min(max(raw, 0LL), static_cast<long long>(n - 1)));
}

template <int VW> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ T load_shared(const float* p) { return *p; }
  static __device__ __forceinline__ void store_shared(float* p, T v) { *p = v; }
  static __device__ __forceinline__ void add_global(float* p, T v) { atomicAdd(p, v); }
  static __device__ __forceinline__ T plus(T a, T b) { return a + b; }
  static __device__ __forceinline__ T zeros() { return 0.f; }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T load_shared(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store_shared(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void add_global(float* p, T v) {
    atomicAdd(reinterpret_cast<float4*>(p), v);  // one 16-byte reduction (sm_90)
  }
  static __device__ __forceinline__ T plus(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ T zeros() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

// lanes of a group, which share one row of nv vectors: the smallest power of
// two >= nv, at most a warp
__host__ __device__ __forceinline__ int group_of(int nv) {
  int g = 32;
  while (g > 1 && g / 2 >= nv) g /= 2;
  return g;
}

__device__ __forceinline__ int hash_slot(int id, int n_slots) {
  unsigned h = static_cast<unsigned>(id);  // murmur3's fmix32, then a multiply into range
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return static_cast<int>((static_cast<unsigned long long>(h) * static_cast<unsigned>(n_slots)) >> 32);
}

// The first port's design: one warp per update row, one global add per element.
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const void* __restrict__ ids, int ids_i64,
                        const float* __restrict__ rows, int64_t r, int d, int n,
                        float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t i = warp; i < r; i += n_warps) {
    const int id = load_id(ids, ids_i64, i, n);
    const float* src = rows + i * d;
    float* dst = out + (int64_t)id * d;
    for (int c = lane; c < d; c += 32) {
      atomicAdd(dst + c, __ldg(src + c));
    }
  }
}

// Tile mode. Per tile of T consecutive rows:
//  1. the tile's ids, clamped, go into an open-addressing hash of 2T slots
//     (atomicCAS); the count of each slot gives each row its rank among the
//     rows of its id;
//  2. every occupied slot becomes an entry with a contiguous range of positions
//     (a counting sort by id: position = the entry's offset + the row's rank);
//  3. the positions are cut into one equal span per lane group (g lanes over
//     the columns); a group walks its span in order, sums consecutive rows of one
//     entry in registers and adds an entry that lies wholly in its span straight
//     into the table, one global add a column;
//  4. an entry cut by span ends leaves its pieces in shared memory, and the
//     group where it starts adds their sum into the table.
// So every distinct id of a tile takes one global add a column, whatever its
// count, and no float is added in shared memory by an atomic. Dynamic shared
// memory, in this order: part [groups][2][dc] floats (each group's head and
// tail piece), pent [groups][2] (their entries, -1 for none), then keys and
// cnt [2T] (the hash; cnt becomes the slot's entry), slot, rank, perm (the row
// at each position), ent (the entry at each position), eoff, ecnt and ekey
// (each entry's first position, row count and id) [T] ints.
int64_t tile_smem(int tile, int dc, int vw) {
  const int64_t groups = kThreads / group_of(dc / vw);
  return 4 * (2 * groups * dc + 2 * groups + 11LL * tile);
}

template <int VW>
__global__ void __launch_bounds__(kThreads, 2)
scatter_tile_kernel(const void* __restrict__ ids, int ids_i64, const float* __restrict__ rows,
                    int64_t r, int d, int n, int tile, int dc, float* __restrict__ out) {
  using V = Vec<VW>;
  extern __shared__ float4 smem4[];
  const int g = group_of(dc / VW);
  const int groups = kThreads / g;
  float* part = reinterpret_cast<float*>(smem4);
  int* pent = reinterpret_cast<int*>(part + 2 * groups * dc);
  int* keys = pent + 2 * groups;
  int* cnt = keys + 2 * tile;
  int* slot = cnt + 2 * tile;
  int* rank = slot + tile;
  int* perm = rank + tile;
  int* ent = perm + tile;
  int* eoff = ent + tile;
  int* ecnt = eoff + tile;
  int* ekey = ecnt + tile;
  __shared__ int n_ent, n_pos;
  const int n_slots = 2 * tile;
  const int q = threadIdx.x / g, sub = threadIdx.x & (g - 1);  // this lane's group
  const int64_t n_tiles = (r + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t base = t * tile;
    const int rows_here = (int)min((long long)tile, (long long)(r - base));
    for (int s = threadIdx.x; s < n_slots; s += kThreads) {
      keys[s] = kEmpty;
      cnt[s] = 0;
    }
    if (threadIdx.x == 0) n_ent = n_pos = 0;
    int my_id[kIdsPerThread];
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      my_id[k] = i < rows_here ? load_id(ids, ids_i64, base + i, n) : kEmpty;
    }
    __syncthreads();
    // 1. the ids into the hash; a row's rank among its id's rows
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int id = my_id[k];
      if (id == kEmpty) continue;
      int s = hash_slot(id, n_slots);
      for (;;) {
        const int prev = atomicCAS(&keys[s], kEmpty, id);
        if (prev == kEmpty || prev == id) break;
        if (++s == n_slots) s = 0;
      }
      const int i = threadIdx.x + k * kThreads;
      rank[i] = atomicAdd(&cnt[s], 1);
      slot[i] = s;
    }
    __syncthreads();
    // 2. entries: thread x takes a run of slots, and one range of entries and of
    // positions for them
    {
      const int per = (n_slots + kThreads - 1) / kThreads;
      const int lo = threadIdx.x * per, hi = min(lo + per, n_slots);
      int occupied = 0, rows_of = 0;
      for (int s = lo; s < hi; ++s) {
        occupied += cnt[s] > 0;
        rows_of += cnt[s];
      }
      int e = atomicAdd(&n_ent, occupied);
      int p = atomicAdd(&n_pos, rows_of);
      for (int s = lo; s < hi; ++s) {
        const int c = cnt[s];
        if (c == 0) continue;
        ekey[e] = keys[s];
        ecnt[e] = c;
        eoff[e] = p;
        cnt[s] = e;
        ++e;
        p += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kIdsPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= rows_here) continue;
      const int e = cnt[slot[i]];
      const int pos = eoff[e] + rank[i];
      perm[pos] = i;
      ent[pos] = e;
    }
    // 3. each group's span of positions
    const int span = (rows_here + groups - 1) / groups;
    const int lo = min(q * span, rows_here), hi = min(lo + span, rows_here);
    for (int c0 = 0; c0 < d; c0 += dc) {
      const int nv = min(dc, d - c0) / VW;
      for (int x = threadIdx.x; x < 2 * groups; x += kThreads) pent[x] = -1;
      __syncthreads();
      for (int v = sub; v < nv; v += g) {
        // the sum of positions [a, b), all of entry e: into the table if that is
        // the whole entry, else a piece: the head (the entry began before this
        // span) or the tail (it goes on after it)
        auto emit = [&](int e, typename V::T sum, int a, int b) {
          const bool head = a > eoff[e], tail = b < eoff[e] + ecnt[e];
          if (!head && !tail) {
            V::add_global(out + (int64_t)ekey[e] * d + c0 + v * VW, sum);
          } else {
            const int k = 2 * q + (head ? 0 : 1);
            pent[k] = e;
            V::store_shared(part + k * dc + v * VW, sum);
          }
        };
        int cur = -1, a = lo;
        typename V::T sum = V::zeros();
        for (int p0 = lo; p0 < hi; p0 += kUnroll) {
          typename V::T x[kUnroll];
          int e[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int p = p0 + u;
            e[u] = -1;
            if (p < hi) {
              e[u] = ent[p];
              x[u] = V::load(rows + (base + perm[p]) * d + c0 + v * VW);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (e[u] < 0) continue;
            if (e[u] != cur) {
              if (cur >= 0) emit(cur, sum, a, p0 + u);
              cur = e[u];
              a = p0 + u;
              sum = x[u];
            } else {
              sum = V::plus(sum, x[u]);
            }
          }
        }
        if (cur >= 0) emit(cur, sum, a, hi);
      }
      __syncthreads();
      // 4. an entry cut by span ends: its tail piece, then the head pieces of
      // the groups after, into the table once
      const int e = pent[2 * q + 1];
      if (e >= 0) {
        for (int v = sub; v < nv; v += g) {
          typename V::T sum = V::load_shared(part + (2 * q + 1) * dc + v * VW);
          for (int q2 = q + 1; q2 < groups && pent[2 * q2] == e; ++q2)
            sum = V::plus(sum, V::load_shared(part + 2 * q2 * dc + v * VW));
          V::add_global(out + (int64_t)ekey[e] * d + c0 + v * VW, sum);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Lets `kernel` take the device's most dynamic shared memory: the opt-in
// limit less the kernel's static shared memory.
template <typename K>
cudaError_t allow_smem(K kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  return err;
}

// Raise the dynamic shared memory limit of the kernels of `mode` (0 row, 1 tile)
// on the current device. Call once per device and mode before the
// first launch. Returns the first CUDA error (0 on success), and clears it, so
// that no later launch reports it.
extern "C" int scatter_add_rows_prepare(int mode) {
  cudaError_t err = cudaSuccess;
  if (mode == kTile) {
    err = allow_smem(scatter_tile_kernel<1>);
    if (err == cudaSuccess) err = allow_smem(scatter_tile_kernel<4>);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// ids [r] int64 when ids_i64, else int32; rows [r, d] float32 row-major;
// out [n, d] float32, any contents: it is zeroed here, on `stream`, before
// the adds. The plan (ops/scatter.py::plan_scatter): `mode`, rows per `tile`,
// `blocks`, `aux` (tile mode: columns per chunk) and `smem`
// bytes of dynamic shared memory. vec4: D % 4 == 0 and rows 16-byte aligned.
// Every call launches, r = 0 included (a block that adds nothing). Returns the
// first CUDA error (0 on success).
extern "C" int scatter_add_rows_launch(const void* ids, int ids_i64, const float* rows,
                                       long long r, int d, int n, int mode, int tile,
                                       int blocks, int aux, int smem, int vec4, float* out,
                                       cudaStream_t stream) {
  if (r < 0 || d < 0 || n < 0 || (r > 0 && n == 0) || blocks < 1 || smem < 0 ||
      smem > kMaxDynamicSmem || (vec4 && d % 4 != 0))
    return (int)cudaErrorInvalidValue;
  if (mode == kTile && (tile < 32 || tile % 32 != 0 || tile > kMaxTile || aux < 1 ||
                        (vec4 && aux % 4 != 0) || tile_smem(tile, aux, vec4 ? 4 : 1) > smem))
    return (int)cudaErrorInvalidValue;
  if (mode != kRow && mode != kTile) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n * (size_t)d, stream);
  if (err != cudaSuccess) return (int)err;
  if (mode == kRow || d == 0) {
    scatter_add_rows_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(ids, ids_i64, rows, r, d,
                                                                       n, out);
  } else if (mode == kTile) {
    if (vec4)
      scatter_tile_kernel<4><<<(unsigned)blocks, kThreads, smem, stream>>>(
          ids, ids_i64, rows, r, d, n, tile, aux, out);
    else
      scatter_tile_kernel<1><<<(unsigned)blocks, kThreads, smem, stream>>>(
          ids, ids_i64, rows, r, d, n, tile, aux, out);
  }
  return (int)cudaGetLastError();
}
