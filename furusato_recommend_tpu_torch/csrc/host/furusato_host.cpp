// Host-side C++ of the port (a copy of the JAX package's
// native/furusato_native.cpp, less its CPU BPR sampler): the Levenshtein
// ratio of the product-ID dedup, the adjacency-list text parser and the
// cuckoo set's build. Bound through ctypes by
// furusato_recommend_tpu_torch/preprocessing/native.py, which builds it with
//
//   g++ -O3 -shared -fPIC -o libfurusato_host-<hash>.so furusato_host.cpp
//
// into furusato_recommend_tpu_torch/_build/ at first use.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Levenshtein ratio with python-Levenshtein semantics: indel cost 1,
// substitution cost 2; ratio = (la + lb - dist) / (la + lb). On unicode code
// points, so Japanese text is compared per character.
double lev_ratio(const uint32_t* a, int32_t la, const uint32_t* b, int32_t lb) {
  if (la == 0 && lb == 0) return 1.0;
  std::vector<int32_t> prev(lb + 1), cur(lb + 1);
  for (int32_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int32_t i = 1; i <= la; ++i) {
    cur[0] = i;
    const uint32_t ca = a[i - 1];
    for (int32_t j = 1; j <= lb; ++j) {
      const int32_t sub = prev[j - 1] + (ca == b[j - 1] ? 0 : 2);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  const double total = static_cast<double>(la) + static_cast<double>(lb);
  return (total - static_cast<double>(prev[lb])) / total;
}

// Ratios of consecutive rows: codepoints holds the rows back to back,
// offsets [n + 1] their bounds; out [n - 1] gets ratio(row i, row i + 1).
void lev_ratio_consecutive(const uint32_t* codepoints, const int64_t* offsets,
                           int64_t n, double* out) {
  for (int64_t i = 0; i + 1 < n; ++i) {
    const uint32_t* a = codepoints + offsets[i];
    const uint32_t* b = codepoints + offsets[i + 1];
    out[i] = lev_ratio(a, static_cast<int32_t>(offsets[i + 1] - offsets[i]), b,
                       static_cast<int32_t>(offsets[i + 2] - offsets[i + 1]));
  }
}

// "uid item1 item2 ..." lines to COO pairs. Returns the number of pairs, or
// -1 if out_cap is too small; called with out_cap = 0 it only counts.
int64_t parse_adjacency(const char* buf, int64_t len, int64_t* out_u,
                        int64_t* out_i, int64_t out_cap) {
  int64_t n = 0;
  int64_t pos = 0;
  while (pos < len) {
    while (pos < len && (buf[pos] == ' ' || buf[pos] == '\r')) ++pos;
    if (pos >= len) break;
    if (buf[pos] == '\n') { ++pos; continue; }
    int64_t uid = 0;
    bool have = false;
    while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
      uid = uid * 10 + (buf[pos] - '0');
      ++pos; have = true;
    }
    if (!have) { while (pos < len && buf[pos] != '\n') ++pos; continue; }
    while (pos < len && buf[pos] != '\n') {
      while (pos < len && (buf[pos] == ' ' || buf[pos] == '\r')) ++pos;
      if (pos >= len || buf[pos] == '\n') break;
      int64_t item = 0;
      bool ihave = false;
      while (pos < len && buf[pos] >= '0' && buf[pos] <= '9') {
        item = item * 10 + (buf[pos] - '0');
        ++pos; ihave = true;
      }
      if (ihave) {
        if (out_cap > 0) {
          if (n >= out_cap) return -1;
          out_u[n] = uid;
          out_i[n] = item;
        }
        ++n;
      } else {
        ++pos;  // a byte that is no digit
      }
    }
  }
  return n;
}

// Partial-key cuckoo set build (ops/cuckoo.py). The slot math is the
// murmur3 fmix32 mixing of ops/cuckoo.py, bit for bit: the membership test
// on the device recomputes both slots from the same fingerprints.
static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

static inline uint64_t cuckoo_h1(uint32_t fp, uint64_t mask) {
  return fmix32(fp ^ 0xC2B2AE3Du) & mask;
}

static inline uint64_t cuckoo_alt(uint64_t slot, uint32_t fp, uint64_t mask) {
  return slot ^ (fmix32(fp ^ 0x165667B1u) & mask);
}

// fps: [n] non-zero fingerprints; tab: [size] zeroed (0 = empty), size a
// power of two. Returns the number of keys left without a slot after
// max_kicks evictions (the caller doubles the table and builds again).
int64_t cuckoo_build(const uint32_t* fps, int64_t n, uint32_t* tab,
                     int64_t size, int64_t max_kicks) {
  const uint64_t mask = (uint64_t)size - 1;
  int64_t failed = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t fp = fps[i];
    uint64_t s1 = cuckoo_h1(fp, mask);
    if (tab[s1] == fp) continue;  // a set: a key already in is skipped
    uint64_t s2 = cuckoo_alt(s1, fp, mask);
    if (tab[s2] == fp) continue;
    if (tab[s1] == 0) { tab[s1] = fp; continue; }
    if (tab[s2] == 0) { tab[s2] = fp; continue; }
    uint32_t cur = fp;  // evict, starting at s1
    uint64_t slot = s1;
    bool placed = false;
    for (int64_t k = 0; k < max_kicks; ++k) {
      uint32_t tmp = tab[slot];
      tab[slot] = cur;
      cur = tmp;
      slot = cuckoo_alt(slot, cur, mask);
      if (tab[slot] == 0 || tab[slot] == cur) {
        tab[slot] = cur;
        placed = true;
        break;
      }
    }
    if (!placed) ++failed;
  }
  return failed;
}

}  // extern "C"
