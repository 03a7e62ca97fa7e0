// Native N:M hash equijoin over packed i64 key ids.
//
// Reference parity: Carnot's EquijoinNode build+probe hash join
// (src/carnot/exec/equijoin_node.cc), for a CPU engine's N:M joins
// (exec/joins.py host_hash). The numpy argsort + searchsorted form pays
// O(n log n) sorts and several full passes; this is the classic
// open-addressing build+probe at O(n), one core.
//
// C ABI (ctypes), single call, two internal passes:
//   needed = hash_join(bk, nb, pk, np, left_outer, l_idx, r_idx, cap)
// - bk/pk: i64 key planes (the engine packs multi-column keys to dense
//   i64 ids first, joins._packed_key_ids).
// - Returns the total number of output pairs. When needed <= cap the
//   outputs are filled: l_idx/r_idx i32 row indices (r_idx -1 for an
//   unmatched probe kept by left_outer). When needed > cap nothing is
//   written — the caller re-allocates and calls again.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  // splitmix64 finalizer: cheap, well-distributed for table indexing.
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

long long hash_join(const long long* bk, long long nb, const long long* pk,
                    long long np, int left_outer, int32_t* l_idx,
                    int32_t* r_idx, long long cap) {
  // Table size: power of two >= 2 * nb (load factor <= 0.5).
  uint64_t tsize = 16;
  while (tsize < uint64_t(nb) * 2) tsize <<= 1;
  const uint64_t mask = tsize - 1;
  std::vector<int32_t> heads(tsize, -1);
  std::vector<int32_t> next(size_t(nb > 0 ? nb : 1), -1);
  // Build: duplicate keys chain through next[]; insert in REVERSE so
  // probing walks the chain in ascending build-row order.
  for (long long i = nb - 1; i >= 0; --i) {
    uint64_t h = mix64(uint64_t(bk[i])) & mask;
    while (heads[h] != -1 && bk[heads[h]] != bk[i]) h = (h + 1) & mask;
    next[i] = heads[h];
    heads[h] = int32_t(i);
  }
  // Pass 1: count output pairs.
  long long total = 0;
  for (long long i = 0; i < np; ++i) {
    uint64_t h = mix64(uint64_t(pk[i])) & mask;
    while (heads[h] != -1 && bk[heads[h]] != pk[i]) h = (h + 1) & mask;
    int32_t j = heads[h];
    if (j == -1) {
      if (left_outer) ++total;
      continue;
    }
    for (; j != -1; j = next[j]) ++total;
  }
  if (total > cap || l_idx == nullptr) return total;
  // Pass 2: fill.
  long long k = 0;
  for (long long i = 0; i < np; ++i) {
    uint64_t h = mix64(uint64_t(pk[i])) & mask;
    while (heads[h] != -1 && bk[heads[h]] != pk[i]) h = (h + 1) & mask;
    int32_t j = heads[h];
    if (j == -1) {
      if (left_outer) {
        l_idx[k] = int32_t(i);
        r_idx[k] = -1;
        ++k;
      }
      continue;
    }
    for (; j != -1; j = next[j]) {
      l_idx[k] = int32_t(i);
      r_idx[k] = j;
      ++k;
    }
  }
  return total;
}

}  // extern "C"
