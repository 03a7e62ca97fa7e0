// Exact INT64 dense-domain group-by fold: per-slot count, sum, max and
// min of an int64 value plane over packed slot ids, in one launch.
//
// Replaces no Pallas kernel. The JAX package folds INT64 aggregates with
// XLA (udf/builtins/math_ops.py: _seg_sum, _seg_count and _seg_max, in
// their sorted 64-bit forms on the TPU); the port's plain route for them
// is torch's index_add_ and scatter_reduce_, four library scatters a
// window for px/http_stats' count, mean and max, which held most of the
// card's time in that script. This kernel takes their place.
//
// What bounds it here: the rows are read once (4 B slot + 8 B value), so
// the byte bound is 12 B x n over the 3.35 TB/s of device memory (about
// 7.5 us for a 2^21-row window); the [g] outputs are small. What stands
// in the way is contention: the main path's rows fall on about 15 live
// slots, so every row of a block lands on one of 15 addresses.
//
// Design: one launch per call.
// - Rows: every thread loads slots and values unconditionally, four rows
//   per int4 of slots and two 16-byte loads of values, two of each in
//   flight (rows.cuh); a scalar head and tail take a misaligned base and
//   a ragged n. Two blocks of 512 threads per SM.
// - Warp aggregation: the lanes of a warp that hold the same slot find
//   each other (__match_any_sync) and reduce their sum, max and min over
//   a tree of shuffles; their count is the size of the group. Only the
//   lowest lane of each group touches the accumulators, so one warp step
//   hits each address at most once.
// - Accumulators: privatised in shared memory, one copy per warp when
//   the warps' copies fit kWarpCopyBytes (g <= 219 with the min, 307
//   without; the main path's g is 160), else one copy per block. With one
//   copy per warp no two warps meet on an address, so the 64-bit shared
//   atomics never contend. The choice follows g alone (int_fold_copies).
// - Merge and decode: the warps' copies reduce into the block's, which
//   merges its live slots into a global workspace with one set of native
//   64-bit atomics per slot, then takes a ticket. The last block to
//   finish copies the workspace into the int64 outputs and resets it and
//   the ticket for the next call on the stream. The caller keeps one
//   workspace per device and stream.
// - Integers stay exact: the sum wraps in two's complement as index_add_
//   on int64 does, and an empty slot reports count 0, sum 0, max
//   INT64_MIN and min INT64_MAX (the neutral values of the UDAs).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
// Shared memory the per-warp copies may take per block: two blocks per SM
// fit the SM's 228 KB.
constexpr int kWarpCopyBytes = 96 * 1024;
// Workspace: kWsArrays arrays of kMaxSlots int64, then the ticket (an
// int64 whose low u32 is counted).
constexpr int kMaxSlots = 2048;
enum { kCnt, kSum, kMax, kMin, kWsArrays };
constexpr unsigned int kFull = 0xFFFFFFFFu;

// The workspace's resting value of each array: what the last block
// leaves behind and what the caller fills a new workspace with.
__device__ __forceinline__ long long ws_init(int k) {
  return k == kMax ? LLONG_MIN : k == kMin ? LLONG_MAX : 0LL;
}

// Bytes of one copy's accumulators per slot: u64 sum, s64 max, s64 min
// (with the min), u32 count.
constexpr int slot_bytes(bool want_min) {
  return want_min ? 28 : 20;
}

int copies_of(int g, bool want_min) {
  return (long long)kWarps * g * slot_bytes(want_min) <= kWarpCopyBytes
             ? kWarps
             : 1;
}

struct Partial {
  unsigned long long sum;
  long long max, min;
};

// Sum, max and min of v over the lanes in `peers` (the calling lane's
// equal-slot lanes), left in the lowest of them. A tree over the peers'
// ranks: each round the even-ranked lanes take in the next remaining peer
// above them. Every lane of the warp calls it.
template <bool kWantMin>
__device__ __forceinline__ Partial reduce_peers(unsigned int peers,
                                                long long v) {
  const unsigned int lane = threadIdx.x & 31;
  unsigned int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned int above = peers & ~((2u << lane) - 1u);
  Partial p{(unsigned long long)v, v, v};
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? (int)lane : next;
    const unsigned long long sum = __shfl_sync(kFull, p.sum, src);
    const long long mx = __shfl_sync(kFull, p.max, src);
    const long long mn = kWantMin ? __shfl_sync(kFull, p.min, src) : 0LL;
    if (above != 0u && (rank & 1u) == 0u) {
      p.sum += sum;
      p.max = mx > p.max ? mx : p.max;
      if (kWantMin) p.min = mn < p.min ? mn : p.min;
    }
    above &= __ballot_sync(kFull, (rank & 1u) == 0u);
    rank >>= 1;
  }
  return p;
}

// out: count | sum | max | min (the last only when kWantMin), each
// int64[g]. `copies` is copies_of(g, kWantMin).
template <bool kWantMin>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
int_fold_kernel(const int* __restrict__ slots,
                const long long* __restrict__ vals, long long n, int g,
                int copies, long long* __restrict__ ws,
                long long* __restrict__ out) {
  // Shared accumulators, `copies` x g of each: sum (u64) | max | min
  // (when kWantMin) | count (u32).
  extern __shared__ long long sh[];
  const int m = copies * g;
  unsigned long long* s_sum = reinterpret_cast<unsigned long long*>(sh);
  long long* s_max = sh + m;
  long long* s_min = sh + 2 * m;
  unsigned int* s_cnt =
      reinterpret_cast<unsigned int*>(sh + (kWantMin ? 3 : 2) * m);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    s_sum[i] = 0ULL;
    s_max[i] = LLONG_MIN;
    if (kWantMin) s_min[i] = LLONG_MAX;
    s_cnt[i] = 0u;
  }
  __syncthreads();

  const int base = ((int)(threadIdx.x >> 5) % copies) * g;
  const int lane = (int)(threadIdx.x & 31);
  rows::for_each_row(slots, vals, n, [&](int s, long long v) {
    const bool keep = (unsigned int)s < (unsigned int)g;  // trash, pad
    const unsigned int peers = __match_any_sync(kFull, keep ? s : -1);
    const Partial p = reduce_peers<kWantMin>(peers, v);
    if (keep && lane == __ffs(peers) - 1) {
      const int i = base + s;
      atomicAdd(&s_cnt[i], (unsigned int)__popc(peers));
      atomicAdd(&s_sum[i], p.sum);
      atomicMax(&s_max[i], p.max);
      if (kWantMin) atomicMin(&s_min[i], p.min);
    }
  });
  __syncthreads();

  for (int s = threadIdx.x; s < g; s += blockDim.x) {
    unsigned long long c = 0ULL, sum = 0ULL;
    long long mx = LLONG_MIN, mn = LLONG_MAX;
    for (int w = 0; w < copies; ++w) {
      const int i = w * g + s;
      c += s_cnt[i];
      sum += s_sum[i];
      mx = s_max[i] > mx ? s_max[i] : mx;
      if (kWantMin) mn = s_min[i] < mn ? s_min[i] : mn;
    }
    if (c == 0ULL) continue;
    atomicAdd(reinterpret_cast<unsigned long long*>(&ws[kCnt * kMaxSlots + s]),
              c);
    atomicAdd(reinterpret_cast<unsigned long long*>(&ws[kSum * kMaxSlots + s]),
              sum);
    atomicMax(&ws[kMax * kMaxSlots + s], mx);
    if (kWantMin) atomicMin(&ws[kMin * kMaxSlots + s], mn);
  }

  // The last block to take a ticket sees every block's merge.
  __shared__ bool last;
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(ws + kWsArrays * kMaxSlots);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const int outs = kWantMin ? 4 : 3;
  for (int s = threadIdx.x; s < g; s += blockDim.x) {
    for (int k = 0; k < outs; ++k) {
      out[k * g + s] = __ldcg(&ws[k * kMaxSlots + s]);
      ws[k * kMaxSlots + s] = ws_init(k);
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

size_t smem_of(int g, bool want_min) {
  return (size_t)copies_of(g, want_min) * g * slot_bytes(want_min);
}

}  // namespace

// How many copies of the accumulators a block keeps in shared memory at
// g slots: one per warp (16) or one per block (1).
extern "C" int int_fold_copies(int g, int want_min) {
  return copies_of(g, want_min != 0);
}

// Once per card, on the current device: lets both kernels take
// kWarpCopyBytes of shared memory, the most any g <= 2048 asks (per-warp
// copies stay within it, one copy a block at 2048 slots too). Returns the
// CUDA error code.
static_assert(kMaxSlots * slot_bytes(true) <= kWarpCopyBytes,
              "one copy a block must fit the shared memory set up");
extern "C" int int_fold_setup() {
  const cudaError_t err = cudaFuncSetAttribute(
      int_fold_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWarpCopyBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(int_fold_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kWarpCopyBytes);
}

// Folds n rows into g <= 2048 slots on `stream` of card `device`, in one
// kernel launch. `ws` is the caller's workspace for this stream (4 x 2048
// int64 at their resting values, then a zero int64 ticket), left as it
// was found; `out` is int64 [3 or 4, g] (4 when want_min), every element
// written. `sms` is the card's SM count. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int int_fold_launch(const int* slots, const long long* vals,
                               long long n, int g, int want_min,
                               long long* ws, long long* out, int sms,
                               int device, void* stream) {
  if (g <= 0 || g > kMaxSlots || n < 0 || sms <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  rows::DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  // Two blocks per SM (each thread takes at least two loads of four rows),
  // and no more: each block merges its live slots with atomics.
  const long long want = (n + kThreads * 8LL - 1) / (kThreads * 8LL);
  const long long cap = (long long)kBlocksPerSm * sms;
  const int blocks = (int)(want < 1 ? 1 : (want < cap ? want : cap));
  const bool wm = want_min != 0;
  const int copies = copies_of(g, wm);
  const size_t smem = smem_of(g, wm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wm) {
    int_fold_kernel<true><<<blocks, kThreads, smem, st>>>(slots, vals, n, g,
                                                          copies, ws, out);
  } else {
    int_fold_kernel<false><<<blocks, kThreads, smem, st>>>(slots, vals, n, g,
                                                           copies, ws, out);
  }
  return (int)cudaGetLastError();
}
