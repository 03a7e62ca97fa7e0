// Row walk shared by the port's fold kernels: (id, value) pairs read
// 16 bytes at a time, spread over a persistent grid. And the device guard
// of their launch functions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rows {

constexpr int kDepth = 2;

// Four consecutive rows' values.
template <typename T>
struct Four {
  T x, y, z, w;
};

// Four values from a 16-byte aligned address: one 16-byte load of f32,
// two of int64.
__device__ __forceinline__ Four<float> load4(const float* p) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  return {q.x, q.y, q.z, q.w};
}

__device__ __forceinline__ Four<long long> load4(const long long* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  const longlong2 a = __ldcg(q);
  const longlong2 b = __ldcg(q + 1);
  return {a.x, a.y, b.x, b.y};
}

// Calls fold(id, value) for every row of ids[0, n) and vals[0, n), spread
// over `workers` threads of which the caller is number `worker` (worker %
// 32 must be the caller's lane). Where the values of the first row past
// the ids' 16-byte boundary lie on one too, rows move four at a time (an
// int4 of ids, 16 or 32 bytes of values: load4), kDepth per input and
// thread in flight before the first fold; the rows before that boundary
// and the ragged tail go one at a time. Inputs whose offsets differ
// (views such as ids[1:] beside vals[2:] for f32) go one row at a time
// throughout. A value is loaded only when wanted(id) holds for its
// row or, in a 16-byte load, for one of its four rows; other rows arrive
// with value 0, as do rows past the end (with id -1). Every lane of a
// warp makes the same number of calls, so fold may use warp-wide
// intrinsics on the full mask.
template <typename T, typename Wanted, typename Fold>
__device__ __forceinline__ void for_each_row(const int* __restrict__ ids,
                                             const T* __restrict__ vals,
                                             long long n, long long worker,
                                             long long workers,
                                             Wanted&& wanted, Fold&& fold) {
  const int lane = (int)(worker & 31);
  const long long warp0 = worker - lane;

  const unsigned mis_i = (unsigned)((uintptr_t)ids & 15u);
  const long long lead = (long long)(((16u - mis_i) & 15u) >> 2);
  long long head = 0, nvec = 0;
  if (((uintptr_t)(vals + lead) & 15u) == 0u) {
    head = lead < n ? lead : n;
    nvec = (n - head) >> 2;
  }
  const long long vec_end = head + 4 * nvec;

  const int4* ids4 = reinterpret_cast<const int4*>(ids + head);
  const T* vals4 = vals + head;
  for (long long j0 = warp0 + lane; j0 - lane < nvec; j0 += kDepth * workers) {
    int4 id[kDepth];
    Four<T> v[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long long j = j0 + d * workers;
      id[d] = j < nvec ? __ldcg(ids4 + j) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long long j = j0 + d * workers;
      const bool want = wanted(id[d].x) || wanted(id[d].y) ||
                        wanted(id[d].z) || wanted(id[d].w);
      v[d] = j < nvec && want ? load4(vals4 + 4 * j) : Four<T>{};
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      fold(id[d].x, v[d].x);
      fold(id[d].y, v[d].y);
      fold(id[d].z, v[d].z);
      fold(id[d].w, v[d].w);
    }
  }

  // Scalar rows: [0, head) and [vec_end, n).
  const long long rest = head + (n - vec_end);
  for (long long k0 = warp0; k0 < rest; k0 += workers) {
    const long long k = k0 + lane;
    int s = -1;
    T v = T(0);
    if (k < rest) {
      const long long i = k < head ? k : vec_end + (k - head);
      s = ids[i];
      if (wanted(s)) v = vals[i];
    }
    fold(s, v);
  }
}

// for_each_row over the whole grid, every value loaded: the wanted test is
// a constant, so slots and values load together, unconditionally.
template <typename T, typename Fold>
__device__ __forceinline__ void for_each_row(const int* __restrict__ ids,
                                             const T* __restrict__ vals,
                                             long long n, Fold&& fold) {
  for_each_row(ids, vals, n,
               (long long)blockIdx.x * blockDim.x + threadIdx.x,
               (long long)gridDim.x * blockDim.x,
               [](int) { return true; }, fold);
}

// Makes `device` current for its lifetime when it is not already (the
// caller's tensors may lie on another card than the current one), and
// restores the caller's device after.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace rows
