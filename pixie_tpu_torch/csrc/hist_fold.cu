// t-digest histogram fold: per-slot row count (weight) and value sum over
// flat slot ids (group x bins + bin).
//
// Replaces: pixie_tpu/ops/pallas_tdigest.py, hist_fold (kernel body
// _hist_kernel). The TPU kernel sweeps a one-hot [C, 2048] tile of slots
// through the MXU for every slot tile, which costs n x S multiply-adds
// (S = the slot count); that is why the JAX package only engages it at
// S <= 2^15. Atomics cost O(n) whatever the slot count, so this kernel
// takes every slot count.
//
// What bounds it here: the rows are read once (4 B id + 4 B value) and
// each slot array is written once (8 B per slot), about 5 us per 2^21
// rows at 3.35 TB/s. Each row does two float atomic adds; the slot
// arrays of the main path (33 groups x 8192 bins, 2.2 MB) stay in the
// 50 MB L2, so L2 atomic throughput is the limit of this simple form.
//
// Design: no sequential grid to carry sums across. Slot arrays that fit
// in shared memory (8 B x S <= 200 KB) are privatised per block, folded
// with shared atomics and merged into the outputs with one global atomic
// per non-empty slot and block. Larger ones take global atomics directly.
// Ids outside [0, S) are dropped by one unsigned bounds check. The caller
// zeroes both outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr long long kSharedSlotBytes = 200LL * 1024;

__global__ void __launch_bounds__(kThreads)
fold_shared(const int* __restrict__ ids, const float* __restrict__ vals,
            long long n, int n_slots, float* __restrict__ w,
            float* __restrict__ mw) {
  extern __shared__ float sh[];
  float* s_w = sh;
  float* s_mw = sh + n_slots;
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    s_w[s] = 0.0f;
    s_mw[s] = 0.0f;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = ids[i];
    if ((unsigned int)s >= (unsigned int)n_slots) continue;
    atomicAdd(&s_w[s], 1.0f);
    atomicAdd(&s_mw[s], vals[i]);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    if (s_w[s] == 0.0f) continue;
    atomicAdd(&w[s], s_w[s]);
    atomicAdd(&mw[s], s_mw[s]);
  }
}

__global__ void __launch_bounds__(kThreads)
fold_global(const int* __restrict__ ids, const float* __restrict__ vals,
            long long n, int n_slots, float* __restrict__ w,
            float* __restrict__ mw) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = ids[i];
    if ((unsigned int)s >= (unsigned int)n_slots) continue;
    atomicAdd(&w[s], 1.0f);
    atomicAdd(&mw[s], vals[i]);
  }
}

}  // namespace

// Folds n rows into n_slots (weight, value sum) pairs on `stream` of card
// `device`. `w` and `mw` are zeroed f32[n_slots] allocated by the caller.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int hist_fold_launch(const int* ids, const float* vals, long long n,
                                int n_slots, float* w, float* mw, int device,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;

  const long long smem = 2LL * n_slots * (long long)sizeof(float);
  if (smem <= kSharedSlotBytes) {
    err = cudaFuncSetAttribute(fold_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    // One block per SM: the private histogram takes most of its shared
    // memory, so a second block would not fit beside it.
    long long want = (n + kThreads - 1) / kThreads;
    int blocks = (int)(want < sms ? want : sms);
    fold_shared<<<blocks, kThreads, (size_t)smem, st>>>(ids, vals, n, n_slots,
                                                        w, mw);
  } else {
    long long want = (n + kThreads * 4LL - 1) / (kThreads * 4LL);
    long long cap = 4LL * sms;
    int blocks = (int)(want < cap ? want : cap);
    fold_global<<<blocks, kThreads, 0, st>>>(ids, vals, n, n_slots, w, mw);
  }
  return (int)cudaGetLastError();
}
