// Dense-domain group-by fold: per-slot count, sum, max and min (or a count
// of -inf values) over packed slot ids.
//
// Replaces: pixie_tpu/ops/pallas_groupby.py, dense_group_fold (kernel body
// _fold_kernel). The TPU kernel walks row chunks in order on one core and
// keeps [g] accumulators in VMEM across its grid; each chunk becomes a
// [C, g] one-hot contraction on the MXU.
//
// What bounds it here: the rows are read once (4 B slot + 4 B value), so
// the byte bound is 8 B x n over the 3.35 TB/s of device memory (about
// 5 us for a 2^21-row window). The work per row is four or five atomic
// updates of a slot, and with a few hundred slots the atomics collide:
// shared-memory atomic throughput, not memory, is the limit of this
// simple form.
//
// Design: Hopper's blocks run in parallel in no order, so nothing carries
// from one block to the next. Each block privatises the [g] accumulators
// in shared memory (20 B x g, at most 40 KB for g <= 2048), folds its
// share of the rows with a grid-stride loop and shared atomics, then
// merges its live slots into a global workspace with one set of global
// atomics per slot. A last small kernel decodes the workspace into the
// four f32 outputs. There is no float atomicMax, so max and min use the
// order-preserving map of the f32 bits onto u32 (negatives inverted,
// positives with the sign bit set) and integer atomicMax/atomicMin.
// NaN has no place in that order, so a per-slot NaN flag forces max and
// min to NaN, as jnp.maximum propagates NaN in the TPU kernel. Slot ids
// outside [0, g) are dropped by one unsigned bounds check. Rows with a
// non-finite value add nothing to the sum; the caller restores NaN/+inf/
// -inf sums from the max/min evidence, as the JAX wrapper does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned int order_bits(float f) {
  unsigned int b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int e) {
  unsigned int b = (e & 0x80000000u) ? (e & 0x7FFFFFFFu) : ~e;
  return __uint_as_float(b);
}

__device__ __forceinline__ bool is_nan_bits(float f) {
  return (__float_as_uint(f) & 0x7FFFFFFFu) > 0x7F800000u;
}

__device__ __forceinline__ bool is_finite_bits(float f) {
  return (__float_as_uint(f) & 0x7F800000u) != 0x7F800000u;
}

// Workspace layout, 5 x g u32: count | sum (f32 bits) | max | aux | nan.
// aux holds the ordered min when want_min, else the count of -inf rows.
__global__ void init_workspace(unsigned int* ws, int g, int want_min) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= g) return;
  ws[s] = 0u;
  ws[g + s] = __float_as_uint(0.0f);
  ws[2 * g + s] = order_bits(-INFINITY);
  ws[3 * g + s] = want_min ? order_bits(INFINITY) : 0u;
  ws[4 * g + s] = 0u;
}

__global__ void __launch_bounds__(kThreads)
fold_rows(const int* __restrict__ slots, const float* __restrict__ vals,
          long long n, int g, int want_min, unsigned int* __restrict__ ws) {
  extern __shared__ unsigned int sh[];
  unsigned int* s_cnt = sh;
  float* s_sum = reinterpret_cast<float*>(sh + g);
  unsigned int* s_max = sh + 2 * g;
  unsigned int* s_aux = sh + 3 * g;
  unsigned int* s_nan = sh + 4 * g;
  const unsigned int max0 = order_bits(-INFINITY);
  const unsigned int aux0 = want_min ? order_bits(INFINITY) : 0u;
  for (int s = threadIdx.x; s < g; s += blockDim.x) {
    s_cnt[s] = 0u;
    s_sum[s] = 0.0f;
    s_max[s] = max0;
    s_aux[s] = aux0;
    s_nan[s] = 0u;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = slots[i];
    if ((unsigned int)s >= (unsigned int)g) continue;  // trash and negative ids
    const float v = vals[i];
    atomicAdd(&s_cnt[s], 1u);
    if (is_nan_bits(v)) {
      atomicOr(&s_nan[s], 1u);
      continue;
    }
    if (is_finite_bits(v)) atomicAdd(&s_sum[s], v);
    const unsigned int e = order_bits(v);
    atomicMax(&s_max[s], e);
    if (want_min) {
      atomicMin(&s_aux[s], e);
    } else if (v == -INFINITY) {
      atomicAdd(&s_aux[s], 1u);
    }
  }
  __syncthreads();

  for (int s = threadIdx.x; s < g; s += blockDim.x) {
    const unsigned int c = s_cnt[s];
    if (c == 0u) continue;
    atomicAdd(&ws[s], c);
    atomicAdd(reinterpret_cast<float*>(&ws[g + s]), s_sum[s]);
    atomicMax(&ws[2 * g + s], s_max[s]);
    if (want_min) {
      atomicMin(&ws[3 * g + s], s_aux[s]);
    } else if (s_aux[s] != 0u) {
      atomicAdd(&ws[3 * g + s], s_aux[s]);
    }
    if (s_nan[s] != 0u) atomicOr(&ws[4 * g + s], 1u);
  }
}

// out: 4 x g f32 = count | sum | max | min (want_min) or -inf count.
__global__ void decode_workspace(const unsigned int* __restrict__ ws, int g,
                                 int want_min, float* __restrict__ out) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= g) return;
  const bool has_nan = ws[4 * g + s] != 0u;
  out[s] = (float)ws[s];
  out[g + s] = __uint_as_float(ws[g + s]);
  out[2 * g + s] = has_nan ? NAN : from_order_bits(ws[2 * g + s]);
  if (want_min) {
    out[3 * g + s] = has_nan ? NAN : from_order_bits(ws[3 * g + s]);
  } else {
    out[3 * g + s] = (float)ws[3 * g + s];
  }
}

}  // namespace

// Folds n rows into g slots on `stream` of card `device`. `ws` is 5 x g
// u32 scratch and `out` 4 x g f32, both allocated by the caller. Returns
// the CUDA error code of the launches (0 on success).
extern "C" int dense_fold_launch(const int* slots, const float* vals,
                                 long long n, int g, int want_min,
                                 unsigned int* ws, float* out, int device,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  const int slot_blocks = (g + kThreads - 1) / kThreads;
  init_workspace<<<slot_blocks, kThreads, 0, st>>>(ws, g, want_min);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // Enough blocks to fill the card, few enough that the per-block merge
  // (one set of atomics per live slot) stays small beside the rows.
  long long want = (n + kThreads * 8LL - 1) / (kThreads * 8LL);
  long long cap = 2LL * sms;
  int blocks = (int)(want < cap ? want : cap);
  if (blocks < 1) blocks = 1;
  const size_t smem = (size_t)5 * g * sizeof(unsigned int);
  fold_rows<<<blocks, kThreads, smem, st>>>(slots, vals, n, g, want_min, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  decode_workspace<<<slot_blocks, kThreads, 0, st>>>(ws, g, want_min, out);
  return (int)cudaGetLastError();
}
