// K2: fused U·Vᵀ + bias + seen-mask + threshold count for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_count_kernel` in
// topk_rec_tpu/ops/topk_hybrid.py (launched by `_count_vs_threshold`), the
// audit pass of the exact "hybrid" top-k. Per user row u it recomputes
// s = U[u]·V[i] + bias[i] for every item i < n_i, tile by tile, and never
// stores s. An excluded item (bit i & 31 of word excl[u, i >> 5] set) scores
// float32.min. With eps = 1e-4·max(|t_u|, |s|) + 1e-6 it counts
//
//   gt[u] = #{i : s > t_u + eps}    eq[u] = #{i : |s - t_u| <= eps}.
//
// Items at or past n_i are never counted. The TPU kernel pads the catalog
// with masked columns, which enter eq when t_u is float32.min; the audit's
// verdict is the same, since such a row fails it either way.
//
// What bounds it on the H100: the same product as K1 (at 8,192 users x
// 10,380 items, d = 50: 4.25 G FMA in fp32 on the CUDA cores) against about
// 11 MB of bitmap and 2 MB of V read. It is compute-bound, and the count is
// a few compares per score, far cheaper than K1's selection. So the design
// is K1's score loop (score_tile.cuh: kRows user rows per block in shared
// memory, V staged in kDTile-column tiles, sequential fmaf) followed by
// per-thread counters in registers. At the end of its item range each warp
// sums its counters with __reduce_add_sync, lane 0 adds them into the
// block's shared counters, and one thread per row adds those into the
// output with atomicAdd (int32, so the total does not depend on the order).
// Small batches split the catalog over grid.y, as K1 does, so that enough
// blocks run; the splits meet in the same atomics and need no second pass.
//
// The eps arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn so that nvcc
// cannot contract it into an fma: the rounding then matches the plain twin's
// separate multiply and add. Output gt, eq: int32 [n_u], zeroed by the
// caller. The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

constexpr float kCountNegInf = -FLT_MAX;  // float32.min: an excluded score

template <typename T>
__global__ void __launch_bounds__(kThreads)
    count_pass(const T* __restrict__ U, const T* __restrict__ V,
               const float* __restrict__ bias,
               const int32_t* __restrict__ excl,
               const float* __restrict__ thr, int32_t* __restrict__ out_gt,
               int32_t* __restrict__ out_eq, int n_u, int n_i, int d, int dpad,
               int n_words, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Us = reinterpret_cast<float*>(smem);  // [kRows][dpad]
  float* Vs = Us + (size_t)kRows * dpad;         // [kThreads][kVStride]
  __shared__ int blk_gt[kRows];
  __shared__ int blk_eq[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int item_begin = blockIdx.y * split_len;
  const int item_end = min(n_i, item_begin + split_len);

  stage_rows(U, Us, row0, n_u, d, dpad);
  if (tid < kRows) {
    blk_gt[tid] = 0;
    blk_eq[tid] = 0;
  }
  float t[kRows];
  int gt[kRows];
  int eq[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    t[r] = row0 + r < n_u ? thr[row0 + r] : 0.f;
    gt[r] = 0;
    eq[r] = 0;
  }
  __syncthreads();

  for (int c0 = item_begin; c0 < item_end; c0 += kThreads) {
    float acc[kRows];
    score_chunk(V, Us, Vs, c0, item_end, d, dpad, acc);
    const int item = c0 + tid;
    if (item < item_end) {
      const float b = bias != nullptr ? bias[item] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int u = row0 + r;
        if (u >= n_u) continue;
        const float s =
            excluded(excl, u, n_words, item) ? kCountNegInf : acc[r] + b;
        const float eps = __fadd_rn(
            __fmul_rn(1e-4f, fmaxf(fabsf(t[r]), fabsf(s))), 1e-6f);
        gt[r] += s > __fadd_rn(t[r], eps);
        eq[r] += fabsf(__fsub_rn(s, t[r])) <= eps;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int g = __reduce_add_sync(kFull, gt[r]);
    const int e = __reduce_add_sync(kFull, eq[r]);
    if (lane == 0 && (g | e)) {
      atomicAdd(&blk_gt[r], g);
      atomicAdd(&blk_eq[r], e);
    }
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < n_u) {
    atomicAdd(&out_gt[row0 + tid], blk_gt[tid]);
    atomicAdd(&out_eq[row0 + tid], blk_eq[tid]);
  }
}

template <typename T>
int launch_count(const void* U, const void* V, const void* bias,
                 const void* excl, const void* thr, void* out_gt, void* out_eq,
                 int n_u, int n_i, int d, int n_words, int split_len,
                 int n_splits, cudaStream_t stream) {
  const int dpad = round_up(d, kDTile);
  const size_t smem = sizeof(float) * tile_smem_floats(dpad);
  cudaError_t err = cudaFuncSetAttribute(
      count_pass<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_u + kRows - 1) / kRows, n_splits);
  count_pass<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<const float*>(bias), static_cast<const int32_t*>(excl),
      static_cast<const float*>(thr), static_cast<int32_t*>(out_gt),
      static_cast<int32_t*>(out_eq), n_u, n_i, d, dpad, n_words, split_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// U [n_u, d], V [n_i, d] (float32 when bf16 == 0, bfloat16 otherwise),
// bias [n_i] float32 or null, excl [n_u, n_words] int32 bit words, thr [n_u]
// float32; out_gt, out_eq [n_u] int32, zeroed. The items split into n_splits
// ranges of split_len (grid.y). Returns a cudaError_t value (0 = ok).
int tkr_count_vs_threshold(const void* U, const void* V, const void* bias,
                           const void* excl, const void* thr, void* out_gt,
                           void* out_eq, int n_u, int n_i, int d, int n_words,
                           int split_len, int n_splits, int bf16,
                           void* stream) {
  if (n_u <= 0 || n_i <= 0 || d <= 0 || d > kMaxD ||
      n_words < (n_i + 31) / 32 || split_len <= 0 || n_splits <= 0 ||
      n_splits > 65535 || (long long)split_len * n_splits < n_i ||
      (long long)split_len * (n_splits - 1) >= n_i)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_count<__nv_bfloat16>(U, V, bias, excl, thr, out_gt, out_eq,
                                       n_u, n_i, d, n_words, split_len,
                                       n_splits, s);
  return launch_count<float>(U, V, bias, excl, thr, out_gt, out_eq, n_u, n_i,
                             d, n_words, split_len, n_splits, s);
}

}  // extern "C"
