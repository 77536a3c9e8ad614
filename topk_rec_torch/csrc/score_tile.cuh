// Shared by K1 (topk_fused.cu) and K2 (topk_count.cu): the block layout and
// the tile loop that computes U·Vᵀ for kRows user rows against one chunk of
// kThreads items, never writing a score to device memory.
//
// A block holds kRows user rows in shared memory (Us, [kRows][dpad], zero
// beyond d) and stages V in tiles of kDTile columns (Vs, [kThreads][kVStride];
// coalesced loads, and a row stride of 36 floats keeps the float4 reads free
// of bank conflicts). Each thread accumulates kRows dot products for its item
// with sequential fmaf over d in fp32; bf16 inputs are widened with
// __bfloat162float, so a bf16 product is exact and only the summation rounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads per block = items per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                // user rows per block
constexpr int kDTile = 32;              // V columns staged per tile
constexpr int kVStride = 36;            // V tile row stride (floats); 36/4 odd
constexpr int kMaxD = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Floats of shared memory that Us and Vs take.
__host__ __device__ inline size_t tile_smem_floats(int dpad) {
  return (size_t)kRows * dpad + (size_t)kThreads * kVStride;
}

// Us[r][j] = U[row0 + r][j], zero past n_u or d. Ends without a barrier.
template <typename T>
__device__ void stage_rows(const T* __restrict__ U, float* Us, int row0,
                           int n_u, int d, int dpad) {
  for (int e = threadIdx.x; e < kRows * dpad; e += kThreads) {
    const int r = e / dpad;
    const int j = e - r * dpad;
    const int u = row0 + r;
    Us[e] = (u < n_u && j < d) ? to_f32(U[(size_t)u * d + j]) : 0.f;
  }
}

// acc[r] = Us[r]·V[c0 + threadIdx.x] for the chunk [c0, c0 + kThreads);
// items at or past item_end read zeros. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void score_chunk(const T* __restrict__ V,
                                            const float* Us, float* Vs,
                                            int c0, int item_end, int d,
                                            int dpad, float (&acc)[kRows]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int j0 = 0; j0 < d; j0 += kDTile) {
    const int dt = min(kDTile, d - j0);
    for (int t = warp; t < kThreads; t += kWarps) {
      const int item = c0 + t;
      Vs[t * kVStride + lane] =
          (item < item_end && lane < dt)
              ? to_f32(V[(size_t)item * d + j0 + lane])
              : 0.f;
    }
    __syncthreads();
    const float4* v4 = reinterpret_cast<const float4*>(Vs + tid * kVStride);
    const int nq = (dt + 3) >> 2;
    for (int q = 0; q < nq; ++q) {
      const float4 v = v4[q];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 u =
            *reinterpret_cast<const float4*>(Us + r * dpad + j0 + 4 * q);
        acc[r] = fmaf(u.x, v.x, acc[r]);
        acc[r] = fmaf(u.y, v.y, acc[r]);
        acc[r] = fmaf(u.z, v.z, acc[r]);
        acc[r] = fmaf(u.w, v.w, acc[r]);
      }
    }
    __syncthreads();
  }
}

// Bit (item & 31) of word excl[u, item >> 5]: the item is excluded for u.
__device__ __forceinline__ bool excluded(const int32_t* __restrict__ excl,
                                         int u, int n_words, int item) {
  const uint32_t w =
      static_cast<uint32_t>(excl[(size_t)u * n_words + (item >> 5)]);
  return (w >> (item & 31)) & 1u;
}

}  // namespace
