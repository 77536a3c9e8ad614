// P1: the floor of K1 for Hopper (sm_90a): fused U·Vᵀ + bias + seen-mask
// + a running max per residue of the item index mod 128, with no selection.
//
// Replaces the Pallas TPU probe kernel `kern` (`make_kernel`) in
// benchmarks/probe_topk_floor.py, launched by its `pallas_call`. Per user
// row u and residue l in [0, 128) it computes
//
//   out_v[u, l] = max over unmasked items i < n_i with i % 128 == l of
//                 U[u]·V[i] + bias[i],
//
// and float32.min where the residue has no unmasked item. An item is masked
// when bit i & 31 of word excl[u, i >> 5] is set (K1's packed exclusion
// words, not the probe's dense int8 mask, so the floor reads what K1
// reads). Variant B (out_i != null) also writes the item that holds the
// max, the lowest index among equal values, and -1 where out_v is
// float32.min; the TPU folded that index into the value as g·1e-12 because
// its output was one f32 lane.
//
// What bounds it on the H100: the same product as K1 (69,878 x 10,380
// x 50 = 36 G FMA in fp32 on the CUDA cores) and the same ~91 MB of bitmap,
// with a compare (and in B a select) per score in place of K1's threshold
// filter and selection. So the design is K1's tile loop unchanged
// (score_tile.cuh: kRows user rows per block in shared memory, V staged in
// kDTile-column tiles, sequential fmaf), which is what makes this a floor
// of K1: the time it takes is the part of K1's time that no selection
// algorithm can remove. kThreads = 256 is a multiple of 128 and every chunk
// starts at a multiple of 128, so thread t only ever sees residue t & 127
// and keeps its running max (and index) per row in registers. At the end,
// threads t and t + 128 combine through shared memory, and thread t < 128
// writes the row's residue t: coalesced, 512 bytes per row. Small batches
// split the catalog over grid.y as K1 does; each split then writes its own
// partial [n_splits, n_u, 128] and a second kernel folds them in split
// order, so the lowest index still wins a tie.
//
// The entry point returns cudaGetLastError() of its last launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

constexpr int kLanes = 128;                // residues of the item index
constexpr float kFloorNegInf = -FLT_MAX;   // float32.min: no unmasked item

template <typename T, bool kIndex>
__global__ void __launch_bounds__(kThreads)
    floor_pass(const T* __restrict__ U, const T* __restrict__ V,
               const float* __restrict__ bias,
               const int32_t* __restrict__ excl, float* __restrict__ out_v,
               int32_t* __restrict__ out_i, int n_u, int n_i, int d, int dpad,
               int n_words, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Us = reinterpret_cast<float*>(smem);  // [kRows][dpad]
  float* Vs = Us + (size_t)kRows * dpad;         // [kThreads][kVStride]
  __shared__ float hi_v[kRows][kLanes];          // threads 128..255
  __shared__ int32_t hi_i[kRows][kLanes];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int item_begin = blockIdx.y * split_len;
  const int item_end = min(n_i, item_begin + split_len);

  stage_rows(U, Us, row0, n_u, d, dpad);
  float m[kRows];
  int32_t g[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kFloorNegInf;
    g[r] = -1;
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
        if (u >= n_u || excluded(excl, u, n_words, item)) continue;
        const float s = acc[r] + b;
        if (kIndex) {
          if (s > m[r]) {  // items rise, so a tie keeps the lower index
            m[r] = s;
            g[r] = item;
          }
        } else {
          m[r] = fmaxf(m[r], s);
        }
      }
    }
  }

  if (tid >= kLanes) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      hi_v[r][tid - kLanes] = m[r];
      if (kIndex) hi_i[r][tid - kLanes] = g[r];
    }
  }
  __syncthreads();
  if (tid < kLanes) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int u = row0 + r;
      if (u >= n_u) continue;
      const float v = hi_v[r][tid];
      const size_t o = ((size_t)blockIdx.y * n_u + u) * kLanes + tid;
      if (kIndex) {
        // g >= 0 exactly where m > float32.min, so on equal values both
        // indices are real or both are -1
        const int32_t gi = hi_i[r][tid];
        if (v > m[r] || (v == m[r] && gi < g[r])) {
          m[r] = v;
          g[r] = gi;
        }
        out_i[o] = g[r];
      } else {
        m[r] = fmaxf(m[r], v);
      }
      out_v[o] = m[r];
    }
  }
}

// out[e] = the fold of part[s, e] over the splits s in order, e = u·128 + l.
template <bool kIndex>
__global__ void floor_merge(const float* __restrict__ part_v,
                            const int32_t* __restrict__ part_i,
                            float* __restrict__ out_v,
                            int32_t* __restrict__ out_i, int n_u,
                            int n_splits) {
  const size_t n = (size_t)n_u * kLanes;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float m = part_v[e];
  int32_t g = kIndex ? part_i[e] : -1;
  for (int s = 1; s < n_splits; ++s) {
    const float v = part_v[s * n + e];
    if (kIndex) {
      if (v > m) {  // a later split holds higher items: a tie stays put
        m = v;
        g = part_i[s * n + e];
      }
    } else {
      m = fmaxf(m, v);
    }
  }
  out_v[e] = m;
  if (kIndex) out_i[e] = g;
}

template <typename T, bool kIndex>
int launch_floor(const void* U, const void* V, const void* bias,
                 const void* excl, void* out_v, void* out_i, void* part_v,
                 void* part_i, int n_u, int n_i, int d, int n_words,
                 int split_len, int n_splits, cudaStream_t stream) {
  const int dpad = round_up(d, kDTile);
  const size_t smem = sizeof(float) * tile_smem_floats(dpad);
  cudaError_t err = cudaFuncSetAttribute(
      floor_pass<T, kIndex>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool split = n_splits > 1;
  float* pv = static_cast<float*>(split ? part_v : out_v);
  int32_t* pi = static_cast<int32_t*>(split ? part_i : out_i);
  dim3 grid((n_u + kRows - 1) / kRows, n_splits);
  floor_pass<T, kIndex><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<const float*>(bias), static_cast<const int32_t*>(excl), pv,
      pi, n_u, n_i, d, dpad, n_words, split_len);
  if (split) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)n_u * kLanes;
    floor_merge<kIndex><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        pv, pi, static_cast<float*>(out_v), static_cast<int32_t*>(out_i),
        n_u, n_splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_index(bool index, const void* U, const void* V,
                   const void* bias, const void* excl, void* out_v,
                   void* out_i, void* part_v, void* part_i, int n_u, int n_i,
                   int d, int n_words, int split_len, int n_splits,
                   cudaStream_t s) {
  if (index)
    return launch_floor<T, true>(U, V, bias, excl, out_v, out_i, part_v,
                                 part_i, n_u, n_i, d, n_words, split_len,
                                 n_splits, s);
  return launch_floor<T, false>(U, V, bias, excl, out_v, out_i, part_v,
                                part_i, n_u, n_i, d, n_words, split_len,
                                n_splits, s);
}

}  // namespace

extern "C" {

// U [n_u, d], V [n_i, d] (float32 when bf16 == 0, bfloat16 otherwise),
// bias [n_i] float32 or null, excl [n_u, n_words] int32 bit words; out_v
// [n_u, 128] float32, out_i [n_u, 128] int32 or null (variant A). The items
// split into n_splits ranges of split_len (grid.y, split_len a multiple of
// 128); with n_splits > 1, part_v / part_i are [n_splits, n_u, 128]
// scratch (part_i null in variant A). Returns a cudaError_t value (0 = ok).
int tkr_topk_floor(const void* U, const void* V, const void* bias,
                   const void* excl, void* out_v, void* out_i, void* part_v,
                   void* part_i, int n_u, int n_i, int d, int n_words,
                   int split_len, int n_splits, int bf16, void* stream) {
  const bool index = out_i != nullptr;
  if (n_u <= 0 || n_i <= 0 || d <= 0 || d > kMaxD ||
      n_words < (n_i + 31) / 32 || split_len <= 0 ||
      split_len % kLanes != 0 || n_splits <= 0 || n_splits > 65535 ||
      (long long)split_len * n_splits < n_i ||
      (long long)split_len * (n_splits - 1) >= n_i || out_v == nullptr ||
      (n_splits > 1 && (part_v == nullptr || (index && part_i == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_index<__nv_bfloat16>(index, U, V, bias, excl, out_v,
                                         out_i, part_v, part_i, n_u, n_i, d,
                                         n_words, split_len, n_splits, s);
  return dispatch_index<float>(index, U, V, bias, excl, out_v, out_i,
                               part_v, part_i, n_u, n_i, d, n_words,
                               split_len, n_splits, s);
}

}  // extern "C"
