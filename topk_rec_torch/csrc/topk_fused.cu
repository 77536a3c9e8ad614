// K1: fused U·Vᵀ + bias + seen-mask + exact top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in topk_rec_tpu/ops/topk_pallas.py
// (launched by `_fused_call`, public `fused_score_topk`). It computes what
// that kernel computes: per user row, the exact top-k of U·Vᵀ + bias with
// excluded items dropped, ordered by value descending and lowest item index
// first among ties (lax.top_k's order). The [users x items] score matrix
// never reaches device memory.
//
// What bounds it on the H100. At the full MovieLens width (69,878 users x
// 10,380 items, d = 50) the product is 36 G FMA in fp32 on the CUDA cores
// (about 1.1 ms at the 67 TFLOP/s fp32 peak), against about 107 MB read
// (U 14 MB, V 2 MB, the packed exclusion bitmap 91 MB: about 32 us at
// 3.35 TB/s). So it is compute-bound, and the selection competes with the
// FMAs for issue slots. The design keeps both cheap and simple:
//
//  * Pass 1, grid (ceil(n_u / kRows), n_splits), kThreads threads. A block
//    holds kRows user rows in shared memory and walks its split of the
//    catalog in chunks of kThreads items, one item per thread. V is staged
//    into shared memory in tiles of kDTile columns (coalesced loads; a row
//    stride of 36 floats keeps the float4 reads free of bank conflicts).
//    Each thread accumulates kRows dot products with sequential fmaf over
//    d in fp32; bf16 inputs are widened with __bfloat162float, so a bf16
//    product is exact and only the summation rounds. This tile loop lives
//    in score_tile.cuh and is shared with K2 (topk_count.cu).
//  * The seen mask is the packed bitmap itself: bit (i & 31) of word
//    excl[u, i >> 5]. The int8 [rows x items] mask that the TPU kernel
//    reads is never built. Items at or past n_i are never scored.
//  * Selection is a threshold filter. Per row the block keeps its current
//    top-k, sorted, in shared memory, plus a buffer of kBuf candidates. A
//    scored item enters the buffer only if it beats the k-th entry under
//    the total order, so after the first chunks few items pass (about
//    k·ln(n/k) insertions for random order). When the buffer could
//    overflow on the next chunk, and once at the end, one warp per row
//    rebuilds the top-k from top-k ∪ buffer by k rounds of warp arg-max.
//    The result is exact by construction: nothing that could be in the
//    top-k is ever dropped. The TPU kernel's top-3 cascade, m4/m5
//    triggers, suspect re-rank, whole-batch fallback and column spans
//    (topk_pallas.py:145-320, 459-489, 535-577) exist for Mosaic and VMEM
//    limits and have no counterpart here.
//  * Pass 2 (only when n_splits > 1, i.e. small user batches that would
//    leave SMs idle): one warp per row merges the n_splits sorted lists
//    (n_splits <= 32, one list head per lane) by k rounds of warp arg-max.
//
// Output: vals f32 [n_u, k], idx i32 [n_u, k]; slots past the number of
// unexcluded items hold (float32.min, -1). Every entry point returns
// cudaGetLastError() so a refused launch is reported to the caller.
// A later change moves the bf16 mode to tensor cores (mma / wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

constexpr int kBuf = 512;               // candidate buffer slots per row
constexpr int kMaxK = 128;
constexpr float kNegInf = -FLT_MAX;     // float32.min: excluded / empty slot

static_assert(kRows % kWarps == 0 || kWarps % kRows == 0, "row/warp split");
static_assert(kBuf >= kThreads, "a chunk must fit in an empty buffer");

__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__host__ __device__ inline size_t pass1_smem_bytes(int k, int dpad) {
  return sizeof(float) * tile_smem_floats(dpad) +
         (sizeof(float) + sizeof(int)) *
             ((size_t)kRows * (k + kBuf) + (size_t)kWarps * k) +
         sizeof(int) * 2 * kRows;
}

// Rebuild one row's top-k from [0, k + cnt): the sorted top list (its empty
// slots hold (-inf, INT_MAX)) followed by cnt buffered candidates. One warp.
__device__ void flush_row(float* cv, int* ci, int* cnt, int* ntop, float* sv,
                          int* si, int k, int lane) {
  const int n = k + *cnt;
  const int m = min(k, *ntop + *cnt);
  int taken = 0;
  for (; taken < m; ++taken) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    int bp = -1;
    for (int p = lane; p < n; p += 32) {
      const float v = cv[p];
      const int i = ci[p];
      if (beats(v, i, bv, bi)) {
        bv = v;
        bi = i;
        bp = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int op = __shfl_xor_sync(kFull, bp, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    if (bp < 0) break;  // warp-uniform; unreachable for finite scores
    if (lane == 0) {
      sv[taken] = bv;
      si[taken] = bi;
      cv[bp] = -INFINITY;
      ci[bp] = INT_MAX;
    }
    __syncwarp();
  }
  for (int s = lane; s < k; s += 32) {
    cv[s] = s < taken ? sv[s] : -INFINITY;
    ci[s] = s < taken ? si[s] : INT_MAX;
  }
  __syncwarp();
  if (lane == 0) {
    *ntop = taken;
    *cnt = 0;
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_pass1(const T* __restrict__ U, const T* __restrict__ V,
               const float* __restrict__ bias,
               const int32_t* __restrict__ excl, float* __restrict__ out_v,
               int32_t* __restrict__ out_i, int n_u, int n_i, int d, int dpad,
               int n_words, int k, int split_len, int n_splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = k + kBuf;  // per-row candidate stride
  float* Us = reinterpret_cast<float*>(smem);   // [kRows][dpad]
  float* Vs = Us + (size_t)kRows * dpad;          // [kThreads][kVStride]
  float* cand_v = Vs + (size_t)kThreads * kVStride;  // [kRows][cs]
  float* scr_v = cand_v + (size_t)kRows * cs;        // [kWarps][k]
  int* cand_i = reinterpret_cast<int*>(scr_v + (size_t)kWarps * k);
  int* scr_i = cand_i + (size_t)kRows * cs;
  int* cnt = scr_i + (size_t)kWarps * k;
  int* ntop = cnt + kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int item_begin = split * split_len;
  const int item_end = min(n_i, item_begin + split_len);

  stage_rows(U, Us, row0, n_u, d, dpad);
  for (int e = tid; e < kRows * cs; e += kThreads) {
    cand_v[e] = -INFINITY;
    cand_i[e] = INT_MAX;
  }
  if (tid < kRows) {
    cnt[tid] = 0;
    ntop[tid] = 0;
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
        if (excluded(excl, u, n_words, item)) continue;
        const float s = acc[r] + b;
        if (s != s) continue;  // NaN scores are never returned
        if (ntop[r] == k &&
            !beats(s, item, cand_v[r * cs + k - 1], cand_i[r * cs + k - 1]))
          continue;
        const int p = atomicAdd(&cnt[r], 1);
        cand_v[r * cs + k + p] = s;
        cand_i[r * cs + k + p] = item;
      }
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      if (cnt[r] > kBuf - kThreads)
        flush_row(cand_v + r * cs, cand_i + r * cs, cnt + r, ntop + r,
                  scr_v + warp * k, scr_i + warp * k, k, lane);
    }
    __syncthreads();
  }

  for (int r = warp; r < kRows; r += kWarps) {
    if (cnt[r] > 0)
      flush_row(cand_v + r * cs, cand_i + r * cs, cnt + r, ntop + r,
                scr_v + warp * k, scr_i + warp * k, k, lane);
    const int u = row0 + r;
    if (u >= n_u) continue;
    const size_t base = ((size_t)u * n_splits + split) * k;
    const int nt = ntop[r];
    for (int s = lane; s < k; s += 32) {
      out_v[base + s] = s < nt ? cand_v[r * cs + s] : kNegInf;
      out_i[base + s] = s < nt ? cand_i[r * cs + s] : -1;
    }
  }
}

// Merge n_splits (<= 32) sorted per-split lists into one top-k per row.
__global__ void topk_merge(const float* __restrict__ in_v,
                           const int32_t* __restrict__ in_i,
                           float* __restrict__ out_v,
                           int32_t* __restrict__ out_i, int n_u, int n_splits,
                           int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= n_u) return;  // warp-uniform
  const float* rv = in_v + (size_t)row * n_splits * k + (size_t)lane * k;
  const int32_t* ri = in_i + (size_t)row * n_splits * k + (size_t)lane * k;
  int h = 0;
  float hv = -INFINITY;
  int hi = INT_MAX;
  if (lane < n_splits && ri[0] >= 0) {
    hv = rv[0];
    hi = ri[0];
  }
  for (int s = 0; s < k; ++s) {
    float bv = hv;
    int bi = hi;
    int bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bl = ol;
      }
    }
    if (bi == INT_MAX) {  // every list exhausted (warp-uniform)
      for (int t = s + lane; t < k; t += 32) {
        out_v[(size_t)row * k + t] = kNegInf;
        out_i[(size_t)row * k + t] = -1;
      }
      return;
    }
    if (lane == 0) {
      out_v[(size_t)row * k + s] = bv;
      out_i[(size_t)row * k + s] = bi;
    }
    if (lane == bl) {
      ++h;
      hv = -INFINITY;
      hi = INT_MAX;
      if (h < k && ri[h] >= 0) {
        hv = rv[h];
        hi = ri[h];
      }
    }
  }
}

template <typename T>
int launch(const void* U, const void* V, const void* bias, const void* excl,
           void* out_v, void* out_i, void* scratch_v, void* scratch_i, int n_u,
           int n_i, int d, int k, int n_words, int split_len, int n_splits,
           cudaStream_t stream) {
  const int dpad = round_up(d, kDTile);
  const size_t smem = pass1_smem_bytes(k, dpad);
  cudaError_t err = cudaFuncSetAttribute(
      topk_pass1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool merged = n_splits > 1;
  dim3 grid((n_u + kRows - 1) / kRows, n_splits);
  topk_pass1<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(U), static_cast<const T*>(V),
      static_cast<const float*>(bias), static_cast<const int32_t*>(excl),
      static_cast<float*>(merged ? scratch_v : out_v),
      static_cast<int32_t*>(merged ? scratch_i : out_i), n_u, n_i, d, dpad,
      n_words, k, split_len, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merged) return (int)err;
  const int rows_per_block = 8;
  topk_merge<<<(n_u + rows_per_block - 1) / rows_per_block,
               rows_per_block * 32, 0, stream>>>(
      static_cast<const float*>(scratch_v),
      static_cast<const int32_t*>(scratch_i), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), n_u, n_splits, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it launches (k <= 128 is checked there
// too, without the library, so that CPU callers see the same error).
int tkr_topk_max_d() { return kMaxD; }
int tkr_topk_chunk() { return kThreads; }
const char* tkr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// U [n_u, d], V [n_i, d] (float32 when bf16 == 0, bfloat16 otherwise),
// bias [n_i] float32 or null, excl [n_u, n_words] int32 bit words,
// out_v [n_u, k] float32, out_i [n_u, k] int32; scratch_* [n_u, n_splits, k]
// are read only when n_splits > 1. Returns a cudaError_t value (0 = ok).
int tkr_topk_fused(const void* U, const void* V, const void* bias,
                   const void* excl, void* out_v, void* out_i,
                   void* scratch_v, void* scratch_i, int n_u, int n_i, int d,
                   int k, int n_words, int split_len, int n_splits, int bf16,
                   void* stream) {
  if (n_u <= 0 || n_i <= 0 || d <= 0 || d > kMaxD || k <= 0 || k > kMaxK ||
      n_words < (n_i + 31) / 32 || split_len <= 0 || n_splits <= 0 ||
      n_splits > 32 || (long long)split_len * (n_splits - 1) >= n_i)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(U, V, bias, excl, out_v, out_i, scratch_v,
                                 scratch_i, n_u, n_i, d, k, n_words, split_len,
                                 n_splits, s);
  return launch<float>(U, V, bias, excl, out_v, out_i, scratch_v, scratch_i,
                       n_u, n_i, d, k, n_words, split_len, n_splits, s);
}

}  // extern "C"
