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
// 10,380 items, d = 50: 4.25 G FMA in fp32, 0.127 ms at 67 TFLOP/s) against
// about 14 MB of bitmap, tables and counts. It is bound by operations, and
// the count is a few compares per score. So the design is the tile loop of
// score_tile_sm90.cuh with 64 users x 128 items per block (fp32: a 4 x 8
// register micro-tile of sequential fmaf per thread; bf16: mma.sync on the
// tensor cores), V double-buffered by cp.async, followed by per-thread
// counters in registers. A score below t - (2e-4·|t| + 4e-6) is in neither
// count, so only the few that reach it read their bit word. At the end of its item
// range each thread adds its counters into the block's shared counters, and
// one thread per row adds those into the output with atomicAdd (int32, so
// the total does not depend on the order). Small batches split the catalog
// over grid.y, as K1 does, so that enough blocks run; the splits meet in the
// same atomics and need no second pass.
//
// The eps arithmetic uses __fmul_rn / __fadd_rn / __fsub_rn so that nvcc
// cannot contract it into an fma: the rounding then matches the plain twin's
// separate multiply and add. Output gt, eq: int32 [n_u], zeroed by the
// caller. The entry points return a cudaError_t value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "score_tile_sm90.cuh"

namespace {

constexpr int kCountBM = 64;              // users per block
constexpr int kCountBN = 128;             // items per tile
constexpr int kCountNT = 256;             // threads per block
constexpr float kCountNegInf = -FLT_MAX;  // float32.min: an excluded score

using CountFma = FmaTile<kCountBM, kCountBN, 4, 8>;
using CountMma = MmaTile<kCountBM, kCountBN, kCountNT>;
static_assert(CountFma::kThreads == kCountNT, "fp32 tile threads");

// K2's epilogue on the tile loop: per-thread counters of its rows.
template <class Tile>
struct Count {
  float t[Tile::RPT];
  float lo[Tile::RPT];  // scores below lo are in neither count
  int gt[Tile::RPT];
  int eq[Tile::RPT];
  float bc[Tile::CPT];  // the bias of this thread's columns of the tile
  const float* bias;
  const int32_t* excl;
  int row0, n_u, n_words, item_end;

  // lo = t - (2e-4·|t| + 4e-6), -inf where that overflows or t is not
  // finite. For s < lo, s > t + eps is false since s < t; and |s - t| >
  // eps: if |s| <= |t|, t - s > 2e-4·|t| + 4e-6 >= twice eps; if |s| > |t|
  // then s < 0, and either t >= 0 and t - s >= |s| > 1e-4·|s| + 1e-6, or
  // t < 0 and x = |s| - |t| > 2e-4·|t| + 4e-6 gives 0.9999·x > 1e-4·|t| +
  // 1e-6, i.e. x > eps. Each margin is far wider than the roundings of
  // eps and s - t. An excluded item scores float32.min, below every finite
  // lo, so the excluded bit is read only for scores that pass.
  __device__ __forceinline__ void set_threshold(int ri, float tr) {
    t[ri] = tr;
    const float m = 2e-4f * fabsf(tr) + 4e-6f;
    const float l = tr - m;
    lo[ri] = isfinite(l) ? l : -INFINITY;
  }

  __device__ __forceinline__ void prefetch(const Tile& tl, int c0) {
    load_bias(bc, tl, bias, c0, item_end);
  }

  __device__ __forceinline__ void tile(const Tile& tl, int c0) {
#pragma unroll
    for (int cj = 0; cj < Tile::CPT; ++cj) {
      const int item = c0 + tl.col(cj);
      if (item >= item_end) continue;
#pragma unroll
      for (int ri = 0; ri < Tile::RPT; ++ri) {
        const float raw = tl.val(ri, cj) + bc[cj];
        if (raw < lo[ri]) continue;
        const int u = row0 + tl.row(ri);
        if (u >= n_u) continue;
        const float s = excluded(excl, n_words, u, item) ? kCountNegInf : raw;
        const float eps = __fadd_rn(
            __fmul_rn(1e-4f, fmaxf(fabsf(t[ri]), fabsf(s))), 1e-6f);
        gt[ri] += s > __fadd_rn(t[ri], eps);
        eq[ri] += fabsf(__fsub_rn(s, t[ri])) <= eps;
      }
    }
  }
};

// Two blocks per SM: at most 128 registers a thread.
template <class Tile>
__global__ void __launch_bounds__(kCountNT, 2)
    count_pass(TileArgs<typename Tile::Elem> a, const float* __restrict__ thr,
               int32_t* __restrict__ out_gt, int32_t* __restrict__ out_eq,
               int n_i, int split_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int blk_gt[kCountBM];
  __shared__ int blk_eq[kCountBM];
  a.row0 = blockIdx.x * kCountBM;
  a.item_begin = blockIdx.y * split_len;
  a.item_end = min(n_i, a.item_begin + split_len);

  const Tile probe;  // the rows this thread holds
  Count<Tile> cnt;
  cnt.bias = a.bias;
  cnt.excl = a.excl;
  cnt.row0 = a.row0;
  cnt.n_u = a.n_u;
  cnt.n_words = a.n_words;
  cnt.item_end = a.item_end;
#pragma unroll
  for (int ri = 0; ri < Tile::RPT; ++ri) {
    const int u = a.row0 + probe.row(ri);
    cnt.set_threshold(ri, u < a.n_u ? thr[u] : 0.f);
    cnt.gt[ri] = 0;
    cnt.eq[ri] = 0;
  }
  for (int r = threadIdx.x; r < kCountBM; r += kCountNT) {
    blk_gt[r] = 0;
    blk_eq[r] = 0;
  }
  __syncthreads();
  run_tiles<Tile, kCountBM, kCountBN>(a, smem, cnt);

#pragma unroll
  for (int ri = 0; ri < Tile::RPT; ++ri) {
    if (cnt.gt[ri] | cnt.eq[ri]) {
      atomicAdd(&blk_gt[probe.row(ri)], cnt.gt[ri]);
      atomicAdd(&blk_eq[probe.row(ri)], cnt.eq[ri]);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kCountBM; r += kCountNT) {
    if (a.row0 + r < a.n_u && (blk_gt[r] | blk_eq[r])) {
      atomicAdd(&out_gt[a.row0 + r], blk_gt[r]);
      atomicAdd(&out_eq[a.row0 + r], blk_eq[r]);
    }
  }
}

template <bool kBf16>
struct CountPass {
  using Tile = typename std::conditional<kBf16, CountMma, CountFma>::type;
  using T = typename Tile::Elem;
  static size_t smem(int d) {
    return tile_smem_bytes(kCountBM, kCountBN, d, kBf16);
  }
  static cudaError_t prepare(int d) {
    return cudaFuncSetAttribute(count_pass<Tile>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem(d));
  }
};

template <bool kBf16>
int launch_count(const void* U, const void* V, const void* bias,
                 const void* excl, const void* thr, void* out_gt, void* out_eq,
                 int n_u, int n_i, int d, int n_words, int split_len,
                 int n_splits, cudaStream_t stream) {
  using P = CountPass<kBf16>;
  using T = typename P::T;
  cudaError_t err = P::prepare(d);
  if (err != cudaSuccess) return (int)err;
  TileArgs<T> a{static_cast<const T*>(U), static_cast<const T*>(V),
                static_cast<const float*>(bias),
                static_cast<const int32_t*>(excl), n_u, d, n_words, 0, 0, 0};
  dim3 grid((n_u + kCountBM - 1) / kCountBM, n_splits);
  count_pass<typename P::Tile><<<grid, kCountNT, P::smem(d), stream>>>(
      a, static_cast<const float*>(thr), static_cast<int32_t*>(out_gt),
      static_cast<int32_t*>(out_eq), n_i, split_len);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int count_occupancy(int d, int* blocks) {
  using P = CountPass<kBf16>;
  cudaError_t err = P::prepare(d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, count_pass<typename P::Tile>, kCountNT, P::smem(d));
}

}  // namespace

extern "C" {

// K2's geometry at (d, mode): *rows users per block, *tile items per tile
// (a split is a whole number of tiles), *blocks resident blocks per SM.
int tkr_count_geometry(int d, int bf16, int* rows, int* tile, int* blocks) {
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  *rows = kCountBM;
  *tile = kCountBN;
  return bf16 ? count_occupancy<true>(d, blocks)
              : count_occupancy<false>(d, blocks);
}

// U [n_u, d], V [n_i, d] (float32 when bf16 == 0, bfloat16 otherwise),
// contiguous, rows and bases 16-byte aligned (see kernel_table in
// ops/topk_fused.py), bias [n_i] float32 or null, excl [n_u, n_words] int32
// bit words, thr [n_u] float32; out_gt, out_eq [n_u] int32, zeroed. The items
// split into n_splits ranges of split_len (grid.y), a multiple of the tile.
// Returns a cudaError_t value (0 = ok).
int tkr_count_vs_threshold(const void* U, const void* V, const void* bias,
                           const void* excl, const void* thr, void* out_gt,
                           void* out_eq, int n_u, int n_i, int d, int n_words,
                           int split_len, int n_splits, int bf16,
                           void* stream) {
  if (n_u <= 0 || n_i <= 0 || d <= 0 || d > kMaxD ||
      n_words < (n_i + 31) / 32 || split_len <= 0 ||
      split_len % kCountBN != 0 || n_splits <= 0 || n_splits > 65535 ||
      (long long)split_len * n_splits < n_i ||
      (long long)split_len * (n_splits - 1) >= n_i ||
      !rows_aligned(d, bf16, U, V))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_count<true>(U, V, bias, excl, thr, out_gt, out_eq, n_u, n_i,
                              d, n_words, split_len, n_splits, s);
  return launch_count<false>(U, V, bias, excl, thr, out_gt, out_eq, n_u, n_i,
                             d, n_words, split_len, n_splits, s);
}

}  // extern "C"
