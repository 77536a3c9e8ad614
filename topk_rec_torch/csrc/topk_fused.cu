// K1: fused U·Vᵀ + bias + seen-mask + exact top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in topk_rec_tpu/ops/topk_pallas.py
// (launched by `_fused_call`, public `fused_score_topk`). It computes what
// that kernel computes: per user row, the exact top-k of U·Vᵀ + bias with
// excluded items dropped, ordered by value descending and lowest item index
// first among ties (lax.top_k's order). The [users x items] score matrix
// never reaches device memory.
//
// What bounds it on the H100. One evaluate chunk (8,192 users x 10,380
// items, d = 50) is 4.25 G FMA, 0.127 ms at the 67 TFLOP/s fp32 peak,
// against about 16 MB read (0.005 ms at 3.35 TB/s): it is bound by
// operations, and the selection competes with the FMAs for issue slots.
// In bf16 on the tensor cores the product is cheap and a served batch of
// 256 users is bound by its loads, its selection and the launch. The
// design:
//
//  * Pass 1, grid (ceil(n_u / BM), n_splits), on the tile loop of
//    score_tile_sm90.cuh: a block owns BM users, walks its split of the
//    catalog in tiles of BN = 128 items with cp.async double buffering, and
//    scores each tile in registers (fp32: a 4 x 8 micro-tile per thread of
//    sequential fmaf; bf16: mma.sync on the tensor cores).
//  * Selection is a threshold filter. Per row the block keeps its current
//    top-k, sorted, in shared memory, plus a buffer of candidates (32 for k
//    <= 32). For each tile a thread reads each of its rows' k-th entry once
//    into registers; a score is offered to the buffer only if it beats
//    that entry under the total order (`beats`) and is not NaN. After the
//    tile a warp rebuilds each of its rows whose buffer is half full or
//    overflowed: it drops the buffered items the user has seen (one bit
//    word per lane), and for k <= 32 sorts the buffer in registers and
//    merges it into the top-k (20 warp exchanges); larger k sorts the row.
//    The scores that found the buffer full are then offered again against
//    the new k-th entry. Nothing that could be in the top-k is dropped, so
//    the result is exact by construction. For random order about
//    k·ln(n/k) scores pass in all, and a row is rebuilt about ten times
//    over 10,380 items at k = 30. In fp32 a warp holds all the scores of
//    its rows, so the selection synchronises that warp only; the bf16
//    tile shares rows between warps and synchronises the block. Rows not
//    yet full read their seen words with the tile, so a user with fewer
//    than k unseen items does not fill the buffer on every tile. The TPU
//    kernel's top-3 cascade, m4/m5 triggers, suspect re-rank, whole-batch
//    fallback and column spans (topk_pallas.py:145-320, 459-489, 535-577)
//    exist for Mosaic and VMEM limits and have no counterpart here.
//  * Pass 2 (only when n_splits > 1, i.e. small user batches that would
//    leave SMs idle): one warp per row merges the n_splits sorted lists
//    (n_splits <= 32, one list head per lane) by k rounds of warp arg-max.
//
// BM is 64 in fp32 and 32 in bf16 (kBMFp32, kBMBf16): the fastest of 16,
// 32 and 64 rows per block at 8,192 x 10,380, d = 50, on the H100
// (PERF.md, "Rows per block").
//
// Output: vals f32 [n_u, k], idx i32 [n_u, k]; slots past the number of
// unexcluded items hold (float32.min, -1). Every entry point returns a
// cudaError_t value so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "score_tile_sm90.cuh"

namespace {

constexpr int kBN = 128;                // items per tile
constexpr int kBMFp32 = 64;             // user rows per block, fp32
constexpr int kBMBf16 = 32;             // and bf16
constexpr int kMaxK = 128;
constexpr float kNegInf = -FLT_MAX;     // float32.min: excluded / empty slot

__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// The tiles of each BM, 256 threads: fp32 micro-tiles of BM/16 x 8 and the
// bf16 warp grid of BM/16 warps down. Eight warps, two blocks per SM, so
// that the latency of the shared-memory loads and the epilogue is hidden.
template <int BM> struct Tiles {
  using Fma = FmaTile<BM, kBN, BM / 16, 8>;
  using Mma = MmaTile<BM, kBN, 256>;
  static_assert(Fma::kThreads == 256, "fp32 tile threads");
};

// Slots of a row: the sorted top-k, then a buffer of row_cap(k)
// candidates; a power of two of at least k + 32, at most 256 (the most the
// register sort takes). For k <= 32 the buffer holds 32, one per lane.
__host__ __device__ inline int row_slots(int k) {
  int cs = 64;
  while (cs < k + 32) cs <<= 1;
  return cs;
}
__host__ __device__ inline int row_cap(int k) {
  return k <= 32 ? 32 : row_slots(k) - k;
}

__host__ __device__ inline size_t select_bytes(int bm, int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)bm * row_slots(k) +
         sizeof(int) * 2 * bm;
}

__host__ __device__ inline size_t pass1_smem_bytes(int bm, int k, int d,
                                                   bool bf16) {
  return tile_smem_bytes(bm, kBN, d, bf16) + select_bytes(bm, k);
}

// Bitonic sort of P = 32·E (value, index) pairs held in a warp's registers,
// element g = e·32 + lane, into `beats` order, best first. Strides below 32
// pair lanes (shuffles); strides of 32 and up pair a lane's own registers.
// Empty slots hold (-inf, INT_MAX) and sort last.
template <int E, int J>
__device__ __forceinline__ void sort_in_lane(float (&v)[E], int (&ix)[E],
                                             int size, int lane) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & J) continue;
    const int f = e | J;
    const bool best_first = ((e * 32 + lane) & size) == 0;
    if (best_first ? beats(v[f], ix[f], v[e], ix[e])
                   : beats(v[e], ix[e], v[f], ix[f])) {
      const float tv = v[e];
      const int ti = ix[e];
      v[e] = v[f];
      ix[e] = ix[f];
      v[f] = tv;
      ix[f] = ti;
    }
  }
}

template <int E>
__device__ void sort_warp(float (&v)[E], int (&ix)[E], int lane) {
  constexpr int P = 32 * E;
#pragma unroll 1
  for (int size = 2; size <= P; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int j = stride >> 5;
        if (j == 1) sort_in_lane<E, 1>(v, ix, size, lane);
        if (E > 2 && j == 2) sort_in_lane<E, (E > 2 ? 2 : 1)>(v, ix, size, lane);
        if (E > 4 && j == 4) sort_in_lane<E, (E > 4 ? 4 : 1)>(v, ix, size, lane);
        continue;
      }
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ov = __shfl_xor_sync(kFull, v[e], stride);
        const int oi = __shfl_xor_sync(kFull, ix[e], stride);
        const bool best_first = ((e * 32 + lane) & size) == 0;
        const bool take = lower == best_first ? beats(ov, oi, v[e], ix[e])
                                              : beats(v[e], ix[e], ov, oi);
        if (take) {
          v[e] = ov;
          ix[e] = oi;
        }
      }
    }
  }
}

// Sort slots [0, 32·E) of one row in registers and write them back.
template <int E>
__device__ __noinline__ void sort_slots(float* cv, int* ci, int lane) {
  float v[E];
  int ix[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = cv[e * 32 + lane];
    ix[e] = ci[e * 32 + lane];
  }
  sort_warp<E>(v, ix, lane);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    cv[e * 32 + lane] = v[e];
    ci[e * 32 + lane] = ix[e];
  }
}

// Sort the first n of a row's slots (the rest are empty) into `beats`
// order: the smallest power of two >= n, at least 32 and at most 256.
__device__ void sort_row(float* cv, int* ci, int n, int lane) {
  if (n <= 32) sort_slots<1>(cv, ci, lane);
  else if (n <= 64) sort_slots<2>(cv, ci, lane);
  else if (n <= 128) sort_slots<4>(cv, ci, lane);
  else sort_slots<8>(cv, ci, lane);
  __syncwarp();
}

// One (value, index) per lane, sorted across the warp into `beats` order,
// best at lane 0 (bitonic network, 15 exchanges).
__device__ __forceinline__ void sort32(float& v, int& ix, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, stride);
      const int oi = __shfl_xor_sync(kFull, ix, stride);
      const bool best_first = (lane & size) == 0 || size == 32;
      const bool lower = (lane & stride) == 0;
      if (lower == best_first ? beats(ov, oi, v, ix) : beats(v, ix, ov, oi)) {
        v = ov;
        ix = oi;
      }
    }
}

// (tv, ti) and (bv, bi) each sorted across the warp, best at lane 0: leave
// the best 32 of both in (tv, ti), sorted. The better of a[l] and b[31 - l]
// at each lane l is the best 32 as a bitonic sequence; five exchanges sort
// it.
__device__ __forceinline__ void merge32(float& tv, int& ti, float bv, int bi,
                                        int lane) {
  const float ov = __shfl_sync(kFull, bv, 31 - lane);
  const int oi = __shfl_sync(kFull, bi, 31 - lane);
  if (beats(ov, oi, tv, ti)) {
    tv = ov;
    ti = oi;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float xv = __shfl_xor_sync(kFull, tv, stride);
    const int xi = __shfl_xor_sync(kFull, ti, stride);
    const bool lower = (lane & stride) == 0;
    if (lower ? beats(xv, xi, tv, ti) : beats(tv, ti, xv, xi)) {
      tv = xv;
      ti = xi;
    }
  }
}

// The selection state of a block's rows, and K1's epilogue on the tile loop.
// Per row: slots [0, k) hold the current top-k, sorted in `beats` order
// (empty slots are (-inf, INT_MAX) and sort last); slots [k, k + cap) are a
// buffer of candidates in arrival order. Warp w rebuilds rows [w·RW, (w +
// 1)·RW); when the tile gives a warp exactly those rows (Tile::kWarpRows,
// the fp32 tile), the epilogue synchronises that warp only.
template <int BM, class Tile>
struct Select {
  static constexpr int NT = Tile::kThreads;
  static constexpr int RW = BM / (NT / 32);  // rows a warp rebuilds
  float* cand_v;  // [BM][cs]
  int* cand_i;
  int* cnt;       // [BM] candidates offered to the buffer this round
  int* ntop;      // [BM] valid top-k entries
  const float* bias;
  const int32_t* excl;
  int k, cs, cap, row0, n_u, n_words, item_end;
  uint32_t failed = 0;  // this thread's scores that found their buffer full
  float bc[Tile::CPT];  // the bias of this thread's columns of the tile

  template <typename T>
  __device__ Select(unsigned char* base, const TileArgs<T>& a, int k_)
      : bias(a.bias), excl(a.excl), k(k_), cs(row_slots(k_)),
        cap(row_cap(k_)), row0(a.row0), n_u(a.n_u),
        n_words(a.n_words), item_end(a.item_end) {
    cand_v = reinterpret_cast<float*>(base);
    cand_i = reinterpret_cast<int*>(cand_v + (size_t)BM * cs);
    cnt = cand_i + (size_t)BM * cs;
    ntop = cnt + BM;
    for (int e = threadIdx.x; e < BM * cs; e += NT) {
      cand_v[e] = -INFINITY;
      cand_i[e] = INT_MAX;
    }
    for (int r = threadIdx.x; r < BM; r += NT) {
      cnt[r] = 0;
      ntop[r] = 0;
    }
  }

  __device__ __forceinline__ void prefetch(const Tile& t, int c0) {
    load_bias(bc, t, bias, c0, item_end);
  }

  // Offer the tile's scores to the buffers. A score is offered only if it
  // reaches its row's k-th entry (read once per tile; -inf while the row is
  // not full, NaN for rows past n_u), so that NaN scores and almost every
  // score of a late tile fail the first compare; then only if its item is
  // in the split and it beats the k-th entry under the total order. A full
  // row's seen bits are read when it is rebuilt, one entry per lane; a row
  // not yet full offers every score, so its seen words for the tile are
  // read here, all at once, and its seen items never take a slot (a user
  // with fewer than k unseen items would otherwise fill the buffer on
  // every tile). On a retry only the scores that found their buffer full
  // are offered again.
  __device__ __forceinline__ void offer(const Tile& t, int c0, bool retry) {
    static_assert(Tile::RPT * Tile::CPT <= 32, "one bit per score");
    constexpr int kWords = kBN / 32;
    float lo[Tile::RPT], tv[Tile::RPT];
    int ti[Tile::RPT];
    uint32_t seen[Tile::RPT][kWords];
#pragma unroll
    for (int ri = 0; ri < Tile::RPT; ++ri) {
      const int r = t.row(ri);
      tv[ri] = cand_v[r * cs + k - 1];
      ti[ri] = cand_i[r * cs + k - 1];
      lo[ri] = row0 + r >= n_u ? NAN : ntop[r] == k ? tv[ri] : -INFINITY;
      const int32_t* w = excl + (size_t)(row0 + r) * n_words + (c0 >> 5);
#pragma unroll
      for (int j = 0; j < kWords; ++j)
        seen[ri][j] = !retry && lo[ri] == -INFINITY && (c0 >> 5) + j < n_words
                          ? static_cast<uint32_t>(__ldg(w + j)) : 0u;
    }
    uint32_t left = 0;
#pragma unroll
    for (int cj = 0; cj < Tile::CPT; ++cj) {
      const int n = t.col(cj);
      const int item = c0 + n;
#pragma unroll
      for (int ri = 0; ri < Tile::RPT; ++ri) {
        const uint32_t bit = 1u << (ri * Tile::CPT + cj);
        if (retry && !(failed & bit)) continue;
        const float s = t.val(ri, cj) + bc[cj];
        if (!(s >= lo[ri]) || item >= item_end) continue;
        uint32_t word = seen[ri][0];
#pragma unroll
        for (int j = 1; j < kWords; ++j)
          if ((n >> 5) == j) word = seen[ri][j];
        if ((word >> (n & 31)) & 1u) continue;
        const int r = t.row(ri);
        if (lo[ri] != -INFINITY && !beats(s, item, tv[ri], ti[ri])) continue;
        const int p = atomicAdd(&cnt[r], 1);
        if (p < cap) {
          cand_v[r * cs + k + p] = s;
          cand_i[r * cs + k + p] = item;
        } else {
          left |= bit;
        }
      }
    }
    failed = left;
  }

  // Rebuild row r's top-k from top-k ∪ buffer, dropping the buffered items
  // the user has seen: keep the best k in order, empty the rest. One warp.
  // For k <= 32 each lane holds one top-k entry and one buffer entry: the
  // buffer is sorted in registers and merged into the top-k; larger k sorts
  // the row's slots. Only a flush changes ntop, so every entry of the
  // buffer was offered while the row was full, or every one while it was
  // not, and then offer() has already dropped the seen ones.
  __device__ void flush(int r) {
    const int lane = threadIdx.x & 31;
    float* cv = cand_v + r * cs;
    int* ci = cand_i + r * cs;
    const int nb = min(cnt[r], cap);
    const int u = row0 + r;
    const bool check = ntop[r] == k;
    int kept;
    if (k <= 32) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      if (lane < nb) {
        bv = cv[k + lane];
        bi = ci[k + lane];
        if (check && excluded(excl, n_words, u, bi)) {
          bv = -INFINITY;
          bi = INT_MAX;
        }
        cv[k + lane] = -INFINITY;
        ci[k + lane] = INT_MAX;
      }
      kept = __popc(__ballot_sync(kFull, bi != INT_MAX));
      sort32(bv, bi, lane);
      float tv = lane < k ? cv[lane] : -INFINITY;
      int ti = lane < k ? ci[lane] : INT_MAX;
      merge32(tv, ti, bv, bi, lane);
      if (lane < k) {
        cv[lane] = tv;
        ci[lane] = ti;
      }
    } else {
      int ex = 0;
      for (int p = k + lane; check && p < k + nb; p += 32)
        if (excluded(excl, n_words, u, ci[p])) {
          cv[p] = -INFINITY;
          ci[p] = INT_MAX;
          ++ex;
        }
      kept = nb - __reduce_add_sync(kFull, ex);
      __syncwarp();
      sort_row(cv, ci, k + nb, lane);
      for (int p = k + lane; p < k + nb; p += 32) {
        cv[p] = -INFINITY;
        ci[p] = INT_MAX;
      }
    }
    __syncwarp();
    if (lane == 0) {
      ntop[r] = min(k, ntop[r] + kept);
      cnt[r] = 0;
    }
    __syncwarp();
  }

  // After a round of offers: rebuild this warp's rows whose buffer
  // overflowed or is half full, and those not yet full that now hold k
  // candidates, so that their threshold rises.
  __device__ __forceinline__ void after_offer() {
    const int r0 = (threadIdx.x >> 5) * RW;
    for (int r = r0; r < r0 + RW; ++r) {
      const int c = cnt[r], nt = ntop[r];
      if (c > cap / 2 || (nt < k && nt + c >= k)) flush(r);
    }
  }

  // The tile epilogue. Every score that could be in the top-k is offered
  // until it has a slot: a row whose buffer overflowed is rebuilt and the
  // scores that found it full are offered again against the new k-th
  // entry, so nothing is dropped and the result is exact by construction.
  // Scores that rise with the item index pass every tile and take several
  // rounds each: slow, still exact.
  __device__ __forceinline__ void tile(const Tile& t, int c0) {
    offer(t, c0, false);
    for (;;) {
      bool again;
      if (Tile::kWarpRows) {
        again = __any_sync(kFull, failed != 0);
        __syncwarp();
      } else {
        again = __syncthreads_or(failed != 0);
      }
      after_offer();
      if (!again) break;
      if (Tile::kWarpRows) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      offer(t, c0, true);
    }
  }
};

template <int BM, class Tile>
__global__ void __launch_bounds__(Tile::kThreads, 2)
    topk_pass1(TileArgs<typename Tile::Elem> a, float* __restrict__ out_v,
               int32_t* __restrict__ out_i, int n_i, int k, int split_len,
               int n_splits) {
  using T = typename Tile::Elem;
  using Sel = Select<BM, Tile>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.y;
  a.row0 = blockIdx.x * BM;
  a.item_begin = split * split_len;
  a.item_end = min(n_i, a.item_begin + split_len);
  Sel sel(smem + tile_smem_bytes(BM, kBN, a.d, kBf16), a, k);
  __syncthreads();
  run_tiles<Tile, BM, kBN>(a, smem, sel);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * Sel::RW;
  for (int r = r0; r < r0 + Sel::RW; ++r) {
    if (sel.cnt[r] > 0) sel.flush(r);
    const int u = a.row0 + r;
    if (u >= a.n_u) continue;
    const size_t base = ((size_t)u * n_splits + split) * k;
    const int nt = sel.ntop[r];
    for (int s = lane; s < k; s += 32) {
      out_v[base + s] = s < nt ? sel.cand_v[r * sel.cs + s] : kNegInf;
      out_i[base + s] = s < nt ? sel.cand_i[r * sel.cs + s] : -1;
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

// The pass-1 kernel of one (BM, mode), its threads and shared memory.
template <int BM, bool kBf16>
struct Pass1 {
  using Tile = typename std::conditional<kBf16, typename Tiles<BM>::Mma,
                                         typename Tiles<BM>::Fma>::type;
  using T = typename Tile::Elem;
  static constexpr int NT = Tile::kThreads;
  static size_t smem(int k, int d) {
    return pass1_smem_bytes(BM, k, d, kBf16);
  }
  static cudaError_t prepare(int k, int d) {
    return cudaFuncSetAttribute(topk_pass1<BM, Tile>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem(k, d));
  }
};

template <int BM, bool kBf16>
int launch(const void* U, const void* V, const void* bias, const void* excl,
           void* out_v, void* out_i, void* scratch_v, void* scratch_i, int n_u,
           int n_i, int d, int k, int n_words, int split_len, int n_splits,
           cudaStream_t stream) {
  using P = Pass1<BM, kBf16>;
  using T = typename P::T;
  cudaError_t err = P::prepare(k, d);
  if (err != cudaSuccess) return (int)err;
  const bool merged = n_splits > 1;
  TileArgs<T> a{static_cast<const T*>(U), static_cast<const T*>(V),
                static_cast<const float*>(bias),
                static_cast<const int32_t*>(excl), n_u, d, n_words, 0, 0, 0};
  dim3 grid((n_u + BM - 1) / BM, n_splits);
  topk_pass1<BM, typename P::Tile><<<grid, P::NT, P::smem(k, d), stream>>>(
      a, static_cast<float*>(merged ? scratch_v : out_v),
      static_cast<int32_t*>(merged ? scratch_i : out_i), n_i, k, split_len,
      n_splits);
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

// Resident blocks per SM of the pass-1 kernel of one mode at (k, d).
template <int BM, bool kBf16>
int occupancy(int k, int d, int* blocks) {
  using P = Pass1<BM, kBf16>;
  cudaError_t err = P::prepare(k, d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, topk_pass1<BM, typename P::Tile>, P::NT, P::smem(k, d));
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it launches (k <= 128 is checked there
// too, without the library, so that CPU callers see the same error).
int tkr_topk_max_d() { return kMaxD; }
const char* tkr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pass 1's geometry at (k, d, mode): *rows users per block, *tile items per
// tile (a split is a whole number of tiles), *blocks resident blocks per SM
// (0 if it cannot run).
int tkr_topk_geometry(int k, int d, int bf16, int* rows, int* tile,
                      int* blocks) {
  if (k <= 0 || k > kMaxK || d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  *rows = bf16 ? kBMBf16 : kBMFp32;
  *tile = kBN;
  return bf16 ? occupancy<kBMBf16, true>(k, d, blocks)
              : occupancy<kBMFp32, false>(k, d, blocks);
}

// U [n_u, d], V [n_i, d] (float32 when bf16 == 0, bfloat16 otherwise),
// contiguous, rows and bases 16-byte aligned (see kernel_table in
// ops/topk_fused.py), bias [n_i] float32 or null, excl [n_u, n_words] int32
// bit words, out_v [n_u, k] float32, out_i [n_u, k] int32; scratch_* [n_u,
// n_splits, k] are read only when n_splits > 1. The items split into
// n_splits ranges of split_len, a multiple of the tile. Returns a
// cudaError_t value (0 = ok).
int tkr_topk_fused(const void* U, const void* V, const void* bias,
                   const void* excl, void* out_v, void* out_i,
                   void* scratch_v, void* scratch_i, int n_u, int n_i, int d,
                   int k, int n_words, int split_len, int n_splits, int bf16,
                   void* stream) {
  if (n_u <= 0 || n_i <= 0 || d <= 0 || d > kMaxD || k <= 0 || k > kMaxK ||
      n_words < (n_i + 31) / 32 || split_len <= 0 || split_len % kBN != 0 ||
      n_splits <= 0 || n_splits > 32 ||
      (long long)split_len * n_splits < n_i ||
      (long long)split_len * (n_splits - 1) >= n_i ||
      !rows_aligned(d, bf16, U, V) ||
      (n_splits > 1 && (scratch_v == nullptr || scratch_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<kBMBf16, true>(U, V, bias, excl, out_v, out_i, scratch_v,
                                 scratch_i, n_u, n_i, d, k, n_words,
                                 split_len, n_splits, s);
  return launch<kBMFp32, false>(U, V, bias, excl, out_v, out_i, scratch_v,
                                scratch_i, n_u, n_i, d, k, n_words, split_len,
                                n_splits, s);
}

}  // extern "C"
