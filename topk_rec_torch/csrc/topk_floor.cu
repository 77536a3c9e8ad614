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
// x 50 = 36.3 G FMA in fp32, 1.08 ms at 67 TFLOP/s) with a compare per
// score in place of K1's threshold filter and selection: it is bound by
// operations. So the design is the tile loop of K1 and K2
// (score_tile_sm90.cuh: 64 users x 128 items per block, 256 threads; fp32
// a 4 x 8 register micro-tile of sequential fmaf, bf16 mma.sync on the
// tensor cores; V double-buffered by cp.async), which is what makes it a
// floor of K1: its time is the part of K1's that no selection can remove.
// The epilogue:
//
//  * Residues stay in registers. The tile is 128 items wide and every
//    split starts at a multiple of 128, so column col(cj) of a thread's
//    micro-tile is the same residue in every tile, and each (row, residue)
//    pair belongs to exactly one thread. Each thread keeps the running max
//    of its RPT x CPT pairs (32 in both modes) over its whole item range
//    and writes them itself at the end: no fold through shared memory.
//  * The seen bit is read lazily, as K1 and K2 read it. A score is
//    compared first; its bit word is read only when the score would raise
//    its residue's max, and an excluded item's score is then dropped. That
//    is exact, since the max is over unmasked items only. In random order a
//    residue's max rises about ln(81) ≈ 5 times over its 81 items, so after
//    the first tile about 6 % of the scores read a word (the previous loop
//    read one for every score, ~91 MB at the probe's shape).
//  * Variant B keeps the item of each max in shared memory, int32
//    [64][128] (32 KB) after the tile buffers, written only when the max
//    rises and only by the thread that owns the pair, so the registers hold
//    the accumulators and the maxima and nothing more. Items rise within a
//    split and the compare is strict, so a tie keeps the lowest index.
//  * Small batches split the catalog over grid.y as K1 does (at most 32
//    splits); each split then writes its own partial [n_splits, n_u, 128]
//    and floor_merge folds them in split order, so the lowest index still
//    wins a tie.
//
// The entry points return a cudaError_t value (0 = ok).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "score_tile_sm90.cuh"

namespace {

constexpr int kFloorBM = 64;             // users per block
constexpr int kFloorBN = 128;            // items per tile: the residues
constexpr int kFloorNT = 256;            // threads per block
constexpr int kFloorMaxSplits = 32;      // catalog splits the wrapper takes
constexpr float kFloorNegInf = -FLT_MAX;  // float32.min: no unmasked item

using FloorFma = FmaTile<kFloorBM, kFloorBN, 4, 8>;
using FloorMma = MmaTile<kFloorBM, kFloorBN, kFloorNT>;
static_assert(FloorFma::kThreads == kFloorNT, "fp32 tile threads");

// P1's epilogue on the tile loop: the running max of each (row, residue)
// pair that this thread owns, and in variant B the item that holds it.
template <class Tile, bool kIndex>
struct Floor {
  float m[Tile::RPT][Tile::CPT];
  float bc[Tile::CPT];  // the bias of this thread's columns of the tile
  int32_t* arg;         // [kFloorBM][kFloorBN] in shared memory (variant B)
  const float* bias;
  const int32_t* excl;
  int row0, n_words, item_end;

  // Rows past n_u start at +inf, so that no score of theirs passes the
  // compare and none reads a bit word of a row that does not exist.
  __device__ __forceinline__ void init(const Tile& tl, int n_u) {
#pragma unroll
    for (int ri = 0; ri < Tile::RPT; ++ri) {
      const float m0 = row0 + tl.row(ri) < n_u ? kFloorNegInf : INFINITY;
#pragma unroll
      for (int cj = 0; cj < Tile::CPT; ++cj) m[ri][cj] = m0;
    }
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
        const float s = tl.val(ri, cj) + bc[cj];
        if (!(s > m[ri][cj])) continue;  // compare first, then the bit
        if (excluded(excl, n_words, row0 + tl.row(ri), item)) continue;
        m[ri][cj] = s;
        if (kIndex) arg[tl.row(ri) * kFloorBN + tl.col(cj)] = item;
      }
    }
  }
};

// Two blocks per SM: at most 128 registers a thread.
template <class Tile, bool kIndex>
__global__ void __launch_bounds__(kFloorNT, 2)
    floor_pass(TileArgs<typename Tile::Elem> a, float* __restrict__ out_v,
               int32_t* __restrict__ out_i, int n_i, int split_len) {
  constexpr bool kBf16 = sizeof(typename Tile::Elem) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  a.row0 = blockIdx.x * kFloorBM;
  a.item_begin = blockIdx.y * split_len;
  a.item_end = min(n_i, a.item_begin + split_len);

  const Tile probe;  // the pairs this thread owns
  Floor<Tile, kIndex> fl;
  fl.arg = reinterpret_cast<int32_t*>(
      smem + tile_smem_bytes(kFloorBM, kFloorBN, a.d, kBf16));
  fl.bias = a.bias;
  fl.excl = a.excl;
  fl.row0 = a.row0;
  fl.n_words = a.n_words;
  fl.item_end = a.item_end;
  fl.init(probe, a.n_u);
  run_tiles<Tile, kFloorBM, kFloorBN>(a, smem, fl);

  // Each pair was written by its owner only: no barrier before the reads.
#pragma unroll
  for (int ri = 0; ri < Tile::RPT; ++ri) {
    const int r = probe.row(ri);
    if (a.row0 + r >= a.n_u) continue;
    const size_t o = ((size_t)blockIdx.y * a.n_u + a.row0 + r) * kFloorBN;
#pragma unroll
    for (int cj = 0; cj < Tile::CPT; ++cj) {
      const int l = probe.col(cj);
      const float v = fl.m[ri][cj];
      out_v[o + l] = v;
      // the item was written exactly when the max rose above float32.min
      if (kIndex)
        out_i[o + l] = v > kFloorNegInf ? fl.arg[r * kFloorBN + l] : -1;
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
  const size_t n = (size_t)n_u * kFloorBN;
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

// The pass kernel of one (mode, variant) and its shared memory: the tile
// loop's buffers, then variant B's items.
template <bool kBf16, bool kIndex>
struct FloorPass {
  using Tile = typename std::conditional<kBf16, FloorMma, FloorFma>::type;
  using T = typename Tile::Elem;
  static size_t smem(int d) {
    return tile_smem_bytes(kFloorBM, kFloorBN, d, kBf16) +
           (kIndex ? sizeof(int32_t) * kFloorBM * kFloorBN : 0);
  }
  static cudaError_t prepare(int d) {
    return cudaFuncSetAttribute(floor_pass<Tile, kIndex>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem(d));
  }
};

template <bool kBf16, bool kIndex>
int launch_floor(const void* U, const void* V, const void* bias,
                 const void* excl, void* out_v, void* out_i, void* part_v,
                 void* part_i, int n_u, int n_i, int d, int n_words,
                 int split_len, int n_splits, cudaStream_t stream) {
  using P = FloorPass<kBf16, kIndex>;
  using T = typename P::T;
  cudaError_t err = P::prepare(d);
  if (err != cudaSuccess) return (int)err;
  const bool split = n_splits > 1;
  float* pv = static_cast<float*>(split ? part_v : out_v);
  int32_t* pi = static_cast<int32_t*>(split ? part_i : out_i);
  TileArgs<T> a{static_cast<const T*>(U), static_cast<const T*>(V),
                static_cast<const float*>(bias),
                static_cast<const int32_t*>(excl), n_u, d, n_words, 0, 0, 0};
  dim3 grid((n_u + kFloorBM - 1) / kFloorBM, n_splits);
  floor_pass<typename P::Tile, kIndex><<<grid, kFloorNT, P::smem(d), stream>>>(
      a, pv, pi, n_i, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return (int)err;
  const size_t n = (size_t)n_u * kFloorBN;
  floor_merge<kIndex><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      pv, pi, static_cast<float*>(out_v), static_cast<int32_t*>(out_i), n_u,
      n_splits);
  return (int)cudaGetLastError();
}

template <bool kBf16>
int dispatch_index(bool index, const void* U, const void* V,
                   const void* bias, const void* excl, void* out_v,
                   void* out_i, void* part_v, void* part_i, int n_u, int n_i,
                   int d, int n_words, int split_len, int n_splits,
                   cudaStream_t s) {
  if (index)
    return launch_floor<kBf16, true>(U, V, bias, excl, out_v, out_i, part_v,
                                     part_i, n_u, n_i, d, n_words, split_len,
                                     n_splits, s);
  return launch_floor<kBf16, false>(U, V, bias, excl, out_v, out_i, part_v,
                                    part_i, n_u, n_i, d, n_words, split_len,
                                    n_splits, s);
}

// Resident blocks per SM of one mode: variant B's, whose items take 32 KB
// more of shared memory than A under the same register bound, so it is the
// fewer of the two.
template <bool kBf16>
int floor_occupancy(int d, int* blocks) {
  using P = FloorPass<kBf16, true>;
  cudaError_t err = P::prepare(d);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, floor_pass<typename P::Tile, true>, kFloorNT, P::smem(d));
}

}  // namespace

extern "C" {

// P1's geometry at (d, mode): *rows users per block, *tile items per tile
// (a split is a whole number of tiles), *blocks resident blocks per SM.
int tkr_floor_geometry(int d, int bf16, int* rows, int* tile, int* blocks) {
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  *rows = kFloorBM;
  *tile = kFloorBN;
  return bf16 ? floor_occupancy<true>(d, blocks)
              : floor_occupancy<false>(d, blocks);
}

// U [n_u, d], V [n_i, d] (float32 when bf16 == 0, bfloat16 otherwise),
// contiguous, rows and bases 16-byte aligned (see kernel_table in
// ops/topk_fused.py), bias [n_i] float32 or null, excl [n_u, n_words] int32
// bit words; out_v [n_u, 128] float32, out_i [n_u, 128] int32 or null
// (variant A). The items split into n_splits (<= 32) ranges of split_len
// (grid.y, a multiple of the tile); with n_splits > 1, part_v / part_i are
// [n_splits, n_u, 128] scratch (part_i null in variant A). Returns a
// cudaError_t value (0 = ok).
int tkr_topk_floor(const void* U, const void* V, const void* bias,
                   const void* excl, void* out_v, void* out_i, void* part_v,
                   void* part_i, int n_u, int n_i, int d, int n_words,
                   int split_len, int n_splits, int bf16, void* stream) {
  const bool index = out_i != nullptr;
  if (n_u <= 0 || n_i <= 0 || d <= 0 || d > kMaxD ||
      n_words < (n_i + 31) / 32 || split_len <= 0 ||
      split_len % kFloorBN != 0 || n_splits <= 0 ||
      n_splits > kFloorMaxSplits || (long long)split_len * n_splits < n_i ||
      (long long)split_len * (n_splits - 1) >= n_i || out_v == nullptr ||
      !rows_aligned(d, bf16, U, V) ||
      (n_splits > 1 && (part_v == nullptr || (index && part_i == nullptr))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch_index<true>(index, U, V, bias, excl, out_v, out_i, part_v,
                                part_i, n_u, n_i, d, n_words, split_len,
                                n_splits, s);
  return dispatch_index<false>(index, U, V, bias, excl, out_v, out_i, part_v,
                               part_i, n_u, n_i, d, n_words, split_len,
                               n_splits, s);
}

}  // extern "C"
