// Shared by K1 (topk_fused.cu) and K2 (topk_count.cu): the Hopper tile loop
// that computes U·Vᵀ for a block's BM user rows against its split of the
// catalog, BN items at a time, never writing a score to device memory.
//
// Geometry. A block owns BM users and walks its item range in tiles of BN
// items. d is cut into slices: one slice when the padded d is at most 64
// columns, else slices of 128 bytes a row (32 fp32 or 64 bf16 columns), so
// that d = 1024 runs in the same shared memory. One stage is one (item
// tile, d slice) pair and holds the V slice [BN][SK]; the U slice [BM][SK]
// is staged once per block when d is one slice, else with each stage. Two
// stages are in flight: while the block scores stage q, cp.async copies
// stage q + 1. Rows past n_u and items past the split's end are zero-filled
// by the copy itself (src-size 0). The bias and the exclusion words are not
// staged: the epilogues read the bias once per column and tile, and a bit
// word only for the rare score that passes their threshold.
//
// Alignment. Every copy is a 16-byte cp.async.cg. A row of d = 50 is 200
// bytes in fp32 and 100 in bf16, so the wrapper hands the kernels tables
// whose rows are padded with zero columns to the arithmetic's step (4 in
// fp32, 16 in bf16); a zero column leaves every score as it was.
//
// Arithmetic, two tiles over the same stage layout:
//  * FmaTile (fp32, the exact mode of evaluate): each thread keeps a TM x TN
//    register micro-tile of scores and walks d in float4 steps; every score
//    is a sequential chain of fp32 fmaf over d in index order, on the CUDA
//    cores. No TF32 and no split products.
//  * MmaTile (bf16, serving): each warp owns a 16 x WN slab and runs
//    mma.sync.m16n8k16 (bf16 operands from ldmatrix, fp32 accumulation) on
//    the tensor cores; d is zero-padded to a multiple of 16. bf16 products
//    are exact in fp32; only the summation order differs from the fp32
//    chain. mma.sync rather than wgmma: a wgmma instruction takes 64 rows
//    per warpgroup from shared memory in its own swizzled layout, and at
//    d = 50 (four k16 steps per tile) the product is not what bounds these
//    kernels: their loads and epilogues are.
//
// Both tiles present the same view to an epilogue: RPT rows and CPT columns
// per thread, row(ri), col(cj) and val(ri, cj), so K1 and K2 write their
// epilogues once for both modes.
//
// Shared-memory strides. fp32: SK/4 is odd, so the float4 reads of eight
// consecutive rows fall in distinct 16-byte bank groups. bf16: SK·2/16 is
// odd, so ldmatrix's eight row addresses are conflict-free.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 1024;
constexpr int kOneSlice = 64;     // padded d up to this is one slice
constexpr int kSliceBytes = 128;  // else: bytes of a row per slice
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Columns of one k step of the arithmetic: fp32 steps by 4, the tensor
// cores by 16. The tables' row stride is d rounded up to it.
__host__ __device__ inline int k_step(bool bf16) { return bf16 ? 16 : 4; }

__host__ __device__ inline int slice_width(int d, bool bf16) {
  const int w = round_up(d, k_step(bf16));
  return w <= kOneSlice ? w : kSliceBytes / (bf16 ? 2 : 4);
}

// Row stride (elements) of the U and V slices in shared memory.
__host__ __device__ inline int slice_stride(int dk, bool bf16) {
  if (bf16) return ((dk / 8) & 1) ? dk : dk + 8;
  return ((dk / 4) & 1) ? dk : dk + 4;
}

// Shared memory of run_tiles: U once when d is one slice, else one U slice
// per stage; two V stages.
__host__ __device__ inline size_t tile_smem_bytes(int bm, int bn, int d,
                                                  bool bf16) {
  const int dk = slice_width(d, bf16);
  const size_t row = (size_t)slice_stride(dk, bf16) * (bf16 ? 2 : 4);
  const int n_u_bufs = round_up(d, k_step(bf16)) <= dk ? 1 : 2;
  return (n_u_bufs * (size_t)bm + 2 * (size_t)bn) * row;
}

// ---- cp.async ---------------------------------------------------------------

// 16 bytes global -> shared; when !valid the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// What a block reads: its rows, its item range and the table layout.
template <typename T>
struct TileArgs {
  const T* U;
  const T* V;
  const float* bias;    // [n_i] or null
  const int32_t* excl;  // [n_u, n_words]
  int n_u, d, n_words;  // d: the row stride too, a multiple of k_step
  int row0;             // first user row of the block
  int item_begin, item_end;
};

// Copy rows [r0, r0 + rows) x columns [k0, k0 + kw) of a table with row
// stride ld into dst [rows][sk]; rows at or past n_valid are zero-filled.
template <typename T, int NT>
__device__ __forceinline__ void copy_rows(T* dst, int sk, const T* src, int ld,
                                          int r0, int rows, int n_valid, int k0,
                                          int kw) {
  constexpr int kPer = 16 / sizeof(T);  // elements per copy
  const int cpr = kw / kPer;             // copies per row
  for (int e = threadIdx.x; e < rows * cpr; e += NT) {
    const int r = e / cpr;
    const int c = (e - r * cpr) * kPer;
    const bool ok = r0 + r < n_valid;
    cp_async16(dst + (size_t)r * sk + c,
               ok ? src + (size_t)(r0 + r) * ld + k0 + c : src, ok);
  }
}

// Bit (item & 31) of the exclusion word of (user u, item): set = excluded.
__device__ __forceinline__ bool excluded(const int32_t* __restrict__ excl,
                                         int n_words, int u, int item) {
  const uint32_t w =
      static_cast<uint32_t>(__ldg(excl + (size_t)u * n_words + (item >> 5)));
  return (w >> (item & 31)) & 1u;
}

// The bias of a thread's CPT columns of the tile at c0 (0 past item_end).
template <class Tile>
__device__ __forceinline__ void load_bias(float (&bc)[Tile::CPT],
                                          const Tile& t, const float* bias,
                                          int c0, int item_end) {
#pragma unroll
  for (int cj = 0; cj < Tile::CPT; ++cj) {
    const int item = c0 + t.col(cj);
    bc[cj] = bias != nullptr && item < item_end ? __ldg(bias + item) : 0.f;
  }
}

// ---- fp32: a register micro-tile on the CUDA cores ------------------------

template <int BM, int BN, int TM, int TN>
struct FmaTile {
  using Elem = float;
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int RPT = TM;
  static constexpr int CPT = TN;
  static constexpr int NX = BN / TN;  // threads along the items
  // A warp holds 32 / NX whole row groups: no other warp scores its rows.
  static constexpr bool kWarpRows = 32 % NX == 0;
  float acc[TM][TN];
  int tx, ty;

  __device__ FmaTile() : tx(threadIdx.x % NX), ty(threadIdx.x / NX) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  // acc += Us·Vsᵀ over columns [0, kw), one fmaf per column in order.
  __device__ __forceinline__ void compute(const float* Us, const float* Vs,
                                          int sk, int kw) {
    const float* ub = Us + (size_t)ty * TM * sk;
    const float* vb = Vs + (size_t)tx * sk;
#pragma unroll 1
    for (int k = 0; k < kw; k += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(ub + i * sk + k);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(vb + (size_t)j * NX * sk + k);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc[i][j] = s;
        }
    }
  }

  __device__ __forceinline__ int row(int ri) const { return ty * TM + ri; }
  __device__ __forceinline__ int col(int cj) const { return tx + cj * NX; }
  __device__ __forceinline__ float val(int ri, int cj) const {
    return acc[ri][cj];
  }
};

// ---- bf16: mma.sync on the tensor cores -----------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warps tile the block 16 rows high: BM / 16 warps down, the rest across.
template <int BM, int BN, int NT>
struct MmaTile {
  using Elem = __nv_bfloat16;
  static constexpr int kThreads = NT;
  static constexpr int kWarpsM = BM / 16;
  static constexpr int kWarpsN = NT / 32 / kWarpsM;
  static constexpr int WN = BN / kWarpsN;
  static constexpr int NI = WN / 8;  // n8 tiles per warp
  static constexpr int RPT = 2;
  static constexpr int CPT = NI * 2;
  static constexpr bool kWarpRows = kWarpsN == 1;
  static_assert(BM % 16 == 0 && kWarpsM * kWarpsN * 32 == NT, "warp grid");
  static_assert(NI % 2 == 0, "B fragments load in pairs");
  float acc[NI][4];
  int lane, wm, wn;

  __device__ MmaTile()
      : lane(threadIdx.x & 31),
        wm((threadIdx.x >> 5) % kWarpsM),
        wn((threadIdx.x >> 5) / kWarpsM) {}

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  __device__ __forceinline__ void compute(const __nv_bfloat16* Us,
                                          const __nv_bfloat16* Vs, int sk,
                                          int kw) {
    // A (16 x 16): lanes 0-15 give rows 0-15 at k, lanes 16-31 at k + 8.
    const __nv_bfloat16* ap =
        Us + (size_t)(wm * 16 + (lane & 15)) * sk + (lane >> 4) * 8;
    // B pairs (two n8 x k16): lanes 0-7 rows 0-7 at k, 8-15 rows 0-7 at
    // k + 8, 16-23 rows 8-15 at k, 24-31 rows 8-15 at k + 8.
    const __nv_bfloat16* bp =
        Vs + (size_t)(wn * WN + (lane & 7) + ((lane >> 4) << 3)) * sk +
        ((lane >> 3) & 1) * 8;
    for (int k = 0; k < kw; k += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, ap + k);
#pragma unroll
      for (int n = 0; n < NI; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, bp + (size_t)n * 8 * sk + k);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }

  // c0, c1: row lane/4, columns 2·(lane%4) + {0, 1}; c2, c3: row + 8.
  __device__ __forceinline__ int row(int ri) const {
    return wm * 16 + (lane >> 2) + ri * 8;
  }
  __device__ __forceinline__ int col(int cj) const {
    return wn * WN + (cj >> 1) * 8 + (lane & 3) * 2 + (cj & 1);
  }
  __device__ __forceinline__ float val(int ri, int cj) const {
    return acc[cj >> 1][ri * 2 + (cj & 1)];
  }
};

// ---- the pipeline -----------------------------------------------------------

// Runs the block's stages. Before the first slice of each item tile every
// thread calls epi.prefetch(tile, c0), so that the epilogue's loads (the
// bias of its columns) overlap the product; after the last slice it calls
// epi.tile(tile, c0), the epilogue of the tile's scores, which may
// synchronise the block (K1's does), since every thread calls it. smem
// holds tile_smem_bytes(BM, BN, d, bf16).
//
// One barrier per stage: it comes after the wait for stage q and before the
// copies of stage q + 1 are issued, so every thread has finished reading
// the buffer those copies overwrite (stage q - 1's) and the copies still
// overlap the scoring of stage q.
template <class Tile, int BM, int BN, class Epi>
__device__ void run_tiles(const TileArgs<typename Tile::Elem>& a,
                          unsigned char* smem, Epi& epi) {
  using T = typename Tile::Elem;
  constexpr int NT = Tile::kThreads;
  constexpr bool kBf16 = sizeof(T) == 2;
  const int dk = slice_width(a.d, kBf16);
  const int sk = slice_stride(dk, kBf16);
  const int n_slices = (a.d + dk - 1) / dk;
  const bool u_once = n_slices == 1;  // U is staged once, not per stage
  T* const ubase = reinterpret_cast<T*>(smem);
  T* const vbase = ubase + (size_t)(u_once ? 1 : 2) * BM * sk;
  const int n_tiles = (a.item_end - a.item_begin + BN - 1) / BN;
  const int n_stages = n_tiles * n_slices;
  Tile tile;

  auto ubuf = [&](int q) { return ubase + (u_once ? 0 : (q & 1) * BM * sk); };
  auto vbuf = [&](int q) { return vbase + (size_t)(q & 1) * BN * sk; };
  auto issue = [&](int q) {
    const int t = q / n_slices;
    const int k0 = (q - t * n_slices) * dk;
    const int kw = min(dk, a.d - k0);
    if (!u_once || q == 0)
      copy_rows<T, NT>(ubuf(q), sk, a.U, a.d, a.row0, BM, a.n_u, k0, kw);
    copy_rows<T, NT>(vbuf(q), sk, a.V, a.d, a.item_begin + t * BN, BN,
                     a.item_end, k0, kw);
    cp_async_commit();
  };

  if (n_stages > 0) issue(0);
  for (int q = 0; q < n_stages; ++q) {
    cp_async_wait_all();
    __syncthreads();
    if (q + 1 < n_stages) issue(q + 1);
    const int t = q / n_slices;
    const int s = q - t * n_slices;
    if (s == 0) {
      epi.prefetch(tile, a.item_begin + t * BN);
      tile.zero();
    }
    tile.compute(ubuf(q), vbuf(q), sk, min(dk, a.d - s * dk));
    if (s == n_slices - 1) epi.tile(tile, a.item_begin + t * BN);
  }
}

// Whether [n, d] tables suit the copies: d a multiple of the arithmetic's
// step (so every slice's copy stays inside its row, and rows are 16-byte
// multiples) and 16-byte aligned bases.
inline bool rows_aligned(int d, bool bf16, const void* U, const void* V) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(U) |
                      reinterpret_cast<uintptr_t>(V);
  return d % k_step(bf16) == 0 && p % 16 == 0;
}

}  // namespace
