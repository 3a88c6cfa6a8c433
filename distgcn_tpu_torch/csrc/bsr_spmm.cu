// Block-sparse matrix times dense matrix: y = S @ x, f32 accumulation.
//
// Replaces the TPU kernels of distgcn_tpu/ops/spmm.py:
//   _spmm_row_kernel (launcher _bsr_spmm_rows, row grid),
//   _spmm_kernel     (launcher _bsr_spmm, block grid).
// Both compute the same function; the block grid left block-rows without
// a block unset, here they give 0.
//
// S is given as blocks sorted by block-row, indexed by row_ptr [R+1], of
// one of four kinds: f32 or bf16 value blocks [nb, bs, bs], int8 0/1
// structure blocks [nb, bs, bs], or bitmap structure blocks
// [nb, bs/32, bs] int32 (bit i % 32 of word [i / 32, j] = cell (i, j)).
// x is [n_cols, F] f32 row-major; y is [n_rows, F] f32. Blocks past
// row_ptr[R] (a sharded panel's padding) are never read.
//
// What bounds it on an H100: bytes, at the least. The blocks of conflict
// graphs are ~2.5% dense, so the work the data needs is one f32 add per
// stored edge and feature (nnz * F: 0.41 G adds at N=65,536, F=128),
// while the bytes are the structure plus x and y (16.1 MB of bitmap words
// + 2 * 32 MB at F=128: about 25 us at 3.35 TB/s).
//
// Bitmap blocks (the structure stream of the exact and sharded routes):
// one warp owns a 32-row group (one word-row of its block-row) and a
// slice of 32 * V features, V = 4, 2 or 1 per lane (the widest that F and
// the alignment of x and y allow). Only 9.6% of the bench graph's words
// are nonzero, each with 8.2 edges on average, so the warp reads x once
// per nonzero word, not once per edge: ~0.2 GB of x from L2 per call
// instead of ~1.6 GB. It walks its block-row's blocks in row_ptr order,
// loading the words of 8 32-column chunks at a time (lane j one word of
// each; the next 8 are in flight while the current ones are listed),
// compacts the nonzero words into a per-warp list in shared memory, in
// column order, and streams the listed words through a per-warp ring of
// 4 pieces of 4 in shared memory: cp.async brings each listed word's x
// row (this lane's V features) while the warp adds earlier ones. A
// listed word's x is added into the accumulators of its set rows, 32
// rows x V features held in registers, by predicated adds: the compiler
// turns the word into row predicates 7 at a time (R2P), and nothing in
// the loop over listed words branches.
//
// What bounds it: the issue of those adds. Every lane issues the add of
// every row, set or not (8.2 of 32 are set on the bench graph): ~386k
// listed words x ~140 instructions at V = 4, about 0.05 ms at 1.98 GHz.
// Skipping 8 or 16 empty rows at a time by a uniform branch cost more
// than the adds it saved at two warps per scheduler (200 registers), and
// so did branching per listed word; 16 rows per warp (twice the warps) and
// a deeper ring changed nothing, so neither the warps' count nor the x
// loads' latency holds it. On an H100 SXM at 700 W it issues at about
// half that rate (PERF.md, with the variants measured). The sum
// order of a row is fixed (blocks in row_ptr order, columns ascending):
// no atomics, two launches are bit-equal.
//
// Value and int8 blocks keep the first design: one warp per output row.
// For each block of the row's block-row, the warp reads the row's cells
// 32 columns at a time (8 such loads in flight), finds the nonzero ones
// with one ballot, and for each of them adds value * x[col, :] to the
// row's accumulator, each lane owning 4 features of a 128-wide chunk.
// It re-reads each x row once per neighbour (from L2 at these sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitmap_walk.cuh"

namespace {

enum Kind { kF32 = 0, kBf16 = 1, kInt8 = 2, kBitmap = 3 };

constexpr int kWarps = 8;
constexpr int kQ = 4;  // features per lane per 128-wide chunk
constexpr int kScan = 8;  // 32-column chunks whose cells are loaded together

template <int KIND>
__device__ __forceinline__ float cell(const void* vals, size_t k, int bs,
                                      int li, int j) {
  if (KIND == kF32) {
    return static_cast<const float*>(vals)[(k * bs + li) * bs + j];
  } else if (KIND == kBf16) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(vals)[(k * bs + li) * bs + j]);
  } else {
    return static_cast<float>(
        static_cast<const int8_t*>(vals)[(k * bs + li) * bs + j]);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kWarps * 32)
    bsr_spmm_kernel(const void* __restrict__ vals,
                    const int32_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ blk_cols,
                    const float* __restrict__ x, float* __restrict__ y,
                    int n_rows, int bs, int f) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp
  const int br = row / bs;
  const int li = row - br * bs;
  const int start = row_ptr[br];
  const int end = row_ptr[br + 1];
  for (int f0 = 0; f0 < f; f0 += 32 * kQ) {
    float acc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[q] = 0.0f;
    for (int k = start; k < end; ++k) {
      const size_t xbase = static_cast<size_t>(blk_cols[k]) * bs;
      for (int jb = 0; jb < bs; jb += 32 * kScan) {
        // the cells of kScan 32-column chunks are loaded before any is
        // used, so that their loads are in flight together
        float v[kScan];
#pragma unroll
        for (int t = 0; t < kScan; ++t) {
          v[t] = jb + 32 * t < bs ? cell<KIND>(vals, k, bs, li,
                                               jb + 32 * t + lane)
                                  : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < kScan; ++t) {
          uint32_t mask = __ballot_sync(0xffffffffu, v[t] != 0.0f);
          while (mask) {
            const int b = __ffs(mask) - 1;
            mask &= mask - 1;
            const float vb = __shfl_sync(0xffffffffu, v[t], b);
            const float* xr = x + (xbase + jb + 32 * t + b) * f;
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const int col = f0 + q * 32 + lane;
              if (col < f) acc[q] = fmaf(vb, xr[col], acc[q]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int col = f0 + q * 32 + lane;
      if (col < f) y[static_cast<size_t>(row) * f + col] = acc[q];
    }
  }
}

// ---------------------------------------------------------------------------
// bitmap blocks: one warp per (32-row group, feature slice)
// ---------------------------------------------------------------------------

using bitmap_walk::kGroup;
using bitmap_walk::load_group;
using bitmap_walk::Walk;

constexpr int kBitWarps = 4;   // warps per CTA of the bitmap kernel
constexpr int kPiece = 4;   // listed words per cp.async group
constexpr int kRing = 4;    // pieces in a warp's ring: kRing - 1 in flight
constexpr int kSlots = kPiece * kRing;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

// acc[b] += xv for every set bit b of the warp-uniform word w, by
// predicated adds
template <int V>
__device__ __forceinline__ void add_word(float (&acc)[32][V], uint32_t w,
                                         const float (&xv)[V]) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (w & (1u << b)) {
#pragma unroll
      for (int i = 0; i < V; ++i) acc[b][i] += xv[i];
    }
  }
}

// cp.async of V floats when `on`, predicated (no branch)
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], %3;\n}\n" ::"r"(d),
      "l"(src), "r"(static_cast<int>(on)), "n"(V * 4));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's shared memory: the x rows of the listed words in flight
// ([kSlots][32 lanes][V] f32), the words of the slots, the count of each
// piece, and the list of one group's nonzero words and their columns. The
// columns run kPiece entries past the longest list: a piece reads kPiece
// of them whatever its count, for the addresses of its predicated
// cp.async (off past the count), without a select per slot.
template <int V>
struct WarpSmem {
  float xr[kSlots][32 * V];
  uint32_t ws[kSlots];
  int pn[kRing];
  uint32_t lw[kGroup * 32];
  int32_t lc[kGroup * 32 + kPiece];
};

// The producer side of a warp: the walk over its block-row's chunks, the
// words of the next group in registers, and the cursor in the list.
struct Feed {
  Walk p;
  int li, ln;          // list cursor and length
  bool pending;        // wv/cv hold a group not yet listed
};

// Puts the next listed words, at most kPiece, into the ring: cp.async of
// their x rows (this lane's V features) into slot (piece % kRing), their
// words beside (0 past the piece's count); lists the next group's nonzero
// words first when the list has run out. A piece is empty only once the
// walk has ended. Commits one cp.async group, possibly empty; no branch
// per listed word.
template <int V>
__device__ __forceinline__ void produce(
    WarpSmem<V>& sm, Feed& fd, uint32_t (&wv)[kGroup], int (&cv)[kGroup],
    const uint32_t* __restrict__ words, const int32_t* __restrict__ cols,
    const float* __restrict__ x, int nch, int wr, int bs, int f, int fl,
    bool active, int lane, int piece) {
  while (fd.li == fd.ln && fd.pending) {
    __syncwarp();  // every lane has read the list
    int n = 0;
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      const uint32_t m = __ballot_sync(0xffffffffu, wv[t] != 0u);
      if (wv[t] != 0u) {
        const int at = n + __popc(m & ((1u << lane) - 1u));
        sm.lw[at] = wv[t];
        sm.lc[at] = cv[t];
      }
      n += __popc(m);
    }
    __syncwarp();
    fd.li = 0;
    fd.ln = n;
    fd.pending = fd.p.left > 0;
    if (fd.pending) load_group(words, cols, nch, wr, bs, lane, fd.p, wv, cv);
  }
  const int slot0 = (piece % kRing) * kPiece;
  const int cnt = min(kPiece, fd.ln - fd.li);
#pragma unroll
  for (int u = 0; u < kPiece; ++u) {
    cp_async<V>(&sm.xr[slot0 + u][lane * V],
                x + static_cast<size_t>(sm.lc[fd.li + u]) * f + fl,
                u < cnt && active);
  }
  if (lane < kPiece) {
    sm.ws[slot0 + lane] = lane < cnt ? sm.lw[fd.li + lane] : 0u;
  }
  if (lane == 0) sm.pn[piece % kRing] = cnt;
  fd.li += cnt;
  cp_async_commit();
}

template <int V>
__global__ void __launch_bounds__(kBitWarps * 32)
    bsr_spmm_bitmap_kernel(const uint32_t* __restrict__ words,
                           const int32_t* __restrict__ row_ptr,
                           const int32_t* __restrict__ blk_cols,
                           const float* __restrict__ x, float* __restrict__ y,
                           int n_groups, int n_slices, int bs, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kBitWarps + warp;
  if (gw >= n_groups * n_slices) return;  // whole warp
  WarpSmem<V>& sm = reinterpret_cast<WarpSmem<V>*>(smem)[warp];
  const int grp = gw / n_slices;   // rows 32 * grp ..
  const int fl = (gw - grp * n_slices) * 32 * V + lane * V;  // lane's features
  const bool active = fl < f;   // f is a multiple of V
  const int nch = bs >> 5;
  const int br = grp / nch;
  const int wr = grp - br * nch;   // word-row
  const int start = row_ptr[br];
  Feed fd{{start, 0, (row_ptr[br + 1] - start) * nch}, 0, 0, false};
  uint32_t wv[kGroup];
  int cv[kGroup];
  fd.pending = fd.p.left > 0;
  if (fd.pending) load_group(words, blk_cols, nch, wr, bs, lane, fd.p, wv, cv);

  float acc[32][V];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[b][i] = 0.0f;
  }
  for (int j = 0; j < kRing - 1; ++j) {
    produce<V>(sm, fd, wv, cv, words, blk_cols, x, nch, wr, bs, f, fl, active,
               lane, j);
  }
  // the first empty piece ends the walk
  for (int j = 0;; ++j) {
    cp_async_wait<kRing - 2>();
    __syncwarp();
    const int slot0 = (j % kRing) * kPiece;
    if (sm.pn[j % kRing] == 0) break;
    // every slot of the piece: past its count the word is 0 and adds
    // nothing (the x there is stale and never added)
#pragma unroll
    for (int u = 0; u < kPiece; ++u) {
      const typename Vec<V>::T t =
          *reinterpret_cast<const typename Vec<V>::T*>(
              &sm.xr[slot0 + u][lane * V]);
      const float* s = reinterpret_cast<const float*>(&t);
      float xv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] = s[i];
      add_word<V>(acc, sm.ws[slot0 + u], xv);
    }
    produce<V>(sm, fd, wv, cv, words, blk_cols, x, nch, wr, bs, f, fl, active,
               lane, j + kRing - 1);
  }
  if (!active) return;
  float* out = y + static_cast<size_t>(grp) * 32 * f + fl;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    typename Vec<V>::T t;
    float* s = reinterpret_cast<float*>(&t);
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = acc[b][i];
    *reinterpret_cast<typename Vec<V>::T*>(out + static_cast<size_t>(b) * f) =
        t;
  }
}

template <int KIND>
int launch(const void* vals, const void* row_ptr, const void* blk_cols,
           const void* x, void* y, int n_rows, int bs, int f,
           cudaStream_t stream) {
  const int grid = (n_rows + kWarps - 1) / kWarps;
  bsr_spmm_kernel<KIND><<<grid, kWarps * 32, 0, stream>>>(
      vals, static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols), static_cast<const float*>(x),
      static_cast<float*>(y), n_rows, bs, f);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_bitmap(const void* vals, const void* row_ptr, const void* blk_cols,
                  const void* x, void* y, int n_rows, int bs, int f,
                  cudaStream_t stream) {
  const int n_groups = n_rows / 32;
  const int n_slices = (f + 32 * V - 1) / (32 * V);
  const long long warps = static_cast<long long>(n_groups) * n_slices;
  const int grid = static_cast<int>((warps + kBitWarps - 1) / kBitWarps);
  // at most 41,344 bytes (V = 4): under the 48 KB a launch may take
  // without raising the kernel's limit
  const int smem = static_cast<int>(kBitWarps * sizeof(WarpSmem<V>));
  static_assert(kBitWarps * sizeof(WarpSmem<4>) <= 48 * 1024, "smem");
  bsr_spmm_bitmap_kernel<V><<<grid, kBitWarps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(vals), static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols), static_cast<const float*>(x),
      static_cast<float*>(y), n_groups, n_slices, bs, f);
  return static_cast<int>(cudaGetLastError());
}

// Features per lane of the bitmap kernel: the widest vector that f and the
// alignment of x and y allow.
int bitmap_width(const void* x, const void* y, int f) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y);
  if (f % 4 == 0 && a % 16 == 0) return 4;
  if (f % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

}  // namespace

extern "C" {

// kind: 0 f32, 1 bf16, 2 int8 value/structure blocks [nb, bs, bs];
// 3 bitmap blocks [nb, bs/32, bs] int32. row_ptr int32 [n_rows/bs + 1],
// blk_cols int32 [nb], x f32 [n_cols, f] -> y f32 [n_rows, f]. bs is a
// multiple of 32 and divides n_rows. Launches on `stream` without
// synchronising; returns the cudaError_t of the launch (0 = success).
int bsr_spmm_launch(const void* vals, int kind, const void* row_ptr,
                    const void* blk_cols, const void* x, void* y, int n_rows,
                    int bs, int f, void* stream) {
  if (bs < 32 || bs % 32 != 0 || n_rows < 0 || n_rows % bs != 0 || f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32:
      return launch<kF32>(vals, row_ptr, blk_cols, x, y, n_rows, bs, f, s);
    case kBf16:
      return launch<kBf16>(vals, row_ptr, blk_cols, x, y, n_rows, bs, f, s);
    case kInt8:
      return launch<kInt8>(vals, row_ptr, blk_cols, x, y, n_rows, bs, f, s);
    case kBitmap:
      switch (bitmap_width(x, y, f)) {
        case 4:
          return launch_bitmap<4>(vals, row_ptr, blk_cols, x, y, n_rows, bs,
                                  f, s);
        case 2:
          return launch_bitmap<2>(vals, row_ptr, blk_cols, x, y, n_rows, bs,
                                  f, s);
        default:
          return launch_bitmap<1>(vals, row_ptr, blk_cols, x, y, n_rows, bs,
                                  f, s);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
