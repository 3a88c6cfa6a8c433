// Block-sparse matrix times dense matrix: y = S @ x, f32 accumulation.
//
// Replaces the TPU kernels of distgcn_tpu/ops/spmm.py:
//   _spmm_row_kernel (launcher _bsr_spmm_rows, row grid),
//   _spmm_kernel     (launcher _bsr_spmm, block grid).
// Both compute the same function; the block grid left block-rows without
// a block unset, here they give 0.
//
// S is given as the bitmap of its structure: blocks [nb, bs/32, bs] int32
// sorted by block-row, indexed by row_ptr [R+1] and blk_cols [nb] (bit
// i % 32 of word [i / 32, j] = cell (i, j)). A weighted S adds its edge
// form (ops/spmm.py, EdgeValues): vals [nnz] f32 or bf16, ordered by
// (block, word-row g, column c, bit b), the order in which a warp below
// meets the set bits, and off [nb * bs/32 + 1], the first value of each
// (block, word-row) run. Value and int8 blocks reach this kernel only
// through that form; their dense blocks (~1.3% full on the bench graph)
// are never read. x is [n_cols, F] f32 row-major; y is [n_rows, F] f32.
// Blocks past row_ptr[R] (a sharded panel's padding) are never read.
//
// What bounds it on an H100: the work the data needs is one add (one FMA
// when weighted) per stored edge and feature (nnz * F: 0.41 G at N=65,536,
// F=128), and the bytes are the structure, the values, x and y: 16.1 MB
// of words + 12.7 MB of f32 values + 2 * 33.5 MB at F=128, about 0.029 ms
// at 3.35 TB/s (the old value blocks alone were 994 MB).
//
// Design: one warp owns a 32-row group (one word-row of its block-row) and
// a slice of 32 * V features, V = 4, 2 or 1 per lane (the widest that F
// and the alignment of x and y allow). Only 9.6% of the bench graph's
// words are nonzero, each with 8.2 edges on average, so the warp reads x
// once per nonzero word, not once per edge. It walks its block-row's
// blocks in row_ptr order, loading the words of 8 32-column chunks at a
// time (lane j one word of each; the next 8 are in flight while the
// current ones are listed), compacts the nonzero words into a per-warp
// list in shared memory, in column order, and streams the listed words
// through a per-warp ring of 4 pieces of 4 in shared memory: cp.async
// brings each listed word's x row (this lane's V features) while the warp
// works on earlier ones. A listed word's x is added into the accumulators
// of its set rows, 32 rows x V features held in registers, by predicated
// adds: nothing in the loop over listed words branches.
//
// Values: when the walk lists a chunk, a warp prefix sum of the words'
// popcounts, from the run's offset, gives each listed word the index of
// its first value; in the ring, lane b brings the value of row b of the
// word (index + popc of the word's bits below b) by a predicated cp.async
// of 4 bytes into the piece, beside the word's x row (bf16 values are
// loaded, widened to f32 and stored by the lane). Each set row then takes
// an FMA of value x x where it took an add, its value read from the piece
// by broadcast shared-memory loads (8 of 16 bytes per listed word).
//
// What bounds it: the issue of those adds. Every lane issues the add (or
// FMA) of every row, set or not (8.2 of 32 are set on the bench graph):
// ~386k listed words x ~140 instructions at V = 4, about 0.05 ms at 1.98
// GHz; the values add the prefix sums, the value loads and the reads from
// shared memory. Skipping 8 or 16 empty rows at a time by a uniform branch
// cost more than the adds it saved at two warps per scheduler (200
// registers), and so did branching per listed word; 16 rows per warp and
// a deeper ring changed nothing (PERF.md). The sum order of a row is fixed
// (blocks in row_ptr order, columns ascending): no atomics, two launches
// are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitmap_walk.cuh"

namespace {

using bitmap_walk::kGroup;
using bitmap_walk::load_chunks;
using bitmap_walk::Walk;

enum Values { kNone = 0, kF32 = 1, kBf16 = 2 };

constexpr int kWarps = 4;   // warps per CTA
constexpr int kPiece = 4;   // listed words per cp.async group
constexpr int kRing = 4;    // pieces in a warp's ring: kRing - 1 in flight
constexpr int kSlots = kPiece * kRing;
constexpr int kList = kGroup * 32 + kPiece;   // list entries, see WarpSmem
constexpr int kMaxDevices = 16;
constexpr unsigned kFull = 0xffffffffu;

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

// acc[b] += vs[b] * xv for every set bit b of w, by predicated FMAs; vs
// (16-byte aligned, shared) read 4 rows at a time
template <int V>
__device__ __forceinline__ void fma_word(float (&acc)[32][V], uint32_t w,
                                         const float* vs,
                                         const float (&xv)[V]) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v4 = reinterpret_cast<const float4*>(vs)[q];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (w & (1u << (4 * q + r))) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc[4 * q + r][i] = fmaf(v[r], xv[i], acc[4 * q + r][i]);
        }
      }
    }
  }
}

// cp.async of N floats when `on`, predicated (no branch)
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool on) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], %3;\n}\n" ::"r"(d),
      "l"(src), "r"(static_cast<int>(on)), "n"(N * 4));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's shared memory: the x rows of the listed words in flight
// ([kSlots][32 lanes][V] f32), their rows' values (weighted only), the
// words of the slots, the count of each piece, and the list of one
// group's nonzero words, their columns and (weighted) the index of their
// first value. The list runs kPiece entries past the longest: a piece
// reads kPiece entries whatever its count, for the addresses of its
// predicated cp.async (off past the count), without a select per slot.
template <int V, bool VALS>
struct alignas(16) WarpSmem {
  float xr[kSlots][32 * V];
  float vs[VALS ? kSlots : 1][32];
  uint32_t ws[kSlots];
  int pn[kRing];
  uint32_t lw[kList];
  int32_t lc[kList];
  int32_t lo[VALS ? kList : 1];
};

// The producer side of a warp: the walk over its block-row's chunks, the
// cursor in the list, and (weighted) the value index of the next chunk.
struct Feed {
  Walk p;
  int li, ln;          // list cursor and length
  bool pending;        // wv/cv hold a group not yet listed
  int vcur;
};

// Puts the next listed words, at most kPiece, into the ring: cp.async of
// their x rows (this lane's V features) into slot (piece % kRing), their
// words beside (0 past the piece's count) and, weighted, the value of
// each set row (lane b: row b); lists the next group's nonzero words
// first when the list has run out. A piece is empty only once the walk
// has ended. Commits one cp.async group, possibly empty; no branch per
// listed word.
template <int V, int VK>
__device__ __forceinline__ void produce(
    WarpSmem<V, VK != kNone>& sm, Feed& fd, uint32_t (&wv)[kGroup],
    int (&cv)[kGroup], int (&rv)[kGroup], const uint32_t* __restrict__ words,
    const int32_t* __restrict__ cols, const void* __restrict__ vals,
    const int32_t* __restrict__ off, const float* __restrict__ x, int nch,
    int wr, int bs, int f, int fl, bool active, int lane, int piece) {
  constexpr bool kVals = VK != kNone;
  const uint32_t below = (1u << lane) - 1u;
  while (fd.li == fd.ln && fd.pending) {
    __syncwarp();  // every lane has read the list
    int n = 0;
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      int vo = 0;
      if (kVals) {
        // this word's first value: the run's offset at a block's first
        // chunk, then the popcounts of the run's earlier words
        if (rv[t] >= 0) fd.vcur = rv[t];
        const int c = __popc(wv[t]);
        int inc = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int up = __shfl_up_sync(kFull, inc, d);
          if (lane >= d) inc += up;
        }
        vo = fd.vcur + inc - c;
        fd.vcur += __shfl_sync(kFull, inc, 31);
      }
      const uint32_t m = __ballot_sync(kFull, wv[t] != 0u);
      if (wv[t] != 0u) {
        const int at = n + __popc(m & below);
        sm.lw[at] = wv[t];
        sm.lc[at] = cv[t];
        if (kVals) sm.lo[at] = vo;
      }
      n += __popc(m);
    }
    __syncwarp();
    fd.li = 0;
    fd.ln = n;
    fd.pending = fd.p.left > 0;
    if (fd.pending) {
      load_chunks<kVals>(words, cols, off, nch, wr, bs, lane, fd.p, wv, cv,
                         rv);
    }
  }
  const int slot0 = (piece % kRing) * kPiece;
  const int cnt = min(kPiece, fd.ln - fd.li);
#pragma unroll
  for (int u = 0; u < kPiece; ++u) {
    cp_async<V>(&sm.xr[slot0 + u][lane * V],
                x + static_cast<size_t>(sm.lc[fd.li + u]) * f + fl,
                u < cnt && active);
  }
  if (kVals) {
#pragma unroll
    for (int u = 0; u < kPiece; ++u) {
      const uint32_t w = sm.lw[fd.li + u];
      const int at = sm.lo[fd.li + u] + __popc(w & below);
      const bool on = u < cnt && ((w >> lane) & 1u);
      if (VK == kF32) {
        cp_async<1>(&sm.vs[slot0 + u][lane],
                    static_cast<const float*>(vals) + at, on);
      } else if (on) {
        sm.vs[slot0 + u][lane] = __bfloat162float(
            static_cast<const __nv_bfloat16*>(vals)[at]);
      }
    }
  }
  if (lane < kPiece) {
    sm.ws[slot0 + lane] = lane < cnt ? sm.lw[fd.li + lane] : 0u;
  }
  if (lane == 0) sm.pn[piece % kRing] = cnt;
  fd.li += cnt;
  cp_async_commit();
}

template <int V, int VK>
__global__ void __launch_bounds__(kWarps * 32)
    bsr_spmm_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ blk_cols,
                    const void* __restrict__ vals,
                    const int32_t* __restrict__ off,
                    const float* __restrict__ x, float* __restrict__ y,
                    int n_groups, int n_slices, int bs, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + warp;
  if (gw >= n_groups * n_slices) return;  // whole warp
  auto& sm = reinterpret_cast<WarpSmem<V, VK != kNone>*>(smem)[warp];
  const int grp = gw / n_slices;   // rows 32 * grp ..
  const int fl = (gw - grp * n_slices) * 32 * V + lane * V;  // lane's features
  const bool active = fl < f;   // f is a multiple of V
  const int nch = bs >> 5;
  const int br = grp / nch;
  const int wr = grp - br * nch;   // word-row
  const int start = row_ptr[br];
  Feed fd{{start, 0, (row_ptr[br + 1] - start) * nch}, 0, 0, false, 0};
  uint32_t wv[kGroup];
  int cv[kGroup], rv[kGroup];
  fd.pending = fd.p.left > 0;
  if (fd.pending) {
    load_chunks<VK != kNone>(words, blk_cols, off, nch, wr, bs, lane, fd.p,
                             wv, cv, rv);
  }

  float acc[32][V];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[b][i] = 0.0f;
  }
  for (int j = 0; j < kRing - 1; ++j) {
    produce<V, VK>(sm, fd, wv, cv, rv, words, blk_cols, vals, off, x, nch,
                   wr, bs, f, fl, active, lane, j);
  }
  // the first empty piece ends the walk
  for (int j = 0;; ++j) {
    cp_async_wait<kRing - 2>();
    __syncwarp();
    const int slot0 = (j % kRing) * kPiece;
    if (sm.pn[j % kRing] == 0) break;
    // every slot of the piece: past its count the word is 0 and adds
    // nothing (the x and values there are stale and never used)
#pragma unroll
    for (int u = 0; u < kPiece; ++u) {
      const typename Vec<V>::T t =
          *reinterpret_cast<const typename Vec<V>::T*>(
              &sm.xr[slot0 + u][lane * V]);
      const float* s = reinterpret_cast<const float*>(&t);
      float xv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) xv[i] = s[i];
      if (VK == kNone) {
        add_word<V>(acc, sm.ws[slot0 + u], xv);
      } else {
        fma_word<V>(acc, sm.ws[slot0 + u], sm.vs[slot0 + u], xv);
      }
    }
    produce<V, VK>(sm, fd, wv, cv, rv, words, blk_cols, vals, off, x, nch,
                   wr, bs, f, fl, active, lane, j + kRing - 1);
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

template <int V, int VK>
int launch(const void* words, const void* row_ptr, const void* blk_cols,
           const void* vals, const void* off, const void* x, void* y,
           int n_rows, int bs, int f, cudaStream_t stream) {
  const int n_groups = n_rows / 32;
  const int n_slices = (f + 32 * V - 1) / (32 * V);
  const long long warps = static_cast<long long>(n_groups) * n_slices;
  const int grid = static_cast<int>((warps + kWarps - 1) / kWarps);
  // 41,984 bytes (V = 4) for a structure, 53,760 with values: past the
  // 48 KB a launch may take unless the kernel's limit is raised, once per
  // device
  const int smem =
      static_cast<int>(kWarps * sizeof(WarpSmem<V, VK != kNone>));
  static_assert(kWarps * sizeof(WarpSmem<4, true>) <= 227 * 1024, "smem");
  if (smem > 48 * 1024) {
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(bsr_spmm_kernel<V, VK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
  }
  bsr_spmm_kernel<V, VK><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols), vals,
      static_cast<const int32_t*>(off), static_cast<const float*>(x),
      static_cast<float*>(y), n_groups, n_slices, bs, f);
  return static_cast<int>(cudaGetLastError());
}

template <int VK>
int launch_width(const void* words, const void* row_ptr,
                 const void* blk_cols, const void* vals, const void* off,
                 const void* x, void* y, int n_rows, int bs, int f,
                 cudaStream_t s) {
  // features per lane: the widest vector that f and the alignment of x
  // and y allow
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y);
  if (f % 4 == 0 && a % 16 == 0) {
    return launch<4, VK>(words, row_ptr, blk_cols, vals, off, x, y, n_rows,
                         bs, f, s);
  }
  if (f % 2 == 0 && a % 8 == 0) {
    return launch<2, VK>(words, row_ptr, blk_cols, vals, off, x, y, n_rows,
                         bs, f, s);
  }
  return launch<1, VK>(words, row_ptr, blk_cols, vals, off, x, y, n_rows, bs,
                       f, s);
}

}  // namespace

extern "C" {

// words: bitmap blocks [nb, bs/32, bs] int32; row_ptr int32 [n_rows/bs +
// 1], blk_cols int32 [nb]; values: 0 none (a 0/1 structure; vals and off
// unread), 1 f32, 2 bf16 vals [nnz] with off int32 [nb * bs/32 + 1] (the
// edge form); x f32 [n_cols, f] -> y f32 [n_rows, f]. bs is a multiple of
// 32 and divides n_rows. Launches on `stream` without synchronising;
// returns the cudaError_t of the launch (0 = success).
int bsr_spmm_launch(const void* words, const void* row_ptr,
                    const void* blk_cols, const void* vals, int values,
                    const void* off, const void* x, void* y, int n_rows,
                    int bs, int f, void* stream) {
  if (bs < 32 || bs % 32 != 0 || n_rows < 0 || n_rows % bs != 0 || f < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (values) {
    case kNone:
      return launch_width<kNone>(words, row_ptr, blk_cols, vals, off, x, y,
                                 n_rows, bs, f, s);
    case kF32:
      return launch_width<kF32>(words, row_ptr, blk_cols, vals, off, x, y,
                                n_rows, bs, f, s);
    case kBf16:
      return launch_width<kBf16>(words, row_ptr, blk_cols, vals, off, x, y,
                                 n_rows, bs, f, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
