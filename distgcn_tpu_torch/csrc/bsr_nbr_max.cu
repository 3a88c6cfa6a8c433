// Block-sparse neighbour-max: y[i] = max over j with S[i, j] != 0 of x[j].
//
// Replaces the TPU kernels of distgcn_tpu/ops/spmm.py that compute this
// function over 0/1 structure blocks. With an f32 payload
// (bsr_nbr_max_f32_launch):
//   _nbr_max_chunk_kernel (launcher _bsr_nbr_max_chunks),
//   _nbr_max_panel_kernel (_bsr_nbr_max_panels),
//   _nbr_max_kernel       (_bsr_nbr_max, block grid),
//   _nbr_max_row_kernel   (_bsr_nbr_max_rows).
// On the TPU they differ only in how the blocks are tiled through VMEM;
// here one kernel covers them. With an int32 payload
// (bsr_nbr_max_i32_launch), the same templates instantiated for int32_t:
//   _nbr_max_row_kernel_i32 (_bsr_nbr_max_rows_i32), which carries the
//   sharded solve's LGS ranks exactly past 2^24 nodes. Payloads are
//   compared as integers and never pass through float.
//
// Blocks: int8 [nb, bs, bs] (nonzero = edge) or bitmap [nb, bs/32, bs]
// int32 words, bit i % 32 of word [i / 32, j] = cell (i, j) (the JAX
// package's pack_bits_blocks layout). Blocks are sorted by block-row and
// row_ptr [R+1] indexes them; blocks past row_ptr[R] (a sharded panel's
// padding) are never read. A row with no neighbour, padding rows and
// empty block-rows included, gets the sentinel: -3.0e38 for f32,
// -(2^31)+1 for int32.
//
// Every row takes its neighbours in one order, blocks in row_ptr order
// and columns ascending within a block, with the rule m = v > m ? v : m:
// the first maximum seen wins, so a tie of +0.0 and -0.0 keeps the one in
// the first column. No atomics; the result is the plain version's, bit for
// bit (`ops.spmm.bsr_nbr_max_plain` resolves ties the same way).
//
// What bounds it on an H100: bytes. At N=65,536 (bs=256, 1,966 bitmap
// blocks) one pass must read 16.1 MB of words plus x and write y: about
// 5 us at 3.35 TB/s. The operations (one compare per edge) are far below
// the card's rate.
//
// Bitmap blocks (every large LGS): one warp per 32-row group (one
// word-row of a block-row), 8 warps per CTA, no __syncthreads. The warp
// walks its block-row's blocks in row_ptr order, 8 32-column chunks at a
// time: lane j loads word j of each chunk, and x of that column only where
// the word is nonzero (9.6% of the bench graph's words). The words of the
// group after next and the x values of the next group are in flight while
// a group is visited. Ballots compact a group's nonzero words and their x
// into a per-warp list in shared memory, in column order; every lane
// reads the list (broadcasts, several reads in flight) and lane b takes
// the value when bit b is set: ~4 instructions per nonzero word instead
// of 32 shared-memory steps per word, zero words included; the list beat
// visiting the words through two shuffles each. What holds it at ~4.7x
// its byte bound on an H100 SXM at 700 W is not split by the
// measurements: 4, 8 or 16 warps per CTA, groups of 16 chunks, or two
// warps sharing a group's walk timed the same within the card's noise
// (PERF.md).
//
// int8 blocks keep the first design: one CTA per block-row, one thread
// per row, the block's x segment staged in shared memory and each thread
// scanning its row's 16-byte cell vectors.
//
// A round of the large LGS (large.bsr_lgs) is two launches of the bitmap
// kernel whose final store is replaced by the round's element-wise logic
// for the warp's own rows (the walk and the max are the same code):
//   rank pass   (bsr_nbr_max_lgs_rank_launch), x = key, where key[j] is
//     node j's rank while it is undecided and -1 once decided:
//     win[i] = key[i] >= 0 && key[i] > m ? 1 : 0, and *cur = 0. The
//     key[i] >= 0 test keeps a decided row with no neighbour (m is the
//     sentinel) from winning.
//   spread pass (bsr_nbr_max_lgs_spread_launch), x = win: a winner gets
//     sel = 1, an undecided row with a winning neighbour (m > 0) gets
//     sel = 0, and both get key = -1; *cur += the rows still undecided
//     (one atomicAdd a warp, exact in any order).
// The rank pass reads the neighbours' key and writes only win; the spread
// pass reads the neighbours' win and writes only its own rows' key and
// sel: neither reads what it writes.
//
// Both passes of a round take two counts: *prev, the previous round's
// count of rows left (or any nonzero value before the first round), and
// *cur, this round's. Where *prev is 0 the round has nothing to do, and
// both passes return before their walk: the rank pass only zeroes *cur,
// so the rounds after it stay gated too. So the host may enqueue several
// rounds between two reads of the counts (large.bsr_lgs): a round past
// the last costs a launch, not two walks. *prev is written only by the
// previous round's spread pass, so it is fixed during either launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bitmap_walk.cuh"

namespace {

template <typename T>
struct Payload;

template <>
struct Payload<float> {
  static __device__ __forceinline__ float sentinel() { return -3.0e38f; }
};

template <>
struct Payload<int32_t> {
  static __device__ __forceinline__ int32_t sentinel() {
    return -2147483647;  // -(2^31) + 1
  }
};

template <typename T>
__device__ __forceinline__ T take_max(T m, T v) {
  return v > m ? v : m;
}

// ---------------------------------------------------------------------------
// int8 blocks: one CTA per block-row, one thread per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void nbr_max_int8_kernel(const int8_t* __restrict__ vals,
                                    const int32_t* __restrict__ row_ptr,
                                    const int32_t* __restrict__ blk_cols,
                                    const T* __restrict__ x,
                                    T* __restrict__ y, int bs) {
  static_assert(sizeof(T) == 4, "f32 and int32 payloads");
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);

  const int br = blockIdx.x;
  const int i = threadIdx.x;  // row within the block-row
  const int start = row_ptr[br];
  const int end = row_ptr[br + 1];
  T m = Payload<T>::sentinel();

  for (int k = start; k < end; ++k) {
    const size_t c = static_cast<size_t>(blk_cols[k]);
    __syncthreads();  // every thread is done with the previous block
    xs[i] = x[c * bs + i];
    __syncthreads();
    const int8_t* row = vals + (static_cast<size_t>(k) * bs + i) * bs;
    for (int j = 0; j < bs; j += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + j);
      const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if ((w4[q >> 2] >> (8 * (q & 3))) & 0xffu) {
          m = take_max(m, xs[j + q]);
        }
      }
    }
  }
  y[static_cast<size_t>(br) * bs + i] = m;
}

// ---------------------------------------------------------------------------
// bitmap blocks: one warp per 32-row group
// ---------------------------------------------------------------------------

using bitmap_walk::kGroup;
using bitmap_walk::load_group;
using bitmap_walk::Walk;

constexpr int kWarps = 8;   // warps per CTA of the bitmap kernel

// what the bitmap kernel does with a row's maximum m
enum Epilogue : int {
  kStore = 0,    // y[i] = m
  kRank = 1,     // the LGS round's rank pass (top of the file)
  kSpread = 2,   // its spread pass
};

// the LGS round's state, read and written by the kRank and kSpread passes
struct LgsRound {
  float* key;            // [rows] rank while undecided, -1 once decided
  int8_t* sel;           // [rows] -1 undecided, 1 selected, 0 excluded
  const int32_t* prev;   // rows undecided before the round; 0 gates it
  int32_t* cur;          // rows still undecided after the spread pass
};

template <typename T, int kEpi>
__global__ void __launch_bounds__(kWarps * 32)
    nbr_max_bitmap_kernel(const uint32_t* __restrict__ words,
                          const int32_t* __restrict__ row_ptr,
                          const int32_t* __restrict__ blk_cols,
                          const T* __restrict__ x, T* __restrict__ y,
                          int n_groups, int bs, LgsRound lgs) {
  static_assert(sizeof(T) == 4, "f32 and int32 payloads");
  static_assert(kEpi == kStore || std::is_same_v<T, float>,
                "the LGS passes carry f32");
  if constexpr (kEpi == kRank) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *lgs.cur = 0;
  }
  if constexpr (kEpi != kStore) {
    if (*lgs.prev == 0) return;  // whole launch: no round left to do
  }
  __shared__ uint32_t list_w[kWarps][kGroup * 32];
  __shared__ T list_x[kWarps][kGroup * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = blockIdx.x * kWarps + warp;
  if (grp >= n_groups) return;  // whole warp
  uint32_t* lw = list_w[warp];
  T* lx = list_x[warp];
  const int nch = bs >> 5;
  const int br = grp / nch;
  const int wr = grp - br * nch;
  const int start = row_ptr[br];
  Walk p{start, 0, (row_ptr[br + 1] - start) * nch};
  T m = Payload<T>::sentinel();

  // three groups in flight: the one visited (words and x), the next
  // (words, then x), the one after (words)
  uint32_t wc[kGroup], wn[kGroup], wnn[kGroup];
  int cc[kGroup], cn[kGroup], cnn[kGroup];
  T xc[kGroup], xn[kGroup];
  bool have = p.left > 0;
  load_group(words, blk_cols, nch, wr, bs, lane, p, wc, cc);
  bool have_next = p.left > 0;
  load_group(words, blk_cols, nch, wr, bs, lane, p, wn, cn);
#pragma unroll
  for (int t = 0; t < kGroup; ++t) xc[t] = wc[t] != 0u ? x[cc[t]] : T(0);
  while (have) {
#pragma unroll
    for (int t = 0; t < kGroup; ++t) xn[t] = wn[t] != 0u ? x[cn[t]] : T(0);
    const bool have_nn = p.left > 0;
    load_group(words, blk_cols, nch, wr, bs, lane, p, wnn, cnn);
    // list the group's nonzero words and their x, in column order
    int n = 0;
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      const uint32_t mask = __ballot_sync(0xffffffffu, wc[t] != 0u);
      if (wc[t] != 0u) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
        lw[at] = wc[t];
        lx[at] = xc[t];
      }
      n += __popc(mask);
    }
    __syncwarp();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const uint32_t w = lw[i];
      const T v = lx[i];
      if ((w >> lane) & 1u) m = take_max(m, v);
    }
    __syncwarp();  // the list is rewritten by the next group
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      wc[t] = wn[t];
      xc[t] = xn[t];
      wn[t] = wnn[t];
      cn[t] = cnn[t];
    }
    have = have_next;
    have_next = have_nn;
  }
  const size_t i = static_cast<size_t>(grp) * 32 + lane;
  if constexpr (kEpi == kStore) {
    y[i] = m;
  } else if constexpr (kEpi == kRank) {
    const T k = x[i];                     // x is key
    y[i] = k >= T(0) && k > m ? T(1) : T(0);
  } else {
    const bool won = x[i] > T(0);         // x is win
    bool open = lgs.key[i] >= 0.0f;
    if (won || (open && m > T(0))) {
      lgs.sel[i] = won ? 1 : 0;
      lgs.key[i] = -1.0f;
      open = false;
    }
    const uint32_t live = __ballot_sync(0xffffffffu, open);
    if (lane == 0 && live != 0u) atomicAdd(lgs.cur, __popc(live));
  }
}

template <typename T>
int launch_checked(const void* vals, int bitmap, const void* row_ptr,
                   const void* blk_cols, const void* x, void* y,
                   int n_block_rows, int bs, void* stream) {
  if (bs < 32 || bs > 1024 || bs % 32 != 0 || n_block_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_block_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const int32_t* cols = static_cast<const int32_t*>(blk_cols);
  if (bitmap) {
    const int n_groups = n_block_rows * (bs / 32);
    nbr_max_bitmap_kernel<T, kStore><<<(n_groups + kWarps - 1) / kWarps,
                                       kWarps * 32, 0, s>>>(
        static_cast<const uint32_t*>(vals), rp, cols,
        static_cast<const T*>(x), static_cast<T*>(y), n_groups, bs,
        LgsRound{});
  } else {
    nbr_max_int8_kernel<T><<<n_block_rows, bs, bs * sizeof(T), s>>>(
        static_cast<const int8_t*>(vals), rp, cols, static_cast<const T*>(x),
        static_cast<T*>(y), bs);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kEpi>
int launch_lgs_pass(const void* words, const void* row_ptr,
                    const void* blk_cols, const void* x, void* y,
                    LgsRound lgs, int n_block_rows, int bs, void* stream) {
  if (bs < 32 || bs > 1024 || bs % 32 != 0 || n_block_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_groups = n_block_rows * (bs / 32);
  if (n_groups == 0) {
    // no row: nothing is undecided
    return static_cast<int>(
        cudaMemsetAsync(lgs.cur, 0, sizeof(int32_t), s));
  }
  nbr_max_bitmap_kernel<float, kEpi><<<(n_groups + kWarps - 1) / kWarps,
                                       kWarps * 32, 0, s>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols), static_cast<const float*>(x),
      static_cast<float*>(y), n_groups, bs, lgs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vals: int8 [nb, bs, bs] (bitmap = 0) or int32 [nb, bs/32, bs]
// (bitmap = 1); row_ptr int32 [n_block_rows + 1]; blk_cols int32 [nb];
// x [n_cols] (n_cols a multiple of bs, covering every block column)
// -> y [n_block_rows * bs], both f32 (bsr_nbr_max_f32_launch) or both
// int32 (bsr_nbr_max_i32_launch). bs is a multiple of 32 in 32..1024.
// The int8 blocks are 16-byte aligned. Launches on `stream` without
// synchronising; returns the cudaError_t of the launch (0 = success).
int bsr_nbr_max_f32_launch(const void* vals, int bitmap, const void* row_ptr,
                           const void* blk_cols, const void* x, void* y,
                           int n_block_rows, int bs, void* stream) {
  return launch_checked<float>(vals, bitmap, row_ptr, blk_cols, x, y,
                               n_block_rows, bs, stream);
}

int bsr_nbr_max_i32_launch(const void* vals, int bitmap, const void* row_ptr,
                           const void* blk_cols, const void* x, void* y,
                           int n_block_rows, int bs, void* stream) {
  return launch_checked<int32_t>(vals, bitmap, row_ptr, blk_cols, x, y,
                                 n_block_rows, bs, stream);
}

// One round of the large LGS over bitmap blocks is two launches on
// `stream` (top of the file): the rank pass zeroes *cur, then reads key
// and writes win; the spread pass reads win, updates key and sel (int8)
// and counts the rows still undecided into *cur. Where *prev is 0 both
// do nothing else. key, win and sel have n_block_rows * bs rows and cover
// every block column; prev and cur are two different int32.
int bsr_nbr_max_lgs_rank_launch(const void* words, const void* row_ptr,
                                const void* blk_cols, const void* key,
                                void* win, const void* prev, void* cur,
                                int n_block_rows, int bs, void* stream) {
  return launch_lgs_pass<kRank>(
      words, row_ptr, blk_cols, key, win,
      LgsRound{nullptr, nullptr, static_cast<const int32_t*>(prev),
               static_cast<int32_t*>(cur)},
      n_block_rows, bs, stream);
}

int bsr_nbr_max_lgs_spread_launch(const void* words, const void* row_ptr,
                                  const void* blk_cols, const void* win,
                                  void* key, void* sel, const void* prev,
                                  void* cur, int n_block_rows, int bs,
                                  void* stream) {
  return launch_lgs_pass<kSpread>(
      words, row_ptr, blk_cols, win, nullptr,
      LgsRound{static_cast<float*>(key), static_cast<int8_t*>(sel),
               static_cast<const int32_t*>(prev),
               static_cast<int32_t*>(cur)},
      n_block_rows, bs, stream);
}

const char* bsr_nbr_max_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
