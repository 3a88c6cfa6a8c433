// The chunk walk over one 32-row group's bitmap words, shared by the
// bitmap kernels of bsr_spmm.cu and bsr_nbr_max.cu.
//
// Bitmap blocks are [nb, bs/32, bs] int32 words sorted by block-row
// (bit i % 32 of word [i / 32, j] = cell (i, j)). A warp that owns
// word-row wr of block-row br walks that row's blocks in row_ptr order and
// each block's columns in 32-column chunks, ascending. Both kernels depend
// on this order: it fixes the SpMM's sum order (two launches bit-equal)
// and makes the neighbour-max keep the first of equal maxima, as its plain
// version does. ops/_build.py hashes this header with each source, so an
// edit here rebuilds both.

#pragma once

#include <stdint.h>

namespace bitmap_walk {

constexpr int kGroup = 8;   // 32-column chunks whose words load together

// Chunk q of the block-row is column chunk jc of block k = start + q / nch
// (nch = bs / 32 chunks per block).
struct Walk {
  int k, jc, left;   // position and chunks left
};

// The words of the next kGroup chunks (lane j: word j of each) and their
// column ids, advancing p; past the last chunk, zero words. With kRuns
// (the SpMM's edge form), rv[t] = runs[k * nch + wr], the first value of
// the run of chunk t's block and word-row, where chunk t starts its block,
// and -1 elsewhere.
template <bool kRuns>
__device__ __forceinline__ void load_chunks(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ cols,
    const int32_t* __restrict__ runs, int nch, int wr, int bs, int lane,
    Walk& p, uint32_t (&wv)[kGroup], int (&cv)[kGroup], int (&rv)[kGroup]) {
#pragma unroll
  for (int t = 0; t < kGroup; ++t) {
    wv[t] = 0u;
    cv[t] = 0;
    if (kRuns) rv[t] = -1;
    if (t < p.left) {
      const int j = p.jc * 32 + lane;
      wv[t] = words[(static_cast<size_t>(p.k) * nch + wr) * bs + j];
      cv[t] = cols[p.k] * bs + j;
      if (kRuns && p.jc == 0) {
        rv[t] = runs[static_cast<size_t>(p.k) * nch + wr];
      }
      if (++p.jc == nch) {
        p.jc = 0;
        ++p.k;
      }
    }
  }
  p.left = p.left > kGroup ? p.left - kGroup : 0;
}

__device__ __forceinline__ void load_group(const uint32_t* __restrict__ words,
                                           const int32_t* __restrict__ cols,
                                           int nch, int wr, int bs, int lane,
                                           Walk& p, uint32_t (&wv)[kGroup],
                                           int (&cv)[kGroup]) {
  int rv[kGroup];
  load_chunks<false>(words, cols, nullptr, nch, wr, bs, lane, p, wv, cv, rv);
}

}  // namespace bitmap_walk
