// Local Greedy Search (LGS): the whole multi-round solve of one graph per CTA.
//
// Replaces the TPU kernel distgcn_tpu/ops/lgs_pallas.py:_lgs_kernel
// (launcher batched_lgs_pallas). Same contract: nodes carry distinct
// priority ranks (ops/lgs.py:lgs_ranks, the (w, -id) total order), and each
// synchronized round
//   1. takes the max rank over each remaining node's remaining neighbours,
//   2. lets a remaining node win iff its rank is strictly greater,
//   3. excludes the remaining non-winners that have a winning neighbour,
// until no node remains or `cap` rounds ran. Output per graph: sel in
// {-1 remaining, 0 excluded/padding, 1 selected} and its own round count.
//
// What bounds it on an H100: bytes. One launch must read the int8 [B, N, N]
// adjacency once (8.39 MB at B=128, N=256), the ranks and mask, and write
// sel: ~2.6 us at 3.35 TB/s. The XLA form re-reads the adjacency every round.
//
// What the design does about it: the adjacency is read from device memory
// exactly once, with 16-byte loads where rows are 16-byte aligned, and packed
// 8x into a row bitmask in shared memory (N*N/8 bytes: 8 KB at N=256, 132 KB
// at N=1024 with the odd row stride below). All rounds then run out of shared
// memory: one thread per node scans `row & remain` words for its neighbours'
// max rank, winners are published with __ballot_sync, and __syncthreads_or
// decides the next round. Each graph stops after its own rounds. The round
// phase is latency-bound (two barriers per round), not bandwidth-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 1024;

__device__ __forceinline__ uint32_t positive_bits4(uint32_t x) {
  // bit k set iff signed byte k of x is > 0 (the JAX `adj > 0` test)
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bits |= static_cast<uint32_t>(static_cast<int8_t>(x >> (8 * k)) > 0) << k;
  }
  return bits;
}

__device__ __forceinline__ uint32_t positive_bits16(uint4 v) {
  return positive_bits4(v.x) | (positive_bits4(v.y) << 4) |
         (positive_bits4(v.z) << 8) | (positive_bits4(v.w) << 12);
}

// Shared memory: rows [n][stride] u32 | ranks [n] i32 | remain [words] u32 |
// win [words] u32. stride = words | 1 is odd, so the threads of a warp, each
// reading word w of its own row, hit 32 distinct banks.
__global__ void __launch_bounds__(kMaxN)
    lgs_kernel(const int8_t* __restrict__ adj,
               const int32_t* __restrict__ ranks,
               const uint8_t* __restrict__ mask, int8_t* __restrict__ sel,
               int32_t* __restrict__ rounds, int n, int cap, int vec16) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) >> 5;
  const int stride = words | 1;
  uint32_t* rows = smem;
  int32_t* rank_s = reinterpret_cast<int32_t*>(rows + n * stride);
  uint32_t* remain = reinterpret_cast<uint32_t*>(rank_s + n);
  uint32_t* win = remain + words;

  const int g = blockIdx.x;
  const int v = threadIdx.x;
  const int lane = v & 31;
  const int warp = v >> 5;
  const int8_t* a = adj + static_cast<size_t>(g) * n * n;

  // prologue: int8 [n, n] -> row bitmask, consecutive threads on
  // consecutive 32-byte row chunks
  for (int idx = v; idx < n * words; idx += blockDim.x) {
    const int i = idx / words;
    const int w = idx - i * words;
    const int8_t* p = a + static_cast<size_t>(i) * n + (w << 5);
    uint32_t bits = 0;
    if (vec16) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      bits = positive_bits16(q[0]) | (positive_bits16(q[1]) << 16);
    } else {
      const int cnt = min(32, n - (w << 5));  // ragged last word
      for (int k = 0; k < cnt; ++k) {
        bits |= static_cast<uint32_t>(p[k] > 0) << k;
      }
    }
    rows[i * stride + w] = bits;
  }

  // threads v >= n (the tail of the last warp) stay excluded and only take
  // part in the ballots and barriers
  int state = 0;
  int32_t my_rank = 0;
  if (v < n) {
    my_rank = ranks[static_cast<size_t>(g) * n + v];
    rank_s[v] = my_rank;
    state = mask[static_cast<size_t>(g) * n + v] ? -1 : 0;
  }
  uint32_t bal = __ballot_sync(0xffffffffu, state == -1);
  if (lane == 0) remain[warp] = bal;
  int r = 0;
  int any = __syncthreads_or(state == -1);  // also publishes rows and ranks
  const uint32_t* row = rows + v * stride;  // dereferenced only when v < n

  while (any && r < cap) {
    bool won = false;
    if (state == -1) {
      int m = -1;  // no remaining neighbour -> -1 < every rank: wins
      for (int w = 0; w < words; ++w) {
        uint32_t bits = row[w] & remain[w];
        while (bits) {
          const int j = __ffs(bits) - 1;
          bits &= bits - 1;
          m = max(m, rank_s[(w << 5) + j]);
        }
      }
      won = my_rank > m;
    }
    bal = __ballot_sync(0xffffffffu, won);
    if (lane == 0) win[warp] = bal;
    __syncthreads();
    if (won) {
      state = 1;
    } else if (state == -1) {
      bool hit = false;
      for (int w = 0; w < words && !hit; ++w) hit = (row[w] & win[w]) != 0;
      if (hit) state = 0;
    }
    // every read of `remain` in this round happened before the barrier
    // above, and every read of `win` happens before the one below
    bal = __ballot_sync(0xffffffffu, state == -1);
    if (lane == 0) remain[warp] = bal;
    ++r;
    any = __syncthreads_or(state == -1);
  }

  if (v < n) sel[static_cast<size_t>(g) * n + v] = static_cast<int8_t>(state);
  if (v == 0) rounds[g] = r;
}

}  // namespace

extern "C" {

// adj int8 [batch, n, n] (contiguous; > 0 is an edge), ranks int32
// [batch, n], mask uint8/bool [batch, n] -> sel int8 [batch, n], rounds int32
// [batch]. Launches on `stream` without synchronising; returns the
// cudaError_t of the launch (0 = success).
int lgs_launch(const void* adj, const void* ranks, const void* mask,
               void* sel, void* rounds, int batch, int n, int cap,
               void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (n + 31) >> 5;
  const int stride = words | 1;
  const size_t smem =
      (static_cast<size_t>(n) * stride + n + 2 * words) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lgs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec16 =
      (n % 32 == 0) && (reinterpret_cast<uintptr_t>(adj) % 16 == 0);
  lgs_kernel<<<batch, words * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(adj), static_cast<const int32_t*>(ranks),
      static_cast<const uint8_t*>(mask), static_cast<int8_t*>(sel),
      static_cast<int32_t*>(rounds), n, cap, vec16);
  return static_cast<int>(cudaGetLastError());
}

const char* lgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
