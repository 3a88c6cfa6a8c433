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
// 8x into a row bitmask (N*N/8 bytes: 8 KB at N=256). All rounds then scan
// that bitmask: a thread per node (or, above 1024 nodes, each of the 1024
// threads for the nodes v, v + 1024, ...) scans `row & remain` words for its
// neighbours' max rank, winners are published with __ballot_sync, and
// __syncthreads_or decides the next round. Each graph stops after its own
// rounds. The round phase is latency-bound (two barriers per round), not
// bandwidth-bound.
//
// Where the rows live: in dynamic shared memory while the whole layout fits
// a CTA's 227 KB (N up to about 1,300, 137 KB at N=1024 with the odd row
// stride below); above that the wrapper passes a device-memory scratch
// [B, N, words|1] u32 (1/8 of the adjacency's bytes) and the prologue packs
// the rows there. The scan reads through the same `rows` pointer either way.
// Ranks, the int8 per-node states (a register when each thread has one node,
// N <= 1024) and the remain/win words stay in shared memory, which sets the
// largest N (max_n()).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 232448;  // a CTA's dynamic shared memory, sm_90

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

// Shared memory, in u32 units: ranks [n] i32 | remain [words] | win [words] |
// state [n] i8 (padded to a u32) | rows [n][stride] when they are not in
// the scratch. stride = words | 1 is odd, so the threads of a warp, each
// reading word w of its own row, hit 32 distinct banks.
__host__ __device__ __forceinline__ size_t small_words(int n) {
  const int words = (n + 31) >> 5;
  return static_cast<size_t>(n) + 2 * words + (n + 3) / 4;
}

__host__ __device__ __forceinline__ size_t row_words(int n) {
  const int words = (n + 31) >> 5;
  return static_cast<size_t>(n) * (words | 1);
}

// SMEM_ROWS: the rows are in shared memory (scratch unused); else in the
// scratch. ONE_NODE (n <= 1024): one node per thread, whose state, rank and
// round outcome stay in registers as in the one-node-per-thread kernel;
// else the int8 states in shared memory. The instantiations run the same
// code; the template lets the compiler address shared memory directly and
// keep a node's values in registers.
template <bool SMEM_ROWS, bool ONE_NODE>
__global__ void __launch_bounds__(kMaxThreads)
    lgs_kernel(const int8_t* __restrict__ adj,
               const int32_t* __restrict__ ranks,
               const uint8_t* __restrict__ mask, int8_t* __restrict__ sel,
               int32_t* __restrict__ rounds, uint32_t* __restrict__ scratch,
               int n, int cap, int vec16) {
  extern __shared__ uint32_t smem[];
  const int words = (n + 31) >> 5;
  const int stride = words | 1;
  const int span = words << 5;  // nodes rounded up to whole warps
  int32_t* rank_s = reinterpret_cast<int32_t*>(smem);
  uint32_t* remain = smem + n;
  uint32_t* win = remain + words;
  int8_t* state = reinterpret_cast<int8_t*>(win + words);

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* rows = SMEM_ROWS
                       ? smem + small_words(n)
                       : scratch + static_cast<size_t>(g) * row_words(n);
  const int8_t* a = adj + static_cast<size_t>(g) * n * n;

  // f(v) for this thread's nodes v = tid, tid + blockDim.x, ... < span.
  // `span` and blockDim.x are multiples of 32, so every call runs whole
  // warps; ONE_NODE calls f(tid) once, with the node's state, rank and
  // round outcome in registers.
  auto for_nodes = [&](auto&& f) {
    if (ONE_NODE) {
      f(tid);
    } else {
      for (int v = tid; v < span; v += blockDim.x) f(v);
    }
  };
  int8_t own = 0;        // ONE_NODE: node tid's state
  int32_t own_rank = 0;  // ONE_NODE: node tid's rank
  bool own_won = false;  // ONE_NODE: node tid won this round
  auto state_of = [&](int v) -> int8_t { return ONE_NODE ? own : state[v]; };
  auto set_state = [&](int v, int8_t s) {
    if (ONE_NODE) {
      own = s;
    } else {
      state[v] = s;
    }
  };

  // prologue: int8 [n, n] -> row bitmask, consecutive threads on
  // consecutive 32-byte row chunks
  for (int idx = tid; idx < n * words; idx += blockDim.x) {
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
    rows[static_cast<size_t>(i) * stride + w] = bits;
  }

  // nodes v >= n (the tail of the last warp) stay excluded and only take
  // part in the ballots and barriers
  bool left = false;
  for_nodes([&](int v) {
    bool rem = false;
    if (v < n) {
      own_rank = rank_s[v] = ranks[static_cast<size_t>(g) * n + v];
      rem = mask[static_cast<size_t>(g) * n + v] != 0;
      set_state(v, rem ? -1 : 0);
    }
    const uint32_t bal = __ballot_sync(0xffffffffu, rem);
    if (lane == 0) remain[v >> 5] = bal;
    left |= rem;
  });
  int r = 0;
  int any = __syncthreads_or(left);  // also publishes rows and ranks

  while (any && r < cap) {
    for_nodes([&](int v) {
      bool won = false;
      if (v < n && state_of(v) == -1) {
        const uint32_t* row = rows + static_cast<size_t>(v) * stride;
        int m = -1;  // no remaining neighbour -> -1 < every rank: wins
        for (int w = 0; w < words; ++w) {
          uint32_t bits = row[w] & remain[w];
          while (bits) {
            const int j = __ffs(bits) - 1;
            bits &= bits - 1;
            m = max(m, rank_s[(w << 5) + j]);
          }
        }
        won = (ONE_NODE ? own_rank : rank_s[v]) > m;
      }
      own_won = won;
      const uint32_t bal = __ballot_sync(0xffffffffu, won);
      if (lane == 0) win[v >> 5] = bal;
    });
    __syncthreads();
    // every read of `remain` in this round happened before the barrier
    // above, and every read of `win` happens before the one below
    left = false;
    for_nodes([&](int v) {
      bool rem = false;
      if (v < n) {
        if (ONE_NODE ? own_won : ((win[v >> 5] >> (v & 31)) & 1u) != 0) {
          set_state(v, 1);
        } else if (state_of(v) == -1) {
          const uint32_t* row = rows + static_cast<size_t>(v) * stride;
          bool hit = false;
          for (int w = 0; w < words && !hit; ++w) hit = (row[w] & win[w]) != 0;
          if (hit) {
            set_state(v, 0);
          } else {
            rem = true;
          }
        }
      }
      const uint32_t bal = __ballot_sync(0xffffffffu, rem);
      if (lane == 0) remain[v >> 5] = bal;
      left |= rem;
    });
    ++r;
    any = __syncthreads_or(left);
  }

  for_nodes([&](int v) {
    if (v < n) sel[static_cast<size_t>(g) * n + v] = state_of(v);
  });
  if (tid == 0) rounds[g] = r;
}

// The largest n whose ranks, states and remain/win words fit a CTA's shared
// memory (the rows then go to the scratch); ops/lgs_cuda.py's MAX_N.
int max_n() {
  int n = static_cast<int>(kMaxSmem / 5);
  while (small_words(n) * sizeof(uint32_t) > kMaxSmem) --n;
  return n;
}

// true iff the row bitmask of an n-node graph fits in shared memory beside
// the rest, so that lgs_launch needs no scratch (ops/lgs_cuda.rows_in_smem).
bool rows_in_smem(int n) {
  return (small_words(n) + row_words(n)) * sizeof(uint32_t) <= kMaxSmem;
}

}  // namespace

extern "C" {

// adj int8 [batch, n, n] (contiguous; > 0 is an edge), ranks int32
// [batch, n], mask uint8/bool [batch, n] -> sel int8 [batch, n], rounds int32
// [batch]. scratch: null when rows_in_smem(n), else u32
// [batch, n, words|1] of device memory for the row bitmasks. Launches on
// `stream` without synchronising; returns the cudaError_t of the launch
// (0 = success).
int lgs_launch(const void* adj, const void* ranks, const void* mask,
               void* sel, void* rounds, void* scratch, int batch, int n,
               int cap, void* stream) {
  if (batch < 1 || n < 1 || n > max_n() ||
      (scratch == nullptr && !rows_in_smem(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (n + 31) >> 5;
  const size_t smem =
      (small_words(n) + (scratch == nullptr ? row_words(n) : 0)) *
      sizeof(uint32_t);
  auto kernel = scratch != nullptr ? lgs_kernel<false, false>
                : n > kMaxThreads ? lgs_kernel<true, false>
                                  : lgs_kernel<true, true>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec16 =
      (n % 32 == 0) && (reinterpret_cast<uintptr_t>(adj) % 16 == 0);
  const int threads = words * 32 < kMaxThreads ? words * 32 : kMaxThreads;
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(adj), static_cast<const int32_t*>(ranks),
      static_cast<const uint8_t*>(mask), static_cast<int8_t*>(sel),
      static_cast<int32_t*>(rounds), static_cast<uint32_t*>(scratch), n, cap,
      vec16);
  return static_cast<int>(cudaGetLastError());
}

const char* lgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
