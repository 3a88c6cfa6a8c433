// Local Greedy Search (LGS): weights in; ranks, every round, the selection,
// the per-graph rounds and the per-graph utility out, one CTA per graph.
//
// Replaces the TPU kernel distgcn_tpu/ops/lgs_pallas.py:_lgs_kernel
// (launcher batched_lgs_pallas) together with what ran around it: the
// ranks (ops/lgs.py:lgs_ranks, a sort and a scatter) and the utility (a
// where and a sum). The rounds are those of ops/lgs.py: nodes carry
// distinct priority ranks (the (w, -id) total order), and each synchronized
// round
//   1. lets a remaining node win iff its rank is above every remaining
//      neighbour's,
//   2. excludes the remaining non-winners that have a winning neighbour,
// until no node remains or `cap` rounds ran. Output per graph: sel in
// {-1 remaining, 0 excluded/padding, 1 selected}, its own round count and
// the sum of its selected weights.
//
// What bounds it on an H100: bytes. One launch must read the int8 [B, N, N]
// adjacency once, the weights and the mask, and write sel, rounds and util:
// 8.59 MB at B=128, N=256, ~2.6 us at 3.35 TB/s.
//
// What the design does about the three losses of the kernel it replaces:
// 1. Bytes in flight. Every thread issues its first loads before the
//    ranking, 64 KB a CTA (at N <= 256, four threads a node each load four
//    16-byte chunks of a quarter row: the whole graph; above, 1024 threads
//    four chunks each), so the graph arrives while the CTA ranks; later
//    steps are loaded a step ahead of their packing (two buffers). The
//    weights and mask go out before the adjacency.
// 2. Rounds over a rank-ordered bitmask. Nodes are relabelled by rank
//    position p = n - rank (p = 0 ranks highest), and row[p] holds bit q
//    for the neighbour at position q, built straight from the loaded
//    bytes: at N <= 256 the four threads of a row set its bits with a
//    shared-memory atomicOr; above, a thread packs whole rows of its own
//    with plain ORs (a RED into the scratch). Then v at position p wins
//    iff `row[p] & remain` has no bit at a position <= p (<= so that a
//    self-loop keeps v from winning, as in the plain rounds): a few word
//    ANDs, with no load per neighbour and no rank read; at N <= 256 the
//    row and the position's state sit in its thread's registers.
//    Exclusion is `row[p] & win` over every word, so that an asymmetric
//    adjacency keeps the plain rounds too. States are bits: remain (two
//    buffers, so a warp writes the next round's words while other warps
//    still read this round's), win and chosen; at N <= 256 only the
//    position warps take the rounds' barriers (named barrier 1).
// 3. The boundary. The ranks are counted from the weights in shared
//    memory: rank[v] = n - #{u ahead of v}, where u is ahead iff its key
//    is larger, or equal and u < v (order_key: -0.0 equals +0.0, NaN after
//    every number), N compares a node from broadcast reads (split over the
//    four threads of a node at N <= 256). The utility is summed in one
//    fixed order (each thread's positions, lanes by shuffle, then warps in
//    order) in f64 and written in the weights' type, so two launches are
//    bit-equal.
//
// Shared adjacency (`share` > 1): weight rows g = q * share + d, d < share,
// all read adjacency q, so D weight variants of one graph (the diver
// heads' guided completions, the rollout's branches; ops/lgs.py's
// batched_lgs_multi) need no D-fold copy of it. Each CTA still packs its
// own rows (scratch per weight row), and adjacency q starts q * n * n
// bytes from the first, so the alignment test for vec holds for all.
//
// Where the rows live: in dynamic shared memory while they fit beside the
// rest (N up to 1,312: 11.4 KB at N=256, 144 KB at N=1024); above that the
// wrapper passes a device-memory scratch per graph, the rows [n][words|1]
// u32 (1/8 of the adjacency's bytes) and the position -> node map [n]. The
// keys (then the node -> position map) and the state words stay in shared
// memory, which sets the largest N (kMaxN).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kQuadN = 256;  // the largest n launched at four threads a node
constexpr size_t kMaxSmem = 232448;  // a CTA's dynamic shared memory, sm_90

// the weights' type: ops/lgs_cuda.py's WEIGHT_TYPES
enum WeightType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// LGS_CLOCKS=1 builds (scripts/torch_lgs_probe.py) sum, in g_clocks, the SM
// cycles thread 0 of each CTA spends in each phase (ops/lgs_cuda.py's
// PHASES): issuing the first step's loads, weights to keys (with the rows
// zeroed), ranks, the position map, waiting for its first step's bytes,
// packing its rows, the states, the rounds, the outputs; then the CTAs
// counted, the largest CTA's cycles and the first CTA's start and the last
// CTA's end on the global timer. lgs_clocks() reads them.
#ifndef LGS_CLOCKS
#define LGS_CLOCKS 0
#endif
constexpr bool kClocks = LGS_CLOCKS != 0;




constexpr int kPhases = 9;
// the phases, the CTAs, the largest CTA's cycles, ~(the first CTA's start)
// and the last CTA's end on the global timer (ns)
constexpr int kClockSlots = kPhases + 4;
__device__ unsigned long long g_clocks[kClockSlots];

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t positive_bits4(uint32_t x) {
  // bit k set iff signed byte k of x is > 0 (the JAX `adj > 0` test): the
  // top bit of each byte of t is set iff its low 7 bits are not all 0 and
  // its sign is clear; the multiply gathers bits 7, 15, 23, 31 into bits
  // 21..24 (its partial products never share a bit, so nothing carries)
  const uint32_t t = ((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) & ~x & 0x80808080u;
  return (((t >> 7) * 0x00204081u) >> 21) & 0xfu;
}

__device__ __forceinline__ uint32_t positive_bits16(uint4 v) {
  return positive_bits4(v.x) | (positive_bits4(v.y) << 4) |
         (positive_bits4(v.z) << 8) | (positive_bits4(v.w) << 12);
}

__device__ __forceinline__ float load_weight(const void* w, size_t i,
                                             int wt) {
  if (wt == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  }
  if (wt == kF16) return __half2float(static_cast<const __half*>(w)[i]);
  return static_cast<const float*>(w)[i];
}

// A key whose unsigned order is the weights' order, with -0.0 equal to
// +0.0 and NaN below every number (0; no number maps there).
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x);
  const uint32_t mag = b & 0x7fffffffu;
  if (mag > 0x7f800000u) return 0u;
  if (mag == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Shared memory, in u32 units: keys [span] (span = words * 32; the tail
// holds 0, which no real node's rank counts; after the ranking the node ->
// position map) | order [n] (position -> node, when the rows are here) |
// remain x2, win, chosen [words] | rows [n][stride] (when they are here).
// stride = words | 1 is odd, so the threads of a warp, each reading word w
// of its own row, hit 32 distinct banks.
__host__ __device__ __forceinline__ size_t small_words(int n, bool rows) {
  const int words = (n + 31) >> 5;
  return static_cast<size_t>(words) * 36 + (rows ? n : 0);
}

__host__ __device__ __forceinline__ size_t row_words(int n) {
  const int words = (n + 31) >> 5;
  return static_cast<size_t>(n) * (words | 1);
}

// TPN (threads per node) = 4 for n <= 256: 4 * span threads, four to a
// node in the ranking and the packing (a quarter of the keys, a quarter of
// the row each), one to a position in the rounds; else 1. SMEM_ROWS: the
// rows and the order map are in shared memory (scratch unused); else in
// the scratch, row_words(n) + n u32 per graph. ONE_NODE (n <= 1024): one
// position per thread.
template <int TPN, bool SMEM_ROWS, bool ONE_NODE>
__global__ void __launch_bounds__(kMaxThreads)
    lgs_kernel(const int8_t* __restrict__ adj, const void* __restrict__ wts,
               int wt, const uint8_t* __restrict__ mask,
               int8_t* __restrict__ sel, void* __restrict__ util,
               int32_t* __restrict__ rounds, uint32_t* __restrict__ scratch,
               int n, int cap, int vec, int share) {
  constexpr int kLoads = 4;  // 16-byte chunks a thread loads at a time
  constexpr int kScan = 8;   // row words a round's scan loads at a time
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = (n + 31) >> 5;
  const int stride = words | 1;
  const int span = words << 5;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const size_t base_n = static_cast<size_t>(g) * n;

  uint32_t* key = smem;  // keys, then the node -> position map
  uint32_t* remain = smem + span + (SMEM_ROWS ? n : 0);
  uint32_t* next = remain + words;
  uint32_t* win = next + words;
  uint32_t* chosen = win + words;
  uint32_t* rows;
  int32_t* order;
  if (SMEM_ROWS) {
    rows = chosen + words;
    order = reinterpret_cast<int32_t*>(smem + span);
  } else {
    rows = scratch + static_cast<size_t>(g) * (row_words(n) + n);
    order = reinterpret_cast<int32_t*>(rows + row_words(n));
  }

  const long long t_start = kClocks ? clock64() : 0;
  long long t_prev = t_start;
  if (kClocks && tid == 0) atomicMax(&g_clocks[kPhases + 2], ~global_ns());
  auto stamp = [&](int phase) {
    if (kClocks && tid == 0) {
      const long long t = clock64();
      atomicAdd(&g_clocks[phase], static_cast<unsigned long long>(t - t_prev));
      if (phase == kPhases - 1) {
        atomicAdd(&g_clocks[kPhases], 1ull);
        atomicMax(&g_clocks[kPhases + 1],
                  static_cast<unsigned long long>(t - t_start));
        atomicMax(&g_clocks[kPhases + 3], global_ns());
      }
      t_prev = t;
    }
  };

  // f(p) for this thread's positions p = tid, tid + nthreads, ... < span.
  // `span` and nthreads are multiples of 32, so every call runs whole
  // warps (at TPN = 4 the warps of threads past span sit out).
  auto for_pos = [&](auto&& f) {
    if (ONE_NODE) {
      if (tid < span) f(tid);
    } else {
      for (int p = tid; p < span; p += nthreads) f(p);
    }
  };

  // The adjacency in 16-byte chunks, cpr a row, bytes past n read as 0.
  // TPN = 1: thread t packs the rows t, t + nthreads, ... < n, kLoads
  // chunks (a step) at a time, so the row it sets bits in is its own: no
  // atomics in shared memory. TPN = 4: thread 4v + h loads the chunks h,
  // h + 4, h + 8, h + 12 of row v (16 cover a row at n <= 256; the four
  // threads of a row read 64 contiguous bytes a load). The first step's
  // loads are issued before the ranking, each later step's a step ahead
  // (two buffers). vec = 16 (n % 16 == 0, adj 16-byte aligned): a chunk is
  // one 16-byte load; vec = 4 (n % 4 == 0): four 4-byte loads; else 16
  // byte loads.
  const int8_t* a = adj + static_cast<size_t>(g / share) * n * n;
  const int cpr = (n + 15) >> 4;
  const int node = TPN == 4 ? tid >> 2 : tid;  // this thread's first row
  const int part = TPN == 4 ? tid & 3 : 0;
  const int groups = TPN == 4 ? 1 : (cpr + kLoads - 1) / kLoads;
  const int steps =
      node < n ? ((n - 1 - node) / (nthreads / TPN) + 1) * groups : 0;
  // step s: row tid + k * nthreads, chunks c0, c0 + 1, ... (TPN = 1), or
  // row node, chunks part, part + 4, ... (TPN = 4)
  auto chunk_col = [&](int s, int u) -> int {
    if (TPN == 4) return (part + 4 * u) << 4;
    return ((s - (s / groups) * groups) * kLoads + u) << 4;
  };
  auto row_of = [&](int s) -> int {
    return TPN == 4 ? node : tid + (s / groups) * nthreads;
  };
  auto load = [&](int s, uint4(&b)[kLoads]) {
    const int8_t* row = a + static_cast<size_t>(row_of(s)) * n;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int col0 = chunk_col(s, u);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (col0 < n) {
        if (vec == 16) {
          v = __ldg(reinterpret_cast<const uint4*>(row + col0));
        } else if (vec == 4) {
          const uint32_t* q = reinterpret_cast<const uint32_t*>(row + col0);
          v.x = __ldg(q);
          if (col0 + 4 < n) v.y = __ldg(q + 1);
          if (col0 + 8 < n) v.z = __ldg(q + 2);
          if (col0 + 12 < n) v.w = __ldg(q + 3);
        } else {
          uint32_t w4[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int c = 0; c < 16; ++c) {
            if (col0 + c < n) {
              w4[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                                row[col0 + c]))
                            << (8 * (c & 3));
            }
          }
          v = make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
      }
      b[u] = v;
    }
  };
  // TPN = 1: sets row[pos[i]] bit pos[j] for each edge (i, j) of step s's
  // chunks, two set bits a turn (two independent lookups of `key`, which
  // holds the node -> position map by then)
  auto scatter = [&](int s, const uint4(&b)[kLoads]) {
    uint32_t* dst = rows + static_cast<size_t>(key[row_of(s)]) * stride;
    auto set = [&](uint32_t q) {
      if (SMEM_ROWS) {
        dst[q >> 5] |= 1u << (q & 31);
      } else {
        atomicOr(dst + (q >> 5), 1u << (q & 31));  // no return: a RED
      }
    };
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int col0 = chunk_col(s, u);
      uint32_t bits = positive_bits16(b[u]);
      while (bits) {
        const uint32_t q1 = key[col0 + __ffs(bits) - 1];
        bits &= bits - 1;
        if (bits) {
          const uint32_t q2 = key[col0 + __ffs(bits) - 1];
          bits &= bits - 1;
          set(q2);
        }
        set(q1);
      }
    }
  };

  // this thread's first weight and mask byte go out first, then the first
  // step's adjacency loads, in flight for the keys and the ranking; then
  // keys, the mask in natural order (in `next`), zeroed rows and `chosen`
  const float w_first = tid < n ? load_weight(wts, base_n + tid, wt) : 0.f;
  const bool m_first = tid < n && mask[base_n + tid] != 0;
  asm volatile("" ::: "memory");
  uint4 b0[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) b0[u] = make_uint4(0u, 0u, 0u, 0u);
  if (steps > 0) load(0, b0);
  stamp(0);
  for (int v = tid; v < span; v += nthreads) {
    const bool first = v == tid;
    const bool real = v < n;
    const float w = first  ? w_first
                    : real ? load_weight(wts, base_n + v, wt)
                           : 0.f;
    const bool m = first ? m_first : real && mask[base_n + v] != 0;
    key[v] = real ? order_key(w) : 0u;
    const uint32_t bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) next[v >> 5] = bal;
  }
  {
    const size_t nrow = row_words(n);
    for (size_t i = tid; i < nrow; i += nthreads) rows[i] = 0u;
  }
  for (int w = tid; w < words; w += nthreads) chosen[w] = 0u;
  stamp(1);
  __syncthreads();

  // ranks by counting: position of v = #{u ahead of v}. The lanes of a
  // warp hold v in one block [vb, vb + 32): below vb an equal key is ahead
  // (smaller id), above vb + 32 it is not, and the block's keys compare
  // ids. At TPN = 4 the four threads of v count every fourth uint4 of keys
  // (64 contiguous bytes a step between them) and add by shuffles.
  const uint4* key4 = reinterpret_cast<const uint4*>(key);
  auto count = [&](int v) -> int {  // this thread's share of v's count
    const uint32_t kv = key[v];
    const int vb = v & ~31;
    int cnt = 0;
    for (int q = part; q < (vb >> 2); q += TPN) {
      const uint4 k = key4[q];
      cnt += (k.x >= kv) + (k.y >= kv) + (k.z >= kv) + (k.w >= kv);
    }
    for (int q = (vb >> 2) + part; q < (vb >> 2) + 8; q += TPN) {
      const uint4 k = key4[q];
      const int u = q << 2;
      cnt += ((k.x > kv) | ((k.x == kv) & (u < v))) +
             ((k.y > kv) | ((k.y == kv) & (u + 1 < v))) +
             ((k.z > kv) | ((k.z == kv) & (u + 2 < v))) +
             ((k.w > kv) | ((k.w == kv) & (u + 3 < v)));
    }
    for (int q = (vb >> 2) + 8 + part; q < (span >> 2); q += TPN) {
      const uint4 k = key4[q];
      cnt += (k.x > kv) + (k.y > kv) + (k.z > kv) + (k.w > kv);
    }
    return cnt;
  };
  if (TPN == 4) {
    int cnt = count(node);  // node < span: every thread has one
    cnt += __shfl_xor_sync(0xffffffffu, cnt, 1);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, 2);
    if (part == 0 && node < n) order[cnt] = node;
  } else {
    for (int v = tid; v < span; v += nthreads) {
      const int cnt = count(v);
      if (v < n) order[cnt] = v;
    }
  }
  __syncthreads();
  stamp(2);
  for (int p = tid; p < n; p += nthreads) key[order[p]] = p;
  __syncthreads();
  stamp(3);

  if (kClocks && steps > 0) {  // wait for the first step's bytes
    uint32_t x = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      x ^= b0[u].x ^ b0[u].y ^ b0[u].z ^ b0[u].w;
    }
    if (x == 0x9e3779b9u && n < 0) smem[0] = x;  // a use the compiler keeps
  }
  stamp(4);
  // rank-ordered rows from the adjacency
  if constexpr (TPN == 4) {
    // a quarter row a thread, each set bit (i, j) set at row pos[i], bit
    // pos[j] by a shared-memory atomicOr
    if (steps > 0) {
      uint32_t* dst = rows + static_cast<size_t>(key[node]) * stride;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int col0 = chunk_col(0, u);
        uint32_t bits = positive_bits16(b0[u]);
        while (bits) {
          const uint32_t q = key[col0 + __ffs(bits) - 1];
          bits &= bits - 1;
          atomicOr(dst + (q >> 5), 1u << (q & 31));
        }
      }
    }
  } else {
    uint4 b1[kLoads];
    for (int st = 0; st < steps; st += 2) {
      if (st + 1 < steps) load(st + 1, b1);
      scatter(st, b0);
      if (st + 1 < steps) {
        if (st + 2 < steps) load(st + 2, b0);
        scatter(st + 1, b1);
      }
    }
  }
  stamp(5);

  bool left = false;
  float w_own = 0.f;  // ONE_NODE: the weight of the position's node
  for_pos([&](int p) {
    bool rem = false;
    if (p < n) {
      const int v = order[p];
      rem = (next[v >> 5] >> (v & 31)) & 1u;
      if (ONE_NODE) w_own = load_weight(wts, base_n + v, wt);
    }
    const uint32_t bal = __ballot_sync(0xffffffffu, rem);
    if (lane == 0) remain[p >> 5] = bal;
    left |= rem;
  });
  bool rem_own = left;  // TPN = 4: the one position's state, in registers
  bool chosen_own = false;
  int r = 0;
  int any = __syncthreads_or(left);  // also publishes the rows
  // From here on only the threads that hold positions work: at TPN = 4 the
  // others leave, and the barriers count the span threads (named barrier
  // 1); else every thread holds positions and __syncthreads serves.
  if (TPN == 4 && tid >= span) return;
  auto sync = [&]() {
    if (TPN == 4) {
      asm volatile("bar.sync 1, %0;" ::"r"(span) : "memory");
    } else {
      __syncthreads();
    }
  };
  auto sync_or = [&](bool x) -> int {
    if (TPN != 4) return __syncthreads_or(x);
    uint32_t out;
    asm volatile(
        "{\n .reg .pred p, q;\n setp.ne.u32 q, %1, 0;\n"
        " bar.red.or.pred p, 1, %2, q;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(out)
        : "r"(static_cast<uint32_t>(x)), "r"(span)
        : "memory");
    return static_cast<int>(out);
  };
  // n <= 256: a position's row (8 words at most) stays in registers
  uint32_t own[TPN == 4 ? 8 : 1];
  if constexpr (TPN == 4) {
    const uint32_t* row = rows + static_cast<size_t>(tid) * stride;
#pragma unroll
    for (int w = 0; w < 8; ++w) own[w] = tid < n && w < words ? row[w] : 0u;
  }
  stamp(6);

  if constexpr (TPN == 4) {
    // one position a thread (p = tid): its row, its state and whether it
    // won stay in registers; every remain and win word is read at once,
    // so no load waits on another
    const int pw = tid >> 5;
    const uint32_t bit = 1u << (tid & 31);
    while (any && r < cap) {
      uint32_t hit = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        if (w < words) {
          const uint32_t m = w < pw    ? remain[w]
                             : w == pw ? remain[w] & (bit | (bit - 1))
                                       : 0u;
          hit |= own[w] & m;
        }
      }
      const bool won = rem_own && hit == 0;
      const uint32_t wins = __ballot_sync(0xffffffffu, won);
      if (lane == 0) win[pw] = wins;
      sync();
      hit = 0;
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        if (w < words) hit |= own[w] & win[w];
      }
      chosen_own |= won;
      rem_own = rem_own && !won && hit == 0;
      const uint32_t stays = __ballot_sync(0xffffffffu, rem_own);
      if (lane == 0) next[pw] = stays;
      uint32_t* t = remain;
      remain = next;
      next = t;
      ++r;
      any = sync_or(rem_own);
    }
  } else {
    while (any && r < cap) {
      for_pos([&](int p) {
        const int pw = p >> 5;
        const uint32_t bit = 1u << (p & 31);
        bool won = false;
        if (p < n && (remain[pw] & bit)) {
          const uint32_t* row = rows + static_cast<size_t>(p) * stride;
          uint32_t hit = row[pw] & remain[pw] & (bit | (bit - 1));
          for (int w0 = 0; w0 < pw && !hit; w0 += kScan) {
#pragma unroll
            for (int w = w0; w < w0 + kScan; ++w) {
              if (w < pw) hit |= row[w] & remain[w];
            }
          }
          won = hit == 0;
        }
        const uint32_t bal = __ballot_sync(0xffffffffu, won);
        if (lane == 0) win[pw] = bal;
      });
      sync();
      // every read of `win` this round happens before the barrier below;
      // each warp reads only its own words of `remain` and writes `next`
      left = false;
      for_pos([&](int p) {
        const int pw = p >> 5;
        const uint32_t bit = 1u << (p & 31);
        bool stay = false;
        if (p < n && (remain[pw] & bit) && !(win[pw] & bit)) {
          const uint32_t* row = rows + static_cast<size_t>(p) * stride;
          uint32_t hit = 0;
          for (int w0 = 0; w0 < words && !hit; w0 += kScan) {
#pragma unroll
            for (int w = w0; w < w0 + kScan; ++w) {
              if (w < words) hit |= row[w] & win[w];
            }
          }
          stay = hit == 0;
        }
        const uint32_t bal = __ballot_sync(0xffffffffu, stay);
        if (lane == 0) {
          next[pw] = bal;
          chosen[pw] |= win[pw];
        }
        left |= stay;
      });
      uint32_t* t = remain;
      remain = next;
      next = t;
      ++r;
      any = sync_or(left);
    }
  }
  stamp(7);

  double acc = 0.0;
  for_pos([&](int p) {
    if (p < n) {
      const uint32_t bit = 1u << (p & 31);
      const int v = order[p];
      const int8_t s = TPN == 4 ? (rem_own ? -1 : chosen_own ? 1 : 0)
                       : (remain[p >> 5] & bit) ? -1
                       : (chosen[p >> 5] & bit) ? 1
                                                : 0;
      sel[base_n + v] = s;
      if (s == 1) acc += ONE_NODE ? w_own : load_weight(wts, base_n + v, wt);
    }
  });
  if (tid == 0) rounds[g] = r;
  if (util == nullptr) {
    stamp(8);
    return;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  }
  // the keys' words are free (last read by the prologue) and hold a double
  // per warp that holds positions: span >= 2 * min(nthreads, span) / 32 u32
  double* partial = reinterpret_cast<double*>(key);
  if (lane == 0 && tid < span) partial[tid >> 5] = acc;
  sync();
  if (tid == 0) {
    double sum = 0.0;
    for (int w = 0; w < (min(nthreads, span) >> 5); ++w) sum += partial[w];
    if (wt == kBF16) {
      static_cast<__nv_bfloat16*>(util)[g] = __double2bfloat16(sum);
    } else if (wt == kF16) {
      static_cast<__half*>(util)[g] = __double2half(sum);
    } else {
      static_cast<float*>(util)[g] = __double2float_rn(sum);
    }
  }
  stamp(8);
}

// The largest n whose keys and state words (36 u32 per 32 nodes) fit a
// CTA's shared memory, the rows and the order map in the scratch;
// ops/lgs_cuda.py's MAX_N.
constexpr int kMaxN = static_cast<int>(kMaxSmem / sizeof(uint32_t) / 36) * 32;

// true iff the rows and the order map of an n-node graph fit in shared
// memory beside the rest, so that lgs_launch needs no scratch
// (ops/lgs_cuda.rows_in_smem).
bool rows_in_smem(int n) {
  return (small_words(n, true) + row_words(n)) * sizeof(uint32_t) <=
         kMaxSmem;
}

}  // namespace

extern "C" {

// adj int8 [batch / share, n, n] (contiguous; > 0 is an edge), wts
// [batch, n] of type `wtype` (WeightType), mask uint8/bool [batch, n] ->
// sel int8 [batch, n], util [batch] of type `wtype` (null: not computed),
// rounds int32 [batch]. Weight rows g and h share an adjacency iff
// g / share == h / share (share = 1: one adjacency per row). scratch: null
// when rows_in_smem(n), else u32 [batch, n * (words | 1) + n] of device
// memory (per weight row). Launches on `stream` without synchronising;
// returns the cudaError_t of the launch (0 = success).
int lgs_launch(const void* adj, const void* wts, const void* mask, void* sel,
               void* util, void* rounds, void* scratch, int batch, int n,
               int cap, int wtype, int share, void* stream) {
  const bool smem_rows = rows_in_smem(n);
  if (batch < 1 || n < 1 || n > kMaxN || wtype < kF32 || wtype > kF16 ||
      share < 1 || batch % share != 0 ||
      (scratch == nullptr && !smem_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int words = (n + 31) >> 5;
  const uintptr_t base = reinterpret_cast<uintptr_t>(adj);
  const int vec = (n % 16 == 0 && base % 16 == 0) ? 16
                  : (n % 4 == 0 && base % 4 == 0) ? 4
                                                  : 1;
  const size_t smem =
      (small_words(n, smem_rows) + (smem_rows ? row_words(n) : 0)) *
      sizeof(uint32_t);
  const int which = !smem_rows ? 0 : n > kMaxThreads ? 1 : n > kQuadN ? 2 : 3;
  void (*const kernels[4])(const int8_t*, const void*, int, const uint8_t*,
                           int8_t*, void*, int32_t*, uint32_t*, int, int,
                           int, int) = {
      lgs_kernel<1, false, false>, lgs_kernel<1, true, false>,
      lgs_kernel<1, true, true>, lgs_kernel<4, true, true>};
  auto kernel = kernels[which];
  // the largest dynamic shared memory each kernel was opened to (one
  // attribute call per new maximum, not per launch)
  static size_t opened[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  if (smem > opened[which]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opened[which] = smem;
  }
  const int threads = n <= kQuadN               ? words * 128
                      : words * 32 < kMaxThreads ? words * 32
                                                 : kMaxThreads;
  kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(adj), wts, wtype,
      static_cast<const uint8_t*>(mask), static_cast<int8_t*>(sel), util,
      static_cast<int32_t*>(rounds), static_cast<uint32_t*>(scratch), n,
      cap, vec, share);
  return static_cast<int>(cudaGetLastError());
}

// Copies the kClockSlots values of an LGS_CLOCKS=1 build (g_clocks) to
// host[0..kClockSlots) and zeroes them; other builds read zeros.
// Synchronises with the device.
int lgs_clocks(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kClockSlots] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_clocks, zero, sizeof(zero)));
}

const char* lgs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
