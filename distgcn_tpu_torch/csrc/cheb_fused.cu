// One fused ChebGCN layer (supports [I, L], K = 1) over 0/1 structure
// blocks of a separable normalized adjacency Anorm = diag(r) A diag(r):
//
//   out = act( h @ (W0 + W1) + b - bf16(r_row) * bf16((A (r * h)) @ W1) )
//
// Replaces the TPU kernels of distgcn_tpu/ops/cheb_fused.py:
//   _fused_layer_kernel (launcher _fused_cheb_layer, row grid),
//   _fused_panel_kernel (_fused_cheb_layer_panels, panel grid),
//   _fused_gwin_kernel  (_fused_cheb_layer_gwin, gather window).
// The three differ only in how x and r are windowed through VMEM.
//
// Rounding points, as in the Pallas body:
//   - A-product: bf16(ind * r_col) x bf16 activations, f32 accumulation;
//   - h @ (W0 + W1) and acc @ W1: f32 (Precision.HIGHEST there; no TF32);
//   - row scaling: bf16(r_row) * bf16(lag), exact in f32;
//   - out = (y - rlag) + bias; leaky_relu(0.2) as max(v, 0.2 v);
//     stored bf16 (round to nearest even) for hidden layers, f32 for the
//     head.
//
// What bounds it on an H100: the f32 W-products. They are 2 * 2 * N * F^2
// operations (4.3 GFLOP at N=65,536, F=128): about 64 us at 67 TFLOP/s on
// the CUDA cores. The A-product the data needs is 2 * nnz * F (0.81 GFLOP);
// over whole 256x256 blocks it is 2 * 1,966 * 256^2 * 128 = 33 GFLOP, ~33 us
// at the 989 TFLOP/s bf16 tensor-core rate. The bytes (16.1 MB of bitmap
// words, x in and out in bf16, r) take ~15 us at 3.35 TB/s.
//
// Design. Persistent CTAs of 256 threads (8 warps), one per SM, each loading
// W1, W0+W1 and the bias into shared memory once (cp.async, in flight during
// the first tile's phase 1) and then looping over row tiles of
// T = 128 rows (8 warps x 16; the largest multiple of 16 up to 128 that
// divides bs, so a tile never leaves its block-row: 32 and 64 at bs = 32
// and 64, where the warps past T/16 idle in phase 1).
//
// Phase 1, the A-product on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate), 32-column k-chunks at a time:
//   - occupancy scan: the CTA reads its rows' bitmap words of every block of
//     the block-row (the int8 stream: the bytes) and marks in shared memory
//     each k-chunk in which any of its T rows has an edge. On the bench
//     graph (1,966 blocks of 256 in grid order) 36.5% of the (128-row,
//     32-column) chunks are marked, and only those are loaded;
//   - a ring of 4 cp.async stages, each holding a marked chunk's x
//     rows (bf16 [32][F + 8]: the pad makes the ldmatrix row reads
//     conflict-free), its r and each warp's 16-row slice of the structure
//     (32 bitmap words, or 16 x 32 bytes). The chunks are visited in
//     block order, so the sums are taken in a fixed order: no atomics, and
//     two launches give bit-equal outputs;
//   - A fragments are built in registers straight from the words: each lane
//     holds its column's 16 row bits and bf16(r_col) in one u32, and four
//     shuffles give a thread the columns of its fragment; a cell is
//     bit ? bf16(r_col) : 0. B fragments come from the staged x rows with
//     ldmatrix.trans. A warp skips the MMAs of a 16-column step in which
//     none of its 16 rows has an edge (17.7% of them have one on the bench
//     graph), so of the 40x dense work only the occupied slices are done.
//   The warp's f32 accumulator (16 rows x F: 64 registers at F = 128) goes
//   to shared memory once per tile.
//
// Phase 2, the W-products in f32 on the CUDA cores: each thread computes 8
// rows x F/16 columns of acc @ W1, then of h @ W01 (h and r, the tile's own
// rows, staged by cp.async at the tile's start), reading the activations as
// float4 / 4 x bf16 broadcasts and W rows as conflict-free float2s, then
// applies the epilogue and stores.
//
// Shared memory at F = 128 (225 KB of the 227 KB, so one CTA per SM):
// W1 and W0+W1 in f32, 128 KB; a 64 KB region that holds the cp.async ring
// during phase 1 (4 stages of 9.6 KB, 12.6 KB with the int8 stream) and the
// f32 accumulator tile [128][F] during phase 2; the bf16 h tile, 32 KB; the
// bias and the tile's r, 1 KB; the occupancy bits, 256 B. Two CTAs per SM
// would need W out of shared memory, and phase 2 reads every W element once
// per 8 rows: the tile of 128 rows halves phase 1's x traffic against 64
// rows instead.
//
// CHEB_FUSED_COUNT=1 builds count, in cheb_fused_counts(), the chunks loaded
// and skipped, the warp steps computed and skipped, and the CTAs' clock
// cycles by part (scripts/torch_fused_layer_probe.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 16 * kWarps;  // rows of a tile
constexpr int kChunk = 32;             // columns of a k-chunk
constexpr int kWin = 2048;             // k-chunks scanned at a time
constexpr int kWinWords = kWin / 32;
constexpr int kStages = 4;             // cp.async ring depth
constexpr int kScanBatch = 4;          // bitmap chunks a warp scans at once
constexpr int kMaxDevices = 64;

// The phases a build runs: 3 (the default) both. 1 or 2 keep only phase 1
// or phase 2 and compute wrong layers; they only split the time
// (scripts/torch_fused_layer_probe.py).
#ifndef CHEB_FUSED_PHASES
#define CHEB_FUSED_PHASES 3
#endif
constexpr bool kPhase1 = (CHEB_FUSED_PHASES & 1) != 0;
constexpr bool kPhase2 = (CHEB_FUSED_PHASES & 2) != 0;
#ifndef CHEB_FUSED_COUNT
#define CHEB_FUSED_COUNT 0
#endif
constexpr bool kCount = CHEB_FUSED_COUNT != 0;

// The counts of a CHEB_FUSED_COUNT=1 build: chunks loaded, chunks skipped,
// warp k16 steps computed, steps skipped; then SM clock cycles on thread 0
// of each CTA summed over the CTAs: in occupancy scans, in the A-product
// pipeline, in phase 2 (from the end of phase 1 to the end of the tile),
// and in the whole CTA; and the largest CTA's cycles.
constexpr int kNumCounts = 9;
__device__ unsigned long long g_counts[kNumCounts];

__device__ __forceinline__ void count_cycles(int which, long long since) {
  if (kCount && threadIdx.x == 0) {
    atomicAdd(&g_counts[which],
              static_cast<unsigned long long>(clock64() - since));
  }
}

template <int F, bool BITMAP>
struct Layout {
  static constexpr int kXStride = F + 8;  // bf16 per staged x row
  static constexpr int kXBytes = kChunk * kXStride * 2;
  static constexpr int kRBytes = kChunk * 4;
  static constexpr int kIndWarp = BITMAP ? kChunk * 4 : 16 * kChunk;
  static constexpr int kStageBytes = kXBytes + kRBytes + kWarps * kIndWarp;
  static constexpr int kAccBytes = kMaxTile * F * 4;
  // the ring shares its region with the phase-2 accumulator tile
  static constexpr int kRegion = kStages * kStageBytes > kAccBytes
                                     ? kStages * kStageBytes
                                     : kAccBytes;
  static constexpr int kWBytes = F * F * 4;
  static constexpr int kHBytes = kMaxTile * F * 2;
  static constexpr int kVecBytes = F * 4 + kMaxTile * 4;  // bias, tile's r
  static constexpr size_t kSmem = 2 * kWBytes + kRegion + kHBytes +
                                  kVecBytes + kWinWords * 4;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// p packs a column's 16 row bits (low half) and bf16(r_col) (high half):
// the A cell of row `bit` in that column
__device__ __forceinline__ uint32_t cell(uint32_t p, int bit) {
  return ((p >> bit) & 1u) ? (p >> 16) : 0u;
}

template <int F, bool BITMAP>
__global__ void __launch_bounds__(kThreads, 1)
    fused_layer_kernel(const void* __restrict__ ind,
                       const int32_t* __restrict__ row_ptr,
                       const int32_t* __restrict__ blk_cols,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ r,
                       const float* __restrict__ w1,
                       const float* __restrict__ w01,
                       const float* __restrict__ bias, void* __restrict__ out,
                       int out_f32, int act_mode, int n_rows, int bs,
                       int tile_rows) {
  using L = Layout<F, BITMAP>;
  constexpr int NT = F / 8;   // n-tiles of the A-product
  constexpr int NC = F / 32;  // float2 column pairs of a phase-2 thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* sw1 = reinterpret_cast<float*>(smem);
  float* sw01 = sw1 + F * F;
  unsigned char* region = smem + 2 * L::kWBytes;
  float* sacc = reinterpret_cast<float*>(region);  // [kMaxTile][F], phase 2
  __nv_bfloat16* sh =
      reinterpret_cast<__nv_bfloat16*>(region + L::kRegion);  // [kMaxTile][F]
  float* sbias = reinterpret_cast<float*>(region + L::kRegion + L::kHBytes);
  float* srow = sbias + F;  // r of the tile's rows
  uint32_t* occ = reinterpret_cast<uint32_t*>(srow + kMaxTile);

  // W1, W0+W1 and the bias, in flight while the first tile's phase 1 runs
  for (int q = threadIdx.x; q < F * F / 4; q += kThreads) {
    cp_async16(sw1 + 4 * q, w1 + 4 * q);
    cp_async16(sw01 + 4 * q, w01 + 4 * q);
  }
  if (threadIdx.x < F / 4) cp_async16(sbias + 4 * threadIdx.x, bias + 4 * threadIdx.x);
  cp_async_commit();
  const long long t_start = clock64();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in the group
  const int nchb = bs / kChunk;
  const int n_tiles = n_rows / tile_rows;
  const bool has_rows = warp < tile_rows / 16;  // warps with rows in phase 1
  const uint32_t* ind32 = static_cast<const uint32_t*>(ind);
  const int8_t* ind8 = static_cast<const int8_t*>(ind);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * tile_rows;
    const int br = row0 / bs;
    const int li0 = row0 - br * bs;  // the tile's first row in its block
    const int wl = li0 + 16 * warp;  // this warp's first row in the block
    {  // the tile's own activations (contiguous rows of x) and r, for
       // phase 2
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(row0) * F);
      for (int p = tid; p < tile_rows * F / 8; p += kThreads) {
        cp_async16(reinterpret_cast<unsigned char*>(sh) + 16 * p, src + 16 * p);
      }
      if (tid < tile_rows / 4) cp_async16(srow + 4 * tid, r + row0 + 4 * tid);
      cp_async_commit();
    }
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    }

    const int start = row_ptr[br];
    const int total = kPhase1 ? (row_ptr[br + 1] - start) * nchb : 0;
    for (int w0 = 0; w0 < total; w0 += kWin) {
      const int nwin = min(kWin, total - w0);
      for (int i = tid; i < kWinWords; i += kThreads) occ[i] = 0;
      __syncthreads();
      long long t0 = clock64();
      // occupancy scan: bit c of occ is set iff k-chunk w0 + c has an edge
      // in one of the tile's rows
      if (BITMAP) {
        const int q_lo = li0 >> 5;
        const int q_hi = (li0 + tile_rows - 1) >> 5;  // at most q_lo + 4
        uint32_t rmask[5];
#pragma unroll
        for (int qq = 0; qq < 5; ++qq) {
          const int lo = max(li0 - 32 * (q_lo + qq), 0);
          const int hi = min(li0 + tile_rows - 32 * (q_lo + qq), 32);
          const int nb = hi - lo;
          rmask[qq] = q_lo + qq > q_hi ? 0u
                      : nb >= 32      ? 0xffffffffu
                                      : ((1u << nb) - 1u) << lo;
        }
        for (int base = warp; base < nwin; base += kWarps * kScanBatch) {
          uint32_t v[kScanBatch];
#pragma unroll
          for (int u = 0; u < kScanBatch; ++u) {
            const int idx = base + u * kWarps;
            v[u] = 0;
            if (idx < nwin) {
              const int kb = (w0 + idx) / nchb;
              const int jc = w0 + idx - kb * nchb;
              const uint32_t* p =
                  ind32 + (static_cast<size_t>(start + kb) * nchb + q_lo) * bs +
                  jc * kChunk + lane;
#pragma unroll
              for (int qq = 0; qq < 5; ++qq) {
                if (rmask[qq]) v[u] |= p[static_cast<size_t>(qq) * bs] & rmask[qq];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kScanBatch; ++u) {
            const int idx = base + u * kWarps;  // warp-uniform
            if (idx < nwin && __any_sync(0xffffffffu, v[u] != 0) && lane == 0) {
              atomicOr(&occ[idx >> 5], 1u << (idx & 31));
            }
          }
        }
      } else {
        for (int idx = warp; idx < nwin; idx += kWarps) {
          const int kb = (w0 + idx) / nchb;
          const int jc = w0 + idx - kb * nchb;
          const int8_t* p =
              ind8 + (static_cast<size_t>(start + kb) * bs + li0) * bs +
              jc * kChunk;
          uint32_t v = 0;
          for (int pc = lane; pc < 2 * tile_rows; pc += 32) {
            const uint4 q = *reinterpret_cast<const uint4*>(
                p + static_cast<size_t>(pc >> 1) * bs + 16 * (pc & 1));
            v |= q.x | q.y | q.z | q.w;
          }
          if (__any_sync(0xffffffffu, v != 0) && lane == 0) {
            atomicOr(&occ[idx >> 5], 1u << (idx & 31));
          }
        }
      }
      __syncthreads();
      count_cycles(4, t0);
      t0 = clock64();
      int nch = 0;
      for (int i = 0; i < (nwin + 31) / 32; ++i) nch += __popc(occ[i]);
      if (kCount && tid == 0) {
        atomicAdd(&g_counts[0], static_cast<unsigned long long>(nch));
        atomicAdd(&g_counts[1], static_cast<unsigned long long>(nwin - nch));
      }

      // the marked chunks in order: a cursor over occ's set bits
      int cw = -1;
      uint32_t cbits = 0;
      auto next = [&]() {
        while (cbits == 0) cbits = occ[++cw];
        const int b = __ffs(cbits) - 1;
        cbits &= cbits - 1;
        return cw * 32 + b;
      };
      // the block column of chunk idx (a global load: fetched before the
      // wait that precedes its issue, so that the two overlap)
      auto col_of = [&](int idx) { return blk_cols[start + (w0 + idx) / nchb]; };
      auto issue = [&](int idx, int bcol, int stage) {
        unsigned char* st = region + stage * L::kStageBytes;
        __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(st);
        float* sr = reinterpret_cast<float*>(st + L::kXBytes);
        unsigned char* sind = st + L::kXBytes + L::kRBytes + warp * L::kIndWarp;
        const int kb = (w0 + idx) / nchb;
        const int jc = w0 + idx - kb * nchb;
        const int k = start + kb;
        const size_t c0 = static_cast<size_t>(bcol) * bs + jc * kChunk;
        for (int p = tid; p < kChunk * F / 8; p += kThreads) {
          const int row = p / (F / 8);
          const int col = p - row * (F / 8);
          cp_async16(sx + row * L::kXStride + 8 * col,
                     x + (c0 + row) * F + 8 * col);
        }
        if (tid < kChunk / 4) cp_async16(sr + 4 * tid, r + c0 + 4 * tid);
        if (has_rows) {
          if (BITMAP) {
            if (lane < kChunk / 4) {
              cp_async16(sind + 16 * lane,
                         ind32 + (static_cast<size_t>(k) * nchb + (wl >> 5)) * bs +
                             jc * kChunk + 4 * lane);
            }
          } else {
            cp_async16(sind + 32 * (lane >> 1) + 16 * (lane & 1),
                       ind8 + (static_cast<size_t>(k) * bs + wl + (lane >> 1)) * bs +
                           jc * kChunk + 16 * (lane & 1));
          }
        }
      };
      auto compute = [&](int stage) {
        const unsigned char* st = region + stage * L::kStageBytes;
        const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(st);
        const float* sr = reinterpret_cast<const float*>(st + L::kXBytes);
        const unsigned char* sind =
            st + L::kXBytes + L::kRBytes + warp * L::kIndWarp;
        uint32_t bits;  // rows wl..wl+15 of column `lane` of the chunk
        if (BITMAP) {
          bits = (reinterpret_cast<const uint32_t*>(sind)[lane] >> (wl & 16)) &
                 0xffffu;
        } else {
          bits = 0;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            bits |= static_cast<uint32_t>(sind[i * kChunk + lane] != 0) << i;
          }
        }
        const uint32_t pk =
            bits | (static_cast<uint32_t>(
                        __bfloat16_as_ushort(__float2bfloat16_rn(sr[lane])))
                    << 16);
        const uint32_t live = __ballot_sync(0xffffffffu, bits != 0);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          // a 16-column step runs iff one of the warp's rows has an edge
          const bool on = ((live >> (16 * s)) & 0xffffu) != 0;  // warp-uniform
          if (kCount && lane == 0) atomicAdd(&g_counts[on ? 2 : 3], 1ull);
          if (!on) continue;
          const int c = 16 * s + 2 * tig;
          const uint32_t p0 = __shfl_sync(0xffffffffu, pk, c);
          const uint32_t p1 = __shfl_sync(0xffffffffu, pk, c + 1);
          const uint32_t p8 = __shfl_sync(0xffffffffu, pk, c + 8);
          const uint32_t p9 = __shfl_sync(0xffffffffu, pk, c + 9);
          const uint32_t a[4] = {cell(p0, g) | (cell(p1, g) << 16),
                                 cell(p0, g + 8) | (cell(p1, g + 8) << 16),
                                 cell(p8, g) | (cell(p9, g) << 16),
                                 cell(p8, g + 8) | (cell(p9, g + 8) << 16)};
          const __nv_bfloat16* bx =
              sx + (16 * s + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kXStride +
              (lane >> 4) * 8;
#pragma unroll
          for (int pp = 0; pp < F / 16; ++pp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bx + 16 * pp);
            mma_bf16(acc[2 * pp], a, b[0], b[1]);
            mma_bf16(acc[2 * pp + 1], a, b[2], b[3]);
          }
        }
      };

      int pidx[kStages - 1];
      int pcol[kStages - 1];
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) {
        if (t < nch) {
          pidx[t] = next();
          pcol[t] = col_of(pidx[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) {
        if (t < nch) issue(pidx[t], pcol[t], t);
        cp_async_commit();
      }
      for (int i = 0; i < nch; ++i) {
        const bool more = i + kStages - 1 < nch;
        int idx = 0, bcol = 0;
        if (more) {  // its block column loads while this thread waits
          idx = next();
          bcol = col_of(idx);
        }
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk i landed; stage (i - 1) % kStages is free
        if (more) issue(idx, bcol, (i + kStages - 1) % kStages);
        cp_async_commit();
        if (has_rows) compute(i % kStages);
      }
      __syncthreads();  // occ and the ring are rewritten by the next window
      count_cycles(5, t0);
    }
    const long long t2 = clock64();

    cp_async_wait<0>();
    __syncthreads();  // W, the h tile and r landed; the ring is free for sacc
    if (has_rows) {
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float* p = sacc + (16 * warp + g) * F + 8 * t + 2 * tig;
        *reinterpret_cast<float2*>(p) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(p + 8 * F) = make_float2(acc[t][2], acc[t][3]);
      }
    }
    __syncthreads();

    // phase 2: thread (ty, tx) owns rows ty + 16 m (m < 8) and columns
    // 32 c + 2 tx + {0, 1}; rows past tile_rows are computed on stale shared
    // memory and never stored
    const int tx = lane & 15;
    const int ty = 2 * warp + (lane >> 4);
    float lag[8][NC][2];
    float y[8][NC][2];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
#pragma unroll
      for (int c = 0; c < NC; ++c) lag[m][c][0] = lag[m][c][1] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < (kPhase2 ? F : 0); k += 4) {
      float4 a4[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        a4[m] = *reinterpret_cast<const float4*>(sacc + (ty + 16 * m) * F + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float2 wv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          wv[c] = *reinterpret_cast<const float2*>(sw1 + (k + kk) * F + 32 * c +
                                                   2 * tx);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float av = component(a4[m], kk);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            lag[m][c][0] = fmaf(av, wv[c].x, lag[m][c][0]);
            lag[m][c][1] = fmaf(av, wv[c].y, lag[m][c][1]);
          }
        }
      }
    }
    // lag becomes bf16(r_row) * bf16(lag)
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float rr = bf16_round(srow[min(ty + 16 * m, tile_rows - 1)]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        lag[m][c][0] = rr * bf16_round(lag[m][c][0]);
        lag[m][c][1] = rr * bf16_round(lag[m][c][1]);
        y[m][c][0] = y[m][c][1] = 0.0f;
      }
    }
#pragma unroll 2
    for (int k = 0; k < (kPhase2 ? F : 0); k += 4) {
      uint2 h4[8];  // 4 bf16 of row ty + 16 m
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        h4[m] = *reinterpret_cast<const uint2*>(sh + (ty + 16 * m) * F + k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float2 wv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          wv[c] = *reinterpret_cast<const float2*>(sw01 + (k + kk) * F +
                                                   32 * c + 2 * tx);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const uint32_t hw = kk < 2 ? h4[m].x : h4[m].y;
          const float hv = __uint_as_float((kk & 1) ? (hw & 0xffff0000u)
                                                    : (hw << 16));
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            y[m][c][0] = fmaf(hv, wv[c].x, y[m][c][0]);
            y[m][c][1] = fmaf(hv, wv[c].y, y[m][c][1]);
          }
        }
      }
    }
    float2 b2[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      b2[c] = *reinterpret_cast<const float2*>(sbias + 32 * c + 2 * tx);
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int row = ty + 16 * m;
      if (row >= tile_rows) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float v0 = (y[m][c][0] - lag[m][c][0]) + b2[c].x;
        float v1 = (y[m][c][1] - lag[m][c][1]) + b2[c].y;
        if (act_mode == 1) {
          v0 = fmaxf(v0, 0.2f * v0);
          v1 = fmaxf(v1, 0.2f * v1);
        }
        const size_t o =
            static_cast<size_t>(row0 + row) * F + 32 * c + 2 * tx;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();  // sacc / sh / occ are rewritten by the next tile
    count_cycles(6, t2);
  }
  count_cycles(7, t_start);
  if (kCount && threadIdx.x == 0) {
    atomicMax(&g_counts[8],
              static_cast<unsigned long long>(clock64() - t_start));
  }
}

template <int F, bool BITMAP>
int launch(const void* ind, const void* row_ptr, const void* blk_cols,
           const void* x, const void* r, const void* w1, const void* w01,
           const void* bias, void* out, int out_f32, int act_mode, int n_rows,
           int bs, cudaStream_t stream) {
  const size_t smem = Layout<F, BITMAP>::kSmem;
  auto kernel = fused_layer_kernel<F, BITMAP>;
  // configured once per instantiation and card, so that a later launch
  // inside a CUDA-graph capture makes no configuration call
  static int resident[kMaxDevices] = {};  // CTAs resident on each card
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  int tile_rows = 16;  // the largest multiple of 16 up to kMaxTile dividing bs
  for (int t = kMaxTile; t >= 16; t -= 16) {
    if (bs % t == 0) {
      tile_rows = t;
      break;
    }
  }
  const int n_tiles = n_rows / tile_rows;
  const int grid = n_tiles < resident[dev] ? n_tiles : resident[dev];
  kernel<<<grid, kThreads, smem, stream>>>(
      ind, static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(r),
      static_cast<const float*>(w1), static_cast<const float*>(w01),
      static_cast<const float*>(bias), out, out_f32, act_mode, n_rows, bs,
      tile_rows);
  return static_cast<int>(cudaGetLastError());
}

template <bool BITMAP>
int launch_f(int f, const void* ind, const void* row_ptr,
             const void* blk_cols, const void* x, const void* r,
             const void* w1, const void* w01, const void* bias, void* out,
             int out_f32, int act_mode, int n_rows, int bs,
             cudaStream_t stream) {
  switch (f) {
    case 32:
      return launch<32, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                                out, out_f32, act_mode, n_rows, bs, stream);
    case 64:
      return launch<64, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                                out, out_f32, act_mode, n_rows, bs, stream);
    case 96:
      return launch<96, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                                out, out_f32, act_mode, n_rows, bs, stream);
    case 128:
      return launch<128, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                                 out, out_f32, act_mode, n_rows, bs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// ind: int8 [nb, bs, bs] 0/1 (bitmap = 0) or int32 [nb, bs/32, bs]
// (bitmap = 1); row_ptr int32 [n_rows/bs + 1]; blk_cols int32 [nb];
// x bf16 [n_rows, f]; r f32 [n_rows]; w1, w01 f32 [f, f] (in, out);
// bias f32 [f] -> out [n_rows, f], f32 if out_f32 else bf16. act_mode 1 =
// leaky_relu(0.2), 0 = identity. f is 32, 64, 96 or 128; bs a multiple of
// 32 dividing n_rows; ind, x, r, w1, w01 and bias 16-byte aligned. Launches
// on `stream` without synchronising; returns the cudaError_t of the launch
// (0 = success).
int cheb_fused_launch(const void* ind, int bitmap, const void* row_ptr,
                      const void* blk_cols, const void* x, const void* r,
                      const void* w1, const void* w01, const void* bias,
                      void* out, int out_f32, int act_mode, int n_rows,
                      int bs, int f, void* stream) {
  if (bs < 32 || bs % 32 != 0 || n_rows < 0 || n_rows % bs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(ind) || !aligned16(x) || !aligned16(r) || !aligned16(w1) ||
      !aligned16(w01) || !aligned16(bias)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bitmap ? launch_f<true>(f, ind, row_ptr, blk_cols, x, r, w1, w01,
                                 bias, out, out_f32, act_mode, n_rows, bs, s)
                : launch_f<false>(f, ind, row_ptr, blk_cols, x, r, w1, w01,
                                  bias, out, out_f32, act_mode, n_rows, bs, s);
}

// Copies the kNumCounts counts of a CHEB_FUSED_COUNT=1 build (g_counts) to
// host[0..8] and zeroes them; other builds read zeros. Synchronises with the
// device.
int cheb_fused_counts(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_counts, sizeof(g_counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kNumCounts] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_counts, zero, sizeof(zero)));
}

const char* cheb_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
