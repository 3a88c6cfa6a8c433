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
//   - h @ (W0 + W1) and acc @ W1: f32 (Precision.HIGHEST there);
//   - row scaling: bf16(r_row) * bf16(lag), exact in f32;
//   - out = (y - rlag) + bias; leaky_relu(0.2) as max(v, 0.2 v);
//     stored bf16 (round to nearest even) for hidden layers, f32 for the
//     head.
//
// What bounds it on an H100: the f32 W-products. They are 2 * 2 * N * F^2
// operations (4.3 GFLOP at N=65,536, F=128): about 64 us at 67 TFLOP/s on
// the CUDA cores, where TF32 is not allowed. The A-product the data needs
// is 2 * nnz * F (0.81 GFLOP, ~12 us); the bytes (16.1 MB of bitmap words,
// x in and out in bf16, r) take ~15 us at 3.35 TB/s.
//
// What the design does about it: persistent CTAs of 512 threads, as many
// as fit on the SMs, each loading W1 and W0+W1 into shared memory once
// (128 KB at F = 128) and then looping over 64-row tiles. Phase 1: each
// warp owns 4 rows of the tile; it scans a row's cells 32 columns at a time
// (one ballot; the cells and r of 8 such chunks are loaded together, since
// with one CTA per SM the scan is bound by the latency of these loads),
// and for each edge adds bf16(r_col) * x[col, :] (CUDA-core
// FMA, each lane owning F/32 features), skipping zero cells. The row's f32
// accumulator and its own activation go to shared memory. Phase 2: each
// thread computes 4 rows x F/32 columns of both W-products as a register
// tile, reading activations as shared-memory broadcasts and W rows
// conflict-free, then applies the epilogue and stores. A tensor-core
// (mma.sync / wgmma) A-product and a tiled W-product are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kScan = 8;  // 32-column chunks whose cells are loaded together
constexpr int kMaxDevices = 64;

// The phases a build runs: 3 (the default) both. 1 or 2 keep only phase 1
// or phase 2 and compute wrong layers; they only split the time
// (scripts/torch_fused_layer_probe.py).
#ifndef CHEB_FUSED_PHASES
#define CHEB_FUSED_PHASES 3
#endif
constexpr bool kPhase1 = (CHEB_FUSED_PHASES & 1) != 0;
constexpr bool kPhase2 = (CHEB_FUSED_PHASES & 2) != 0;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int NC, bool BITMAP>
__global__ void __launch_bounds__(kThreads, 1)
    fused_layer_kernel(const void* __restrict__ ind,
                       const int32_t* __restrict__ row_ptr,
                       const int32_t* __restrict__ blk_cols,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ r,
                       const float* __restrict__ w1,
                       const float* __restrict__ w01,
                       const float* __restrict__ bias, void* __restrict__ out,
                       int out_f32, int act_mode, int n_rows, int bs) {
  constexpr int F = NC * 32;
  extern __shared__ __align__(16) float smem[];
  float* sw1 = smem;
  float* sw01 = sw1 + F * F;
  float* sh = sw01 + F * F;          // [kTileRows, F] own activations, f32
  float* sacc = sh + kTileRows * F;  // [kTileRows, F] A-product

  for (int q = threadIdx.x; q < F * F; q += kThreads) {
    sw1[q] = w1[q];
    sw01[q] = w01[q];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows;
    // phase 1: acc[row] = sum over edges (row, j) of bf16(r_j) * x[j]
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int lr = warp + kWarps * m;
      const int gi = row0 + lr;
      float acc[NC];
      float h[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = h[c] = 0.0f;
      if (gi < n_rows) {  // whole warp
        const int br = gi / bs;
        const int li = gi - br * bs;
        const int start = row_ptr[br];
        const int end = kPhase1 ? row_ptr[br + 1] : start;
        for (int k = start; k < end; ++k) {
          const size_t c0 = static_cast<size_t>(blk_cols[k]) * bs;
          for (int jb = 0; jb < bs; jb += 32 * kScan) {
            // the cells and r of kScan 32-column chunks are loaded before
            // any is used, so that their loads are in flight together
            float iv[kScan];
            float rc[kScan];
#pragma unroll
            for (int t = 0; t < kScan; ++t) {
              const int j = jb + 32 * t + lane;
              iv[t] = 0.0f;
              rc[t] = 0.0f;
              if (jb + 32 * t < bs) {
                if (BITMAP) {
                  const uint32_t w = static_cast<const uint32_t*>(
                      ind)[(static_cast<size_t>(k) * (bs >> 5) + (li >> 5)) *
                               bs + j];
                  iv[t] = static_cast<float>((w >> (li & 31)) & 1u);
                } else {
                  iv[t] = static_cast<float>(static_cast<const int8_t*>(
                      ind)[(static_cast<size_t>(k) * bs + li) * bs + j]);
                }
                rc[t] = r[c0 + j];
              }
            }
#pragma unroll
            for (int t = 0; t < kScan; ++t) {
              uint32_t mask = __ballot_sync(0xffffffffu, iv[t] != 0.0f);
              const float rv = bf16_round(iv[t] * rc[t]);  // bf16(ind * r_col)
              while (mask) {
                const int b = __ffs(mask) - 1;
                mask &= mask - 1;
                const float rb = __shfl_sync(0xffffffffu, rv, b);
                const __nv_bfloat16* xr = x + (c0 + jb + 32 * t + b) * F;
#pragma unroll
                for (int c = 0; c < NC; ++c) {
                  acc[c] = fmaf(rb, __bfloat162float(xr[c * 32 + lane]),
                                acc[c]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          h[c] = __bfloat162float(x[static_cast<size_t>(gi) * F + c * 32 +
                                    lane]);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        sh[lr * F + c * 32 + lane] = h[c];
        sacc[lr * F + c * 32 + lane] = acc[c];
      }
    }
    __syncthreads();

    // phase 2: y = h @ W01, lag = acc @ W1 for rows warp + 16 m, columns
    // lane + 32 c
    float y[kRowsPerWarp][NC];
    float lg[kRowsPerWarp][NC];
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
#pragma unroll
      for (int c = 0; c < NC; ++c) y[m][c] = lg[m][c] = 0.0f;
    }
#pragma unroll 4
    for (int k = 0; k < (kPhase2 ? F : 0); ++k) {
      float hk[kRowsPerWarp];
      float ak[kRowsPerWarp];
#pragma unroll
      for (int m = 0; m < kRowsPerWarp; ++m) {
        hk[m] = sh[(warp + kWarps * m) * F + k];
        ak[m] = sacc[(warp + kWarps * m) * F + k];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float w01k = sw01[k * F + c * 32 + lane];
        const float w1k = sw1[k * F + c * 32 + lane];
#pragma unroll
        for (int m = 0; m < kRowsPerWarp; ++m) {
          y[m][c] = fmaf(hk[m], w01k, y[m][c]);
          lg[m][c] = fmaf(ak[m], w1k, lg[m][c]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int gi = row0 + warp + kWarps * m;
      if (gi >= n_rows) continue;
      const float rr = bf16_round(r[gi]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 32 + lane;
        float v = (y[m][c] - rr * bf16_round(lg[m][c])) + bias[col];
        if (act_mode == 1) v = fmaxf(v, 0.2f * v);
        const size_t o = static_cast<size_t>(gi) * F + col;
        if (out_f32) {
          static_cast<float*>(out)[o] = v;
        } else {
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        }
      }
    }
    __syncthreads();  // sh / sacc are rewritten by the next tile
  }
}

template <int NC, bool BITMAP>
int launch(const void* ind, const void* row_ptr, const void* blk_cols,
           const void* x, const void* r, const void* w1, const void* w01,
           const void* bias, void* out, int out_f32, int act_mode, int n_rows,
           int bs, cudaStream_t stream) {
  constexpr int F = NC * 32;
  const size_t smem = (2 * F * F + 2 * kTileRows * F) * sizeof(float);
  auto kernel = fused_layer_kernel<NC, BITMAP>;
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
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int grid = n_tiles < resident[dev] ? n_tiles : resident[dev];
  kernel<<<grid, kThreads, smem, stream>>>(
      ind, static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(r),
      static_cast<const float*>(w1), static_cast<const float*>(w01),
      static_cast<const float*>(bias), out, out_f32, act_mode, n_rows, bs);
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
      return launch<1, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                               out, out_f32, act_mode, n_rows, bs, stream);
    case 64:
      return launch<2, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                               out, out_f32, act_mode, n_rows, bs, stream);
    case 96:
      return launch<3, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                               out, out_f32, act_mode, n_rows, bs, stream);
    case 128:
      return launch<4, BITMAP>(ind, row_ptr, blk_cols, x, r, w1, w01, bias,
                               out, out_f32, act_mode, n_rows, bs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// ind: int8 [nb, bs, bs] 0/1 (bitmap = 0) or int32 [nb, bs/32, bs]
// (bitmap = 1); row_ptr int32 [n_rows/bs + 1]; blk_cols int32 [nb];
// x bf16 [n_rows, f]; r f32 [n_rows]; w1, w01 f32 [f, f] (in, out);
// bias f32 [f] -> out [n_rows, f], f32 if out_f32 else bf16. act_mode 1 =
// leaky_relu(0.2), 0 = identity. f is 32, 64, 96 or 128; bs a multiple of
// 32 dividing n_rows. Launches on `stream` without synchronising; returns
// the cudaError_t of the launch (0 = success).
int cheb_fused_launch(const void* ind, int bitmap, const void* row_ptr,
                      const void* blk_cols, const void* x, const void* r,
                      const void* w1, const void* w01, const void* bias,
                      void* out, int out_f32, int act_mode, int n_rows,
                      int bs, int f, void* stream) {
  if (bs < 32 || bs % 32 != 0 || n_rows < 0 || n_rows % bs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bitmap ? launch_f<true>(f, ind, row_ptr, blk_cols, x, r, w1, w01,
                                 bias, out, out_f32, act_mode, n_rows, bs, s)
                : launch_f<false>(f, ind, row_ptr, blk_cols, x, r, w1, w01,
                                  bias, out, out_f32, act_mode, n_rows, bs, s);
}

const char* cheb_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
