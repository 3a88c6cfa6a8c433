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
// x is [n_cols, F] f32 row-major; y is [n_rows, F] f32.
//
// What bounds it on an H100: bytes. The blocks of conflict graphs are
// ~2.5% dense, so the work the data needs is one f32 FMA per stored edge
// and feature (2 * nnz * F operations: 0.81 GFLOP at N=65,536, F=128, about
// 12 us on the CUDA cores), while the bytes are the structure plus x and y
// (16.1 MB of bitmap words + 2 * 32 MB at F=128: about 24 us).
//
// What the design does about it: one warp per output row. For each block
// of the row's block-row, the warp reads the row's cells 32 columns at a
// time (coalesced; 8 such loads in flight), finds the nonzero ones with
// one ballot, and for each of them adds value * x[col, :] to the row's
// accumulator, each lane
// owning 4 features of a 128-wide chunk (coalesced 128-byte reads of x).
// Zero cells cost no FMA and no x read. Products are CUDA-core FMAs in
// f32; no atomics, so the sum order of a row is fixed. This simple form
// re-reads each x row once per neighbour (from L2 at these sizes); a
// faster kernel would stage x tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  } else if (KIND == kInt8) {
    return static_cast<float>(
        static_cast<const int8_t*>(vals)[(k * bs + li) * bs + j]);
  } else {
    const uint32_t w = static_cast<const uint32_t*>(
        vals)[(k * (bs >> 5) + (li >> 5)) * bs + j];
    return static_cast<float>((w >> (li & 31)) & 1u);
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
      return launch<kBitmap>(vals, row_ptr, blk_cols, x, y, n_rows, bs, f,
                             s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bsr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
