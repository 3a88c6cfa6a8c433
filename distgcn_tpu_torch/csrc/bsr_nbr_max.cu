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
// (bsr_nbr_max_i32_launch), the same template instantiated for int32_t:
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
// What bounds it on an H100: bytes. At N=65,536 (bs=256, 1,966 bitmap
// blocks) one pass must read 16.1 MB of words plus x and write y: about
// 5 us at 3.35 TB/s. The operations (one compare per stored cell) are far
// below the card's rate.
//
// What the design does about it: one CTA per block-row, one thread per
// row. For each block of the row, the CTA stages the block's bitmap words
// (16-byte loads, read once from device memory) and the block's x segment
// in shared memory; each thread then scans its row. The 32 threads of a
// warp share one word row, so every shared-memory read is a broadcast.
// Each row's maximum is its own thread's: no atomics, no reduction order,
// so the result is bit-equal to any exact max.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, bool BITMAP>
__global__ void nbr_max_kernel(const void* __restrict__ vals,
                               const int32_t* __restrict__ row_ptr,
                               const int32_t* __restrict__ blk_cols,
                               const T* __restrict__ x, T* __restrict__ y,
                               int bs) {
  static_assert(sizeof(T) == 4, "f32 and int32 payloads");
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  // bs is a multiple of 32, so bs * 4 bytes keep `words` 16-byte aligned
  // for the uint4 stores below
  uint32_t* words = reinterpret_cast<uint32_t*>(smem + bs * sizeof(T));

  const int br = blockIdx.x;
  const int i = threadIdx.x;  // row within the block-row
  const int start = row_ptr[br];
  const int end = row_ptr[br + 1];
  const int nwords = (bs >> 5) * bs;
  const uint32_t* my_words = words + (i >> 5) * bs;
  const int bit = i & 31;
  T m = Payload<T>::sentinel();

  for (int k = start; k < end; ++k) {
    const size_t c = static_cast<size_t>(blk_cols[k]);
    __syncthreads();  // every thread is done with the previous block
    xs[i] = x[c * bs + i];
    if (BITMAP) {
      const uint4* src = reinterpret_cast<const uint4*>(
          static_cast<const uint32_t*>(vals) + static_cast<size_t>(k) * nwords);
      uint4* dst = reinterpret_cast<uint4*>(words);
      for (int q = i; q < (nwords >> 2); q += bs) dst[q] = src[q];
    }
    __syncthreads();
    if (BITMAP) {
#pragma unroll 8
      for (int j = 0; j < bs; ++j) {
        if ((my_words[j] >> bit) & 1u) m = take_max(m, xs[j]);
      }
    } else {
      const int8_t* row = static_cast<const int8_t*>(vals) +
                          (static_cast<size_t>(k) * bs + i) * bs;
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
  }
  y[static_cast<size_t>(br) * bs + i] = m;
}

template <typename T, bool BITMAP>
int launch(const void* vals, const void* row_ptr, const void* blk_cols,
           const void* x, void* y, int n_block_rows, int bs,
           cudaStream_t stream) {
  const size_t smem =
      bs * sizeof(T) + (BITMAP ? static_cast<size_t>(bs / 32) * bs * 4 : 0);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nbr_max_kernel<T, BITMAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nbr_max_kernel<T, BITMAP><<<n_block_rows, bs, smem, stream>>>(
      vals, static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(blk_cols), static_cast<const T*>(x),
      static_cast<T*>(y), bs);
  return static_cast<int>(cudaGetLastError());
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
  return bitmap ? launch<T, true>(vals, row_ptr, blk_cols, x, y,
                                  n_block_rows, bs, s)
                : launch<T, false>(vals, row_ptr, blk_cols, x, y,
                                   n_block_rows, bs, s);
}

}  // namespace

extern "C" {

// vals: int8 [nb, bs, bs] (bitmap = 0) or int32 [nb, bs/32, bs]
// (bitmap = 1); row_ptr int32 [n_block_rows + 1]; blk_cols int32 [nb];
// x [n_cols] (n_cols a multiple of bs, covering every block column)
// -> y [n_block_rows * bs], both f32 (bsr_nbr_max_f32_launch) or both
// int32 (bsr_nbr_max_i32_launch). bs is a multiple of 32 in 32..1024.
// The buffers are 16-byte aligned. Launches on `stream` without
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

const char* bsr_nbr_max_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
