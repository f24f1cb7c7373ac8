// Shared pieces of the port's CUDA kernels: the by-value column list
// that PAD and PACK take, and a block-wide exclusive scan.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TPQ_MAX_COLS 16

// Up to TPQ_MAX_COLS columns, each of 4- or 8-byte elements, passed by
// value so that one launch moves every column.
struct ColList {
  const void* src[TPQ_MAX_COLS];
  void* dst[TPQ_MAX_COLS];
  int esz[TPQ_MAX_COLS];
  int n;
};

static inline ColList make_cols(const void* const* src, void* const* dst,
                                const int* esz, int n) {
  ColList c;
  c.n = n;
  for (int i = 0; i < n; i++) {
    c.src[i] = src[i];
    c.dst[i] = dst[i];
    c.esz[i] = esz[i];
  }
  return c;
}

__device__ __forceinline__ void copy_row(const ColList& c, int64_t from,
                                         int64_t to) {
  for (int i = 0; i < c.n; i++) {
    if (c.esz[i] == 8)
      static_cast<int64_t*>(c.dst[i])[to] =
          static_cast<const int64_t*>(c.src[i])[from];
    else
      static_cast<int32_t*>(c.dst[i])[to] =
          static_cast<const int32_t*>(c.src[i])[from];
  }
}

// Exclusive scan of one int per thread across the block, in thread
// order; *total gets the block's sum. blockDim.x must be a multiple of
// 32. `warp_sums` is shared scratch of 32 ints. Every thread of the
// block must call it (it holds __syncthreads).
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* warp_sums,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int32_t excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

#define TPQ_SCAN_THREADS 1024

// Exclusive scan of n ints by ONE block of TPQ_SCAN_THREADS threads,
// looping over chunks with a running carry; *total gets the sum. The
// block offsets of PACK and of the walk/emit kernel come from here,
// never from atomics, so rows land in the same order on every run.
// (static: each .cu file that launches it holds its own copy)
static __global__ void scan_exclusive_one_block(const int32_t* __restrict__ in,
                                                int64_t n,
                                                int32_t* __restrict__ out,
                                                int32_t* __restrict__ total) {
  __shared__ int32_t warp_sums[32];
  int32_t carry = 0;  // identical in every thread
  for (int64_t base = 0; base < n; base += blockDim.x) {
    const int64_t k = base + threadIdx.x;
    const int32_t v = k < n ? in[k] : 0;
    int32_t chunk;
    const int32_t excl = block_exclusive_scan(v, warp_sums, &chunk);
    if (k < n) out[k] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = carry;
}
