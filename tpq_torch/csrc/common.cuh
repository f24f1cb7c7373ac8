// Shared pieces of the port's CUDA kernels: the by-value column list
// that PAD and PACK take, a block-wide exclusive scan, and the
// decoupled look-back of PACK and the fused walk/emit.
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

// Single-pass scans with decoupled look-back (Merrill & Garland, 2016),
// shared by PACK and the fused walk/emit. Work items (tiles) are taken
// in order through an atomic ticket, so an item's predecessors are held
// by running blocks and waiting on them cannot deadlock. An item's
// status is one 64-bit word, call epoch << 32 | inclusive flag << 31 |
// count, written with st.release and read with ld.acquire, so no reader
// sees a torn pair; the epoch makes the words of earlier calls read as
// not yet written, so nothing is reset between calls.
constexpr uint64_t kTagMask = 0xffffffff00000000ull;
constexpr uint64_t kInclusive = 1ull << 31;
constexpr uint64_t kCountMask = kInclusive - 1;

static __device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Warp 0 of a block, all lanes: publishes item t's count `agg`, looks
// back over its predecessors 32 at a time, adding counts until it meets
// an inclusive prefix, publishes its own and returns the exclusive one.
static __device__ int64_t look_back(uint64_t* status, int64_t t, uint32_t agg,
                                    uint64_t tag) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) st_release(&status[0], tag | kInclusive | agg);
    return 0;
  }
  if (lane == 0) st_release(&status[t], tag | agg);
  int64_t prefix = 0;
  for (int64_t top = t - 1;; top -= 32) {
    const int64_t i = top - lane;  // lane 0 is the nearest predecessor
    uint64_t w;
    bool ready;
    do {
      w = i >= 0 ? ld_acquire(&status[i]) : (tag | kInclusive);
      ready = (w & kTagMask) == tag;
    } while (!__all_sync(0xffffffffu, ready));
    const unsigned incl = __ballot_sync(0xffffffffu, (w & kInclusive) != 0);
    const int last = incl ? __ffs(incl) - 1 : 31;  // nearest inclusive lane
    int64_t s = lane <= last ? int64_t(w & kCountMask) : 0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    prefix += s;
    if (incl) break;
  }
  if (lane == 0) st_release(&status[t], tag | kInclusive | uint64_t(prefix + agg));
  return prefix;
}
