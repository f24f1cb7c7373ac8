// Shared pieces of the port's CUDA kernels: the engine's key hash (the
// hash kernel's and the probe layout's), the by-value column list that
// PAD and PACK take, the grid-wide zero-fill of PACK and the aggregate's
// run-end pass, a block-wide exclusive scan, and the decoupled look-back
// of PACK and the fused walk/emit (the run-end pass keeps its state in
// the same layout, in a buffer of its own).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define TPQ_MAX_COLS 16

// tpq_torch.hashing.hash_keys of one key (csrc/hash.cu says what it
// computes), as the int32 h >> shift, shift = 32 - bits.
constexpr uint32_t kPhiA = 0x9E3779B9u;
constexpr uint32_t kPhiB = 0x85EBCA6Bu;
constexpr uint32_t kPhiC = 0xC2B2AE35u;

static __device__ __forceinline__ int32_t hash_one(long long key, uint32_t salt, int shift) {
  const uint64_t k = static_cast<uint64_t>(key);
  uint32_t h = (uint32_t(k) ^ salt) * kPhiA;
  h ^= uint32_t(k >> 32) * kPhiB;
  h ^= h >> 16;
  h *= kPhiB;
  h ^= h >> 13;
  h *= kPhiC;
  h ^= h >> 16;
  return static_cast<int32_t>(h >> shift);
}

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

// The 16-byte vector of 4- or 8-byte elements.
template <typename T>
struct Vec16;
template <>
struct Vec16<int32_t> {
  using type = int4;
};
template <>
struct Vec16<int64_t> {
  using type = longlong2;
};

// Zeroes dst[from, to) of a 4- or 8-byte column with the whole grid,
// 16-byte stores in the aligned middle.
template <typename T>
__device__ __forceinline__ void zero_range(void* dst, int64_t from, int64_t to) {
  using Vec = typename Vec16<T>::type;
  constexpr int V = 16 / sizeof(T);
  T* d = static_cast<T*>(dst);
  const int64_t a = min(to, (from + V - 1) / V * V);  // 16-byte aligned middle
  const int64_t b = max(a, to / V * V);
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = from + tid; i < a; i += stride) d[i] = 0;
  for (int64_t i = b + tid; i < to; i += stride) d[i] = 0;
  const Vec z{};
  for (int64_t i = a / V + tid; i < b / V; i += stride) reinterpret_cast<Vec*>(d)[i] = z;
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
// status is one 64-bit word, launch epoch << 32 | inclusive flag << 31 |
// count, written with st.release and read with ld.acquire, so no reader
// sees a torn pair; the epoch makes the words of earlier launches read
// as not yet written, so nothing is reset between launches.
//
// The state buffer, kept per device and stream by the wrappers
// (tpq_torch/kernels/_build.py stream_state, owner move.PACK_OWNER) and
// zero when it is made; the aggregate's run-end pass keeps one of the
// same layout, whose records are multi-word with raw payloads, apart
// from it (owner aggregate.state_owner), since the words below past the
// header must only ever hold statuses:
//   state[0]  the epoch of the last launch (0: none yet) << 32 | the
//             tickets drawn in this one. A block's atomic draw returns
//             both, so every block learns the launch's epoch (the last
//             one + 1) with its first ticket, at no extra load or fence;
//             the block that draws the launch's last ticket, after every
//             other draw, stores the new epoch with a count of 0. The
//             epoch lives on the device: a CUDA graph that replays a
//             launch takes a new one at every replay;
//   state[1]  blocks finished, counted only by the launch of epoch
//             kLastEpoch (2^32 - 1): its last block to finish zeroes the
//             status words and state[0], so the launch after the wrap
//             starts again at epoch 1 on clean words;
//   state[kStateHeader + t]  work item t's status.
constexpr uint64_t kTagMask = 0xffffffff00000000ull;
constexpr uint64_t kInclusive = 1ull << 31;
constexpr uint64_t kCountMask = kInclusive - 1;
constexpr int kStateHeader = 2;  // STATE_HEADER in tpq_torch/kernels/move.py
constexpr uint32_t kLastEpoch = 0xffffffffu;

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

// Thread 0 of a block: draws the next ticket of the launch and sets
// *epoch to the launch's epoch.
static __device__ __forceinline__ uint64_t draw_ticket(uint64_t* state, uint32_t* epoch) {
  const unsigned long long w = atomicAdd(reinterpret_cast<unsigned long long*>(state), 1ull);
  *epoch = uint32_t(w >> 32) + 1;
  return w & 0xffffffffull;
}

// Thread 0 of the block that drew the launch's last ticket (every other
// draw came before it): the tickets rearmed, the launch's epoch stored.
static __device__ __forceinline__ void finish_tickets(uint64_t* state, uint32_t epoch) {
  atomicExch(reinterpret_cast<unsigned long long*>(state),
             static_cast<unsigned long long>(epoch) << 32);
}

// Thread 0 of every block, after the block's last access to a status
// word (a block's statuses are read and written by its warp 0 only). In
// the launch of epoch kLastEpoch the block that gets here last zeroes
// the status words [kStateHeader, words), then state[1] and state[0]:
// the launch after the wrap starts again at epoch 1 on clean words. One
// thread zeroes them, once every 2^32 launches; the common path is one
// compare, with no barrier (a block-wide form at the walk/emit's end
// cost 0.78 of its 5.77 ms at config 4 on an H100, PERF.md).
static __device__ __forceinline__ void finish_block(uint64_t* state, int64_t words,
                                                    uint32_t epoch) {
  if (epoch != kLastEpoch) return;
  __threadfence();  // this block's status and epoch stores come first
  if (atomicAdd(reinterpret_cast<unsigned long long*>(&state[1]), 1ull) != gridDim.x - 1ull)
    return;
  __threadfence();
  for (int64_t i = kStateHeader; i < words; i++) state[i] = 0;
  __threadfence();
  atomicExch(reinterpret_cast<unsigned long long*>(&state[1]), 0ull);
  atomicExch(reinterpret_cast<unsigned long long*>(&state[0]), 0ull);
}
