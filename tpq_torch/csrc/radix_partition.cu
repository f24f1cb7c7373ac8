// Bucket histogram for Hopper (sm_90a): the port of
// tpq/kernels/radix_partition.py _hist_kernel (wrapper radix_histogram),
// which the distributed join's capacity planner runs twice per shard
// (16,777,216 ids into 9 buckets at config 5: the 8 shards and the
// padding sentinel).
//
// What it computes. out[b] is the number of ids equal to b, for b in
// [0, nbuckets); ids outside that range (the planner's padding sentinel
// nbuckets, negative ids) are ignored.
//
// The TPU kernel turns counting into a [tile, nbuckets] one-hot product
// on the MXU, accumulated across its sequential grid in a VMEM-resident
// output block. CUDA blocks run in parallel and in no order. Here:
//   * bound by bytes (each id read once, 4 B): a grid of at most the
//     blocks the card holds at once strides over the ids in 16-byte
//     loads, kLoads of them a step, the next step's in flight while a
//     thread counts the current one's;
//     the ids before the first 16-byte boundary and the ragged tail (at
//     most 3 each) are counted one by one;
//   * one bin per bucket in the block's shared memory, taken with shared
//     atomics. They return nothing, so a thread goes on to its next ids
//     while they complete. At the planner's 9 buckets lane-private
//     counters (bank = lane, no atomic, but a load and a dependent store
//     per id) and counters in registers were timed against it on the
//     H100 and lost (PERF.md §6);
//   * one launch, no memset: each block adds its non-zero bins into an
//     accumulator in a scratch buffer kept by the wrapper per device and
//     stream (zero when the launch starts), then takes a ticket; the
//     block with the last ticket moves the accumulator into out, zeroing
//     it with atomicExch, and rearms the ticket. Integer sums: every run
//     writes the same bytes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;          // 16-byte loads in flight per thread
constexpr int kSmemLimit = 232448; // bytes of shared memory a block may use

// Splits ids into an unaligned head, 16-byte vectors and a ragged tail.
struct Span {
  const int32_t* ids;
  int64_t n, head, nvec;
  __device__ __forceinline__ const int4* vec() const {
    return reinterpret_cast<const int4*>(ids + head);
  }
  // the i-th id outside the vectors, i < n - 4 * nvec
  __device__ __forceinline__ int32_t edge(int i) const {
    return i < head ? ids[i] : ids[head + 4 * nvec + (i - head)];
  }
};

// Runs count(id) over every id of the span, the vectors striped over the
// grid: the kLoads loads of a thread's next step are issued before the
// ids of its current step are counted, so that counting never leaves
// the thread without loads in flight. Block 0 counts the head and tail.
template <typename Count>
__device__ __forceinline__ void for_each_id(const Span& s, Count count) {
  const int4* v = s.vec();
  const int64_t step = int64_t(gridDim.x) * kThreads * kLoads;
  auto load = [&](int4* x, int64_t base) {
#pragma unroll
    for (int u = 0; u < kLoads; u++) {
      const int64_t i = base + int64_t(u) * kThreads;
      x[u] = i < s.nvec ? __ldg(v + i) : make_int4(-1, -1, -1, -1);
    }
  };
  int64_t base = int64_t(blockIdx.x) * kThreads * kLoads + threadIdx.x;
  int4 cur[kLoads];
  load(cur, base);
  for (; base < s.nvec; base += step) {
    int4 next[kLoads];
    load(next, base + step);
#pragma unroll
    for (int u = 0; u < kLoads; u++) {
      count(cur[u].x);
      count(cur[u].y);
      count(cur[u].z);
      count(cur[u].w);
      cur[u] = next[u];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < s.n - 4 * s.nvec) count(s.edge(threadIdx.x));
}

// After the block has added its counts into the accumulator: in the
// block with the last ticket, moves the accumulator into out and rearms
// the ticket. acc[0] is the ticket, acc[1 + b] bucket b. `flag` is a
// word of the block's shared memory that it no longer reads (no static
// shared memory here: the shared bins may fill all the block may use).
__device__ __forceinline__ void finish(uint32_t* acc, int nbuckets, int32_t* out,
                                       uint32_t* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(acc, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  for (int b = threadIdx.x; b < nbuckets; b += kThreads)
    out[b] = int32_t(atomicExch(acc + 1 + b, 0u));
  if (threadIdx.x == 0) atomicExch(acc, 0u);
}

__global__ void __launch_bounds__(kThreads)
    hist_shared_bins(Span s, int nbuckets, int32_t* __restrict__ out,
                     uint32_t* __restrict__ acc) {
  extern __shared__ uint32_t s_bin[];
  for (int i = threadIdx.x; i < nbuckets; i += kThreads) s_bin[i] = 0;
  __syncthreads();
  for_each_id(s, [&](int32_t b) {
    if (unsigned(b) < unsigned(nbuckets)) atomicAdd(&s_bin[b], 1u);
  });
  __syncthreads();
  for (int b = threadIdx.x; b < nbuckets; b += kThreads)
    if (s_bin[b] != 0) atomicAdd(acc + 1 + b, s_bin[b]);
  finish(acc, nbuckets, out, s_bin);
}

// Blocks of hist_shared_bins the current card holds at once with `smem`
// bytes of dynamic shared memory each, asked once per device and size
// (the shared-memory attribute is raised with the first ask).
int grid_limit(int smem) {
  struct Limit {
    int dev, smem, blocks;
  };
  static Limit cache[256];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < used; i++)
    if (cache[i].dev == dev && cache[i].smem == smem) return cache[i].blocks;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(hist_shared_bins, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemLimit);
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_shared_bins, kThreads, smem);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (used < 256) cache[used++] = {dev, smem, blocks};
  return blocks;
}

}  // namespace

extern "C" {

// out receives nbuckets int32 counts. acc: acc_words >= nbuckets + 1
// uint32 words, zero before the first call and left zero for the next
// call on the same stream.
int tpq_radix_histogram(const int32_t* ids, int64_t n, int nbuckets, int32_t* out,
                        uint32_t* acc, int64_t acc_words, cudaStream_t stream) {
  if (nbuckets < 1 || size_t(nbuckets) * 4 > size_t(kSmemLimit) || n < 1 ||
      acc_words < int64_t(nbuckets) + 1)
    return int(cudaErrorInvalidValue);
  Span s;
  s.ids = ids;
  s.n = n;
  s.head = ((16 - int64_t(reinterpret_cast<uintptr_t>(ids) & 15)) & 15) / 4;
  if (s.head > n) s.head = n;
  s.nvec = (n - s.head) / 4;
  const int smem = nbuckets * 4;
  const int64_t by_load = (s.nvec + int64_t(kThreads) * kLoads - 1) / (int64_t(kThreads) * kLoads);
  int64_t blocks = by_load < 1 ? 1 : by_load;
  const int limit = grid_limit(smem);
  if (blocks > limit) blocks = limit;
  hist_shared_bins<<<unsigned(blocks), kThreads, smem, stream>>>(s, nbuckets, out, acc);
  return int(cudaGetLastError());
}

}  // extern "C"
