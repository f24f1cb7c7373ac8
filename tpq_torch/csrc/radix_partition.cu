// Bucket histogram for Hopper (sm_90a): the port of
// tpq/kernels/radix_partition.py _hist_kernel (wrapper radix_histogram),
// which the distributed join's capacity planner runs twice per shard.
//
// What it computes. out[b] is the number of ids equal to b, for b in
// [0, nbuckets); ids outside that range (the planner's padding sentinel
// nbuckets, negative ids) are ignored.
//
// The TPU kernel turns counting into a [tile, nbuckets] one-hot product
// on the MXU, accumulated across its sequential grid in a VMEM-resident
// [1, nbuckets] output block. CUDA blocks run in parallel and in no
// order, so here each block of a grid-stride loop counts into its own
// histogram in dynamic shared memory, then adds each non-zero bin once
// into the zeroed output with a global atomicAdd. At the planner's
// nbuckets = 9 the shared-memory adds of a warp land on few addresses,
// so the warp first groups its lanes by id (__match_any_sync) and the
// lowest lane of each group adds the group's size. Integer atomics make
// the counts independent of their order: every run writes the same
// bytes. Bound by bytes: each id is read once (4 B) and nbuckets ints
// are written; the grid is capped at a few blocks per SM so that the
// global adds stay few.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__global__ void hist_kernel(const int32_t* __restrict__ bucket, int64_t n,
                            int nbuckets, int32_t* __restrict__ out) {
  extern __shared__ int32_t s_hist[];
  for (int i = threadIdx.x; i < nbuckets; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  // base is the same for the whole block, so every warp is whole at
  // __match_any_sync; lanes past n carry the id -1 and add nothing
  for (int64_t base = int64_t(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const int64_t k = base + threadIdx.x;
    const int32_t b = k < n ? bucket[k] : -1;
    const bool in = b >= 0 && b < nbuckets;
    const unsigned same = __match_any_sync(0xffffffffu, in ? b : -1);
    if (in && lane == __ffs(same) - 1) atomicAdd(&s_hist[b], __popc(same));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbuckets; i += blockDim.x)
    if (s_hist[i] != 0) atomicAdd(&out[i], s_hist[i]);
}

}  // namespace

extern "C" {

// out receives nbuckets int32 counts; it is zeroed here, on the stream.
int tpq_radix_histogram(const int32_t* bucket, int64_t n, int nbuckets,
                        int32_t* out, cudaStream_t stream) {
  const size_t smem = size_t(nbuckets) * sizeof(int32_t);
  if (nbuckets < 1 || smem > size_t(kSmemLimit))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(out, 0, smem, stream);
  if (err != cudaSuccess) return int(err);
  if (n <= 0) return int(cudaGetLastError());
  cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hist_kernel<<<unsigned(blocks), kThreads, smem, stream>>>(bucket, n, nbuckets,
                                                            out);
  return int(cudaGetLastError());
}

}  // extern "C"
