// The bounds of tpq_torch.trace's spans inside a CUDA graph: one thread
// writes the card's global nanosecond timer into a slot. A timing-event
// node in a graph slows every replay far more than this kernel (PERF.md).

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

}  // namespace

extern "C" int tpq_stamp(void* slot, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<unsigned long long*>(slot));
  return int(cudaGetLastError());
}
