// Streaming copy used by tpq_torch/bench/roofline.py to measure the
// card's sustained device-memory bandwidth (tpq measures it with an XLA
// saxpy). 16-byte loads and stores, grid-stride.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void copy_kernel(const int4* __restrict__ src, int4* __restrict__ dst,
                            int64_t n16) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n16;
       i += stride)
    dst[i] = src[i];
}

}  // namespace

extern "C" int tpq_copy(const void* src, void* dst, int64_t nbytes,
                        cudaStream_t stream) {
  const int64_t n16 = nbytes / 16;  // the wrapper passes multiples of 16
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  copy_kernel<<<sms * 8, 512, 0, stream>>>(static_cast<const int4*>(src),
                                           static_cast<int4*>(dst), n16);
  return int(cudaGetLastError());
}
