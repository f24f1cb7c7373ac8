// The engine's u32 key hash for Hopper (sm_90a): tpq_torch.hashing.hash_keys,
// the port of tpq/hashing.py hash_keys (:63). tpq computes it as a chain
// of u32 operations that XLA fuses into one pass; it is not a Pallas
// kernel. Eager torch ran the chain as about 20 int64 launches over the
// whole column (bucket ids and h2 of the lane build, the probe layout's
// buckets and lanes, the distributed join's owners).
//
// What it computes, per key, in native uint32 arithmetic:
//   (lo, hi) = the low and high 32 bits of the key's two's complement;
//   h = (lo ^ salt) * PHI32_A;  h ^= hi * PHI32_B;
//   h ^= h >> 16;  h *= PHI32_B;  h ^= h >> 13;  h *= PHI32_C;  h ^= h >> 16;
//   out = h >> (32 - bits) for bits < 32, else all 32 bits as int32.
//
// Bound by bytes: each key read once (8 B), each id written once (4 B),
// a few integer operations a key. No reuse, so no staging: a grid of at
// most the blocks the card holds at once strides over groups of 4 keys,
// two 16-byte loads and one 16-byte store a group. The wrapper gives
// `out` the keys' alignment (out + head is 16-byte aligned where keys +
// head is); the keys before that boundary (at most 1) and the ragged
// tail (at most 3) are hashed one by one. A call whose keys are not
// 8-byte aligned, or whose `out + head` is not 16-byte aligned, is refused.
// hash_one is csrc/common.cuh's, shared with the probe layout (layout.cu).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Keys [head, head + 4 * ngroups) in groups of 4, the others one by one.
__global__ void __launch_bounds__(kThreads)
    hash_keys_kernel(const long long* __restrict__ keys, int64_t n, int64_t head,
                     int64_t ngroups, uint32_t salt, int shift,
                     int32_t* __restrict__ out) {
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const longlong2* kv = reinterpret_cast<const longlong2*>(keys + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  for (int64_t g = tid; g < ngroups; g += stride) {
    const longlong2 a = __ldg(kv + 2 * g);
    const longlong2 b = __ldg(kv + 2 * g + 1);
    ov[g] = make_int4(hash_one(a.x, salt, shift), hash_one(a.y, salt, shift),
                      hash_one(b.x, salt, shift), hash_one(b.y, salt, shift));
  }
  const int64_t rest = n - 4 * ngroups;  // the head, then the tail
  for (int64_t i = tid; i < rest; i += stride) {
    const int64_t j = i < head ? i : head + 4 * ngroups + (i - head);
    out[j] = hash_one(keys[j], salt, shift);
  }
}

// Blocks of hash_keys_kernel the current card holds at once, asked once
// per device.
int grid_limit() {
  static int blocks[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && blocks[dev] > 0) return blocks[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_keys_kernel, kThreads, 0);
  const int b = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) blocks[dev] = b;
  return b;
}

}  // namespace

extern "C" {

// out[i] = hash_keys(keys[i], bits, salt) for i < n (n >= 1, 1 <= bits <= 32).
int tpq_hash_keys(const int64_t* keys, int64_t n, int bits, uint32_t salt, int32_t* out,
                  cudaStream_t stream) {
  if (n < 1 || bits < 1 || bits > 32) return int(cudaErrorInvalidValue);
  const uintptr_t k = reinterpret_cast<uintptr_t>(keys);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int64_t head = int64_t((16 - (k & 15)) & 15) / 8;
  if (head > n) head = n;
  if ((k & 7) || ((o + 4 * head) & 15)) return int(cudaErrorInvalidValue);
  const int64_t ngroups = (n - head) / 4;
  const int64_t items = ngroups > 0 ? ngroups : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int limit = grid_limit();
  if (blocks > limit) blocks = limit;
  hash_keys_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const long long*>(keys), n, head, ngroups, salt, 32 - bits, out);
  return int(cudaGetLastError());
}

}  // extern "C"
