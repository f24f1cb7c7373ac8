// One stable 1-bit split for Hopper (sm_90a): the port of
// tpq/kernels/radix_sort.py _split1_kernel (wrapper _split1), the pass
// that lsd_radix_sort_bits repeats once per key bit.
//
// What it computes. Rows whose bit is 0 go first, then rows whose bit is
// 1, each group in its input order, and every int32 plane is carried
// along. n0, the number of zeros, is the total of the count scan and
// stays on the device, so no pass syncs with the host.
//
// The TPU kernel is one sequential grid with two fused pack streams
// (zeros and ones), each front-compacted through a shift network and
// flushed by DMA with a cursor in SMEM; the host then splices the ones
// after n0. CUDA blocks run in parallel and in no order, so the cursor
// becomes three launches: a per-block count of zeros, the repo's
// one-block exclusive scan of those counts, and a scatter in which each
// block ranks its rows with a block scan. A row with z zeros before it
// goes to z if its bit is 0, else to n0 + (k - z), where n0 is the
// scan's total. No atomics: every run writes the same bytes. Bound by
// bytes: the bit plane is read twice, every plane once, and every plane
// written once.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 16;
constexpr int64_t kTile = int64_t(kThreads) * kIters;

struct Planes {
  const int32_t* src[TPQ_MAX_COLS];
  int32_t* dst[TPQ_MAX_COLS];
  int n;
};

__global__ void split_count_kernel(const int32_t* __restrict__ bit, int64_t n,
                                   int32_t* __restrict__ block_zeros) {
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int32_t c = 0;
  for (int it = 0; it < kIters; it++) {
    const int64_t k = base + int64_t(it) * kThreads + threadIdx.x;
    c += __syncthreads_count(k < n && bit[k] == 0);
  }
  if (threadIdx.x == 0) block_zeros[blockIdx.x] = c;
}

__global__ void split_scatter_kernel(Planes planes,
                                     const int32_t* __restrict__ bit,
                                     int64_t n,
                                     const int32_t* __restrict__ block_zeros_ex,
                                     const int32_t* __restrict__ n0_ptr) {
  __shared__ int32_t warp_sums[32];
  const int64_t n0 = *n0_ptr;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  int64_t run = block_zeros_ex[blockIdx.x];  // zeros before this block
  for (int it = 0; it < kIters; it++) {
    const int64_t k = base + int64_t(it) * kThreads + threadIdx.x;
    const int32_t z = k < n && bit[k] == 0;
    int32_t chunk;
    const int64_t before = run + block_exclusive_scan(z, warp_sums, &chunk);
    run += chunk;
    if (k >= n) continue;
    const int64_t dest = z ? before : n0 + (k - before);
    for (int i = 0; i < planes.n; i++) planes.dst[i][dest] = planes.src[i][k];
  }
}

}  // namespace

extern "C" {

// block_zeros and block_offsets hold ceil(n / tpq_split1_tile()) ints each;
// total receives the zero count n0, which the scatter reads.
int tpq_split1(const int32_t* const* src, int32_t* const* dst, int nplanes,
               const int32_t* bit, int64_t n, int32_t* block_zeros,
               int32_t* block_offsets, int32_t* total, cudaStream_t stream) {
  if (n <= 0) return int(cudaGetLastError());
  const int64_t blocks = (n + kTile - 1) / kTile;
  split_count_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(bit, n,
                                                                block_zeros);
  scan_exclusive_one_block<<<1, TPQ_SCAN_THREADS, 0, stream>>>(
      block_zeros, blocks, block_offsets, total);
  for (int g = 0; g < nplanes; g += TPQ_MAX_COLS) {
    Planes p;
    p.n = nplanes - g < TPQ_MAX_COLS ? nplanes - g : TPQ_MAX_COLS;
    for (int i = 0; i < p.n; i++) {
      p.src[i] = src[g + i];
      p.dst[i] = dst[g + i];
    }
    split_scatter_kernel<<<unsigned(blocks), kThreads, 0, stream>>>(
        p, bit, n, block_offsets, total);
  }
  return int(cudaGetLastError());
}

int64_t tpq_split1_tile(void) { return kTile; }

}  // extern "C"
