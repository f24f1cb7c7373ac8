// PAD and PACK for Hopper (sm_90a): the port of tpq/kernels/move.py.
//
// PAD replaces move._pad_kernel (wrapper move.pad). On the TPU each
// output tile DMAs its contiguous source window and expands it through
// a shift network, because Mosaic has no fast scatter. Here the card
// scatters natively: the outputs are zeroed with cudaMemsetAsync, then
// one thread per source row writes its row to slot dest[k]. dest is
// strictly increasing over the live prefix, so no two rows share a slot
// and no atomics are needed. Bound by device-memory bytes: the zero
// fill writes every output once, the scatter reads each source row and
// writes it once.
//
// PACK replaces move._pack_kernel (wrapper move.pack). The TPU version
// is one sequential grid carrying a row cursor in SMEM; blocks here run
// in parallel and in no order, so the cursor becomes three launches:
// a per-block count of live rows, a one-block exclusive scan of those
// counts, and a stable scatter in which each block ranks its rows with
// a block scan. Outputs are zeroed first, which leaves everything past
// `total` zero as tpq's contract asks. Bound by bytes: occ is read twice,
// the live rows once, and the outputs written once by the zero fill and
// once by the scatter.
//
// Every entry point returns cudaGetLastError() (0 on success).

#include "common.cuh"

namespace {

constexpr int kPadThreads = 256;
constexpr int kPackThreads = 256;
constexpr int kPackIters = 16;
constexpr int64_t kPackTile = int64_t(kPackThreads) * kPackIters;

__global__ void pad_kernel(ColList cols, const int32_t* __restrict__ dest,
                           const int32_t* __restrict__ n_live, int64_t n,
                           int64_t out_len, int32_t* __restrict__ occ) {
  const int64_t k = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n || k >= int64_t(*n_live)) return;
  const int64_t d = dest[k];
  if (d < 0 || d >= out_len) return;  // dropped: overflow is counted upstream
  copy_row(cols, k, d);
  occ[d] = 1;
}

__global__ void pack_count_kernel(const int32_t* __restrict__ occ, int64_t n,
                                  int32_t* __restrict__ block_counts) {
  const int64_t base = int64_t(blockIdx.x) * kPackTile;
  int32_t c = 0;
  for (int it = 0; it < kPackIters; it++) {
    const int64_t k = base + int64_t(it) * kPackThreads + threadIdx.x;
    c += __syncthreads_count(k < n && occ[k] != 0);
  }
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void pack_scatter_kernel(ColList cols,
                                    const int32_t* __restrict__ occ, int64_t n,
                                    const int32_t* __restrict__ block_offsets) {
  __shared__ int32_t warp_sums[32];
  const int64_t base = int64_t(blockIdx.x) * kPackTile;
  int64_t run = block_offsets[blockIdx.x];
  for (int it = 0; it < kPackIters; it++) {
    const int64_t k = base + int64_t(it) * kPackThreads + threadIdx.x;
    const int32_t f = k < n && occ[k] != 0;
    int32_t chunk;
    const int32_t excl = block_exclusive_scan(f, warp_sums, &chunk);
    if (f) copy_row(cols, k, run + excl);
    run += chunk;
  }
}

}  // namespace

extern "C" {

int tpq_pad(const void* const* src, void* const* dst, const int* esz,
            int ncols, const int32_t* dest, const int32_t* n_live, int64_t n,
            int64_t out_len, int32_t* occ, cudaStream_t stream) {
  ColList cols = make_cols(src, dst, esz, ncols);
  for (int i = 0; i < ncols; i++)
    cudaMemsetAsync(dst[i], 0, size_t(out_len) * esz[i], stream);
  cudaMemsetAsync(occ, 0, size_t(out_len) * sizeof(int32_t), stream);
  if (n > 0) {
    const int64_t blocks = (n + kPadThreads - 1) / kPadThreads;
    pad_kernel<<<unsigned(blocks), kPadThreads, 0, stream>>>(
        cols, dest, n_live, n, out_len, occ);
  }
  return int(cudaGetLastError());
}

// block_counts and block_offsets hold pack_blocks(n) ints each.
int tpq_pack(const void* const* src, void* const* dst, const int* esz,
             int ncols, const int32_t* occ, int64_t n, int32_t* block_counts,
             int32_t* block_offsets, int32_t* total, cudaStream_t stream) {
  ColList cols = make_cols(src, dst, esz, ncols);
  for (int i = 0; i < ncols; i++)
    cudaMemsetAsync(dst[i], 0, size_t(n) * esz[i], stream);
  cudaMemsetAsync(total, 0, sizeof(int32_t), stream);
  if (n > 0) {
    const int64_t blocks = (n + kPackTile - 1) / kPackTile;
    pack_count_kernel<<<unsigned(blocks), kPackThreads, 0, stream>>>(
        occ, n, block_counts);
    scan_exclusive_one_block<<<1, TPQ_SCAN_THREADS, 0, stream>>>(
        block_counts, blocks, block_offsets, total);
    pack_scatter_kernel<<<unsigned(blocks), kPackThreads, 0, stream>>>(
        cols, occ, n, block_offsets);
  }
  return int(cudaGetLastError());
}

int64_t tpq_pack_tile(void) { return kPackTile; }

const char* tpq_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

}  // extern "C"
