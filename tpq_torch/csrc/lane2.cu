// Fused lane walk + emit for Hopper (sm_90a): the port of
// tpq/kernels/lane2.py _fused2_kernel (wrapper fused_probe_emit2) and the
// walk it shares with lane_table._walk.
//
// What it computes. Build tables hold, per partition p, a [D, 128] tile
// per column: lane l's bucket is the column (0..blen[p][l]-1, l). Padded
// queries of partition p sit at [p*probe_cap, (p+1)*probe_cap). Each live
// query walks its bucket at its own lane and yields cnt (matches),
// d_first (depth of the first match, or -1) and one output row
// (key, build payloads, probe payloads) per match j < min(cnt, K).
//
// The TPU kernel walks (32,128) query tiles against VMEM-resident table
// windows and packs rows through a shift network with async staged
// flushes, because Mosaic can only gather along the 128 lanes of a vreg
// row. Here a CTA takes one (partition, 1024-query chunk):
//   * it stages the partition's key tile, D*128 int64 (49,152 B at D=48,
//     above the 48 KB static limit, hence dynamic shared memory raised
//     with cudaFuncSetAttribute), and the [128] bucket lengths, which the
//     build computes once in place of tpq's per-call column sum of occ;
//   * build payloads are NOT staged: at four int64 payload columns they
//     would not fit beside the keys at D=48 (240 KB > 227 KB). A match
//     reads them from device memory, at most K reads per query;
//   * emit offsets come from a scan (walk -> one-block scan of per-CTA
//     row counts -> emit), never from atomics, so the output is the same
//     on every run. Rows go out in (padded query, j) order; rows at or
//     past out_capacity are dropped (the caller sees the overflow in its
//     totals).
// The walk launch alone is, in substance, tpq's probe_lane_tables kernel
// without its inline payload outputs.
//
// Bound: the walk reads every padded query (key, lane, occ: 16 B) and
// each partition's key tile once per chunk, mostly from L2; the emit
// reads them again and writes the output rows. Shared-memory reads of
// the walk (about blen per query) are the inner loop.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // queries per CTA
constexpr int kLanes = 128;

struct EmitCols {
  const int64_t* tpay[TPQ_MAX_COLS];  // build payloads [npart, D, 128]
  const int64_t* spay[TPQ_MAX_COLS];  // probe payloads [u]
  int64_t* out_r[TPQ_MAX_COLS];
  int64_t* out_s[TPQ_MAX_COLS];
  int nr, ns;
};

__device__ __forceinline__ void stage_tile(int64_t* s_key, int32_t* s_blen,
                                           const int64_t* __restrict__ t_key,
                                           const int32_t* __restrict__ blen,
                                           int p, int D) {
  const int64_t* tk = t_key + int64_t(p) * D * kLanes;
  for (int i = threadIdx.x; i < D * kLanes; i += blockDim.x) s_key[i] = tk[i];
  if (threadIdx.x < kLanes) s_blen[threadIdx.x] = blen[p * kLanes + threadIdx.x];
  __syncthreads();
}

// grid (chunks per partition, npart)
__global__ void walk_kernel(const int64_t* __restrict__ t_key,
                            const int32_t* __restrict__ blen,
                            const int64_t* __restrict__ qk,
                            const int32_t* __restrict__ lane,
                            const int32_t* __restrict__ qocc, int D, int K,
                            int probe_cap, int32_t* __restrict__ cnt_out,
                            int32_t* __restrict__ dfirst_out,
                            int32_t* __restrict__ block_rows) {
  extern __shared__ int64_t s_key[];
  __shared__ int32_t s_blen[kLanes];
  __shared__ int32_t warp_sums[32];
  const int p = blockIdx.y;
  stage_tile(s_key, s_blen, t_key, blen, p, D);

  int32_t rows = 0;
  for (int it = 0; it < kChunk / kThreads; it++) {
    const int qi = blockIdx.x * kChunk + it * kThreads + threadIdx.x;
    if (qi >= probe_cap) break;
    const int64_t q = int64_t(p) * probe_cap + qi;
    int c = 0, df = -1;
    if (qocc[q] > 0) {
      const int l = lane[q];
      const int64_t key = qk[q];
      const int bl = s_blen[l];
      for (int d = 0; d < bl; d++) {
        if (s_key[d * kLanes + l] == key) {
          if (c == 0) df = d;
          c++;
        }
      }
    }
    cnt_out[q] = c;
    dfirst_out[q] = df;
    rows += min(c, K);
  }
  int32_t total;
  block_exclusive_scan(rows, warp_sums, &total);
  if (threadIdx.x == 0) block_rows[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void emit_kernel(const int64_t* __restrict__ t_key,
                            const int32_t* __restrict__ blen,
                            const int64_t* __restrict__ qk,
                            const int32_t* __restrict__ lane,
                            const int32_t* __restrict__ cnt,
                            const int32_t* __restrict__ dfirst, int D, int K,
                            int probe_cap,
                            const int32_t* __restrict__ block_offsets,
                            EmitCols cols, int64_t* __restrict__ out_key,
                            int64_t out_capacity) {
  extern __shared__ int64_t s_key[];
  __shared__ int32_t s_blen[kLanes];
  __shared__ int32_t warp_sums[32];
  const int p = blockIdx.y;
  stage_tile(s_key, s_blen, t_key, blen, p, D);

  int64_t run = block_offsets[blockIdx.y * gridDim.x + blockIdx.x];
  for (int it = 0; it < kChunk / kThreads; it++) {
    const int qi = blockIdx.x * kChunk + it * kThreads + threadIdx.x;
    const int64_t q = int64_t(p) * probe_cap + qi;
    const int c = qi < probe_cap ? min(cnt[q], K) : 0;
    int32_t chunk;
    const int64_t o = run + block_exclusive_scan(c, warp_sums, &chunk);
    run += chunk;
    if (c == 0) continue;
    const int l = lane[q];
    const int64_t key = qk[q];
    const int bl = s_blen[l];
    int j = 0;
    for (int d = dfirst[q]; d < bl && j < c; d++) {
      if (s_key[d * kLanes + l] != key) continue;
      const int64_t row = o + j++;
      if (row >= out_capacity) break;
      const int64_t slot = (int64_t(p) * D + d) * kLanes + l;
      out_key[row] = key;
      for (int i = 0; i < cols.nr; i++) cols.out_r[i][row] = cols.tpay[i][slot];
      for (int i = 0; i < cols.ns; i++) cols.out_s[i][row] = cols.spay[i][q];
    }
  }
}

}  // namespace

extern "C" {

// Scratch: block_rows and block_offsets hold npart * ceil(probe_cap /
// 1024) ints each, total_inline one int.
int tpq_walk_emit(const int64_t* t_key, const int64_t* const* t_pays, int nr,
                  const int32_t* blen, int npart, int D, int K, int probe_cap,
                  const int64_t* qk, const int32_t* lane, const int32_t* qocc,
                  const int64_t* const* s_pays, int ns, int32_t* cnt,
                  int32_t* dfirst, int64_t* out_key, int64_t* const* out_r,
                  int64_t* const* out_s, int64_t out_capacity,
                  int32_t* block_rows, int32_t* block_offsets,
                  int32_t* total_inline, cudaStream_t stream) {
  EmitCols cols;
  cols.nr = nr;
  cols.ns = ns;
  for (int i = 0; i < nr; i++) {
    cols.tpay[i] = t_pays[i];
    cols.out_r[i] = out_r[i];
  }
  for (int i = 0; i < ns; i++) {
    cols.spay[i] = s_pays[i];
    cols.out_s[i] = out_s[i];
  }
  const size_t smem = size_t(D) * kLanes * sizeof(int64_t);
  cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  cudaFuncSetAttribute(emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       int(smem));
  const int chunks = (probe_cap + kChunk - 1) / kChunk;
  const dim3 grid(chunks, npart);
  walk_kernel<<<grid, kThreads, smem, stream>>>(t_key, blen, qk, lane, qocc, D,
                                                K, probe_cap, cnt, dfirst,
                                                block_rows);
  scan_exclusive_one_block<<<1, TPQ_SCAN_THREADS, 0, stream>>>(
      block_rows, int64_t(chunks) * npart, block_offsets, total_inline);
  emit_kernel<<<grid, kThreads, smem, stream>>>(t_key, blen, qk, lane, cnt,
                                                dfirst, D, K, probe_cap,
                                                block_offsets, cols, out_key,
                                                out_capacity);
  return int(cudaGetLastError());
}

}  // extern "C"
