// Lane-table probes for Hopper (sm_90a): the fused walk + emit, port of
// tpq/kernels/lane2.py _fused2_kernel (wrapper fused_probe_emit2), and
// the walk-only probe, port of tpq/kernels/lane_table.py _probe_kernel
// (wrapper probe_lane_tables); both share the walk of lane_table._walk.
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
// row. walk_emit_kernel does the walk and the emit in one launch:
//   * a CTA takes one work item: `chunk` (at most 4,096) padded queries
//     of one partition. The wrapper picks it from a whole partition,
//     2,048 and 1,024 by the waves of CTAs each size needs on the card
//     (config 5's 16,384 partitions of 3,072 queries: whole partitions;
//     config 1's 512: 1,024 queries). Work items are handed out in
//     (partition, chunk) order by an atomic ticket, not by blockIdx, so
//     an item's predecessors are held by CTAs that started first;
//   * one thread copies the partition's key tile (D*128 int64, 49,152 B
//     at D 48) and its 128 bucket lengths (computed once at build in
//     place of tpq's per-call column sum of occ) into dynamic shared
//     memory with the Tensor Memory Accelerator (cp.async.bulk,
//     completing on an mbarrier), while every thread loads its first
//     queries (key, lane, occ) into registers. The one partition of the
//     config-3 heavy table spans many CTAs; each copies the tile again,
//     from L2 after the first (64 KB at D 64), which is simpler than a
//     cluster multicast for the same DRAM bytes;
//   * build payload tiles are not staged: a match reads its payload from
//     device memory, one 32-byte sector, and the matches of a partition
//     touch fewer distinct sectors than its whole payload tile holds
//     (about 1,100 of 1,536 at config 1, 700 at config 5), while staging
//     the tile would also cost a CTA per SM;
//   * each thread walks its queries (striped over the CTA, so the loads
//     coalesce), writes cnt and d_first and keeps the first K match
//     depths and the lane of each query in shared memory, so the emit
//     neither reads the queries again nor walks again; a dead query
//     costs its loads and the two stores;
//   * the CTA's rows are counted by one block scan over its queries and
//     placed by a single-pass scan with decoupled look-back over the
//     work items (look_back in common.cuh, with PACK's 64-bit (epoch,
//     flag, count) statuses in a buffer kept per device and stream; the
//     epoch is read from that buffer, and the CTA with the last ticket
//     rearms the counter and stores the epoch, so a graph replay takes a
//     new one; the last work item writes total_inline), never by
//     atomics: rows go out in (padded query, j) order, the same bytes on
//     every run;
//   * the CTA's rows [offset, offset + rows) are written by row, not by
//     query: a thread takes two neighbouring rows, finds each one's query
//     by binary search over the scanned counts and stores every column
//     of the pair as one aligned 16-byte store, so each column's range
//     is written contiguously. Rows at or past out_capacity are dropped.
// Bound by bytes: every padded query read once (key, lane, occ: 16 B),
// each partition's key tile and bucket lengths once, cnt and d_first and
// every emitted row written once, a build payload (a sector) and the
// probe payloads read per emitted row.
//
// probe_walk_kernel is the walk-only probe, the port of
// tpq/kernels/lane_table.py _probe_kernel (wrapper probe_lane_tables),
// which the skew join's membership probes run (a one-partition list
// table of the heavy keys, D 48, K 1, no payload columns, probed by
// 1,048,576 rows at config 3). It writes, per padded query, cnt, d_first
// and the build payloads of its first K matches (0 past cnt and for
// dead queries). Bound by bytes: each query read once (key, lane, occ:
// 16 B) and 8 B plus 8 B per (rank, payload column) written. So:
//   * a CTA takes `chunk` padded queries of one partition, the size
//     picked by the waves of CTAs it needs on the card, as for the
//     walk/emit (lane_table.probe_walk_chunk): a one-partition table of
//     a million queries is walked by one wave of 2,048-query CTAs, each
//     of which copies the tile once;
//   * warp 0 reads the partition's 128 bucket lengths and one thread
//     copies the key tile's depths up to the longest bucket (the depths
//     any walk reads: 6 of 48 for config 3's 292 heavy keys) into shared
//     memory by TMA on an mbarrier, while every thread loads its first
//     queries;
//   * a thread walks its queries, striped over the CTA, and keeps the
//     depths of its first K matches in a register; cnt and d_first, then
//     each (rank, column) payload, go out in one coalesced store per
//     warp, zero at ranks at or past cnt.
// Nothing is ordered across CTAs, so no ticket or look-back.

#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kMaxK = 8;  // MAX_K in tpq_torch/kernels/lane_table.py
constexpr int kBatch = 4;  // queries a thread loads before walking them
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

// ---------------------------------------------------------------------------
// the fused walk/emit
// ---------------------------------------------------------------------------

constexpr int kEmitThreads = 256;
constexpr int kMaxChunk = 4096;  // queries per work item: MAX_CHUNK in kernels/lane2.py

struct EmitCols {
  const int64_t* tpay[TPQ_MAX_COLS];  // build payloads [npart, D, 128]
  const int64_t* spay[TPQ_MAX_COLS];  // probe payloads [u]
  int64_t* out_r[TPQ_MAX_COLS];
  int64_t* out_s[TPQ_MAX_COLS];
  int nr, ns;
};

// Byte offsets of the dynamic shared memory of a work item of `chunk`
// queries: the key tile, the bucket lengths, the scanned row counts
// (uint16, chunk + 1), the first K depths per query and each query's lane.
struct EmitSmem {
  int blen, lo, dep, lane, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline EmitSmem emit_smem(int D, int K, int chunk) {
  EmitSmem s;
  s.blen = D * kLanes * 8;
  s.lo = s.blen + kLanes * 4;
  s.dep = s.lo + align16((chunk + 1) * 2);
  s.lane = s.dep + align16(chunk * K);
  s.bytes = s.lane + align16(chunk);
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// the walk-only probe
// ---------------------------------------------------------------------------

constexpr int kWalkThreads = 256;

struct ProbeCols {
  const int64_t* tpay[TPQ_MAX_COLS];   // build payloads [npart, D, 128]
  int64_t* out[kMaxK * TPQ_MAX_COLS];  // rank j, column i at [j * n + i]
  int n;
};

// The grid is 1-D, one CTA per `chunk` padded queries of a partition,
// partition-major (gridDim.y stops at 65,535 partitions).
__global__ void __launch_bounds__(kWalkThreads)
    probe_walk_kernel(const int64_t* __restrict__ t_key, const int32_t* __restrict__ blen,
                      const int64_t* __restrict__ qk, const int32_t* __restrict__ lane,
                      const int32_t* __restrict__ qocc, int D, int K, int probe_cap,
                      int chunk, int32_t* __restrict__ cnt_out,
                      int32_t* __restrict__ dfirst_out, ProbeCols cols) {
  extern __shared__ __align__(16) unsigned char smem[];  // key tile, depths < s_depth
  __shared__ __align__(8) uint64_t bar;
  __shared__ __align__(16) int32_t s_blen[kLanes];
  __shared__ int s_depth;
  const int64_t* s_key = reinterpret_cast<const int64_t*>(smem);
  const int chunks = (probe_cap + chunk - 1) / chunk;
  const int64_t p = blockIdx.x / chunks;
  const int c0 = int(blockIdx.x % chunks) * chunk;
  const int qn = min(chunk, probe_cap - c0);
  const int64_t q0 = p * probe_cap + c0;

  if (threadIdx.x < 32) {  // warp 0: bucket lengths, the longest, the tile
    const int4 b = reinterpret_cast<const int4*>(blen + p * kLanes)[threadIdx.x];
    reinterpret_cast<int4*>(s_blen)[threadIdx.x] = b;
    int m = max(max(b.x, b.y), max(b.z, b.w));
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    m = min(m, D);
    if (threadIdx.x == 0) {
      s_depth = m;
      if (m > 0) {
        mbar_init(&bar);
        mbar_expect_tx(&bar, uint32_t(m) * kLanes * 8);
        bulk_load(smem, t_key + p * D * kLanes, uint32_t(m) * kLanes * 8, &bar);
      }
    }
  }

  // query q = k * kWalkThreads + threadIdx.x, kBatch values of k loaded
  // at a time (the first batch while the tile is in flight)
  const int nk = (qn + kWalkThreads - 1) / kWalkThreads;
  int32_t b_occ[kBatch], b_lane[kBatch];
  int64_t b_key[kBatch];
  auto load_batch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kBatch; i++) {
      const int q = (k0 + i) * kWalkThreads + threadIdx.x;
      b_occ[i] = q < qn ? qocc[q0 + q] : 0;
      b_lane[i] = q < qn ? lane[q0 + q] : 0;
      b_key[i] = q < qn ? qk[q0 + q] : 0;
    }
  };
  load_batch(0);
  __syncthreads();
  if (s_depth > 0) mbar_wait(&bar, 0);
  for (int k0 = 0; k0 < nk; k0 += kBatch) {
    if (k0 > 0) load_batch(k0);
#pragma unroll
    for (int i = 0; i < kBatch; i++) {
      const int q = (k0 + i) * kWalkThreads + threadIdx.x;
      if (q >= qn) break;
      int c = 0, df = -1;
      uint64_t deps = 0;  // depth of match j in byte j, j < K
      const int l = b_lane[i];
      if (b_occ[i] > 0) {
        const int64_t key = b_key[i];
        const int bl = s_blen[l];
        for (int d = 0; d < bl; d++) {
          if (s_key[d * kLanes + l] == key) {
            if (c == 0) df = d;
            if (c < K) deps |= uint64_t(d) << (8 * c);
            c++;
          }
        }
      }
      const int64_t g = q0 + q;
      cnt_out[g] = c;
      dfirst_out[g] = df;
      for (int j = 0; j < K; j++) {
        const int64_t slot = (p * D + int((deps >> (8 * j)) & 0xff)) * kLanes + l;
        for (int i2 = 0; i2 < cols.n; i2++)
          cols.out[j * cols.n + i2][g] = j < c ? cols.tpay[i2][slot] : 0;
      }
    }
  }
}

// The query of the work item's row r: the last q with lo[q] <= r (a
// query with rows is the last of its equal offsets).
__device__ __forceinline__ int row_query(const uint16_t* lo, int qn, int r) {
  int a = 0, b = qn;
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (int(lo[m]) <= r) a = m; else b = m;
  }
  return a;
}

__device__ __forceinline__ void store_pair(int64_t* __restrict__ dst, int64_t g0, bool in0,
                                           bool in1, int64_t a, int64_t b) {
  if (in0 && in1)
    *reinterpret_cast<longlong2*>(dst + g0) = make_longlong2(a, b);
  else if (in0)
    dst[g0] = a;
  else if (in1)
    dst[g0 + 1] = b;
}

// The state buffer's layout is in common.cuh: the epoch and ticket word,
// the wrap count, and work item t's status at state[kStateHeader + t].
__global__ void __launch_bounds__(kEmitThreads)
    walk_emit_kernel(const int64_t* __restrict__ t_key, const int32_t* __restrict__ blen,
                     const int64_t* __restrict__ qk, const int32_t* __restrict__ lane,
                     const int32_t* __restrict__ qocc, int D, int K, int probe_cap,
                     int chunk, int64_t nwork, int32_t* __restrict__ cnt_out,
                     int32_t* __restrict__ dfirst_out, EmitCols cols,
                     int64_t* __restrict__ out_key, int64_t out_capacity,
                     uint64_t* __restrict__ state, int64_t state_words,
                     int32_t* __restrict__ total_inline) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int64_t s_ticket, s_off;
  __shared__ uint32_t s_epoch;
  __shared__ int32_t warp_sums[32];
  const EmitSmem L = emit_smem(D, K, chunk);
  const int64_t* s_key = reinterpret_cast<const int64_t*>(smem);
  const int32_t* s_blen = reinterpret_cast<const int32_t*>(smem + L.blen);
  uint16_t* s_lo = reinterpret_cast<uint16_t*>(smem + L.lo);
  uint8_t* s_dep = smem + L.dep;
  uint8_t* s_lane = smem + L.lane;

  if (threadIdx.x == 0) {
    uint32_t e;
    const uint64_t t = draw_ticket(state, &e);
    if (t == uint64_t(nwork) - 1)  // every CTA of the launch has its ticket
      finish_tickets(state, e);
    s_ticket = int64_t(t);
    s_epoch = e;
    mbar_init(&bar);
  }
  __syncthreads();
  const int64_t t = s_ticket;
  const int chunks = (probe_cap + chunk - 1) / chunk;
  const int64_t p = t / chunks;
  const int c0 = int(t % chunks) * chunk;
  const int qn = min(chunk, probe_cap - c0);
  const int64_t q0 = p * probe_cap + c0;
  if (threadIdx.x == 0) {
    const uint32_t tile = uint32_t(D) * kLanes * 8;
    mbar_expect_tx(&bar, tile + kLanes * 4);
    bulk_load(smem, t_key + p * D * kLanes, tile, &bar);
    bulk_load(smem + L.blen, blen + p * kLanes, kLanes * 4, &bar);
  }

  // walk: query q = k * kEmitThreads + threadIdx.x, kBatch values of k
  // loaded at a time (the first batch while the tile is in flight)
  const int nk = (qn + kEmitThreads - 1) / kEmitThreads;
  int32_t b_occ[kBatch], b_lane[kBatch];
  int64_t b_key[kBatch];
  auto load_batch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kBatch; i++) {
      const int q = (k0 + i) * kEmitThreads + threadIdx.x;
      b_occ[i] = q < qn ? qocc[q0 + q] : 0;
      b_lane[i] = q < qn ? lane[q0 + q] : 0;
      b_key[i] = q < qn ? qk[q0 + q] : 0;
    }
  };
  load_batch(0);
  mbar_wait(&bar, 0);
  for (int k0 = 0; k0 < nk; k0 += kBatch) {
    if (k0 > 0) load_batch(k0);
#pragma unroll
    for (int i = 0; i < kBatch; i++) {
      const int q = (k0 + i) * kEmitThreads + threadIdx.x;
      if (q >= qn) break;
      int c = 0, df = -1;
      if (b_occ[i] > 0) {
        const int l = b_lane[i];
        const int64_t key = b_key[i];
        const int bl = s_blen[l];
        for (int d = 0; d < bl; d++) {
          if (s_key[d * kLanes + l] == key) {
            if (c == 0) df = d;
            if (c < K) s_dep[q * K + c] = uint8_t(d);
            c++;
          }
        }
        s_lane[q] = uint8_t(l);
      }
      cnt_out[q0 + q] = c;
      dfirst_out[q0 + q] = df;
      s_lo[q] = uint16_t(min(c, K));
    }
  }
  __syncthreads();

  // the work item's rows per query, scanned in place; s_lo[qn] = rows
  const int per = (qn + kEmitThreads - 1) / kEmitThreads;
  const int a0 = threadIdx.x * per;
  int32_t sum = 0;
  for (int j = 0; j < per && a0 + j < qn; j++) sum += s_lo[a0 + j];
  int32_t rows;
  int32_t run = block_exclusive_scan(sum, warp_sums, &rows);
  for (int j = 0; j < per && a0 + j < qn; j++) {
    const int v = s_lo[a0 + j];
    s_lo[a0 + j] = uint16_t(run);
    run += v;
  }
  if (threadIdx.x == 0) s_lo[qn] = uint16_t(rows);
  if (threadIdx.x < 32) {
    const int64_t prefix =
        look_back(state + kStateHeader, t, uint32_t(rows), uint64_t(s_epoch) << 32);
    if (threadIdx.x == 0) {
      s_off = prefix;
      if (t == nwork - 1) *total_inline = int32_t(prefix + rows);
      finish_block(state, state_words, s_epoch);
    }
  }
  __syncthreads();

  // emit: output rows [off, end), two neighbouring rows a thread
  const int64_t off = s_off;
  const int64_t end = min(off + int64_t(rows), out_capacity);
  for (int64_t g0 = 2 * ((off >> 1) + threadIdx.x); g0 < end; g0 += 2 * kEmitThreads) {
    const bool in0 = g0 >= off, in1 = g0 + 1 < end;
    const int r0 = int(g0 - off), r1 = r0 + 1;
    const int qa = in0 ? row_query(s_lo, qn, r0) : 0;
    const int qb = in1 ? row_query(s_lo, qn, r1) : 0;
    const int64_t ga = q0 + qa, gb = q0 + qb;
    const int64_t slot_a = (p * D + s_dep[qa * K + (in0 ? r0 - s_lo[qa] : 0)]) * kLanes + s_lane[qa];
    const int64_t slot_b = (p * D + s_dep[qb * K + (in1 ? r1 - s_lo[qb] : 0)]) * kLanes + s_lane[qb];
    store_pair(out_key, g0, in0, in1, in0 ? qk[ga] : 0, in1 ? qk[gb] : 0);
    for (int i = 0; i < cols.nr; i++)
      store_pair(cols.out_r[i], g0, in0, in1, in0 ? cols.tpay[i][slot_a] : 0,
                 in1 ? cols.tpay[i][slot_b] : 0);
    for (int i = 0; i < cols.ns; i++)
      store_pair(cols.out_s[i], g0, in0, in1, in0 ? cols.spay[i][ga] : 0,
                 in1 ? cols.spay[i][gb] : 0);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the fused walk/emit at (D, K, chunk).
int tpq_walk_emit_smem(int D, int K, int chunk) { return emit_smem(D, K, chunk).bytes; }

// CTAs of the fused walk/emit at (D, K, chunk) that the current card
// holds at once.
int tpq_walk_emit_slots(int D, int K, int chunk) {
  const int smem = emit_smem(D, K, chunk).bytes;
  cudaFuncSetAttribute(walk_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_emit_kernel, kEmitThreads, smem);
  return sms * per_sm;
}

// One work item per `chunk` (<= 4,096) padded queries of a partition.
// state: state_words >= nwork + kStateHeader words, zero before the first
// call on the stream and left for the next one (layout in common.cuh).
// t_key and blen 16-byte aligned; out columns 16-byte aligned.
int tpq_walk_emit(const int64_t* t_key, const int64_t* const* t_pays, int nr,
                  const int32_t* blen, int npart, int D, int K, int probe_cap, int chunk,
                  const int64_t* qk, const int32_t* lane, const int32_t* qocc,
                  const int64_t* const* s_pays, int ns, int32_t* cnt, int32_t* dfirst,
                  int64_t* out_key, int64_t* const* out_r, int64_t* const* out_s,
                  int64_t out_capacity, uint64_t* state, int64_t state_words,
                  int32_t* total_inline, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || chunk < 1 || chunk > kMaxChunk || nr < 0 ||
      nr > TPQ_MAX_COLS || ns < 0 || ns > TPQ_MAX_COLS || npart < 1 || probe_cap < 1)
    return int(cudaErrorInvalidValue);
  const int64_t nwork = int64_t(npart) * ((probe_cap + chunk - 1) / chunk);
  if (nwork + kStateHeader > state_words) return int(cudaErrorInvalidValue);
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
  const int smem = emit_smem(D, K, chunk).bytes;
  cudaFuncSetAttribute(walk_emit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  walk_emit_kernel<<<unsigned(nwork), kEmitThreads, smem, stream>>>(
      t_key, blen, qk, lane, qocc, D, K, probe_cap, chunk, nwork, cnt, dfirst, cols,
      out_key, out_capacity, state, state_words, total_inline);
  return int(cudaGetLastError());
}

// Dynamic shared memory of the walk-only probe at depth D (the whole
// key tile; a CTA copies the depths up to its longest bucket).
static int probe_walk_smem(int D) { return D * kLanes * 8; }

// Raises the walk-only probe's shared-memory limit to `smem`, once per
// device and size.
static void probe_walk_allow(int smem) {
  static int allowed[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > allowed[dev & 63]) {
    cudaFuncSetAttribute(probe_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    allowed[dev & 63] = smem;
  }
}

// CTAs of the walk-only probe at depth D that the current card holds at once.
int tpq_probe_walk_slots(int D) {
  const int smem = probe_walk_smem(D);
  probe_walk_allow(smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_walk_kernel, kWalkThreads, smem);
  return sms * per_sm;
}

// One CTA per `chunk` padded queries of a partition. outs holds K * npay
// column pointers, rank-major. t_key and blen 16-byte aligned.
int tpq_probe_walk(const int64_t* t_key, const int64_t* const* t_pays, int npay,
                   const int32_t* blen, int npart, int D, int K, int probe_cap, int chunk,
                   const int64_t* qk, const int32_t* lane, const int32_t* qocc, int32_t* cnt,
                   int32_t* dfirst, int64_t* const* outs, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || npay < 0 || npay > TPQ_MAX_COLS || npart < 1 ||
      probe_cap < 1 || chunk < 1 || D < 1 || probe_walk_smem(D) > kSmemLimit - 1024)
    return int(cudaErrorInvalidValue);
  ProbeCols cols;
  cols.n = npay;
  for (int i = 0; i < npay; i++) cols.tpay[i] = t_pays[i];
  for (int i = 0; i < K * npay; i++) cols.out[i] = outs[i];
  const int smem = probe_walk_smem(D);
  probe_walk_allow(smem);
  const int64_t grid = int64_t(npart) * ((probe_cap + chunk - 1) / chunk);
  probe_walk_kernel<<<unsigned(grid), kWalkThreads, smem, stream>>>(
      t_key, blen, qk, lane, qocc, D, K, probe_cap, chunk, cnt, dfirst, cols);
  return int(cudaGetLastError());
}

}  // extern "C"
