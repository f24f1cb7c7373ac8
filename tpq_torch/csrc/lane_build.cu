// The lane join's build for Hopper (sm_90a): the lane-bucket tables of
// tpq_torch.kernels.lane_table.build_lane_tables, whose plain version
// (build_lane_tables_ref) is tpq's sequence: two hashes, a stable int64
// sort of the composite (bucket << 32) | h2 over the whole capacity and
// its perm, the key and payload gathers by the perm, a rank of each row
// in its bucket, PAD into a flat lane-major [nb * D] layout and a
// transposing copy of each column into [npart, D, 128] tiles
// (tpq/kernels/lane_table.py build_lane_tables; not a Pallas kernel, PAD
// is).
//
// What it computes, for a plan of npart = 2^pbits partitions of 128
// lanes (nb = npart * 128 buckets) and depth D: live row k (k <
// num_rows) has bucket b = hash(key[k], pbits + 7 bits, salt_lane),
// partition p = b >> 7, lane l = b & 127, and h2 = hash(key[k], 32 bits,
// salt_h2). Bucket b's rows in (h2, k) order, the order the stable
// composite sort gives within a bucket, fill depths d < min(count, D) of
// column l of partition p's tiles: key, payloads, occ 1. Every other
// slot holds 0 (occ 0). blen[b] = min(count, D). ok is false where a
// bucket holds more than D rows (overflow) or two neighbours in that
// order share h2 and differ in key (the h2 hazard, which would break a
// key's run in d); it equals the sort path's on every input. Where ok is
// true every output byte equals the sort path's; where a bucket
// overflows, which rows fill it is unspecified (the joins never read the
// tables then: they fall back or count an overflow).
//
// Bound by bytes: the live rows' key and payloads read once, every slot
// of every tile written once (at config 5's shards 2^21 buckets at D 48,
// 100.7M slots of 20 bytes a shard, of which 15.6M are live). Two
// launches and no sort of the capacity:
//   1. count and place: one thread a live row (num_rows read on the
//      device) hashes its key twice and takes a depth in its bucket with
//      atomicAdd on the bucket's counter, which is its blen word (the
//      wrapper hands blen over zeroed). A depth under D parks
//      (h2 << 32 | row) in the key tile's slot of that depth, which the
//      finish overwrites: no scratch at all (the wrapper's one memset is
//      blen's);
//   2. finish, one block a partition and one thread a lane (its
//      bucket): the thread loads its min(count, D) parked words into a
//      column of shared memory and sorts them by insertion (unsigned
//      64-bit order is (h2, row) order), so the order of the atomics
//      leaves no trace. Then, depth by depth for all 128 lanes together
//      (1 KB stores), it gathers each row's key and payloads and writes
//      every slot of every tile once, zeros past the bucket's rows; it
//      checks the hazard between neighbours as it goes, turns its count
//      into blen, and the block clears ok on an overflow or a hazard (the
//      count's block 0 set it).
// At config 5's shards (16,384 partitions, 15.6M live rows a shard) the
// park's random 8-byte stores and the finish's random key and payload
// gathers take about 1.0 and 1.3 of the 3.2 ms a shard on an H100
// (against a 0.68-ms bound): no pass here orders the rows before they
// meet their buckets. Tried there and at config 1: blocks of 32 lanes
// with each bucket ranked (m^2 independent compares) in place of the
// insertion sort, slower at both (2.15 against 1.85 ms, 0.120 against
// 0.082 ms for the finish), faster only for one-partition tables (0.073
// against 0.092 ms at 5,000 rows, D 64), whose insertion chains are
// long (PERF.md).
// The sort's shared memory is 8 bytes a depth for each of 128 lanes, D
// KB a block, so the depth is capped at kMaxDepth (232,448 B / 1 KB,
// LANE_BUILD_MAX_DEPTH in kernels/lane_table.py), about the walk/emit's
// own cap; a deeper plan keeps the sort path.

#include "common.cuh"

namespace {

constexpr int kLanes = 128;  // L in kernels/lane_table.py
constexpr int kCountThreads = 256;
constexpr int kRowsPerThread = 4;  // the count's independent atomics in flight
constexpr int kCountTile = kCountThreads * kRowsPerThread;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a Hopper block may use
constexpr int kMaxDepth = kSmemLimit / (8 * kLanes);  // 227
constexpr int kGather = 8;  // depths whose gathers a finish thread has in flight

struct Build {
  const long long* key;  // [n]
  const long long* pay[TPQ_MAX_COLS];
  int npay;
  const void* num_rows;
  int nr_size;  // 4 or 8 bytes
  int64_t n;
  int depth;
  int shift;  // 32 - (pbits + 7)
  uint32_t salt_lane, salt_h2;
  long long* tkey;  // [npart, D, 128] each
  long long* tpay[TPQ_MAX_COLS];
  int32_t* occ;
  int32_t* blen;  // [nb]: zero at the launch, the counts, then min(count, D)
  bool* ok;
};

__device__ __forceinline__ int64_t live_rows(const Build& a) {
  const int64_t nr = a.nr_size == 8 ? *static_cast<const int64_t*>(a.num_rows)
                                    : int64_t(*static_cast<const int32_t*>(a.num_rows));
  return max(int64_t(0), min(nr, a.n));
}

__global__ void __launch_bounds__(kCountThreads) lane_build_count_kernel(Build a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.ok = true;
  const int64_t nr = live_rows(a);
  const int64_t base = int64_t(blockIdx.x) * kCountTile + threadIdx.x;
  long long key[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; j++) {
    const int64_t row = base + j * kCountThreads;
    key[j] = row < nr ? __ldg(a.key + row) : 0;
  }
  int32_t depth[kRowsPerThread];
  uint32_t bucket[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; j++) {
    const int64_t row = base + j * kCountThreads;
    bucket[j] = uint32_t(hash_one(key[j], a.salt_lane, a.shift));
    depth[j] = row < nr ? atomicAdd(a.blen + bucket[j], 1) : a.depth;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; j++) {
    if (depth[j] < a.depth) {
      const int64_t row = base + j * kCountThreads;
      const uint32_t h2 = uint32_t(hash_one(key[j], a.salt_h2, 0));
      const int64_t p = bucket[j] >> 7, l = bucket[j] & (kLanes - 1);
      a.tkey[(p * a.depth + depth[j]) * kLanes + l] =
          static_cast<long long>((uint64_t(h2) << 32) | uint64_t(row));
    }
  }
}

__global__ void __launch_bounds__(kLanes) lane_build_finish_kernel(Build a) {
  extern __shared__ unsigned long long s_parked[];  // [D][128]: lane l's column
  const int D = a.depth;
  const int l = threadIdx.x;
  const int64_t b = int64_t(blockIdx.x) * kLanes + l;
  const int64_t base = int64_t(blockIdx.x) * D * kLanes + l;  // slot (p, 0, l)
  unsigned long long* col = s_parked + l;
  const int32_t count = a.blen[b];
  const int m = min(count, D);

  // the parked words into the column, kGather loads in flight
  for (int d0 = 0; d0 < m; d0 += kGather) {
    unsigned long long w[kGather];
#pragma unroll
    for (int j = 0; j < kGather; j++)
      w[j] = d0 + j < m ? static_cast<unsigned long long>(a.tkey[base + int64_t(d0 + j) * kLanes])
                        : 0;
#pragma unroll
    for (int j = 0; j < kGather; j++)
      if (d0 + j < m) col[(d0 + j) * kLanes] = w[j];
  }
  // insertion sort of the column: (h2, row) order
  for (int i = 1; i < m; i++) {
    const unsigned long long v = col[i * kLanes];
    int j = i;
    for (; j > 0; j--) {
      const unsigned long long u = col[(j - 1) * kLanes];
      if (u <= v) break;
      col[j * kLanes] = u;
    }
    col[j * kLanes] = v;
  }

  bool bad = count > D;
  uint32_t prev_h2 = 0;
  long long prev_key = 0;
  for (int d0 = 0; d0 < D; d0 += kGather) {
    int64_t row[kGather];
    uint32_t h2[kGather];
    long long key[kGather];
#pragma unroll
    for (int j = 0; j < kGather; j++) {
      const bool live = d0 + j < m;
      const unsigned long long w = live ? col[(d0 + j) * kLanes] : 0;
      row[j] = live ? int64_t(uint32_t(w)) : -1;
      h2[j] = uint32_t(w >> 32);
      key[j] = live ? __ldg(a.key + row[j]) : 0;
    }
#pragma unroll
    for (int j = 0; j < kGather; j++) {
      const int d = d0 + j;
      if (d < D) {
        const int64_t s = base + int64_t(d) * kLanes;
        a.tkey[s] = key[j];
        a.occ[s] = d < m ? 1 : 0;
        if (d < m) {
          bad |= d > 0 && h2[j] == prev_h2 && key[j] != prev_key;
          prev_h2 = h2[j];
          prev_key = key[j];
        }
      }
    }
    for (int c = 0; c < a.npay; c++) {
      const long long* __restrict__ src = a.pay[c];
      long long v[kGather];
#pragma unroll
      for (int j = 0; j < kGather; j++) v[j] = row[j] >= 0 ? __ldg(src + row[j]) : 0;
      long long* __restrict__ dst = a.tpay[c];
#pragma unroll
      for (int j = 0; j < kGather; j++)
        if (d0 + j < D) dst[base + int64_t(d0 + j) * kLanes] = v[j];
    }
  }
  a.blen[b] = m;
  if (__syncthreads_or(bad) && threadIdx.x == 0) *a.ok = false;
}

// Raises the finish's shared-memory limit to the largest depth's, once
// per device.
bool finish_smem_ready(int smem) {
  static bool raised[64] = {false};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem <= 48 * 1024 || (dev < 64 && raised[dev])) return true;
  if (cudaFuncSetAttribute(lane_build_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxDepth * kLanes * 8) != cudaSuccess)
    return false;
  if (dev < 64) raised[dev] = true;
  return true;
}

}  // namespace

extern "C" {

// The lane tables of n rows (key and npay int64 payloads, num_rows a 4-
// or 8-byte int on the device) at npart = 2^pbits partitions of depth D:
// tkey, tpays and occ of npart * D * 128 slots, blen of npart * 128 ints,
// all zero (the counters), ok one bool. n < 2^31, pbits + 7 < 32, 1 <= D
// <= 227.
int tpq_lane_build(const int64_t* key, const int64_t* const* pays, int npay,
                   const void* num_rows, int nr_size, int64_t n, int pbits, int depth,
                   uint32_t salt_lane, uint32_t salt_h2, int64_t* tkey, int64_t* const* tpays,
                   int32_t* occ, int32_t* blen, bool* ok, cudaStream_t stream) {
  if (npay < 0 || npay > TPQ_MAX_COLS || pbits < 0 || pbits + 7 >= 32 || depth < 1 ||
      depth > kMaxDepth || n < 0 || n >= (int64_t(1) << 31) || (nr_size != 4 && nr_size != 8))
    return int(cudaErrorInvalidValue);
  Build a;
  a.key = reinterpret_cast<const long long*>(key);
  a.npay = npay;
  for (int c = 0; c < TPQ_MAX_COLS; c++) {
    a.pay[c] = c < npay ? reinterpret_cast<const long long*>(pays[c]) : nullptr;
    a.tpay[c] = c < npay ? reinterpret_cast<long long*>(tpays[c]) : nullptr;
  }
  a.num_rows = num_rows;
  a.nr_size = nr_size;
  a.n = n;
  a.depth = depth;
  a.shift = 32 - (pbits + 7);
  a.salt_lane = salt_lane;
  a.salt_h2 = salt_h2;
  a.tkey = reinterpret_cast<long long*>(tkey);
  a.occ = occ;
  a.blen = blen;
  a.ok = ok;
  const int smem = depth * kLanes * 8;
  if (!finish_smem_ready(smem)) return int(cudaGetLastError());
  const int64_t count_blocks = n > 0 ? (n + kCountTile - 1) / kCountTile : 1;
  lane_build_count_kernel<<<unsigned(count_blocks), kCountThreads, 0, stream>>>(a);
  lane_build_finish_kernel<<<unsigned(1) << pbits, kLanes, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
