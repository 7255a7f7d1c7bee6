// Feature-row gather for Hopper (sm_90a): out[m] = table[idx[m]].
//
// Replaces the Pallas kernel graph_learn_tpu/ops/pallas/gather.py
// gather_rows (_gather_kernel), which streams rows HBM -> VMEM with 16
// per-row DMAs in flight and pads the indices to 4096-row blocks.
//
// Bound: bytes.  The kernel reads M rows of D*itemsize bytes at random
// rows of the table and writes them once, contiguously, plus the M int32
// ids; there is no arithmetic.  At the paths' shapes: 1 024 / 15 360 /
// 153 600 rows of a [200 000, 128] bf16 table (serving and training src,
// hop 1, the GAT step's hop 2) move 0.53 / 7.9 / 79.3 MB; of the 62M-edge
// [2 450 000, 100] bf16 table 0.41 / 6.2 / 62.1 MB.  Random rows cost the
// card more than their bytes: a 200-byte row touches seven or eight
// 32-byte sectors, and device memory serves scattered rows at well under
// its streaming rate.
//
// Design, two routes, chosen here by shape and alignment:
//
// * Bulk copies (rows of a multiple of 8 bytes, up to kMaxBulkRow, an
//   8-byte aligned table and output, and more rows than one wave of the
//   lane-group kernel holds).  A block of kTile threads takes kTile
//   consecutive output rows: thread t reads id t and asks the copy engine
//   (cp.async.bulk, global -> shared, completing on one mbarrier with
//   expect_tx) for row t's 16-byte-aligned covering span, 208 bytes for a
//   200-byte row at a shift of 0 or 8.  A block keeps its 128 rows in
//   flight without registers, so every resident block does; the threads
//   then write the compacted tile out with 8-byte stores, neighbouring
//   threads on neighbouring addresses.  A span that would reach before the
//   table's first byte (a view whose base is only 8-byte aligned) or past
//   its last (the last row when N * 200 % 16 == 8) is read by its thread
//   with 8-byte loads instead.  Row offsets are int64.
// * Lane groups (everything else: D = 7, 1- to 4-byte vectors, unaligned
//   bases, and few rows).  A group of `tpr` lanes copies one row (tpr = the
//   power of two that covers the row's vectors, at most a warp), in
//   vectors of 16, 8, 4, 2 or 1 bytes as the row size and both base
//   pointers allow: one id load and one vector a lane.  While the whole
//   grid fits one wave of resident threads (1 024 rows of either table,
//   15 360 of the 200k one) every row's load is issued at once, and this
//   is the quickest route: the bulk route's fixed cost (barrier set-up, the
//   copy engine's latency, the block barrier, the pass through shared
//   memory) makes it 20% slower at 1 024 rows.
//
// Measured on an H100 and dropped (PERF.md gives the times): a warp per 1
// to 32 consecutive rows with the ids handed out by shuffles and lanes
// striding over (row, 8- or 16-byte vector) pairs, 4 to 32 loads in flight
// a lane (5% slower than the bulk copies at the 62M table, level at 200k;
// more loads in flight cost registers and then resident warps); the bulk
// route writing 16-byte stores from two 8-byte shared reads (3-5% slower
// than 8-byte stores).  No padding of M: the last block and lane group
// mask their own rows.  The indices must already lie in [0, N): the caller
// (ops/kernels/dispatch.py feature_gather) clips them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- lane groups: one row to a group of lanes, one vector a lane ----------

constexpr int kBlock = 256;

template <typename V>
__global__ void __launch_bounds__(kBlock)
    gather_rows_kernel(const V* __restrict__ table,
                       const int32_t* __restrict__ idx, V* __restrict__ out,
                       int64_t m, int64_t vecs, int tpr_log2) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t row = t >> tpr_log2;
  if (row >= m) return;
  const int64_t lane = t & ((1 << tpr_log2) - 1);
  const V* src = table + static_cast<int64_t>(idx[row]) * vecs;
  V* dst = out + row * vecs;
  for (int64_t c = lane; c < vecs; c += (int64_t{1} << tpr_log2)) {
    dst[c] = src[c];
  }
}

int tpr_log2_of(int64_t vecs) {
  int tpr_log2 = 0;
  while (tpr_log2 < 5 && (int64_t{1} << tpr_log2) < vecs) ++tpr_log2;
  return tpr_log2;
}

template <typename V>
void launch_lanes(const void* table, const void* idx, void* out, int64_t m,
                  int64_t row_bytes, cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<int64_t>(sizeof(V));
  const int tpr_log2 = tpr_log2_of(vecs);
  const int64_t grid = ((m << tpr_log2) + kBlock - 1) / kBlock;
  gather_rows_kernel<V><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), m, vecs, tpr_log2);
}

// ---- bulk copies: a block's rows in flight through the copy engine --------

constexpr int kTile = 128;        // rows (and threads) of a block
constexpr int kMaxBulkRow = 512;  // bytes; shared memory: kTile slots

// shared-memory bytes of one row's slot: its covering span at a shift of 0
// or 8 bytes, rounded up to 16
constexpr int64_t slot_bytes(int64_t row_bytes) {
  return (row_bytes + 8 + 15) & ~int64_t{15};
}

struct BulkArgs {
  const unsigned char* table;
  const int32_t* idx;
  unsigned char* out;
  int64_t m, table_bytes;
  int row_bytes, slot;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// thread t owns row t of the block's tile: it reads the id, and either asks
// for the row's covering span (announcing its bytes on the barrier first,
// so the phase cannot complete before the copy lands) or, where the span
// leaves the table, copies the row itself; all threads then write the
// tile out compacted.
__global__ void __launch_bounds__(kTile) gather_rows_bulk_kernel(
    const BulkArgs a) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int shift[kTile];
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int rows = a.m - row0 < kTile ? static_cast<int>(a.m - row0) : kTile;
  const uint32_t b = smem_addr(&bar);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b),
                 "r"(kTile)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t < rows) {
    const int64_t first = static_cast<int64_t>(a.idx[row0 + t]) * a.row_bytes;
    const int sh = static_cast<int>(
        reinterpret_cast<uintptr_t>(a.table + first) & 15);
    const int64_t lo = first - sh;  // the span, from the table's base
    const uint32_t len = (sh + a.row_bytes + 15) & ~15u;
    unsigned char* slot = ring + t * a.slot;
    if (lo >= 0 && lo + len <= a.table_bytes) {
      shift[t] = sh;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(len)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(slot)),
          "l"(a.table + lo), "r"(len), "r"(b)
          : "memory");
    } else {
      shift[t] = 0;
      const uint64_t* src =
          reinterpret_cast<const uint64_t*>(a.table + first);
      for (int w = 0; w < a.row_bytes / 8; ++w) {
        reinterpret_cast<uint64_t*>(slot)[w] = src[w];
      }
      mbar_arrive(b);
    }
  } else {
    mbar_arrive(b);
  }
  mbar_wait(b, 0);
  __syncthreads();  // shift[] and the rows copied by threads
  const int upr = a.row_bytes / 8;
  const int units = rows * upr;
  uint64_t* dst = reinterpret_cast<uint64_t*>(a.out + row0 * a.row_bytes);
  for (int u = t; u < units; u += kTile) {
    const int r = static_cast<unsigned>(u) / static_cast<unsigned>(upr);
    dst[u] = *reinterpret_cast<const uint64_t*>(
        ring + r * a.slot + shift[r] + (u - r * upr) * 8);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// threads the card holds at once (queried once)
int64_t resident_threads() {
  static const int64_t n = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                           dev);
    return static_cast<int64_t>(sms) * per_sm;
  }();
  return n;
}

void launch_bulk(const void* table, int64_t n_rows, const void* idx,
                 void* out, int64_t m, int64_t row_bytes,
                 cudaStream_t stream) {
  static const bool ready = [] {
    cudaFuncSetAttribute(gather_rows_bulk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kTile * slot_bytes(kMaxBulkRow)));
    return true;
  }();
  (void)ready;
  const int slot = static_cast<int>(slot_bytes(row_bytes));
  const BulkArgs a{static_cast<const unsigned char*>(table),
                   static_cast<const int32_t*>(idx),
                   static_cast<unsigned char*>(out), m, n_rows * row_bytes,
                   static_cast<int>(row_bytes), slot};
  const int64_t grid = (m + kTile - 1) / kTile;
  gather_rows_bulk_kernel<<<static_cast<unsigned>(grid), kTile, kTile * slot,
                            stream>>>(a);
}

}  // namespace

// table [n_rows, row_bytes] (any dtype), idx [m] int32, out [m, row_bytes].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int glt_gather_rows(const void* table, long long n_rows,
                               const void* idx, void* out, long long m,
                               long long row_bytes, void* stream) {
  if (m <= 0 || row_bytes <= 0) return 0;
  int vb = 16;
  while (vb > 1 && (row_bytes % vb != 0 || !aligned(table, vb) ||
                    !aligned(out, vb))) {
    vb >>= 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t lane_threads = m << tpr_log2_of(row_bytes / vb);
  if (vb >= 8 && row_bytes <= kMaxBulkRow &&
      lane_threads > resident_threads()) {
    launch_bulk(table, n_rows, idx, out, m, row_bytes, s);
    return static_cast<int>(cudaGetLastError());
  }
  switch (vb) {
    case 16: launch_lanes<uint4>(table, idx, out, m, row_bytes, s); break;
    case 8: launch_lanes<uint2>(table, idx, out, m, row_bytes, s); break;
    case 4: launch_lanes<uint32_t>(table, idx, out, m, row_bytes, s); break;
    case 2: launch_lanes<uint16_t>(table, idx, out, m, row_bytes, s); break;
    default: launch_lanes<uint8_t>(table, idx, out, m, row_bytes, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
