// CSR order for Hopper (sm_90a): one direction of an edge table's adjacency
// built on the card.
//
// Replaces no Pallas kernel.  The JAX package builds every CSR on the host
// (core/store.py _build_csr: a stable np.lexsort by row, then by the
// adjacency key), and so does the port's CPU view.  This kernel computes
// the same order on the card from the edge arrays a device view keeps, so
// a CUDA view no longer waits for the host sort; every array it writes
// equals the host build's bit for bit.
//
// Order: by row; inside a row by the key, then by edge id ascending (the
// host sort is stable, so the edge id breaks every tie).  A key is compared
// as the host compares it: NaN after every number, -0.0 equal to +0.0, a
// float key taken descending where the host sorts -key.  Key kinds: none,
// float32, int32 (ascending), float64.
//
// Bound: bytes.  rows, cols and a 4-byte key read once, nbr and eid written
// once: 20 bytes an edge, 2.47 GB at 123 718 280 edges, 0.74 ms at 3.35
// TB/s.  Three of those streams are random here: the scatter writes each
// edge id to its row's slot, and the sort reads each edge's key and column
// at its edge id, so every such 4-byte access costs a 32-byte sector.
//
// Design: three passes, and nothing of size E beyond the two outputs.
// (1) Scatter: slot = row_offsets[r] + atomicAdd(&cursor[r], 1) and
//     eid[slot] = e, with the wrapper's [N] int32 cursor of zeros.  A row's
//     slots then hold its edges in whatever order the atomics gave.
// (2) A sort of each row's slots by the item (key image, edge id): one
//     unsigned 64-bit integer for keys of up to 32 bits (the key's ordered
//     image above the id), a (64-bit image, id) pair for float64.  Items
//     are distinct, so the order is total and the result does not depend
//     on the atomics.  The sort writes eid[slot] in order and nbr[slot] =
//     cols[eid[slot]].  Tiers by row length: a warp per row, bitonic in
//     shared memory, up to kWarpCap edges (sort_warp_rows, over all rows);
//     past that a block per row sorts tiles of kTileCap in shared memory
//     into a scratch buffer and merges pairs of runs there, each item
//     finding its rank in the other run by binary search (sort_listed_rows,
//     over the rows the wrapper lists, in batches whose scratch it
//     bounds).
// (3) The wrapper lists the rows past kWarpCap from the row offsets.
//
// Measured on an H100 80GB HBM3 (PERF.md): 20.9 ms at 123 718 280 edges
// of degree about 50 (scatter 11.7, warp tier 8.5), 2.8% of the bound:
// the scatter's atomics on random rows set its pace.  That is 0.1% of the
// set-up the host sort took.  On skewed stores of the same size (power
// law, both directions): 28.2 ms with 10% of the edges in rows past
// kWarpCap (largest 39 994; listed rows 8.7-11.1 ms), 256 ms with 42%
// (largest 1 366 955, one block merging it alone: listed rows 232 ms).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpCap = 256;    // ops/kernels/csr.py WARP_ROWS
constexpr int kTileCap = 2048;  // ops/kernels/csr.py TILE_ROWS
constexpr int kWarpsPerBlock = 8;
constexpr int kBlockThreads = 1024;
constexpr int kScatterThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

enum KeyKind { kNone = 0, kF32 = 1, kI32 = 2, kF64 = 3 };

// A float64 key's item: its ordered image, then the edge id.
struct Wide {
  uint64_t key;
  uint32_t eid;
  uint32_t pad;
};

__device__ __forceinline__ bool operator<(const Wide& a, const Wide& b) {
  return a.key < b.key || (a.key == b.key && a.eid < b.eid);
}

// The ordered image of a float's bits: unsigned order equals the float
// order, NaN (of either sign) after every number, -0.0 equal to +0.0;
// descending reverses it and keeps NaN last.
__device__ __forceinline__ uint32_t f32_image(float x, bool desc) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  if ((u & 0x7fffffffu) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return desc ? ~u : u;
}

__device__ __forceinline__ uint64_t f64_image(double x, bool desc) {
  const uint64_t sign = 0x8000000000000000ull;
  uint64_t u = static_cast<uint64_t>(__double_as_longlong(x));
  if ((u & ~sign) > 0x7ff0000000000000ull) return ~0ull;
  if ((u & ~sign) == 0ull) u = 0ull;
  u = (u & sign) ? ~u : (u | sign);
  return desc ? ~u : u;
}

template <int KIND>
struct Traits {
  using Item = uint64_t;
  static __device__ __forceinline__ Item load(const void* key, int32_t e,
                                              bool desc) {
    uint32_t k = 0u;
    if constexpr (KIND == kF32) {
      k = f32_image(static_cast<const float*>(key)[e], desc);
    } else if constexpr (KIND == kI32) {
      k = static_cast<uint32_t>(static_cast<const int32_t*>(key)[e]) ^
          0x80000000u;
    }
    return (static_cast<uint64_t>(k) << 32) | static_cast<uint32_t>(e);
  }
  static __device__ __forceinline__ int32_t eid(const Item& it) {
    return static_cast<int32_t>(it & 0xffffffffull);
  }
  // past every item: a real edge id is below 2**31
  static __device__ __forceinline__ Item top() { return ~0ull; }
};

template <>
struct Traits<kF64> {
  using Item = Wide;
  static __device__ __forceinline__ Item load(const void* key, int32_t e,
                                              bool desc) {
    return Wide{f64_image(static_cast<const double*>(key)[e], desc),
                static_cast<uint32_t>(e), 0u};
  }
  static __device__ __forceinline__ int32_t eid(const Item& it) {
    return static_cast<int32_t>(it.eid);
  }
  static __device__ __forceinline__ Item top() { return Wide{~0ull, ~0u, 0u}; }
};

__device__ __forceinline__ int pow2_above(int n) {
  return n <= 2 ? 2 : 1 << (32 - __clz(n - 1));
}

// Sorts buf[0, p) ascending, p a power of two, by `nt` threads of which
// this is `tid`: a warp (WARP) or the whole block.  Each pass pairs i with
// i ^ j, one thread a pair; the sync ends every pass.
template <typename Item, bool WARP>
__device__ __forceinline__ void bitonic(Item* buf, int p, int tid, int nt) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p; i += nt) {
        const int l = i ^ j;
        if (l > i) {
          const Item a = buf[i];
          const Item b = buf[l];
          if ((i & k) == 0 ? (b < a) : (a < b)) {
            buf[i] = b;
            buf[l] = a;
          }
        }
      }
      if (WARP) {
        __syncwarp();
      } else {
        __syncthreads();
      }
    }
  }
}

__global__ void __launch_bounds__(kScatterThreads)
    scatter_rows(const int32_t* __restrict__ rows,
                 const int32_t* __restrict__ ro, int32_t* __restrict__ cursor,
                 int32_t* __restrict__ eid, long long e, long long n_rows) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < e; i += stride) {
    const int32_t r = rows[i];
    if (r < 0 || r >= n_rows) continue;
    const int32_t slot = ro[r] + atomicAdd(cursor + r, 1);
    if (slot < ro[r + 1]) eid[slot] = static_cast<int32_t>(i);
  }
}

// A warp per row of at most kWarpCap edges; longer rows are left to
// sort_listed_rows.
template <int KIND>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sort_warp_rows(const int32_t* __restrict__ ro, long long n_rows,
                   int32_t* __restrict__ eid, int32_t* __restrict__ nbr,
                   const int32_t* __restrict__ cols,
                   const void* __restrict__ key, bool desc) {
  using T = Traits<KIND>;
  using Item = typename T::Item;
  __shared__ Item buf[kWarpsPerBlock][kWarpCap];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  Item* b = buf[w];
  const long long warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + w;
       r < n_rows; r += warps) {
    const int32_t start = ro[r];
    const int n = ro[r + 1] - start;
    if (n > kWarpCap) continue;
    if (n <= 1) {
      if (n == 1 && lane == 0) nbr[start] = cols[eid[start]];
      continue;
    }
    const int p = pow2_above(n);
    for (int i = lane; i < p; i += 32) {
      b[i] = i < n ? T::load(key, eid[start + i], desc) : T::top();
    }
    __syncwarp();
    bitonic<Item, true>(b, p, lane, 32);
    for (int i = lane; i < n; i += 32) {
      const int32_t e = T::eid(b[i]);
      eid[start + i] = e;
      nbr[start + i] = cols[e];
    }
    __syncwarp();
  }
}

// A block per listed row: tiles of kTileCap edges sorted in shared memory
// into scratch_a at the row's offset (items), then pairs of runs merged
// between scratch_a and scratch_b (none for a row of one tile).  Between
// passes the block's own global writes are visible to it after
// __syncthreads, so the scratch pointers are plain (not read through the
// read-only cache).
template <int KIND>
__global__ void __launch_bounds__(kBlockThreads)
    sort_listed_rows(const int32_t* __restrict__ ro,
                     const int32_t* __restrict__ listed,
                     const long long* __restrict__ offs,
                     int32_t* __restrict__ eid, int32_t* __restrict__ nbr,
                     const int32_t* __restrict__ cols,
                     const void* __restrict__ key, bool desc,
                     typename Traits<KIND>::Item* scratch_a,
                     typename Traits<KIND>::Item* scratch_b) {
  using T = Traits<KIND>;
  using Item = typename T::Item;
  __shared__ Item buf[kTileCap];
  const int tid = threadIdx.x;
  const int32_t r = listed[blockIdx.x];
  const int32_t start = ro[r];
  const long long n = ro[r + 1] - start;
  Item* a = scratch_a + offs[blockIdx.x];
  Item* b = scratch_b + offs[blockIdx.x];
  for (long long t0 = 0; t0 < n; t0 += kTileCap) {
    const int m = static_cast<int>(n - t0 < kTileCap ? n - t0 : kTileCap);
    const int p = pow2_above(m);
    for (int i = tid; i < p; i += kBlockThreads) {
      buf[i] = i < m ? T::load(key, eid[start + t0 + i], desc) : T::top();
    }
    __syncthreads();
    bitonic<Item, false>(buf, p, tid, kBlockThreads);
    for (int i = tid; i < m; i += kBlockThreads) a[t0 + i] = buf[i];
    __syncthreads();
  }
  for (long long width = kTileCap; width < n; width <<= 1) {
    for (long long i = tid; i < n; i += kBlockThreads) {
      const Item it = a[i];
      const long long run = i / width;
      const long long base = (run & ~1ll) * width;
      long long lo, hi, pos;
      if (run & 1) {
        lo = base;
        hi = base + width;
        pos = i - hi;
      } else {
        lo = base + width < n ? base + width : n;
        hi = base + 2 * width < n ? base + 2 * width : n;
        pos = i - base;
      }
      // items of the other run below this one
      long long l = lo, h = hi;
      while (l < h) {
        const long long mid = l + ((h - l) >> 1);
        if (a[mid] < it) {
          l = mid + 1;
        } else {
          h = mid;
        }
      }
      b[base + pos + (l - lo)] = it;
    }
    __syncthreads();
    Item* t = a;
    a = b;
    b = t;
  }
  for (long long i = tid; i < n; i += kBlockThreads) {
    const int32_t e = T::eid(a[i]);
    eid[start + i] = e;
    nbr[start + i] = cols[e];
  }
}

template <int KIND>
void launch_warp_rows(const int32_t* ro, long long n_rows, int32_t* eid,
                      int32_t* nbr, const int32_t* cols, const void* key,
                      bool desc, cudaStream_t s) {
  long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sort_warp_rows<KIND><<<static_cast<unsigned>(blocks),
                         kWarpsPerBlock * 32, 0, s>>>(ro, n_rows, eid, nbr,
                                                      cols, key, desc);
}

template <int KIND>
void launch_listed_rows(const int32_t* ro, const int32_t* listed,
                        const long long* offs, long long n_listed,
                        int32_t* eid, int32_t* nbr, const int32_t* cols,
                        const void* key, bool desc, void* scratch_a,
                        void* scratch_b, cudaStream_t s) {
  using Item = typename Traits<KIND>::Item;
  sort_listed_rows<KIND><<<static_cast<unsigned>(n_listed), kBlockThreads, 0,
                           s>>>(ro, listed, offs, eid, nbr, cols, key, desc,
                                static_cast<Item*>(scratch_a),
                                static_cast<Item*>(scratch_b));
}

int item_bytes(int kind) {
  return kind == kF64 ? static_cast<int>(sizeof(Wide))
                      : static_cast<int>(sizeof(uint64_t));
}

}  // namespace

// The tiers' sizes and the bytes of one scratch item of `kind`, which the
// wrapper must agree with: 0 when they do, else -1.
extern "C" int glt_csr_check(int warp_cap, int tile_cap, int kind,
                             int bytes) {
  if (kind < kNone || kind > kF64) return -1;
  return warp_cap == kWarpCap && tile_cap == kTileCap &&
                 bytes == item_bytes(kind)
             ? 0
             : -1;
}

extern "C" int glt_csr_scatter(const void* rows, const void* ro,
                               void* cursor, void* eid, long long e,
                               long long n_rows, void* stream) {
  if (e <= 0) return 0;
  long long blocks = (e + kScatterThreads - 1) / kScatterThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  scatter_rows<<<static_cast<unsigned>(blocks), kScatterThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(ro),
      static_cast<int32_t*>(cursor), static_cast<int32_t*>(eid), e, n_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_csr_sort_rows(const void* ro, long long n_rows, void* eid,
                                 void* nbr, const void* cols, const void* key,
                                 int kind, int desc, void* stream) {
  if (n_rows <= 0) return 0;
  const int32_t* r = static_cast<const int32_t*>(ro);
  int32_t* e = static_cast<int32_t*>(eid);
  int32_t* o = static_cast<int32_t*>(nbr);
  const int32_t* c = static_cast<const int32_t*>(cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kNone: launch_warp_rows<kNone>(r, n_rows, e, o, c, key, false, s);
      break;
    case kF32: launch_warp_rows<kF32>(r, n_rows, e, o, c, key, desc, s);
      break;
    case kI32: launch_warp_rows<kI32>(r, n_rows, e, o, c, key, false, s);
      break;
    case kF64: launch_warp_rows<kF64>(r, n_rows, e, o, c, key, desc, s);
      break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int glt_csr_sort_listed(const void* ro, const void* listed,
                                   const void* offs, long long n_listed,
                                   void* eid, void* nbr, const void* cols,
                                   const void* key, int kind, int desc,
                                   void* scratch_a, void* scratch_b,
                                   void* stream) {
  if (n_listed <= 0) return 0;
  const int32_t* r = static_cast<const int32_t*>(ro);
  const int32_t* l = static_cast<const int32_t*>(listed);
  const long long* f = static_cast<const long long*>(offs);
  int32_t* e = static_cast<int32_t*>(eid);
  int32_t* o = static_cast<int32_t*>(nbr);
  const int32_t* c = static_cast<const int32_t*>(cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kNone:
      launch_listed_rows<kNone>(r, l, f, n_listed, e, o, c, key, false,
                                scratch_a, scratch_b, s);
      break;
    case kF32:
      launch_listed_rows<kF32>(r, l, f, n_listed, e, o, c, key, desc,
                               scratch_a, scratch_b, s);
      break;
    case kI32:
      launch_listed_rows<kI32>(r, l, f, n_listed, e, o, c, key, false,
                               scratch_a, scratch_b, s);
      break;
    case kF64:
      launch_listed_rows<kF64>(r, l, f, n_listed, e, o, c, key, desc,
                               scratch_a, scratch_b, s);
      break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
