// Sorted-hit group aggregation and the full-table stream sum for Hopper
// (sm_90a): the two kernels of the 62M-edge frontier harness.
//
//   sweep_aggregate:  out[g] += table[slab * R + r]  for every hit of the
//                     sorted packed hit list (packed = r | g << 12, slab
//                     from `starts`), out [G, D] f32
//   stream_sum:       out[0] = sum over rows of table, out [1, D] f32
//
// They replace the Pallas kernels of examples/sweep_aggregate.py:
// make_sweep_kernel (a sequential grid streams every R-row slab of the
// table through VMEM and scatter-accumulates the slab's hit run into a
// [G, D] output that stays resident across grid steps) and
// make_stream_kernel (the same stream with one running [1, D] sum).
//
// sweep_aggregate.  Bound: bytes.  What these inputs need is the N hit
// rows read once, the hit list and the slab starts, and [G, D] f32 written
// once: at the harness shape (N = 153 600 hits into a [2 457 600, 128] f32
// table, G = 15 360) 78.6 MB + 0.6 MB in and 7.9 MB out; at the 62M-edge
// table ([2 450 000, 100] bf16) 30.7 MB + 0.6 MB in and 6.1 MB out; not
// the table.  Blocks run in no order and [G, D] fits no shared memory, so
// nothing is carried between blocks and nobody streams slabs that were not
// hit: rows are added into out with red.global.add (four floats an
// instruction where D allows; out stays in L2) and the sums of a group
// arrive in an order that changes from run to run.  Hits that point
// outside the table or the groups are skipped.
//
// Design (the second one).  A warp takes 32 consecutive hits of the sorted
// list.  The slab of the first comes from one search by the whole warp (32
// probes a step, two steps for 600 slabs); every later hit's slab from a
// window of the next 32 slab starts, one a lane, searched by shuffles in
// five steps.  Then the lanes stride over the chunk's (hit, column vector)
// pairs, so that at D = 100 bf16 (25 eight-byte vectors a row) no lane
// idles, and keep four row loads in flight a lane before the four adds.
// The grid is the blocks the card holds at once (occupancy x SMs), each
// warp striding over the chunks.  The zero fill of out is a
// cudaMemsetAsync on the stream inside the C entry: the wrapper allocates
// with torch.empty.  The first design gave each hit a lane group that
// bisected `starts` itself (about ten dependent loads per hit, repeated by
// every lane of the group) before it could load the packed word and then
// the row, behind a torch.zeros fill kernel.
//
// Tried and dropped (PERF.md gives their times on an H100): eight or
// sixteen row loads in flight a lane (more registers, fewer resident
// warps: 5-59% slower at both shapes); one
// cooperative kernel that zeroes out, crosses a grid barrier and sums
// (1-4% slower than the memset and the kernel).  With the rows handed in
// (no slab search at all) the first design's kernel runs 4-8% faster than
// this one, and plain stores in place of the reductions save 4-8% more:
// what is left is the random row reads.
//
// stream_sum.  Bound: bytes, the whole table read once (1.26 GB at the
// harness shape).  Design: a block is a tile of rows x column vectors, its
// threads in row-major order, so a warp reads consecutive 16-byte vectors
// of consecutive rows whatever D is; each thread keeps the f32 sums of its
// VEC columns over a grid-stride loop of rows, the block adds its rows'
// partial sums in shared memory and then adds one value per column into
// out with atomicAdd (the pass across blocks; out starts at 0).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#if defined(__CUDACC_VER_MAJOR__) &&   \
    (__CUDACC_VER_MAJOR__ > 12 ||      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define GLT_VECTOR_ATOMICS 1  // atomicAdd(float2*/float4*), sm_90, CUDA 12.1
#else
#define GLT_VECTOR_ATOMICS 0
#endif

namespace {

constexpr int kBlock = 256;
constexpr int kUnroll = 4;  // row loads in flight a lane (sweep_aggregate)

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// p[0..VEC) += f[0..VEC) in global memory, result unused (a reduction).
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float (&f)[VEC]) {
  if constexpr (GLT_VECTOR_ATOMICS && VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + j),
                make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]));
    }
  } else if constexpr (GLT_VECTOR_ATOMICS && VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(f[0], f[1]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) atomicAdd(p + j, f[j]);
  }
}

struct SweepArgs {
  const int32_t* starts;
  const int32_t* packed;
  const void* table;
  float* out;
  int64_t n_hits, n_rows, n_groups, d, nvec;
  int n_slabs, slab_log2;
};

constexpr unsigned kFull = 0xffffffffu;

// The slab of hit h0: the largest s in [0, n_slabs) with starts[s] <= h0,
// found by the whole warp, 32 probes a step (two steps for 600 slabs).
__device__ __forceinline__ int first_slab(const int32_t* __restrict__ starts,
                                          int n_slabs, int64_t h0,
                                          int lane) {
  int lo = 0, hi = n_slabs;  // starts[lo] <= h0 < starts[hi] (or hi = end)
  while (hi - lo > 1) {
    const int span = hi - lo;
    const int p = span <= 32
                      ? lo + lane
                      : lo + static_cast<int>((int64_t{lane} * span) >> 5);
    const bool le = p < hi && static_cast<int64_t>(__ldg(starts + p)) <= h0;
    int k = __popc(__ballot_sync(kFull, le));  // the probes <= h0: a prefix
    k = k > 0 ? k : 1;  // starts[lo] <= h0 holds for a valid hit list
    if (span <= 32) {
      lo += k - 1;
      hi = lo + 1;
    } else {
      const int next_lo = lo + static_cast<int>((int64_t{k - 1} * span) >> 5);
      if (k < 32) hi = lo + static_cast<int>((int64_t{k} * span) >> 5);
      lo = next_lo;
    }
  }
  return lo;
}

// A warp takes 32 consecutive hits of the sorted list at a time (a grid of
// the card's resident blocks strides over these chunks).  Phase A, one hit
// a lane: its packed word (one coalesced load), its slab from the chunk's
// first slab and a window of the next 32 slab starts held one a lane (a
// five-step search over the window by shuffles; a chunk that spans more
// than 32 slabs moves the window on).  Phase B: the lanes stride over the
// chunk's (hit, column vector) pairs, kUnroll pairs a lane at a time:
// kUnroll row loads in flight, then kUnroll vector reductions into out.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBlock)
    sweep_aggregate_kernel(const SweepArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kBlock +
                        threadIdx.x) >> 5;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (kBlock / 32);
  const T* table = static_cast<const T*>(a.table);
  const int rmask = (1 << a.slab_log2) - 1;
  // pair p = it * 32 + lane of a chunk: hit p / nv, vector p % nv
  const int nv = static_cast<int>(a.nvec);
  const int hit_step = 32 / nv, vec_step = 32 % nv;
  const int64_t n_chunks = (a.n_hits + 31) >> 5;
  for (int64_t chunk = warp; chunk < n_chunks; chunk += n_warps) {
    const int64_t h0 = chunk << 5;
    const int64_t h = h0 + lane;
    const bool live = h < a.n_hits;
    const int32_t word = live ? __ldg(a.packed + h) : 0;
    int base = first_slab(a.starts, a.n_slabs, h0, lane);
    int slab = -1;
    bool todo = live;
    while (__any_sync(kFull, todo)) {
      const int j = base + 1 + lane;
      const int64_t w = j <= a.n_slabs ? __ldg(a.starts + j) : INT64_MAX;
      int c = 0;  // entries of the window <= h (sorted one a lane)
#pragma unroll
      for (int s = 16; s >= 1; s >>= 1) {
        if (__shfl_sync(kFull, w, c + s - 1) <= h) c += s;
      }
      if (__shfl_sync(kFull, w, 31) <= h) c = 32;
      if (todo && c < 32) {
        slab = base + c;
        todo = false;
      }
      base += 32;
    }
    const int64_t group = word >> 12;
    if (slab < 0 ||
        (static_cast<int64_t>(slab) << a.slab_log2) + (word & rmask) >=
            a.n_rows ||
        group < 0 || group >= a.n_groups) {
      slab = -1;  // outside the table or the groups: skipped
    }
    int hit = lane / nv, v = lane - hit * nv;
    for (int it0 = 0; it0 < nv; it0 += kUnroll) {
      Vec<T, VEC> x[kUnroll];
      int64_t dst[kUnroll];  // float offset into out, -1: nothing to add
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int hs = __shfl_sync(kFull, slab, hit & 31);
        const int hw = __shfl_sync(kFull, word, hit & 31);
        dst[u] = -1;
        if (it0 + u < nv && hs >= 0) {
          const int64_t row = (static_cast<int64_t>(hs) << a.slab_log2) +
                              (hw & rmask);
          x[u] = *reinterpret_cast<const Vec<T, VEC>*>(table + row * a.d +
                                                       v * VEC);
          dst[u] = (hw >> 12) * a.d + v * VEC;
        }
        hit += hit_step;
        v += vec_step;
        if (v >= nv) {
          v -= nv;
          ++hit;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (dst[u] >= 0) {
          float f[VEC];
#pragma unroll
          for (int e = 0; e < VEC; ++e) f[e] = to_f32(x[u].v[e]);
          red_add<VEC>(a.out + dst[u], f);
        }
      }
    }
  }
}

// Block tile: `cpb` column vectors x `rpb` rows, cpb * rpb <= kBlock.
// blockIdx.y picks the chunk of column vectors (one chunk unless a row has
// more than kBlock vectors), blockIdx.x strides over row tiles.
template <typename T, int VEC>
__global__ void stream_sum_kernel(const T* __restrict__ table,
                                  float* __restrict__ out, int64_t n_rows,
                                  int64_t d, int cpb, int rpb) {
  __shared__ float part[kBlock * VEC];
  const int tid = threadIdx.x;
  const int r = tid / cpb;
  const int c = tid - r * cpb;
  const int64_t cv = static_cast<int64_t>(blockIdx.y) * cpb + c;
  const bool live = r < rpb && cv * VEC < d;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  if (live) {
    const int64_t step = static_cast<int64_t>(gridDim.x) * rpb;
    const T* col = table + cv * VEC;
#pragma unroll 4
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * rpb + r;
         row < n_rows; row += step) {
      const Vec<T, VEC> x =
          *reinterpret_cast<const Vec<T, VEC>*>(col + row * d);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += to_f32(x.v[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) part[tid * VEC + j] = acc[j];
  __syncthreads();
  if (live && r == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float s = 0.f;
      for (int rr = 0; rr < rpb; ++rr) s += part[(rr * cpb + c) * VEC + j];
      atomicAdd(out + cv * VEC + j, s);
    }
  }
}

template <typename T, int VEC>
void launch_stream(const void* table, void* out, int64_t n_rows, int64_t d,
                   int n_sms, cudaStream_t stream) {
  const int64_t nvec = d / VEC;
  const int cpb = static_cast<int>(nvec < kBlock ? nvec : kBlock);
  const int rpb = kBlock / cpb;
  const int64_t col_chunks = (nvec + cpb - 1) / cpb;
  const int64_t row_tiles = (n_rows + rpb - 1) / rpb;
  // enough blocks to fill every SM eight times over, no more than tiles
  int64_t gx = static_cast<int64_t>(n_sms) * 8 / col_chunks;
  if (gx < 1) gx = 1;
  if (gx > row_tiles) gx = row_tiles;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(col_chunks));
  stream_sum_kernel<T, VEC><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(table), static_cast<float*>(out), n_rows, d, cpb,
      rpb);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Widest vector (in elements) that divides D and keeps the table loads
// (<= 16 bytes) and the f32 adds into `out` (<= 16 bytes) aligned.
int pick_vec(const void* table, const void* out, int64_t d, int in_size) {
  for (int vec = 16 / in_size; vec > 1; vec >>= 1) {
    const int out_bytes = (vec < 4 ? vec : 4) * 4;
    if (d % vec == 0 && aligned(table, vec * in_size) &&
        aligned(out, out_bytes)) {
      return vec;
    }
  }
  return 1;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      n <= 0) {
    n = 132;
  }
  return n;
}

template <typename T, int VEC>
int launch_sweep(const SweepArgs& a, int n_sms, cudaStream_t stream) {
  // a grid of the blocks the card holds at once, no more than the chunks
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sweep_aggregate_kernel<T, VEC>, kBlock, 0);
    return n;
  }();
  const int64_t n_chunks = (a.n_hits + 31) >> 5;
  int64_t blocks = (n_chunks + kBlock / 32 - 1) / (kBlock / 32);
  const int64_t resident = static_cast<int64_t>(n_sms) * per_sm;
  if (resident > 0 && blocks > resident) blocks = resident;
  sweep_aggregate_kernel<T, VEC>
      <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// starts [n_slabs + 1] int32, packed [n_hits] int32 (row in slab | group <<
// 12, sorted by table row), table [n_rows, d] (dtype code 0 = f32, 1 =
// bf16), out [n_groups, d] f32, zeroed here by a cudaMemsetAsync on the
// stream before the kernel (the kernel is launched only for n_hits > 0 and
// n_slabs > 0).  slab_rows is a power of two <= 4096.  Returns the CUDA
// error of the memset or the launch (0 on success), -1 for a bad dtype
// code or slab size.
extern "C" int glt_sweep_aggregate(const void* starts, const void* packed,
                                   const void* table, void* out,
                                   long long n_hits, long long n_slabs,
                                   int slab_rows, long long n_rows,
                                   long long n_groups, long long d, int dtype,
                                   void* stream) {
  if (dtype < 0 || dtype > 1 || slab_rows <= 0 || slab_rows > 4096 ||
      (slab_rows & (slab_rows - 1)) != 0) {
    return -1;
  }
  if (n_groups <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_groups * d) * sizeof(float), s);
  if (e != cudaSuccess || n_hits <= 0 || n_slabs <= 0) {
    return static_cast<int>(e);
  }
  int slab_log2 = 0;
  while ((1 << slab_log2) < slab_rows) ++slab_log2;
  const int vec = pick_vec(table, out, d, dtype == 0 ? 4 : 2);
  const SweepArgs a{static_cast<const int32_t*>(starts),
                    static_cast<const int32_t*>(packed), table,
                    static_cast<float*>(out), n_hits, n_rows, n_groups, d,
                    d / vec, static_cast<int>(n_slabs), slab_log2};
  const int n_sms = sm_count();
#define GLT_SWEEP(T, V)                                               \
  return launch_sweep<T, V>(a, n_sms, s)
  if (dtype == 0) {
    switch (vec) {
      case 4: GLT_SWEEP(float, 4);
      case 2: GLT_SWEEP(float, 2);
      default: GLT_SWEEP(float, 1);
    }
  }
  switch (vec) {
    case 8: GLT_SWEEP(__nv_bfloat16, 8);
    case 4: GLT_SWEEP(__nv_bfloat16, 4);
    case 2: GLT_SWEEP(__nv_bfloat16, 2);
    default: GLT_SWEEP(__nv_bfloat16, 1);
  }
#undef GLT_SWEEP
}

// table [n_rows, d] (dtype code as above), out [1, d] f32, already zero.
// Returns cudaGetLastError() after the launch (0 on success, -1 for a bad
// dtype code).
extern "C" int glt_stream_sum(const void* table, void* out, long long n_rows,
                              long long d, int dtype, void* stream) {
  if (dtype < 0 || dtype > 1) return -1;
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_sms = sm_count();
#define GLT_STREAM(T, V) launch_stream<T, V>(table, out, n_rows, d, n_sms, s)
  if (dtype == 0) {
    switch (pick_vec(table, out, d, 4)) {
      case 4: GLT_STREAM(float, 4); break;
      case 2: GLT_STREAM(float, 2); break;
      default: GLT_STREAM(float, 1); break;
    }
  } else {
    switch (pick_vec(table, out, d, 2)) {
      case 8: GLT_STREAM(__nv_bfloat16, 8); break;
      case 4: GLT_STREAM(__nv_bfloat16, 4); break;
      case 2: GLT_STREAM(__nv_bfloat16, 2); break;
      default: GLT_STREAM(__nv_bfloat16, 1); break;
    }
  }
#undef GLT_STREAM
  return static_cast<int>(cudaGetLastError());
}
