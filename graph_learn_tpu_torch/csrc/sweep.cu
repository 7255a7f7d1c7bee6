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
// table, G = 15 360) 78.6 MB + 0.6 MB in and 7.9 MB out, not the 1.26 GB
// table.  Design: blocks run in no order and [G, D] fits no shared memory,
// so nothing is carried between blocks and nobody streams slabs that were
// not hit.  A group of `tpr` lanes owns one hit of the sorted list (fixed
// chunks of the list per block, which balances whatever the slabs hold),
// finds the hit's slab by bisection over `starts` (n_slabs + 1 entries,
// cache resident), loads its columns of the row as one vector of up to 16
// bytes, widens to f32 and adds into out[g] with red.global.add (four
// floats per instruction where D allows).  [G, D] stays in L2 (7.9 MB of
// 50 MB).  The sums of a group arrive in an order that changes from run to
// run.  Hits that point outside the table or the groups are skipped.
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

template <typename T, int VEC>
__global__ void sweep_aggregate_kernel(const int32_t* __restrict__ starts,
                                       const int32_t* __restrict__ packed,
                                       const T* __restrict__ table,
                                       float* __restrict__ out,
                                       int64_t n_hits, int n_slabs,
                                       int slab_rows, int64_t n_rows,
                                       int64_t n_groups, int64_t d,
                                       int tpr_log2) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t hit = t >> tpr_log2;
  if (hit >= n_hits) return;
  const int64_t lane = t & ((1 << tpr_log2) - 1);
  // the slab s with starts[s] <= hit < starts[s + 1]
  int lo = 0, hi = n_slabs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(starts[mid]) <= hit) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int32_t word = packed[hit];
  const int64_t row = static_cast<int64_t>(lo) * slab_rows +
                      (word & (slab_rows - 1));
  const int64_t group = word >> 12;
  if (row >= n_rows || group < 0 || group >= n_groups) return;
  const T* src = table + row * d;
  float* dst = out + group * d;
  const int64_t nvec = d / VEC;
  for (int64_t v = lane; v < nvec; v += (int64_t{1} << tpr_log2)) {
    const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(src + v * VEC);
    float f[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f32(x.v[j]);
    red_add<VEC>(dst + v * VEC, f);
  }
}

template <typename T, int VEC>
void launch_sweep(const void* starts, const void* packed, const void* table,
                  void* out, int64_t n_hits, int n_slabs, int slab_rows,
                  int64_t n_rows, int64_t n_groups, int64_t d,
                  cudaStream_t stream) {
  const int64_t nvec = d / VEC;
  int tpr_log2 = 0;
  while (tpr_log2 < 5 && (int64_t{1} << tpr_log2) < nvec) ++tpr_log2;
  const int64_t grid = ((n_hits << tpr_log2) + kBlock - 1) / kBlock;
  sweep_aggregate_kernel<T, VEC>
      <<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
          static_cast<const int32_t*>(starts),
          static_cast<const int32_t*>(packed), static_cast<const T*>(table),
          static_cast<float*>(out), n_hits, n_slabs, slab_rows, n_rows,
          n_groups, d, tpr_log2);
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

}  // namespace

// starts [n_slabs + 1] int32, packed [n_hits] int32 (row in slab | group <<
// 12, sorted by table row), table [n_rows, d] (dtype code 0 = f32, 1 =
// bf16), out [n_groups, d] f32, already zero.  slab_rows is a power of two
// <= 4096.  Returns cudaGetLastError() after the launch (0 on success, -1
// for a bad dtype code or slab size).
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
  if (n_hits <= 0 || d <= 0 || n_slabs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ns = static_cast<int>(n_slabs);
#define GLT_SWEEP(T, V)                                                     \
  launch_sweep<T, V>(starts, packed, table, out, n_hits, ns, slab_rows,     \
                     n_rows, n_groups, d, s)
  if (dtype == 0) {
    switch (pick_vec(table, out, d, 4)) {
      case 4: GLT_SWEEP(float, 4); break;
      case 2: GLT_SWEEP(float, 2); break;
      default: GLT_SWEEP(float, 1); break;
    }
  } else {
    switch (pick_vec(table, out, d, 2)) {
      case 8: GLT_SWEEP(__nv_bfloat16, 8); break;
      case 4: GLT_SWEEP(__nv_bfloat16, 4); break;
      case 2: GLT_SWEEP(__nv_bfloat16, 2); break;
      default: GLT_SWEEP(__nv_bfloat16, 1); break;
    }
  }
#undef GLT_SWEEP
  return static_cast<int>(cudaGetLastError());
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
