// Segment SpMM for Hopper (sm_90a):
//   out[i] = reduce_{c < deg[i]} feats[ids[i, c]]   (sum | mean | max | min)
//
// Replaces the Pallas kernel graph_learn_tpu/ops/pallas/spmm.py
// segment_spmm (_spmm_kernel), which runs one grid step per output row and
// double-buffers the neighbour-row DMAs into an f32 VMEM accumulator.  Same
// semantics: accumulation in f32, mean divides by max(deg, 1), an empty
// max/min row (and any non-finite max/min) is written as 0, ids are clipped
// into [0, N - 1] and degrees into [0, cap] as
// graph_learn_tpu/ops/aggregate.py:107-113 clips them before the Pallas
// call.  Run with deg == k it is the deepest-hop group mean
// (ops/aggregate.py gather_group_agg).
//
// Bound: bytes.  It reads sum(deg) feature rows at random rows of the
// table, plus the ids and degrees, and writes [b, D] once: at the serving
// and training paths' deepest hop ([15 360, 10] ids into a [200 000, 128]
// bf16 table, f32 out) 39.3 MB in and 7.9 MB out; at the 62M-edge table
// ([2 450 000, 100] bf16) 30.7 MB in and 6.1 MB out; as the harness bar
// ([2 457 600, 128] f32) 78.6 MB in and 7.9 MB out.  The [b * cap, D]
// gathered rows are never written.  Its sum(deg) * D adds are far below the
// card's f32 rate.
//
// Design: a group of `tpr` lanes owns one output row (tpr = the power of
// two that covers the row's vectors, at most a warp).  Each lane holds the
// f32 accumulators of VEC adjacent columns, reads id c, clips it, loads its
// columns of row c as one vector of up to 16 bytes (four neighbours
// unrolled), and writes its slice of the result once.  The grid is the
// blocks the card holds at once, each group stepping over rows.  The
// kernel clips ids into [0, N - 1] and degrees into [0, cap] as it reads
// them (two 32-bit min/max an id), so one call is one launch and one
// allocation, the output: the wrapper's two clamp kernels took about a
// quarter of the call at the serving shape.  The arguments travel as one
// struct and the clip is 32-bit, so the kernel keeps the registers (and
// the resident warps) of one that clips nothing: the random row reads in
// flight set its pace.  The grid of resident blocks beats one row group a
// thread by 5-6% at the 200k and 62M tables.
//
// Tried on an H100 and dropped (PERF.md gives their times, against this
// design on a flat grid): a row's ids loaded once by its lane group and
// passed on by shuffles, 4 to 16 of its rows in flight before the adds (6%
// slower at best, 3.3x at worst); one thread per (output row, column
// vector) pair, so that no lane idles at D = 100 bf16, 25 eight-byte
// vectors for 32 lanes (3% slower at best, 3.8x at worst).  More rows in flight a thread cost registers, and the
// random row reads came no faster.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Agg { kSum = 0, kMean = 1, kMax = 2, kMin = 3 };
constexpr int kBlock = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename O>
__device__ __forceinline__ O from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct SpmmArgs {
  const void* feats;
  const int32_t* ids;
  const int32_t* deg;
  void* out;
  int64_t b, d;
  int cap, last, tpr_log2, agg;  // last: the last row of the table, or -1
};

// Output row `row`, reduced by the lane `lane` of its group: each lane
// holds the f32 accumulators of VEC adjacent columns (stepping by the
// group's width over the row's vectors), reads each neighbour id and clips
// it, loads its columns of that row as one vector (four neighbours
// unrolled) and writes its slice of the result once.
template <typename T, typename O, int VEC>
__device__ __forceinline__ void reduce_row(const SpmmArgs& a, int64_t row,
                                           int64_t lane) {
  const T* __restrict__ feats = static_cast<const T*>(a.feats);
  const int raw = a.deg[row];
  const int n = a.last < 0 ? 0 : (raw < 0 ? 0 : (raw > a.cap ? a.cap : raw));
  const int32_t* __restrict__ rid = a.ids + row * a.cap;
  const int64_t nvec = a.d / VEC;
  const int agg = a.agg;
  const float init = agg == kMax ? -INFINITY : (agg == kMin ? INFINITY : 0.f);
  for (int64_t v = lane; v < nvec; v += (int64_t{1} << a.tpr_log2)) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = init;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const int id = rid[c];
      const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(
          feats + static_cast<int64_t>(id < 0 ? 0 : (id > a.last ? a.last : id))
                      * a.d + v * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(x.v[j]);
        if (agg <= kMean) {
          acc[j] += f;
        } else if (agg == kMax) {
          acc[j] = (f != f || f > acc[j]) ? f : acc[j];  // NaN propagates
        } else {
          acc[j] = (f != f || f < acc[j]) ? f : acc[j];
        }
      }
    }
    Vec<O, VEC> y;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float r = acc[j];
      if (agg == kMean) r = r / static_cast<float>(n > 1 ? n : 1);
      if (agg >= kMax && !(fabsf(r) < INFINITY)) r = 0.f;  // also NaN
      y.v[j] = from_f32<O>(r);
    }
    *reinterpret_cast<Vec<O, VEC>*>(static_cast<O*>(a.out) + row * a.d +
                                    v * VEC) = y;
  }
}

// A group of `tpr` lanes owns one output row (tpr: the power of two that
// covers the row's vectors, at most a warp); the grid is the blocks the
// card holds at once, and each group steps over rows by the grid's size.
template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kBlock)
    segment_spmm_kernel(const SpmmArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const int64_t lane = t & ((1 << a.tpr_log2) - 1);
  const int64_t step = (static_cast<int64_t>(gridDim.x) * kBlock) >>
                       a.tpr_log2;
  for (int64_t row = t >> a.tpr_log2; row < a.b; row += step) {
    reduce_row<T, O, VEC>(a, row, lane);
  }
}

template <typename T, typename O, int VEC>
void launch(SpmmArgs a, cudaStream_t stream) {
  // the blocks the card holds at once (queried once per instantiation)
  static const int64_t resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_spmm_kernel<T, O, VEC>, kBlock, 0);
    return static_cast<int64_t>(sms) * per_sm;
  }();
  const int64_t nvec = a.d / VEC;
  a.tpr_log2 = 0;
  while (a.tpr_log2 < 5 && (int64_t{1} << a.tpr_log2) < nvec) ++a.tpr_log2;
  int64_t blocks = ((a.b << a.tpr_log2) + kBlock - 1) / kBlock;
  if (resident > 0 && resident < blocks) blocks = resident;
  segment_spmm_kernel<T, O, VEC>
      <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(a);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Widest vector (in elements) that divides D and keeps both the input
// loads (<= 16 bytes) and the output stores aligned: 8-byte loads at
// D = 100 bf16, whose 200-byte rows are 8-byte aligned only.
int pick_vec(const void* feats, const void* out, int64_t d, int in_size,
             int out_size) {
  for (int vec = 16 / in_size; vec > 1; vec >>= 1) {
    if (d % vec == 0 && aligned(feats, vec * in_size) &&
        aligned(out, vec * out_size)) {
      return vec;
    }
  }
  return 1;
}

template <typename T, typename O>
void dispatch_vec(const SpmmArgs& a, cudaStream_t s) {
  switch (pick_vec(a.feats, a.out, a.d, sizeof(T), sizeof(O))) {
    case 8:
      if constexpr (sizeof(T) == 2) launch<T, O, 8>(a, s);
      break;
    case 4: launch<T, O, 4>(a, s); break;
    case 2: launch<T, O, 2>(a, s); break;
    default: launch<T, O, 1>(a, s); break;
  }
}

}  // namespace

// feats [n_rows, d] (dtype code 0 = f32, 1 = bf16), ids [b, cap] int32 and
// deg [b] int32 as the caller has them (clipped here), out [b, d] (dtype
// code as for feats), agg 0..3 = sum/mean/max/min.  Returns
// cudaGetLastError() after the launch (0 on success, -1 for an unknown
// dtype or agg code).
extern "C" int glt_segment_spmm(const void* feats, const void* ids,
                                const void* deg, void* out, long long b,
                                int cap, long long d, long long n_rows,
                                int in_dtype, int out_dtype, int agg,
                                void* stream) {
  if (agg < kSum || agg > kMin || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1) {
    return -1;
  }
  if (b <= 0 || d <= 0) return 0;
  // ids are int32: no clipped id lies past INT32_MAX, whatever the table
  const int last = n_rows <= 0 ? -1
                               : static_cast<int>(n_rows - 1 < INT32_MAX
                                                      ? n_rows - 1
                                                      : INT32_MAX);
  const SpmmArgs a{feats, static_cast<const int32_t*>(ids),
                   static_cast<const int32_t*>(deg), out, b, d, cap, last, 0,
                   agg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    if (out_dtype == 0) {
      dispatch_vec<float, float>(a, s);
    } else {
      dispatch_vec<float, __nv_bfloat16>(a, s);
    }
  } else if (out_dtype == 0) {
    dispatch_vec<__nv_bfloat16, float>(a, s);
  } else {
    dispatch_vec<__nv_bfloat16, __nv_bfloat16>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}
