// Segment SpMM for Hopper (sm_90a):
//   out[i] = reduce_{c < deg[i]} feats[ids[i, c]]   (sum | mean | max | min)
//
// Replaces the Pallas kernel graph_learn_tpu/ops/pallas/spmm.py
// segment_spmm (_spmm_kernel), which runs one grid step per output row and
// double-buffers the neighbour-row DMAs into an f32 VMEM accumulator.  Same
// semantics: accumulation in f32, mean divides by max(deg, 1), an empty
// max/min row (and any non-finite max/min) is written as 0.  Run with
// deg == k it is the serving path's deepest-hop group mean
// (ops/aggregate.py gather_group_agg).
//
// Bound: bytes.  It reads sum(deg) feature rows at random rows of the
// table, plus the ids and degrees, and writes [b, D] once: at the serving
// path's deepest hop ([15 360, 10] ids into a [200 000, 128] bf16 table,
// f32 out) about 39.3 MB in and 7.9 MB out.  The [b * cap, D] gathered
// rows are never written to memory.  Its sum(deg) * D adds are far below
// the card's f32 rate.
//
// Design: a group of `tpr` lanes owns one output row (tpr = the power of
// two that covers the row's vectors, at most a warp).  Each lane holds the
// f32 accumulators of VEC adjacent columns, loads them from every
// neighbour row as one vector of up to 16 bytes, and writes its slice of
// the result once.  The ids and degrees must already lie in range: the
// wrapper (ops/kernels/spmm.py) clips them; there are no bounds checks.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Agg { kSum = 0, kMean = 1, kMax = 2, kMin = 3 };

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

template <typename T, typename O, int VEC>
__global__ void segment_spmm_kernel(const T* __restrict__ feats,
                                    const int32_t* __restrict__ ids,
                                    const int32_t* __restrict__ deg,
                                    O* __restrict__ out, int64_t b, int cap,
                                    int64_t d, int tpr_log2, int agg) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t row = t >> tpr_log2;
  if (row >= b) return;
  const int64_t lane = t & ((1 << tpr_log2) - 1);
  const int n = deg[row];
  const int32_t* rid = ids + row * cap;
  const int64_t nvec = d / VEC;
  const float init = agg == kMax ? -INFINITY : (agg == kMin ? INFINITY : 0.f);
  for (int64_t v = lane; v < nvec; v += (int64_t{1} << tpr_log2)) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = init;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const Vec<T, VEC> x = *reinterpret_cast<const Vec<T, VEC>*>(
          feats + static_cast<int64_t>(rid[c]) * d + v * VEC);
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
    *reinterpret_cast<Vec<O, VEC>*>(out + row * d + v * VEC) = y;
  }
}

template <typename T, typename O, int VEC>
void launch(const void* feats, const void* ids, const void* deg, void* out,
            int64_t b, int cap, int64_t d, int agg, cudaStream_t stream) {
  const int64_t nvec = d / VEC;
  int tpr_log2 = 0;
  while (tpr_log2 < 5 && (int64_t{1} << tpr_log2) < nvec) ++tpr_log2;
  const int block = 256;
  const int64_t grid = ((b << tpr_log2) + block - 1) / block;
  segment_spmm_kernel<T, O, VEC>
      <<<static_cast<unsigned>(grid), block, 0, stream>>>(
          static_cast<const T*>(feats), static_cast<const int32_t*>(ids),
          static_cast<const int32_t*>(deg), static_cast<O*>(out), b, cap, d,
          tpr_log2, agg);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Widest vector (in elements) that divides D and keeps both the input
// loads (<= 16 bytes) and the output stores aligned.
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
void dispatch_vec(const void* feats, const void* ids, const void* deg,
                  void* out, int64_t b, int cap, int64_t d, int agg,
                  cudaStream_t s) {
  switch (pick_vec(feats, out, d, sizeof(T), sizeof(O))) {
    case 8: launch<T, O, 8>(feats, ids, deg, out, b, cap, d, agg, s); break;
    case 4: launch<T, O, 4>(feats, ids, deg, out, b, cap, d, agg, s); break;
    case 2: launch<T, O, 2>(feats, ids, deg, out, b, cap, d, agg, s); break;
    default: launch<T, O, 1>(feats, ids, deg, out, b, cap, d, agg, s); break;
  }
}

}  // namespace

// feats [N, d] (dtype code 0 = f32, 1 = bf16), ids [b, cap] int32, deg [b]
// int32, out [b, d] (dtype code as for feats), agg 0..3 = sum/mean/max/min.
// Returns cudaGetLastError() after the launch (0 on success, -1 for an
// unknown dtype or agg code).
extern "C" int glt_segment_spmm(const void* feats, const void* ids,
                                const void* deg, void* out, long long b,
                                int cap, long long d, int in_dtype,
                                int out_dtype, int agg, void* stream) {
  if (agg < kSum || agg > kMin || in_dtype < 0 || in_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1) {
    return -1;
  }
  if (b <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    dispatch_vec<float, float>(feats, ids, deg, out, b, cap, d, agg, s);
  } else if (in_dtype == 0) {
    dispatch_vec<float, __nv_bfloat16>(feats, ids, deg, out, b, cap, d, agg,
                                       s);
  } else if (out_dtype == 0) {
    dispatch_vec<__nv_bfloat16, float>(feats, ids, deg, out, b, cap, d, agg,
                                       s);
  } else {
    dispatch_vec<__nv_bfloat16, __nv_bfloat16>(feats, ids, deg, out, b, cap,
                                               d, agg, s);
  }
  return static_cast<int>(cudaGetLastError());
}
