// Fused GAT neighbour block for Hopper (sm_90a), forward and backward.
//
//   nh     = nbr . wn[h] (+ bn[h])                     [b * e, W] per head
//   logits = leaky_relu(el[h, s] + nh . ar[h] (+ ba[h]), 0.2)
//   coef   = softmax_j(logits) (* drop)
//   out    = sum_j coef[j] * nh[j]                     [H, b, W]
//
// Replaces the Pallas kernel examples/segment_softmax_probe.py make_pallas,
// which keeps one (seed block, head) projection Wx = X . W_h in VMEM,
// scores and soft-maxes it there and writes only the weighted sum.  The
// function here is EgoGATConv's `block` (graph_learn_tpu/nn/layers/ego.py):
// the self term `el` is an input (the probe takes it from each group's
// first row), and bias and attention dropout are optional.
//
// Bound: operations.  Taken literally the block is one [b*e, Din] x
// [Din, H*W] product (8.05e10 f32 operations at b*e = 153 600, Din = 128,
// H*W = 2048), and nh would be 1.26 GB if it were written.  Both of nh's
// uses are linear in it, so this file never forms it:
//
//   nh[j] . ar       = [nbr[j], 1] . v,    v = [wn; bn] . ar      (K' values)
//   sum_j q[j] nh[j] = (sum_j q[j] [nbr[j], 1]) . [wn; bn] = a . [wn; bn]
//
// with K' = Din + 1 when there is a bias (the 1 carries bn), else Din, and
// q = coef * drop.  The logits need one K'-long dot per neighbour row and
// head, and the matrix product runs on b rows per head instead of b * e:
// 2 * H * b * K' * W operations (8.1e9 at the shape above).  The inputs are
// read once from device memory; `a` [H, b, K'] is the only intermediate
// that leaves the chip (1/16 of nh's size at that shape).
//
// Design.  Forward: (1) prep: v = [wn; bn] . ar; (2) attention: one warp
// per seed, all heads: logits, softmax, q, then a = sum_j q[j] [nbr[j], 1]
// (a lane keeps eight heads' accumulators in registers, so each element of
// a neighbour row is read once per pass, not once per head);
// (3) a 64x64-tile f32 FMA matrix product out[h] = a[h] . [wn; bn][h].
// Backward recomputes v, the softmax and a from the inputs (nothing but the
// inputs is saved), then
//   d_a   = g . [wn; bn]^T                     (same tile product, B read
//                                               transposed)
//   d_wn' = a^T . g                            (same tile product, A read
//                                               transposed, split over b,
//                                               f32 atomicAdd of partials)
//   d_q[j] = [nbr[j], 1] . d_a;  softmax and leaky-relu backward -> d_z
//   d_el  = sum_j d_z;  d_v = sum_{s, j} d_z [nbr[j], 1]   (block partials
//                                               in shared memory, then
//                                               atomicAdd)
//   d_nbr[j] = sum_h q[h, j] d_a[h] + d_z[h, j] v[h]       (one warp owns a
//                                               seed's rows for every head:
//                                               no atomics)
//   d_ar  = [wn; bn]^T . d_v;  d_wn' += d_v (x) ar
// d_bn is the last row of d_wn'.  Sums across blocks (d_wn', d_v) use f32
// atomicAdd, so their order, and the last bits of those gradients, vary
// from run to run.  Any b, e, Din, H, W: edges are masked, nothing is
// padded.  The per-warp softmax scratch (4 * H * e floats) and the block's
// d_v partial (H * K' floats) live in dynamic shared memory; the launcher
// lowers the warps per block until they fit and returns -2 if one warp's
// scratch does not.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kSlope = 0.2f;
constexpr int kTile = 64;   // output tile of the matrix product (rows, cols)
constexpr int kTileK = 16;  // depth of one shared-memory stage
constexpr int kMaxSmem = 200 * 1024;
// heads whose accumulators a lane keeps in registers at once, so that an
// element of a neighbour row is read once for all of them
constexpr int kHeads = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Column d of the augmented row [row, 1].
template <typename T>
__device__ __forceinline__ float xval(const T* row, int d, int din) {
  return d < din ? to_f32(row[d]) : 1.f;
}

// v[h, k] = sum_w wn'[h, k, w] * ar[h, w]; one warp per (h, k).
__global__ void prep_kernel(const float* __restrict__ wn,
                            const float* __restrict__ ar,
                            float* __restrict__ v, int64_t rows, int k,
                            int w) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* wr = wn + row * w;
  const float* a = ar + (row / k) * w;
  float s = 0.f;
  for (int c = lane; c < w; c += 32) s += wr[c] * a[c];
  s = warp_sum(s);
  if (lane == 0) v[row] = s;
}

// One warp, one seed s, every head: pre-activation logits zs, softmax ps
// and qs = ps * drop, each [H, e] in the warp's shared scratch.
template <typename T>
__device__ void attn_coef(const T* __restrict__ rows,
                          const float* __restrict__ v,
                          const float* __restrict__ el,
                          const float* __restrict__ ba,
                          const float* __restrict__ drop, int64_t s,
                          int64_t b, int e, int din, int k, int nh, int lane,
                          float* zs, float* ps, float* qs) {
  for (int h0 = 0; h0 < nh; h0 += kHeads) {
    const int hc = min(kHeads, nh - h0);
    const float* vh = v + static_cast<int64_t>(h0) * k;
    for (int j = 0; j < e; ++j) {
      const T* row = rows + static_cast<int64_t>(j) * din;
      float acc[kHeads];
#pragma unroll
      for (int i = 0; i < kHeads; ++i) acc[i] = 0.f;
      for (int d = lane; d < din; d += 32) {
        const float x = to_f32(row[d]);
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          if (i < hc) acc[i] += x * vh[static_cast<int64_t>(i) * k + d];
        }
      }
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        if (i < hc) {
          const float dot = warp_sum(acc[i]);
          if (lane == 0) {
            const int h = h0 + i;
            zs[h * e + j] = el[static_cast<int64_t>(h) * b + s] +
                            (k > din ? vh[static_cast<int64_t>(i) * k + din]
                                     : 0.f) +
                            (ba ? ba[h] : 0.f) + dot;
          }
        }
      }
    }
  }
  __syncwarp();
  for (int h = lane; h < nh; h += 32) {
    float m = -INFINITY;
    for (int j = 0; j < e; ++j) {
      const float z = zs[h * e + j];
      m = fmaxf(m, z > 0.f ? z : kSlope * z);
    }
    float sum = 0.f;
    for (int j = 0; j < e; ++j) {
      const float z = zs[h * e + j];
      const float ex = expf((z > 0.f ? z : kSlope * z) - m);
      ps[h * e + j] = ex;
      sum += ex;
    }
    const float inv = 1.f / sum;
    const float* dr =
        drop ? drop + (static_cast<int64_t>(h) * b + s) * e : nullptr;
    for (int j = 0; j < e; ++j) {
      const float p = ps[h * e + j] * inv;
      ps[h * e + j] = p;
      qs[h * e + j] = dr ? p * dr[j] : p;
    }
  }
  __syncwarp();
}

// a[h, s, :] = sum_j q[h, s, j] * [nbr[s, j, :], 1]
template <typename T>
__global__ void attn_fwd_kernel(const T* __restrict__ nbr,
                                const float* __restrict__ v,
                                const float* __restrict__ el,
                                const float* __restrict__ ba,
                                const float* __restrict__ drop,
                                float* __restrict__ a, int64_t b, int e,
                                int din, int k, int nh) {
  extern __shared__ float smem[];
  const int wpb = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* zs = smem + static_cast<size_t>(warp) * 4 * nh * e;
  float* ps = zs + nh * e;
  float* qs = ps + nh * e;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * wpb + warp; s < b;
       s += static_cast<int64_t>(gridDim.x) * wpb) {
    const T* rows = nbr + s * e * din;
    attn_coef(rows, v, el, ba, drop, s, b, e, din, k, nh, lane, zs, ps, qs);
    for (int h0 = 0; h0 < nh; h0 += kHeads) {
      const int hc = min(kHeads, nh - h0);
      for (int d = lane; d < k; d += 32) {
        float acc[kHeads];
#pragma unroll
        for (int i = 0; i < kHeads; ++i) acc[i] = 0.f;
        for (int j = 0; j < e; ++j) {
          const float x = xval(rows + static_cast<int64_t>(j) * din, d, din);
#pragma unroll
          for (int i = 0; i < kHeads; ++i) {
            if (i < hc) acc[i] += qs[(h0 + i) * e + j] * x;
          }
        }
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          if (i < hc) {
            a[(static_cast<int64_t>(h0 + i) * b + s) * k + d] = acc[i];
          }
        }
      }
    }
    __syncwarp();
  }
}

// Softmax / leaky-relu backward for one seed per warp; see the file note.
template <typename T>
__global__ void attn_bwd_kernel(const T* __restrict__ nbr,
                                const float* __restrict__ v,
                                const float* __restrict__ el,
                                const float* __restrict__ ba,
                                const float* __restrict__ drop,
                                const float* __restrict__ da,
                                float* __restrict__ d_el,
                                float* __restrict__ dv,
                                float* __restrict__ d_nbr, int64_t b, int e,
                                int din, int k, int nh) {
  extern __shared__ float smem[];
  const int wpb = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* dv_s = smem + static_cast<size_t>(wpb) * 4 * nh * e;
  for (int i = threadIdx.x; i < nh * k; i += blockDim.x) dv_s[i] = 0.f;
  __syncthreads();
  float* zs = smem + static_cast<size_t>(warp) * 4 * nh * e;
  float* ps = zs + nh * e;
  float* qs = ps + nh * e;
  float* ds = qs + nh * e;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * wpb + warp; s < b;
       s += static_cast<int64_t>(gridDim.x) * wpb) {
    const T* rows = nbr + s * e * din;
    attn_coef(rows, v, el, ba, drop, s, b, e, din, k, nh, lane, zs, ps, qs);
    // d_q[h, j] = [nbr[j], 1] . d_a[h, s, :]
    for (int h0 = 0; h0 < nh; h0 += kHeads) {
      const int hc = min(kHeads, nh - h0);
      const float* dah = da + (static_cast<int64_t>(h0) * b + s) * k;
      for (int j = 0; j < e; ++j) {
        const T* row = rows + static_cast<int64_t>(j) * din;
        float acc[kHeads];
#pragma unroll
        for (int i = 0; i < kHeads; ++i) acc[i] = 0.f;
        for (int d = lane; d < k; d += 32) {
          const float x = xval(row, d, din);
#pragma unroll
          for (int i = 0; i < kHeads; ++i) {
            if (i < hc) acc[i] += x * dah[static_cast<int64_t>(i) * b * k + d];
          }
        }
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          if (i < hc) {
            const float dot = warp_sum(acc[i]);
            if (lane == 0) ds[(h0 + i) * e + j] = dot;
          }
        }
      }
    }
    __syncwarp();
    for (int h = lane; h < nh; h += 32) {
      const float* dr =
          drop ? drop + (static_cast<int64_t>(h) * b + s) * e : nullptr;
      float dot = 0.f;
      for (int j = 0; j < e; ++j) {
        const float dp = dr ? ds[h * e + j] * dr[j] : ds[h * e + j];
        ds[h * e + j] = dp;
        dot += ps[h * e + j] * dp;
      }
      float sz = 0.f;
      for (int j = 0; j < e; ++j) {
        const float dl = ps[h * e + j] * (ds[h * e + j] - dot);
        const float dz = zs[h * e + j] > 0.f ? dl : kSlope * dl;
        ds[h * e + j] = dz;
        sz += dz;
      }
      d_el[static_cast<int64_t>(h) * b + s] = sz;
    }
    __syncwarp();
    // d_v[h, :] += sum_j d_z[h, j] * [nbr[j], 1]
    for (int h0 = 0; h0 < nh; h0 += kHeads) {
      const int hc = min(kHeads, nh - h0);
      for (int d = lane; d < k; d += 32) {
        float acc[kHeads];
#pragma unroll
        for (int i = 0; i < kHeads; ++i) acc[i] = 0.f;
        for (int j = 0; j < e; ++j) {
          const float x = xval(rows + static_cast<int64_t>(j) * din, d, din);
#pragma unroll
          for (int i = 0; i < kHeads; ++i) {
            if (i < hc) acc[i] += ds[(h0 + i) * e + j] * x;
          }
        }
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          if (i < hc) atomicAdd(&dv_s[(h0 + i) * k + d], acc[i]);
        }
      }
    }
    if (d_nbr != nullptr) {
      for (int j = 0; j < e; ++j) {
        float* out = d_nbr + (s * e + j) * din;
        for (int d = lane; d < din; d += 32) {
          float acc = 0.f;
          for (int h = 0; h < nh; ++h) {
            acc += qs[h * e + j] *
                       da[(static_cast<int64_t>(h) * b + s) * k + d] +
                   ds[h * e + j] * v[static_cast<int64_t>(h) * k + d];
          }
          out[d] = acc;
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * k; i += blockDim.x) {
    atomicAdd(&dv[i], dv_s[i]);
  }
}

// Batched tile product C[z] (+)= A[z] . B[z] in f32 FMAs, any strides:
// A(m, kk) = A[m * sam + kk * sak], B(kk, n) = B[kk * sbk + n * sbn],
// C row-major with leading dimension ldc.  blockIdx.z = z * splits + part:
// each part takes a slice of the depth and, when `atomic`, adds its
// partial with atomicAdd (C must then start at zero).  256 threads, each a
// 4x4 corner of the 64x64 tile; the shared stages are stored depth-major
// so that a thread reads its four rows and four columns as one vector each.
__global__ void __launch_bounds__(256)
    gemm_kernel(const float* __restrict__ a, const float* __restrict__ bm,
                float* __restrict__ c, int m, int n, int depth, int64_t sam,
                int64_t sak, int64_t sab, int64_t sbk, int64_t sbn,
                int64_t sbb, int64_t ldc, int64_t scb, int splits,
                int atomic) {
  __shared__ __align__(16) float as[kTileK][kTile + 4];
  __shared__ __align__(16) float bs[kTileK][kTile + 4];
  const int z = blockIdx.z / splits, part = blockIdx.z % splits;
  const int chunk =
      ((depth + splits - 1) / splits + kTileK - 1) / kTileK * kTileK;
  const int k0 = part * chunk;
  const int k1 = min(depth, k0 + chunk);
  a += static_cast<int64_t>(z) * sab;
  bm += static_cast<int64_t>(z) * sbb;
  c += static_cast<int64_t>(z) * scb;
  const int m0 = blockIdx.x * kTile, n0 = blockIdx.y * kTile;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int kb = k0; kb < k1; kb += kTileK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = t + i * 256;
      // neighbouring threads walk the operand's contiguous dimension
      int mm, kk;
      if (sam == 1) {
        mm = idx & (kTile - 1);
        kk = idx / kTile;
      } else {
        kk = idx & (kTileK - 1);
        mm = idx / kTileK;
      }
      const int gm = m0 + mm, gk = kb + kk;
      as[kk][mm] = (gm < m && gk < k1)
                       ? a[static_cast<int64_t>(gm) * sam +
                           static_cast<int64_t>(gk) * sak]
                       : 0.f;
      int nn, kn;
      if (sbn == 1) {
        nn = idx & (kTile - 1);
        kn = idx / kTile;
      } else {
        kn = idx & (kTileK - 1);
        nn = idx / kTileK;
      }
      const int gn = n0 + nn, gk2 = kb + kn;
      bs[kn][nn] = (gn < n && gk2 < k1)
                       ? bm[static_cast<int64_t>(gk2) * sbk +
                            static_cast<int64_t>(gn) * sbn]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= n) continue;
      float* dst = c + static_cast<int64_t>(gm) * ldc + gn;
      if (atomic) {
        atomicAdd(dst, acc[i][j]);
      } else {
        *dst = acc[i][j];
      }
    }
  }
}

// d_ar[h, w] = sum_k wn'[h, k, w] d_v[h, k];  d_wn'[h, k, w] += d_v[h, k]
// ar[h, w].  One thread per (h, w).
__global__ void finalize_kernel(const float* __restrict__ wn,
                                const float* __restrict__ ar,
                                const float* __restrict__ dv,
                                float* __restrict__ d_wn,
                                float* __restrict__ d_ar, int nh, int k,
                                int w) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(nh) * w) return;
  const int64_t h = i / w, col = i % w;
  const float arv = ar[i];
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const int64_t at = (h * k + kk) * w + col;
    const float d = dv[h * k + kk];
    acc += wn[at] * d;
    d_wn[at] += d * arv;
  }
  d_ar[i] = acc;
}

int first_error(int seen) {
  const int now = static_cast<int>(cudaGetLastError());
  return seen != 0 ? seen : now;
}

// Warps per block whose scratch (4 * H * e floats each, plus `extra`
// floats per block) fits in shared memory; 0 if one warp's does not.
int pick_warps(int nh, int e, int64_t extra, size_t* bytes) {
  for (int wpb = 8; wpb >= 1; wpb >>= 1) {
    const int64_t need =
        (static_cast<int64_t>(wpb) * 4 * nh * e + extra) * 4;
    if (need <= kMaxSmem) {
      *bytes = static_cast<size_t>(need);
      return wpb;
    }
  }
  return 0;
}

void launch_gemm(const float* a, const float* bm, float* c, int64_t m, int n,
                 int depth, int64_t sam, int64_t sak, int64_t sab,
                 int64_t sbk, int64_t sbn, int64_t sbb, int64_t ldc,
                 int64_t scb, int batch, int splits, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m + kTile - 1) / kTile),
                  static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>(batch * splits));
  gemm_kernel<<<grid, 256, 0, s>>>(a, bm, c, static_cast<int>(m), n, depth,
                                   sam, sak, sab, sbk, sbn, sbb, ldc, scb,
                                   splits, splits > 1 ? 1 : 0);
}

void launch_prep(const float* wn, const float* ar, float* v, int nh, int k,
                 int w, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(nh) * k;
  prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, s>>>(
      wn, ar, v, rows, k, w);
}

template <typename T>
int launch_attn_fwd(const void* nbr, const float* v, const float* el,
                    const float* ba, const float* drop, float* a, int64_t b,
                    int e, int din, int k, int nh, cudaStream_t s) {
  size_t bytes = 0;
  const int wpb = pick_warps(nh, e, 0, &bytes);
  if (wpb == 0) return -2;
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(attn_fwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
  const int64_t blocks = (b + wpb - 1) / wpb;
  attn_fwd_kernel<T><<<static_cast<unsigned>(blocks), wpb * 32, bytes, s>>>(
      static_cast<const T*>(nbr), v, el, ba, drop, a, b, e, din, k, nh);
  return 0;
}

template <typename T>
int launch_attn_bwd(const void* nbr, const float* v, const float* el,
                    const float* ba, const float* drop, const float* da,
                    float* d_el, float* dv, float* d_nbr, int64_t b, int e,
                    int din, int k, int nh, cudaStream_t s) {
  size_t bytes = 0;
  const int wpb =
      pick_warps(nh, e, static_cast<int64_t>(nh) * k, &bytes);
  if (wpb == 0) return -2;
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(attn_bwd_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
  }
  // a bounded grid: each block adds its d_v partial once
  int64_t blocks = (b + wpb - 1) / wpb;
  if (blocks > 132 * 8) blocks = 132 * 8;
  attn_bwd_kernel<T><<<static_cast<unsigned>(blocks), wpb * 32, bytes, s>>>(
      static_cast<const T*>(nbr), v, el, ba, drop, da, d_el, dv, d_nbr, b, e,
      din, k, nh);
  return 0;
}

}  // namespace

// Forward.  nbr [b, e, din] (dtype code 0 = f32, 1 = bf16); wn [H, k, W]
// with k = din (no bias) or din + 1 (row din holds bn); ar [H, W];
// el [H, b]; ba [H] or null; drop [H, b, e] or null; scratch v [H, k] and
// a [H, b, k]; out [H, b, W].  All but nbr are f32.  Returns 0, the first
// CUDA error of a launch, -1 for an unknown dtype, or -2 when the softmax
// scratch of one warp does not fit in shared memory.
extern "C" int glt_gat_block_fwd(const void* nbr, int nbr_dtype,
                                 const float* wn, const float* ar,
                                 const float* el, const float* ba,
                                 const float* drop, float* v, float* a,
                                 float* out, long long b, int e, int din,
                                 int k, int nh, int w, void* stream) {
  if (nbr_dtype < 0 || nbr_dtype > 1) return -1;
  if (b <= 0 || nh <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  launch_prep(wn, ar, v, nh, k, w, s);
  err = first_error(err);
  const int rc =
      nbr_dtype == 0
          ? launch_attn_fwd<float>(nbr, v, el, ba, drop, a, b, e, din, k, nh,
                                   s)
          : launch_attn_fwd<__nv_bfloat16>(nbr, v, el, ba, drop, a, b, e,
                                           din, k, nh, s);
  if (rc != 0) return rc;
  err = first_error(err);
  // out[h] = a[h] . wn'[h]
  launch_gemm(a, wn, out, b, w, k, k, 1, static_cast<int64_t>(b) * k, w, 1,
              static_cast<int64_t>(k) * w, w, static_cast<int64_t>(b) * w,
              nh, 1, s);
  return first_error(err);
}

// Backward.  Inputs as for the forward, plus g = d_out [H, b, W]; scratch
// v [H, k], a and da [H, b, k], dv [H, k]; outputs d_nbr [b, e, din] f32
// or null (not wanted), d_wn [H, k, W] (row din is d_bn), d_ar [H, W],
// d_el [H, b].  Return codes as for the forward.
extern "C" int glt_gat_block_bwd(const void* nbr, int nbr_dtype,
                                 const float* wn, const float* ar,
                                 const float* el, const float* ba,
                                 const float* drop, const float* g, float* v,
                                 float* a, float* da, float* dv,
                                 float* d_nbr, float* d_wn, float* d_ar,
                                 float* d_el, long long b, int e, int din,
                                 int k, int nh, int w, void* stream) {
  if (nbr_dtype < 0 || nbr_dtype > 1) return -1;
  if (nh <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  cudaMemsetAsync(d_wn, 0, sizeof(float) * nh * k * w, s);
  cudaMemsetAsync(dv, 0, sizeof(float) * nh * k, s);
  err = first_error(err);
  if (b > 0) {
    launch_prep(wn, ar, v, nh, k, w, s);
    err = first_error(err);
    int rc =
        nbr_dtype == 0
            ? launch_attn_fwd<float>(nbr, v, el, ba, drop, a, b, e, din, k,
                                     nh, s)
            : launch_attn_fwd<__nv_bfloat16>(nbr, v, el, ba, drop, a, b, e,
                                             din, k, nh, s);
    if (rc != 0) return rc;
    err = first_error(err);
    // d_a[h] = g[h] . wn'[h]^T : B(kk = col of wn', n = row of wn')
    launch_gemm(g, wn, da, b, k, w, w, 1, static_cast<int64_t>(b) * w, 1, w,
                static_cast<int64_t>(k) * w, k, static_cast<int64_t>(b) * k,
                nh, 1, s);
    err = first_error(err);
    // d_wn'[h] = a[h]^T . g[h], the depth b split into parts that add
    // their partials with atomicAdd: about four blocks per SM in all
    const int64_t tiles = static_cast<int64_t>((k + kTile - 1) / kTile) *
                          ((w + kTile - 1) / kTile) * nh;
    int64_t splits = (528 + tiles - 1) / tiles;
    const int64_t by_depth = (b + 511) / 512;
    if (splits > by_depth) splits = by_depth;
    if (splits < 2) splits = 2;  // the atomic path: d_wn starts at zero
    launch_gemm(a, g, d_wn, k, w, static_cast<int>(b), 1, k,
                static_cast<int64_t>(b) * k, w, 1,
                static_cast<int64_t>(b) * w, w, static_cast<int64_t>(k) * w,
                nh, static_cast<int>(splits), s);
    err = first_error(err);
    rc = nbr_dtype == 0
             ? launch_attn_bwd<float>(nbr, v, el, ba, drop, da, d_el, dv,
                                      d_nbr, b, e, din, k, nh, s)
             : launch_attn_bwd<__nv_bfloat16>(nbr, v, el, ba, drop, da, d_el,
                                              dv, d_nbr, b, e, din, k, nh,
                                              s);
    if (rc != 0) return rc;
    err = first_error(err);
  }
  const int64_t cells = static_cast<int64_t>(nh) * w;
  finalize_kernel<<<static_cast<unsigned>((cells + 255) / 256), 256, 0, s>>>(
      wn, ar, dv, d_wn, d_ar, nh, k, w);
  return first_error(err);
}
