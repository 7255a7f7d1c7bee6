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
// The algebra.  Taken literally the block is one [b*e, Din] x [Din, H*W]
// product (8.05e10 operations at b*e = 153 600, Din = 128, H*W = 2048), and
// nh would be 1.26 GB if it were written.  Both of nh's uses are linear in
// it, so this file never forms it:
//
//   nh[j] . ar       = [nbr[j], 1] . v,    v = [wn; bn] . ar      (K' values)
//   sum_j q[j] nh[j] = (sum_j q[j] [nbr[j], 1]) . [wn; bn] = a . [wn; bn]
//
// with K' = Din + 1 when there is a bias (the 1 carries bn), else Din, and
// q = coef * drop.  The logits need one K'-long dot per neighbour row and
// head, and the matrix product runs on b rows per head instead of b * e:
// 2 * H * b * K' * W operations (8.1e9 at the shape above).
//
// Bound: bytes.  The three products run on the tensor cores (split TF32,
// csrc/gat_mma.cuh and csrc/gat_wgmma.cuh), where 8.1e9 operations are
// 0.016 ms at 495 TFLOP/s; the inputs and the output are 0.2 GB forward
// (0.061 ms at 3.35 TB/s).  What the kernels add to that: `a` [H, b, lda]
// (forward and backward) and `d_a` (backward) are written by one kernel and
// read by the next, 62.9 MB each way at that shape.  They stay in device
// memory: a block that kept a seed tile's `a` for every head on the chip
// would hold 32 seeds at most and stream the 128 KB of [wn; bn][h] per head
// and tile from L2 instead, and it is that traffic into the SMs, not the
// tensor cores, that bounds a product here (gat_wgmma.cuh).
//
// Forward: (1) prep_kernel: v = [wn; bn] . ar, and where the wgmma product
// follows, [wn; bn] transposed and split into TF32 hi and lo
// (split_transposed_kernel).  (2) attn_fwd_kernel: one
// warp per seed, all heads, the warps of a grid that just fills the card
// walking over the seeds.  v lies in shared memory, once per block.  A
// seed's neighbour rows come into the warp's shared buffer by cp.async, all
// copies in flight at once (16 bytes each, 8 for bf16), and are read from
// there twice.  A lane takes four neighbouring elements of a row and keeps
// eight heads' partial dots, two rows at a time; the eight sums are reduced
// together by halving the values at each shuffle step (9 shuffles for eight
// sums, not 40).  The heads are padded to a multiple of eight with zeros in
// shared memory, so the inner loops test nothing.  Then the softmax, four
// lanes a head, and a = sum_j q[j] [nbr[j], 1].  (3) out[h] = a[h] . [wn;
// bn][h]: on wgmma with the weights resident in shared memory when the
// padded depth lda is at most 128 (gat_wgmma.cuh), else on mma.sync.
// Backward (nothing but the inputs is saved):
//   prep; d_a = g . [wn; bn]^T                 (product, B read transposed)
//   attn_bwd_kernel, one warp per seed, rows and the seed's d_a staged as
//     above: the logits and softmax again, and `a` again (the forward's
//     kernel does not run a second time); d_q[j] = [nbr[j], 1] . d_a;
//     softmax and leaky-relu backward -> d_z; d_el = sum_j d_z;
//     d_v = sum_{s, j} d_z [nbr[j], 1], kept in the warp's registers from
//     seed to seed where a lane owns one chunk of a row and there are at
//     most eight heads (shared-memory float atomics are compare-and-swap
//     loops: they cost this kernel half its time), else added to the
//     block's shared partial seed by seed; blocks add theirs with
//     atomicAdd;  d_nbr[j] = sum_h q[h, j] d_a[h] + d_z[h, j] v[h] (one
//     warp owns a seed's rows for every head: no atomics)
//   d_wn' = a^T . g                             (product, A read transposed,
//                                               split over b, partials added)
//   tail_kernel, (h, 16 rows of K')-parallel: d_ar = [wn; bn]^T . d_v and
//     d_wn' += d_v (x) ar
// d_bn is row Din of d_wn'.
//
// `a`, `d_a` and the shared copies of v and d_a have rows of lda floats,
// lda = K' rounded up to a multiple of 4, so that every row starts on 16
// bytes; the attention kernels write zeros into a's padding.
//
// The products take one of two routes, chosen by shape alone: W % 4 == 0
// (16-byte chunks of every operand) -> tensor cores; any other W -> the
// 64x64-tile f32 FMA product below (scalar loads, any strides).  On the
// tensor route the forward's product is the wgmma kernel when lda <= 128,
// again by shape alone; the backward's two stay on mma.sync (d_wn' reads
// both operands with the depth as their rows, which TF32 wgmma does not
// take; d_a's weights, 256 KB split at W = 256, do not fit beside a ring).
// The entry point reports the route it took and whether wgmma ran.  The
// attention kernels use the 4-wide loads when Din % 4 == 0 and the rows
// start on 16 bytes, else scalar ones, and stage the rows when they fit in
// shared memory.
//
// Sums across blocks (d_wn', d_v, d_ar) are added with atomics, so their
// order, and the last bits of those gradients, vary from run to run; the
// forward is the same from run to run.  Any b, e, Din, H, W: edges are
// masked.  The per-warp scratch and the block's copies of v and d_v live in
// dynamic shared memory; the launcher lowers the warps per block until they
// fit (in 100 KB, for two blocks an SM, if they can) and returns -2 if one
// warp's do not.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gat_mma.cuh"
#include "gat_wgmma.cuh"

namespace {

constexpr float kSlope = 0.2f;
constexpr int kTile = 64;   // FMA route: output tile (rows, cols)
constexpr int kTileK = 16;  // FMA route: depth of one shared-memory stage
constexpr int kMaxSmem = 200 * 1024;
// heads whose accumulators a lane keeps in registers at once, so that an
// element of a neighbour row is read once for all of them
constexpr int kHeads = 8;
// routes of the three products; kRouteMma (asked for only: timing) is the
// tensor-core route without the wgmma kernel; kUsedWgmma is added to the
// reported route when the wgmma kernel was launched
constexpr int kRouteTensor = 1, kRouteFma = 2, kRouteMma = 3;
constexpr int kUsedWgmma = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC neighbouring elements from p (aligned to VEC elements when VEC == 4).
template <int VEC>
__device__ __forceinline__ void load_chunk(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    x[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_chunk(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// All n elements of one seed's rows (n % 4 == 0, 4 elements a copy: 16
// bytes, 8 for bf16) into the warp's shared buffer, every copy in flight at
// once.  The caller commits, waits and syncs the warp.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* __restrict__ rows,
                                           int n, int lane) {
  for (int i = lane * 4; i < n; i += 128) {
    const uint32_t d =
        static_cast<uint32_t>(__cvta_generic_to_shared(buf + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(rows + i), "n"(static_cast<int>(4 * sizeof(T)))
                 : "memory");
  }
}

// Eight partial sums a lane -> in every lane the warp's full sum number
// (lane >> 2) & 7.  Each step hands half of the values to the partner lane
// and keeps the other half: 4 + 2 + 1 shuffles, then 2 within the group of
// four lanes that hold the same sum.
__device__ __forceinline__ float reduce8(float (&acc)[kHeads], int lane) {
  const unsigned full = 0xffffffffu;
  {
    const bool up = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up ? acc[i] : acc[i + 4];
      const float keep = up ? acc[i + 4] : acc[i];
      acc[i] = keep + __shfl_xor_sync(full, send, 16);
    }
  }
  {
    const bool up = (lane & 8) != 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? acc[i] : acc[i + 2];
      const float keep = up ? acc[i + 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(full, send, 8);
    }
  }
  {
    const bool up = (lane & 4) != 0;
    const float send = up ? acc[0] : acc[1];
    const float keep = up ? acc[1] : acc[0];
    acc[0] = keep + __shfl_xor_sync(full, send, 4);
  }
  acc[0] += __shfl_xor_sync(full, acc[0], 2);
  acc[0] += __shfl_xor_sync(full, acc[0], 1);
  return acc[0];
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

// wn' transposed and split for the wgmma product (csrc/gat_wgmma.cuh):
// hi[h, w, kk] + lo[h, w, kk] = wn'[h, kk, w] with hi the nearest TF32
// number, zeros for k <= kk < lda.  32 x 32 tiles through shared memory, so
// that reads run along w and writes along kk.  Grid (w tiles, lda tiles, H),
// block (32, 8).
__global__ void split_transposed_kernel(const float* __restrict__ wn,
                                        float* __restrict__ hi,
                                        float* __restrict__ lo, int k, int lda,
                                        int w) {
  __shared__ float tile[32][33];
  const int h = blockIdx.z, k0 = blockIdx.y * 32, w0 = blockIdx.x * 32;
  const float* src = wn + static_cast<int64_t>(h) * k * w;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int kk = k0 + i, ww = w0 + threadIdx.x;
    tile[i][threadIdx.x] =
        (kk < k && ww < w) ? src[static_cast<int64_t>(kk) * w + ww] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int ww = w0 + i, kk = k0 + threadIdx.x;
    if (ww >= w || kk >= lda) continue;
    uint32_t xh, xl;
    glt_mma::split_tf32<true>(tile[threadIdx.x][i], xh, xl);
    const int64_t at = (static_cast<int64_t>(h) * w + ww) * lda + kk;
    hi[at] = __uint_as_float(xh);
    lo[at] = __uint_as_float(xl);
  }
}

// One warp, one seed: dst[h, j] = rows[j, :Din] . vec[h, :Din] for every
// head and neighbour row.  vec [hp, lda] and dst [hp, e] lie in shared
// memory with the heads padded to hp, a multiple of kHeads (vec's padding
// is zero), so that the inner loops carry no test on the head.
template <int VEC, typename T>
__device__ __forceinline__ void row_dots(const T* __restrict__ rows,
                                         const float* vec, int e, int din,
                                         int lda, int hp, int lane,
                                         float* dst) {
  const int nchunk = din / VEC;
  for (int h0 = 0; h0 < hp; h0 += kHeads) {
    const float* vh = vec + h0 * lda;
    for (int j = 0; j < e; j += 2) {
      // two rows in flight; a last odd row is read twice and dropped once
      const bool two = j + 1 < e;
      const T* r0 = rows + static_cast<int64_t>(j) * din;
      const T* r1 = two ? r0 + din : r0;
      float acc0[kHeads], acc1[kHeads];
#pragma unroll
      for (int i = 0; i < kHeads; ++i) acc0[i] = acc1[i] = 0.f;
      for (int c = lane; c < nchunk; c += 32) {
        float x0[VEC], x1[VEC], vv[kHeads][VEC];
        load_chunk<VEC>(r0 + c * VEC, x0);
        load_chunk<VEC>(r1 + c * VEC, x1);
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          load_chunk<VEC>(vh + i * lda + c * VEC, vv[i]);
        }
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            acc0[i] = fmaf(x0[u], vv[i][u], acc0[i]);
            acc1[i] = fmaf(x1[u], vv[i][u], acc1[i]);
          }
        }
      }
      const float d0 = reduce8(acc0, lane);
      const float d1 = reduce8(acc1, lane);
      if ((lane & 3) == 0) {
        float* out = dst + (h0 + (lane >> 2)) * e + j;
        out[0] = d0;
        if (two) out[1] = d1;
      }
    }
  }
}

// Sum and maximum over the four lanes that share a head.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Four lanes a head, each every fourth neighbour.  In: zs[h, j] = nbr[j] .
// v[h].  Out: zs the pre-activation logits, ps the softmax, qs = ps * drop;
// and, when `a` is given, a[h, s, Din..lda): the bias column sum_j q (if
// K' > Din) and the padding's zeros.
__device__ __forceinline__ void softmax_heads(
    float* zs, float* ps, float* qs, const float* vs,
    const float* __restrict__ el, const float* __restrict__ ba,
    const float* __restrict__ drop, float* __restrict__ a, int64_t s,
    int64_t b, int e, int din, int k, int lda, int nh, int lane) {
  const int part = lane & 3;
  for (int hb = 0; hb < nh; hb += kHeads) {
    const int h = hb + (lane >> 2);
    const bool on = h < nh;
    const int je = on ? e : 0;  // the shuffles below are for every lane
    float* z = zs + h * e;
    float* p = ps + h * e;
    float* q = qs + h * e;
    float add = 0.f;
    const float* dr = nullptr;
    if (on) {
      add = el[static_cast<int64_t>(h) * b + s] +
            (k > din ? vs[h * lda + din] : 0.f) + (ba ? ba[h] : 0.f);
      if (drop) dr = drop + (static_cast<int64_t>(h) * b + s) * e;
    }
    float m = -INFINITY;
    for (int j = part; j < je; j += 4) {
      const float zj = z[j] + add;
      z[j] = zj;
      m = fmaxf(m, zj > 0.f ? zj : kSlope * zj);
    }
    m = quad_max(m);
    float sum = 0.f;
    for (int j = part; j < je; j += 4) {
      const float zj = z[j];
      const float ex = expf((zj > 0.f ? zj : kSlope * zj) - m);
      p[j] = ex;
      sum += ex;
    }
    const float inv = 1.f / quad_sum(sum);
    float sq = 0.f;
    for (int j = part; j < je; j += 4) {
      const float pj = p[j] * inv;
      const float qj = dr ? pj * dr[j] : pj;
      p[j] = pj;
      q[j] = qj;
      sq += qj;
    }
    sq = quad_sum(sq);
    if (a != nullptr && on && part == 0) {
      float* tail = a + (static_cast<int64_t>(h) * b + s) * lda;
      for (int d = din; d < lda; ++d) {
        tail[d] = (d == din && k > din) ? sq : 0.f;
      }
    }
  }
}

// a[h, s, :Din] = sum_j qs[h, j] rows[j]; with BWD also d_v[h, :Din] +=
// sum_j ds[h, j] rows[j].  qs and ds [hp, e] (padding zero).  With ONE (hp
// == kHeads and one chunk a lane) the d_v sums stay in the caller's
// registers `sd` from seed to seed; else they are added to the block's
// shared partial dv_s with atomics, seed by seed.
template <int VEC, typename T, bool BWD, bool ONE>
__device__ __forceinline__ void weighted_sums(
    const T* __restrict__ rows, const float* qs, const float* ds,
    float* __restrict__ a, float* dv_s, float (&sd)[kHeads][VEC], int64_t s,
    int64_t b, int e, int din, int lda, int nh, int hp, int lane) {
  const int nchunk = din / VEC;
  for (int h0 = 0; h0 < hp; h0 += kHeads) {
    for (int c = lane; c < nchunk; c += 32) {
      float sa[kHeads][VEC];
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          sa[i][u] = 0.f;
          if constexpr (BWD && !ONE) sd[i][u] = 0.f;
        }
      }
#pragma unroll 2
      for (int j = 0; j < e; ++j) {
        float x[VEC];
        load_chunk<VEC>(rows + static_cast<int64_t>(j) * din + c * VEC, x);
#pragma unroll
        for (int i = 0; i < kHeads; ++i) {
          const float q = qs[(h0 + i) * e + j];
#pragma unroll
          for (int u = 0; u < VEC; ++u) sa[i][u] = fmaf(q, x[u], sa[i][u]);
          if constexpr (BWD) {
            const float dz = ds[(h0 + i) * e + j];
#pragma unroll
            for (int u = 0; u < VEC; ++u) sd[i][u] = fmaf(dz, x[u], sd[i][u]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
        if (h0 + i < nh) {
          store_chunk<VEC>(
              a + (static_cast<int64_t>(h0 + i) * b + s) * lda + c * VEC,
              sa[i]);
          if constexpr (BWD && !ONE) {
#pragma unroll
            for (int u = 0; u < VEC; ++u) {
              atomicAdd(&dv_s[(h0 + i) * lda + c * VEC + u], sd[i][u]);
            }
          }
        }
      }
    }
  }
}

// The block's copy of v in shared memory, [hp, lda], zero outside [nh, k].
__device__ __forceinline__ void stage_v(float* vs, const float* __restrict__ v,
                                        int k, int lda, int nh, int hp) {
  for (int i = threadIdx.x; i < hp * lda; i += blockDim.x) {
    const int h = i / lda, d = i % lda;
    vs[i] = (h < nh && d < k) ? v[h * k + d] : 0.f;
  }
}

// a[h, s, :] = sum_j q[h, s, j] * [nbr[s, j, :], 1].  Shared memory: v
// [hp, lda], then per warp `pw` floats (zs, ps, qs [hp, e] each) and, with
// STAGE, `row_bytes` for the seed's rows.
template <typename T, int VEC, bool STAGE>
__global__ void __launch_bounds__(256, STAGE ? 3 : 1)
    attn_fwd_kernel(const T* __restrict__ nbr, const float* __restrict__ v,
                    const float* __restrict__ el,
                    const float* __restrict__ ba,
                    const float* __restrict__ drop, float* __restrict__ a,
                    int64_t b, int e, int din, int k, int lda, int nh, int hp,
                    int pw, int row_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int wpb = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* vs = smem;
  char* mine = reinterpret_cast<char*>(vs + hp * lda) +
               static_cast<size_t>(warp) * (pw * 4 + row_bytes);
  float* zs = reinterpret_cast<float*>(mine);
  float* ps = zs + hp * e;
  float* qs = ps + hp * e;
  T* rowbuf = reinterpret_cast<T*>(mine + pw * 4);
  stage_v(vs, v, k, lda, nh, hp);
  for (int i = lane; i < pw; i += 32) zs[i] = 0.f;
  __syncthreads();
  float none[kHeads][VEC];  // the backward's d_v sums: not touched here
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * wpb + warp; s < b;
       s += static_cast<int64_t>(gridDim.x) * wpb) {
    const T* rows = nbr + s * e * din;
    if constexpr (STAGE) {
      stage_rows(rowbuf, rows, e * din, lane);
      glt_mma::cp_async_commit();
      glt_mma::cp_async_wait<0>();
      __syncwarp();
      rows = rowbuf;
    }
    row_dots<VEC>(rows, vs, e, din, lda, hp, lane, zs);
    __syncwarp();
    softmax_heads(zs, ps, qs, vs, el, ba, drop, a, s, b, e, din, k, lda, nh,
                  lane);
    __syncwarp();
    weighted_sums<VEC, T, false, false>(rows, qs, nullptr, a, nullptr, none,
                                        s, b, e, din, lda, nh, hp, lane);
    __syncwarp();
  }
}

// The attention's backward for one seed per warp; see the file note.
// Shared memory: v [hp, lda] and the block's d_v partial [hp, lda], then
// per warp `pw` floats (the seed's d_a [hp, lda]; zs, ps, qs, ds [hp, e]
// each) and, with STAGE, `row_bytes` for the seed's rows.
template <typename T, int VEC, bool STAGE, bool ONE>
__global__ void __launch_bounds__(256, STAGE ? 2 : 1)
    attn_bwd_kernel(const T* __restrict__ nbr, const float* __restrict__ v,
                    const float* __restrict__ el,
                    const float* __restrict__ ba,
                    const float* __restrict__ drop,
                    const float* __restrict__ da, float* __restrict__ a,
                    float* __restrict__ d_el, float* __restrict__ dv,
                    float* __restrict__ d_nbr, int64_t b, int e, int din,
                    int k, int lda, int nh, int hp, int pw, int row_bytes) {
  extern __shared__ __align__(16) float smem[];
  const int wpb = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* vs = smem;
  float* dv_s = vs + hp * lda;
  char* mine = reinterpret_cast<char*>(dv_s + hp * lda) +
               static_cast<size_t>(warp) * (pw * 4 + row_bytes);
  float* das = reinterpret_cast<float*>(mine);
  T* rowbuf = reinterpret_cast<T*>(mine + pw * 4);
  float* zs = das + hp * lda;
  float* ps = zs + hp * e;
  float* qs = ps + hp * e;
  float* ds = qs + hp * e;
  stage_v(vs, v, k, lda, nh, hp);
  for (int i = threadIdx.x; i < hp * lda; i += blockDim.x) dv_s[i] = 0.f;
  for (int i = lane; i < pw; i += 32) das[i] = 0.f;
  __syncthreads();
  const int nchunk = din / VEC;
  const int part = lane & 3;
  float sd[kHeads][VEC];
#pragma unroll
  for (int i = 0; i < kHeads; ++i) {
#pragma unroll
    for (int u = 0; u < VEC; ++u) sd[i][u] = 0.f;
  }
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * wpb + warp; s < b;
       s += static_cast<int64_t>(gridDim.x) * wpb) {
    const T* rows = nbr + s * e * din;
    // this seed's d_a rows (lda % 4 == 0, rows start on 16 bytes) and, with
    // STAGE, its neighbour rows: every copy in flight at once
    const int quads = lda / 4;
    for (int i = lane; i < nh * quads; i += 32) {
      const int h = i / quads, c = i % quads;
      glt_mma::cp_async16(
          das + h * lda + c * 4,
          da + (static_cast<int64_t>(h) * b + s) * lda + c * 4, 16);
    }
    if constexpr (STAGE) stage_rows(rowbuf, rows, e * din, lane);
    glt_mma::cp_async_commit();
    glt_mma::cp_async_wait<0>();
    __syncwarp();
    if constexpr (STAGE) rows = rowbuf;
    row_dots<VEC>(rows, vs, e, din, lda, hp, lane, zs);
    __syncwarp();
    softmax_heads(zs, ps, qs, vs, el, ba, drop, a, s, b, e, din, k, lda, nh,
                  lane);
    // d_q[h, j] = [nbr[j], 1] . d_a[h, s, :]
    row_dots<VEC>(rows, das, e, din, lda, hp, lane, ds);
    __syncwarp();
    // softmax and leaky-relu backward, four lanes a head
    for (int hb = 0; hb < nh; hb += kHeads) {
      const int h = hb + (lane >> 2);
      const bool on = h < nh;
      const int je = on ? e : 0;
      const float* dr =
          on && drop ? drop + (static_cast<int64_t>(h) * b + s) * e : nullptr;
      const float db = on && k > din ? das[h * lda + din] : 0.f;
      float dot = 0.f;
      for (int j = part; j < je; j += 4) {
        float dp = ds[h * e + j] + db;
        if (dr) dp *= dr[j];
        ds[h * e + j] = dp;
        dot += ps[h * e + j] * dp;
      }
      dot = quad_sum(dot);
      float sz = 0.f;
      for (int j = part; j < je; j += 4) {
        const float dl = ps[h * e + j] * (ds[h * e + j] - dot);
        const float dz = zs[h * e + j] > 0.f ? dl : kSlope * dl;
        ds[h * e + j] = dz;
        sz += dz;
      }
      sz = quad_sum(sz);
      if (on && part == 0) {
        d_el[static_cast<int64_t>(h) * b + s] = sz;
        if (k > din) atomicAdd(&dv_s[h * lda + din], sz);
      }
    }
    __syncwarp();
    weighted_sums<VEC, T, true, ONE>(rows, qs, ds, a, dv_s, sd, s, b, e, din,
                                     lda, nh, hp, lane);
    if (d_nbr != nullptr) {
      for (int j = 0; j < e; ++j) {
        float* out = d_nbr + (s * e + j) * din;
        for (int c = lane; c < nchunk; c += 32) {
          float acc[VEC];
#pragma unroll
          for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
          for (int h = 0; h < nh; ++h) {
            const float q = qs[h * e + j], dz = ds[h * e + j];
            float dav[VEC], vv[VEC];
            load_chunk<VEC>(das + h * lda + c * VEC, dav);
            load_chunk<VEC>(vs + h * lda + c * VEC, vv);
#pragma unroll
            for (int u = 0; u < VEC; ++u) {
              acc[u] = fmaf(q, dav[u], fmaf(dz, vv[u], acc[u]));
            }
          }
          store_chunk<VEC>(out + c * VEC, acc);
        }
      }
    }
    __syncwarp();
  }
  if constexpr (ONE) {
    // the warp's d_v sums, once: lane owns chunk `lane` of every head
    if (lane < nchunk) {
#pragma unroll
      for (int i = 0; i < kHeads; ++i) {
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          atomicAdd(&dv_s[i * lda + lane * VEC + u], sd[i][u]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nh * k; i += blockDim.x) {
    atomicAdd(&dv[i], dv_s[(i / k) * lda + i % k]);
  }
}

// FMA route.  Batched tile product C[z] (+)= A[z] . B[z] in f32 FMAs, any
// strides: A(m, kk) = A[m * sam + kk * sak], B(kk, n) = B[kk * sbk + n *
// sbn], C row-major with leading dimension ldc.  blockIdx.z = z * splits +
// part: each part takes a slice of the depth and, when `atomic`, adds its
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

// d_ar[h, w] += sum_{k in this block's 16 rows} wn'[h, k, w] d_v[h, k] and
// d_wn'[h, k, w] += d_v[h, k] ar[h, w].  Grid (16-row slices of K', H),
// threads over w; d_ar starts at zero.
constexpr int kTailRows = 16;
__global__ void tail_kernel(const float* __restrict__ wn,
                            const float* __restrict__ ar,
                            const float* __restrict__ dv,
                            float* __restrict__ d_wn,
                            float* __restrict__ d_ar, int k, int w) {
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * kTailRows, r1 = min(k, r0 + kTailRows);
  for (int col = threadIdx.x; col < w; col += blockDim.x) {
    const float arv = ar[static_cast<int64_t>(h) * w + col];
    float acc = 0.f;
    for (int kk = r0; kk < r1; ++kk) {
      const int64_t at = (static_cast<int64_t>(h) * k + kk) * w + col;
      const float d = dv[h * k + kk];
      acc = fmaf(wn[at], d, acc);
      d_wn[at] += d * arv;
    }
    atomicAdd(&d_ar[static_cast<int64_t>(h) * w + col], acc);
  }
}

// Everything one call works on.  nbr [b, e, din] (dtype code 0 = f32, 1 =
// bf16); wn [H, k, W] with k = din (no bias) or din + 1 (row din holds
// bn); ar [H, W]; el [H, b]; ba [H] or null; drop [H, b, e] or null;
// g = d_out [H, b, W]; scratch v [H, k], a and da [H, b, lda], dv [H, k],
// bt_hi and bt_lo [H, W, lda] (the forward's wgmma product; else null);
// outputs out [H, b, W], d_nbr [b, e, din] f32 or null (not wanted), d_wn
// [H, k, W] (row din is d_bn), d_ar [H, W], d_el [H, b].  All but nbr f32.
struct Call {
  const void* nbr;
  int nbr_dtype;
  const float *wn, *ar, *el, *ba, *drop, *g;
  float *v, *a, *da, *dv, *bt_hi, *bt_lo, *out, *d_nbr, *d_wn, *d_ar, *d_el;
  int64_t b;
  int e, din, k, lda, nh, w;
  cudaStream_t s;
};

enum Part {
  kPrep = 0,
  kAttnFwd = 1,
  kProductOut = 2,
  kProductDa = 3,
  kAttnBwd = 4,
  kProductDwn = 5,
  kTail = 6,
};

// The route of the three products, by shape alone.
int route_of(const Call& c) { return c.w % 4 == 0 ? kRouteTensor : kRouteFma; }

// On the tensor route the forward's product takes the wgmma kernel when a
// block can keep the whole depth of the weights in shared memory.
bool wgmma_takes(const Call& c, int route) {
  return route == kRouteTensor && c.lda <= glt_wgmma::kMaxDepth;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// How an attention kernel is laid over the card.
struct Plan {
  int wpb = 0;        // warps per block; 0: one warp's scratch does not fit
  int pw = 0;         // floats of scratch per warp
  int row_bytes = 0;  // per warp, for the staged rows; 0: read from global
  size_t bytes = 0;   // dynamic shared memory per block
};

// The most warps per block (8, 4, 2, 1) whose scratch (`pw` floats each and
// `row_bytes` for the seed's rows, plus `per_block` floats) fits in 100 KB
// (two blocks an SM), else in kMaxSmem; the rows are staged only if they
// fit at all.
Plan plan_attn(int64_t pw, int64_t per_block, int64_t row_bytes) {
  Plan p;
  pw = (pw + 3) / 4 * 4;
  row_bytes = (row_bytes + 15) / 16 * 16;
  for (int stage = row_bytes > 0 ? 1 : 0; stage >= 0; --stage) {
    const int64_t rb = stage ? row_bytes : 0;
    for (int64_t cap : {int64_t{100} * 1024, int64_t{kMaxSmem}}) {
      for (int wpb = 8; wpb >= 1; wpb >>= 1) {
        const int64_t need = wpb * (pw * 4 + rb) + per_block * 4;
        if (need <= cap) {
          p.wpb = wpb;
          p.pw = static_cast<int>(pw);
          p.row_bytes = static_cast<int>(rb);
          p.bytes = static_cast<size_t>(need);
          return p;
        }
      }
    }
  }
  return p;
}

// Blocks of `kernel` that the card holds at once: the grid of a kernel
// whose warps walk over the seeds (each block stages v once and, in the
// backward, adds its d_v partial once).
template <typename K>
int64_t resident_blocks(K kernel, const Plan& p) {
  if (p.bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(p.bytes));
  }
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.wpb * 32,
                                                p.bytes);
  return static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sms;
}

template <typename T, int VEC, bool STAGE>
void launch_attn_fwd(const Call& c, const Plan& p, int hp) {
  auto kernel = attn_fwd_kernel<T, VEC, STAGE>;
  const int64_t blocks =
      std::min((c.b + p.wpb - 1) / p.wpb, resident_blocks(kernel, p));
  kernel<<<static_cast<unsigned>(blocks), p.wpb * 32, p.bytes, c.s>>>(
      static_cast<const T*>(c.nbr), c.v, c.el, c.ba, c.drop, c.a, c.b, c.e,
      c.din, c.k, c.lda, c.nh, hp, p.pw, p.row_bytes);
}

template <typename T, int VEC, bool STAGE, bool ONE>
void launch_attn_bwd(const Call& c, const Plan& p, int hp) {
  auto kernel = attn_bwd_kernel<T, VEC, STAGE, ONE>;
  const int64_t blocks =
      std::min((c.b + p.wpb - 1) / p.wpb, resident_blocks(kernel, p));
  kernel<<<static_cast<unsigned>(blocks), p.wpb * 32, p.bytes, c.s>>>(
      static_cast<const T*>(c.nbr), c.v, c.el, c.ba, c.drop, c.da, c.a,
      c.d_el, c.dv, c.d_nbr, c.b, c.e, c.din, c.k, c.lda, c.nh, hp, p.pw,
      p.row_bytes);
}

// The attention kernels with 4-wide row loads where the rows allow them,
// the seed's rows staged in shared memory where they fit, and in the
// backward the d_v sums in registers when a lane owns one chunk of a row
// and there are at most kHeads heads.
template <typename T>
int launch_attn(const Call& c, bool bwd) {
  const bool vec = c.din % 4 == 0 && aligned16(c.nbr) && aligned16(c.d_nbr);
  const int hp = (c.nh + kHeads - 1) / kHeads * kHeads;
  const int64_t he = static_cast<int64_t>(hp) * c.e;
  const int64_t hk = static_cast<int64_t>(hp) * c.lda;
  const int64_t rows = vec ? static_cast<int64_t>(c.e) * c.din * sizeof(T) : 0;
  const Plan p = bwd ? plan_attn(hk + 4 * he, 2 * hk, rows)
                     : plan_attn(3 * he, hk, rows);
  if (p.wpb == 0) return -2;
  const bool staged = p.row_bytes > 0;
  if (!bwd) {
    if (!vec) {
      launch_attn_fwd<T, 1, false>(c, p, hp);
    } else if (!staged) {
      launch_attn_fwd<T, 4, false>(c, p, hp);
    } else {
      launch_attn_fwd<T, 4, true>(c, p, hp);
    }
  } else if (!vec) {
    launch_attn_bwd<T, 1, false, false>(c, p, hp);
  } else if (!staged) {
    launch_attn_bwd<T, 4, false, false>(c, p, hp);
  } else if (hp == kHeads && c.din <= 128) {
    launch_attn_bwd<T, 4, true, true>(c, p, hp);
  } else {
    launch_attn_bwd<T, 4, true, false>(c, p, hp);
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

// Parts of the depth b of the d_wn' product so that about `want` blocks run
// in all, each part at least `least` deep.
int depth_splits(int64_t tiles, int64_t b, int64_t want, int64_t least) {
  int64_t splits = (want + tiles - 1) / tiles;
  const int64_t by_depth = (b + least - 1) / least;
  if (splits > by_depth) splits = by_depth;
  return static_cast<int>(splits < 1 ? 1 : splits);
}

// One of the three products on the given route; returns a launch's error.
int launch_product(const Call& c, Part part, int route) {
  using glt_mma::Operand;
  using glt_mma::Product;
  const int b = static_cast<int>(c.b);
  const int64_t bl = c.b * c.lda, bw = c.b * c.w;
  const int64_t kw = static_cast<int64_t>(c.k) * c.w;
  if (part == kProductOut && wgmma_takes(c, route)) {
    // out[h] = a[h] . (wn'[h]^T)^T with wn'^T split ahead by prep
    const int64_t wl = static_cast<int64_t>(c.w) * c.lda;
    return static_cast<int>(glt_wgmma::launch_product(
        glt_wgmma::Product{c.a, c.lda, bl, c.bt_hi, c.bt_lo, c.lda, wl, c.out,
                           c.w, bw, b, c.w, c.lda, c.nh, 1},
        c.s));
  }
  if (route != kRouteFma) {
    const Operand a_rows{c.a, c.lda, bl, b, c.lda};
    const Operand g_rows{c.g, c.w, bw, b, c.w};
    const Operand wn_rows{c.wn, c.w, kw, c.k, c.w};
    if (part == kProductOut) {
      // out[h] = a[h] . wn'[h], the careful grade: out meets a ReLU
      glt_mma::launch_product<true, false, 2, true>(
          Product{a_rows, wn_rows, c.out, c.w, bw, b, c.w, c.k, 1}, c.nh, c.s);
    } else if (part == kProductDa) {
      // d_a[h] = g[h] . wn'[h]^T: wn' read with its rows as the columns
      glt_mma::launch_product<true, true, 4, false>(
          Product{g_rows, wn_rows, c.da, c.lda, bl, b, c.k, c.w, 1}, c.nh,
          c.s);
    } else {
      // d_wn'[h] = a[h]^T . g[h], the depth b in parts that add their
      // partials: about two blocks per SM in all
      const int64_t tiles = static_cast<int64_t>((c.k + 127) / 128) *
                            ((c.w + glt_mma::kBN - 1) / glt_mma::kBN) * c.nh;
      const int splits = depth_splits(tiles, c.b, 264, 4 * glt_mma::kBK);
      glt_mma::launch_product<false, false, 4, false>(
          Product{a_rows, g_rows, c.d_wn, c.w, kw, c.k, c.w, b, splits}, c.nh,
          c.s);
    }
    return 0;
  }
  if (part == kProductOut) {
    launch_gemm(c.a, c.wn, c.out, c.b, c.w, c.k, c.lda, 1, bl, c.w, 1, kw,
                c.w, bw, c.nh, 1, c.s);
  } else if (part == kProductDa) {
    // B(kk = col of wn', n = row of wn')
    launch_gemm(c.g, c.wn, c.da, c.b, c.k, c.w, c.w, 1, bw, 1, c.w, kw, c.lda,
                bl, c.nh, 1, c.s);
  } else {
    // about four blocks per SM in all; always the atomic path
    const int64_t tiles = static_cast<int64_t>((c.k + kTile - 1) / kTile) *
                          ((c.w + kTile - 1) / kTile) * c.nh;
    int splits = depth_splits(tiles, c.b, 528, 512);
    if (splits < 2) splits = 2;
    launch_gemm(c.a, c.g, c.d_wn, c.k, c.w, b, 1, c.lda, bl, c.w, 1, bw, c.w,
                kw, c.nh, splits, c.s);
  }
  return 0;
}

// Launch one part; returns 0, -2, or the launch's CUDA error.
int run_part(const Call& c, Part part, int route) {
  int rc = 0;
  switch (part) {
    case kPrep: {
      const int64_t rows = static_cast<int64_t>(c.nh) * c.k;
      prep_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, c.s>>>(
          c.wn, c.ar, c.v, rows, c.k, c.w);
      if (c.bt_hi != nullptr && wgmma_takes(c, route)) {
        const dim3 grid(static_cast<unsigned>((c.w + 31) / 32),
                        static_cast<unsigned>((c.lda + 31) / 32),
                        static_cast<unsigned>(c.nh));
        split_transposed_kernel<<<grid, dim3(32, 8), 0, c.s>>>(
            c.wn, c.bt_hi, c.bt_lo, c.k, c.lda, c.w);
      }
      break;
    }
    case kAttnFwd:
    case kAttnBwd:
      rc = c.nbr_dtype == 0
               ? launch_attn<float>(c, part == kAttnBwd)
               : launch_attn<__nv_bfloat16>(c, part == kAttnBwd);
      break;
    case kProductOut:
    case kProductDa:
    case kProductDwn:
      rc = launch_product(c, part, route);
      break;
    case kTail: {
      const dim3 grid(static_cast<unsigned>((c.k + kTailRows - 1) / kTailRows),
                      static_cast<unsigned>(c.nh));
      tail_kernel<<<grid, 256, 0, c.s>>>(c.wn, c.ar, c.dv, c.d_wn, c.d_ar,
                                         c.k, c.w);
      break;
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

int run_parts(const Call& c, const Part* parts, int n, int route) {
  for (int i = 0; i < n; ++i) {
    const int rc = run_part(c, parts[i], route);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// what: -1 the forward (prep, attention, out product), -2 the backward
// (d_a product, attention backward, d_wn' product, tail), 0..6 one Part
// alone (for timing: its inputs must have been made by the parts before
// it, and a lone kProductDwn or kTail adds into d_wn / d_ar as they are).
// force_route: 0 = the route the shape gives, 1 = tensor cores (needs W % 4
// == 0), 2 = the FMA product, 3 = tensor cores without the wgmma kernel
// (every product on mma.sync).  *route receives the route the products
// took (1 or 2; 0 when nothing was launched), plus 4 when the forward's
// product ran on the wgmma kernel.  The pointers and sizes are those of
// struct Call; bt_hi and bt_lo may be null for anything but the forward,
// kPrep and kProductOut on the route that takes wgmma.  Returns 0, the
// first CUDA error of a launch, -1 for an unknown dtype, `what` or route
// or missing scratch, or -2 when the scratch of one warp does not fit in
// shared memory.
extern "C" int glt_gat_block(int what, int force_route, const void* nbr,
                             int nbr_dtype, const float* wn, const float* ar,
                             const float* el, const float* ba,
                             const float* drop, const float* g, float* v,
                             float* a, float* da, float* dv, float* bt_hi,
                             float* bt_lo, float* out, float* d_nbr,
                             float* d_wn, float* d_ar, float* d_el, int* route,
                             long long b, int e, int din, int k, int lda,
                             int nh, int w, void* stream) {
  *route = 0;
  if (nbr_dtype < 0 || nbr_dtype > 1 || what < -2 || what > kTail) return -1;
  if (force_route < 0 || force_route > kRouteMma) return -1;
  if (force_route != 0 && force_route != kRouteFma && w % 4 != 0) return -1;
  if (lda < k || lda % 4 != 0) return -1;
  if (nh <= 0 || w <= 0) return 0;
  const Call c{nbr,   nbr_dtype, wn,  ar,    el,   ba,   drop, g,   v,  a,
               da,    dv,        bt_hi, bt_lo, out,  d_nbr, d_wn, d_ar, d_el,
               b,     e,         din, k,     lda,  nh,   w,
               static_cast<cudaStream_t>(stream)};
  const int r = force_route != 0 ? force_route : route_of(c);
  const bool fwd_product = what == -1 || what == kProductOut;
  const bool wgmma = fwd_product && wgmma_takes(c, r);
  if (wgmma && (bt_hi == nullptr || bt_lo == nullptr)) return -1;
  const int took = (r == kRouteFma ? kRouteFma : kRouteTensor) +
                   (wgmma ? kUsedWgmma : 0);
  if (what >= 0) {
    if (b <= 0) return 0;
    *route = took;
    return run_part(c, static_cast<Part>(what), r);
  }
  if (what == -1) {
    if (b <= 0) return 0;
    *route = took;
    const Part parts[] = {kPrep, kAttnFwd, kProductOut};
    return run_parts(c, parts, 3, r);
  }
  cudaMemsetAsync(d_wn, 0, sizeof(float) * nh * k * w, c.s);
  cudaMemsetAsync(dv, 0, sizeof(float) * nh * k, c.s);
  cudaMemsetAsync(d_ar, 0, sizeof(float) * nh * w, c.s);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (b > 0) {
    *route = took;
    const Part parts[] = {kPrep, kProductDa, kAttnBwd, kProductDwn};
    rc = run_parts(c, parts, 4, r);
    if (rc != 0) return rc;
  }
  return run_part(c, kTail, r);
}
