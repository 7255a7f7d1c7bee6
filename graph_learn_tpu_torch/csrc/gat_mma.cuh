// Batched matrix product on Hopper's tensor cores in split TF32 ("3xTF32")
// with mma.sync, for the products of the GAT block (csrc/gat.cu): the
// backward's two at any shape, and the forward's where its depth is too
// large for the wgmma kernel (csrc/gat_wgmma.cuh):
//
//   C[z] (+)= A[z] . B[z],   f32 in, f32 out, z = head
//
// Why split.  A TF32 operand keeps 10 mantissa bits, so one tensor-core pass
// is good to about three digits; the block is held to 2e-4 of each tensor's
// largest value at depths up to 15 360.  Each f32 operand x is therefore cut
// in registers into a TF32 number hi and the rest lo = x - hi (exact in f32;
// the tensor core reads its upper 19 bits), and a product is three
// mma.sync.m16n8k8 passes into the same f32 accumulators, small terms first:
// lo.hi + hi.lo + hi.hi.  The lo.lo term, about 2^-22 of a term, is dropped.
//
// Two grades (template flag FOLD).  The tensor core does not round the sums
// it adds into an accumulator, it cuts them short, so a long chain of MMAs
// into one accumulator drifts to one side: measured on the H100 at depth
// 128 to 15 360, 1e-6 to 6e-6 of the largest value against a float64
// product, where f32 FMAs are at 4e-7.  Plain grade: hi is x with its low
// bits cleared and all MMAs chain into the accumulators; for the backward's
// two products.  FOLD grade: hi is rounded to nearest, the twelve MMAs of
// one depth step chain into a second set of accumulators that starts at
// zero, and the step is added to the total with an f32 add (3e-7 measured);
// for the forward's product, whose output passes a ReLU in the model, where
// an error of 1e-6 flipped the sign of one value in four million and with
// it one step's gradients by 3e-3.  FOLD costs registers, so its block is
// 64 rows high (MI = 2) where the plain grade's is 128 (MI = 4).
//
// Layout.  Either operand may be stored with the depth contiguous (kc: rows
// of memory are rows of A / columns of B) or with the depth as its rows (rows
// of memory are depth steps; A is then read transposed).  A block owns a
// 32 MI x 128 tile of C and walks the depth in steps of 32 through a ring of
// three shared-memory stages filled by 16-byte cp.async, so loads overlap
// the MMAs; chunks outside an operand are zero-filled by cp.async's source
// size, never read.  Tiles keep memory's orientation; their row strides
// (32 + 4 floats with the depth contiguous, rows + 8 otherwise) make every
// fragment read of a warp hit 32 different banks.  Eight warps, 2 x 4, each
// a 16 MI x 32 corner: MI x 4 MMA tiles, 16 MI accumulators a thread; two
// blocks an SM (at most 128 registers a thread).
//
// The depth may be split over blockIdx.z (the d_wn' product, depth b): each
// part adds its register tile with red.global.add.v2.f32 into a C that
// starts at zero, so the sums arrive in an order that changes from run to
// run.
//
// Needs: every operand's contiguous extent (`cols`) and leading dimension a
// multiple of 4 floats and its base 16-byte aligned; ldc even.  A depth-
// contiguous operand whose true depth is not a multiple of 4 must carry
// zeros up to the next multiple, and the other operand must then have the
// depth as its rows (those rows are zero-filled here).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace glt_mma {

#if defined(__CUDACC_VER_MAJOR__) &&   \
    (__CUDACC_VER_MAJOR__ > 12 ||      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define GLT_MMA_VECTOR_RED 1  // atomicAdd(float2*), sm_90, CUDA 12.1
#else
#define GLT_MMA_VECTOR_RED 0
#endif

constexpr int kBN = 128, kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStrideK = kBK + 4;  // tile row stride, depth contiguous

// Floats of one staged tile of `rows` rows or columns of C, either layout
// (depth as rows: kBK rows of rows + 8 floats).
__host__ __device__ constexpr int tile_floats(int rows) {
  return rows * kStrideK > kBK * (rows + 8) ? rows * kStrideK
                                            : kBK * (rows + 8);
}

__host__ __device__ constexpr int smem_bytes(int bm) {
  return kStages * (tile_floats(bm) + tile_floats(kBN)) * 4;
}

// A row-major [rows, cols] f32 matrix per head; cols % 4 == 0, ld % 4 == 0.
struct Operand {
  const float* p;
  int64_t ld;
  int64_t batch;  // floats between heads
  int rows;
  int cols;
};

struct Product {
  Operand a, b;
  float* c;
  int64_t ldc;
  int64_t c_batch;
  int m, n;    // extent of C that is stored
  int depth;
  int splits;  // parts of the depth; > 1: partials are added into C
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ROWS (rows or columns of C) x 32 (depth) tile of an operand into
// shared memory: ROWS * 8 chunks of 16 bytes, ROWS / 32 a thread.
template <bool KC, int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const Operand& o,
                                          const float* base, int mn0, int kk0,
                                          int k1, int tid) {
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int id = tid + i * kThreads;
    int r, c, at;
    bool ok;
    if (KC) {
      const int tr = id >> 3, tc = (id & 7) * 4;
      r = mn0 + tr;
      c = kk0 + tc;
      at = tr * kStrideK + tc;
      ok = r < o.rows && c < o.cols && c < k1;
    } else {
      const int tr = id / (ROWS / 4), tc = (id % (ROWS / 4)) * 4;
      r = kk0 + tr;
      c = mn0 + tc;
      at = tr * (ROWS + 8) + tc;
      ok = r < o.rows && r < k1 && c < o.cols;
    }
    const float* src = ok ? base + static_cast<int64_t>(r) * o.ld + c : base;
    cp_async16(tile + at, src, ok ? 16 : 0);
  }
}

// Element (row or column of C `mn`, depth step `kk`) of a staged tile.
template <bool KC, int ROWS>
__device__ __forceinline__ float tile_at(const float* tile, int mn, int kk) {
  return KC ? tile[mn * kStrideK + kk] : tile[kk * (ROWS + 8) + mn];
}

// x = hi + lo with hi a TF32 number and lo = x - hi, exact in f32; the
// tensor core reads lo's upper 19 bits.  ROUND: hi is x rounded to nearest
// (ties away from zero, in integer arithmetic: cvt.rna.tf32 gives the same
// bits at a quarter of the rate), so lo has either sign; else hi is x with
// its low 13 bits cleared, one instruction less, and lo has x's sign.
template <bool ROUND>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + (ROUND ? 0x1000u : 0u)) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two neighbouring columns of one row of C: stored, or added to C.
__device__ __forceinline__ void put2(float* dst, float v0, float v1, int left,
                                     bool vec, bool add) {
  if (left <= 0) return;
  if (add) {
#if GLT_MMA_VECTOR_RED
    if (vec && left > 1) {
      atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
      return;
    }
#endif
    atomicAdd(dst, v0);
    if (left > 1) atomicAdd(dst + 1, v1);
  } else if (vec && left > 1) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (left > 1) dst[1] = v1;
  }
}

template <bool AKC, bool BKC, int MI, bool FOLD>
__global__ void __launch_bounds__(kThreads, 2)
    product_kernel(const Product p) {
  constexpr int BM = 32 * MI;  // two warps down the tile, MI MMA tiles each
  constexpr int kATile = tile_floats(BM), kBTile = tile_floats(kBN);
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z / p.splits, part = blockIdx.z % p.splits;
  const int chunk = ((p.depth + p.splits - 1) / p.splits + kBK - 1) / kBK * kBK;
  const int k0 = part * chunk;
  const int k1 = min(p.depth, k0 + chunk);
  if (k0 >= k1) return;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const float* a = p.a.p + static_cast<int64_t>(z) * p.a.batch;
  const float* bm = p.b.p + static_cast<int64_t>(z) * p.b.batch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 1) * (16 * MI), wn = (warp >> 1) * 32;
  const int steps = (k1 - k0 + kBK - 1) / kBK;

  float acc[MI][4][4] = {};

  auto stage_a = [&](int s) { return smem + s * (kATile + kBTile); };
  auto stage_b = [&](int s) { return smem + s * (kATile + kBTile) + kATile; };
  auto load = [&](int step) {
    const int s = step % kStages;
    load_tile<AKC, BM>(stage_a(s), p.a, a, m0, k0 + step * kBK, k1, tid);
    load_tile<BKC, kBN>(stage_b(s), p.b, bm, n0, k0 + step * kBK, k1, tid);
  };
  // the MMAs of one staged step (depth 32) into dst
  auto multiply = [&](const float* as, const float* bs,
                      float (&dst)[MI][4][4]) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // the m16n8k8 A fragment: rows g, g + 8; depth steps t, t + 4
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = tile_at<AKC, BM>(as, wm + mi * 16 + g + (q & 1) * 8,
                                           kk + t + (q >> 1) * 4);
          split_tf32<FOLD>(x, ah[mi][q], al[mi][q]);
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // the B fragment: column g; depth steps t, t + 4
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float x =
              tile_at<BKC, kBN>(bs, wn + ni * 8 + g, kk + t + q * 4);
          split_tf32<FOLD>(x, bh[ni][q], bl[ni][q]);
        }
      }
      // one pass over all the tiles at a time: two MMAs into the same
      // accumulators are then 4 * MI instructions apart
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            mma_tf32(dst[mi][ni], pass == 0 ? al[mi] : ah[mi],
                     pass == 1 ? bl[ni] : bh[ni]);
          }
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage read at step - 1 is free now: refill it
    if (step + kStages - 1 < steps) load(step + kStages - 1);
    cp_async_commit();
    const float* as = stage_a(step % kStages);
    const float* bs = stage_b(step % kStages);
    if constexpr (FOLD) {
      // the tensor core cuts its sums short (it does not round them), so a
      // long chain of MMAs into one accumulator drifts to one side: chain
      // only this step's twelve, and add the step to the total in f32
      float part_sum[MI][4][4] = {};
      multiply(as, bs, part_sum);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part_sum[mi][ni][r];
        }
      }
    } else {
      multiply(as, bs, acc);
    }
  }
  cp_async_wait<0>();

  float* c = p.c + static_cast<int64_t>(z) * p.c_batch;
  const bool vec = ((p.ldc | p.c_batch) & 1) == 0;
  const bool add = p.splits > 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= p.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t;
        put2(c + static_cast<int64_t>(row) * p.ldc + col,
             acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1], p.n - col,
             vec, add);
      }
    }
  }
}

// Launch the product over `batch` heads on stream s.
template <bool AKC, bool BKC, int MI, bool FOLD>
void launch_product(const Product& p, int batch, cudaStream_t s) {
  constexpr int BM = 32 * MI;
  cudaFuncSetAttribute(product_kernel<AKC, BKC, MI, FOLD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes(BM));
  const dim3 grid(static_cast<unsigned>((p.m + BM - 1) / BM),
                  static_cast<unsigned>((p.n + kBN - 1) / kBN),
                  static_cast<unsigned>(batch * p.splits));
  product_kernel<AKC, BKC, MI, FOLD>
      <<<grid, kThreads, smem_bytes(BM), s>>>(p);
}

}  // namespace glt_mma
