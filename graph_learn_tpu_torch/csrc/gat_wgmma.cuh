// The forward's matrix product of the GAT block (csrc/gat.cu) on Hopper's
// warpgroup tensor-core instruction (wgmma.mma_async, sm_90a) in split TF32
// ("3xTF32"):
//
//   C[z] = A[z] . B[z]^T,   A [m, depth] f32 (the attention-weighted sums
//                           `a`), B [n, depth] given as two TF32-valued f32
//                           matrices hi and lo = B - hi (the transposed
//                           weights, written by prep_kernel once a call)
//
// Why this shape.  TF32 wgmma takes B only from shared memory, with the
// depth contiguous, and reads it as it lies there: so B is split ahead of
// the product and A, the long operand, is staged as plain f32, taken into
// registers with ldmatrix, split there and fed to wgmma as its register
// operand.  One depth step of 8 is three wgmmas into the same accumulators,
// small terms first: lo.hi + hi.lo + hi.hi (lo.lo, about 2^-22 of a term,
// is dropped).  As in gat_mma.cuh's FOLD grade, hi is rounded to nearest,
// the twelve wgmmas of one stage (depth 32) start from zero, and the stage
// is added to the total with f32 adds: the tensor core cuts the sums it
// adds into an accumulator short, and a long chain drifts to one side.
//
// What bounds it: the bytes a block pulls in, not the tensor cores.  A
// first version staged A, B hi and B lo for every step (48 KB a step from
// L2 for 2.1e6 operations; measured 0.146 ms at the block's full shape, no
// better than mma.sync).  So a block keeps B of its 128 columns, the whole
// depth (at most 128: 128 KB), in shared memory and walks over row tiles
// only; a step loads 16 KB of A and nothing else (0.098 ms measured).
// blockIdx.x = (head * column tiles + column tile) * groups + group; a
// group takes every groups-th row tile, and the launcher picks as many
// groups as fill the card once.
//
// A block is two warpgroups, each 64 rows of a 128 x 128 tile of C
// (m64n128k8, 64 accumulators a thread and 64 more for the stage's sums).
// A comes through a ring of six 16 KB stages filled by 16-byte cp.async
// four steps ahead; the ring runs on across tile boundaries, and a tile is
// stored while the next one's first wgmmas run.  Rows of a tile are 128
// bytes with the 16-byte chunks XOR-swizzled by the row (the tensor core's
// 128-byte swizzle for B; the same for A, which makes ldmatrix conflict-
// free); chunks outside an operand are zero-filled by cp.async's source
// size, never read.  The fragments of a step are split while the wgmmas of
// the step before are still running (two register sets, the loop unrolled
// by two).
//
// Needs: depth <= 128 and a multiple of 4 (pad with zeros), lda % 4 == 0,
// ldb % 4 == 0, bases 16-byte aligned.  One block an SM (222 registers a
// thread, 225 KB of shared memory).

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "gat_mma.cuh"

namespace glt_wgmma {

using glt_mma::cp_async_commit;
using glt_mma::cp_async_wait;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;
constexpr int kTileBytes = 128 * kBK * 4;  // one operand tile: 16 KB
constexpr int kMaxDepth = 4 * kBK;         // the deepest B a block keeps
constexpr int kBTiles = 2 * kMaxDepth / kBK;  // hi and lo of every step
constexpr int kStages = 6;                 // of A
// the tiles are aligned to 1 KB inside the block's dynamic shared memory
constexpr int kSmemBytes = (kBTiles + kStages) * kTileBytes + 1024;

struct Product {
  const float* a;  // [batch][m, lda]
  int64_t lda, a_batch;
  const float *b_hi, *b_lo;  // [batch][n, ldb]
  int64_t ldb, b_batch;
  float* c;  // [batch][m, ldc]
  int64_t ldc, c_batch;
  int m, n, depth, batch;
  int groups;  // blocks that share one (head, column tile)
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// What the threads wrote into shared memory (cp.async) made visible to the
// tensor core's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The compiler does not know that a wgmma reads and writes its registers
// after the instruction has started: these keep a value alive (and in place)
// up to the point where the wgmmas are known to be done.
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor of a tile with the depth contiguous,
// rows of 128 bytes, 128-byte swizzle: start address, leading offset 1
// (unused for this layout), 1024 bytes between groups of eight rows.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (+)= a . b: 64 x 128 x 8, A from registers, B by descriptor; with
// scale_d 0 d starts from zero.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// The split A fragments of one stage: four depth steps of 8.
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};

// Which row tile and depth step a block's flattened step number means.
struct Where {
  int m0, k0;
  bool last;  // the tile's last depth step
};

// A thread's share of a warpgroup's 64 x 128 accumulators into C: rows
// `row` and `row` + 8 of the tile, two neighbouring columns of every eighth.
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           const Product& p, int z, int m0,
                                           int n0, int row, int t) {
  float* c = p.c + z * p.c_batch;
  const bool vec = ((p.ldc | p.c_batch) & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + row + half * 8;
    if (r >= p.m) continue;
    float* out = c + static_cast<int64_t>(r) * p.ldc;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      const float v0 = acc[4 * j + 2 * half];
      const float v1 = acc[4 * j + 2 * half + 1];
      if (vec && col + 1 < p.n) {
        *reinterpret_cast<float2*>(out + col) = make_float2(v0, v1);
      } else {
        if (col < p.n) out[col] = v0;
        if (col + 1 < p.n) out[col + 1] = v1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    product_kernel(const Product p) {
  extern __shared__ uint8_t smem_raw[];
  // B hi and lo of depth step ks at tiles 2 ks and 2 ks + 1, then A's ring
  const uint32_t smem = (shared_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = smem + kBTiles * kTileBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (p.m + kBM - 1) / kBM, nt = (p.n + kBN - 1) / kBN;
  const int ksteps = (p.depth + kBK - 1) / kBK;
  const int group = blockIdx.x % p.groups, zn = blockIdx.x / p.groups;
  const int z = zn / nt, n0 = (zn % nt) * kBN;
  const int total = (mt - group + p.groups - 1) / p.groups * ksteps;

  auto where = [&](int step) {
    Where w;
    w.m0 = (group + step / ksteps * p.groups) * kBM;
    w.k0 = step % ksteps * kBK;
    w.last = w.k0 == (ksteps - 1) * kBK && step < total;
    return w;
  };
  // 128 rows x 32 floats of a row-major matrix from (row0, col0) into a
  // swizzled tile, zero outside [rows, depth]
  auto load_tile = [&](uint32_t tile, const float* base, int64_t ld, int row0,
                       int rows, int col0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads;
      const int r = id >> 3, c = id & 7;
      const int col = col0 + c * 4;
      const bool ok = col < p.depth && row0 + r < rows;
      const float* src =
          ok ? base + static_cast<int64_t>(row0 + r) * ld + col : base;
      cp_async16(tile + swizzled(r, c), src, ok ? 16 : 0);
    }
  };
  // A's loads of one step, always one commit group
  auto prefetch = [&](int step) {
    if (step < total) {
      const Where w = where(step);
      load_tile(ring + static_cast<uint32_t>(step % kStages) * kTileBytes,
                p.a + z * p.a_batch, p.lda, w.m0, p.m, w.k0);
    }
    cp_async_commit();
  };
  for (int ks = 0; ks < ksteps; ++ks) {
    load_tile(smem + 2 * ks * kTileBytes, p.b_hi + z * p.b_batch, p.ldb, n0,
              p.n, ks * kBK);
    load_tile(smem + (2 * ks + 1) * kTileBytes, p.b_lo + z * p.b_batch, p.ldb,
              n0, p.n, ks * kBK);
  }
  cp_async_commit();

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  Frags f[2];
  Where prev = where(0);
  prev.last = false;

  // this warp's rows of the stage: the warpgroup's 64, the warp's 16
  const int warp_row = (warp >> 2) * 64 + (warp & 3) * 16;
  const int frag_row = warp_row + (lane & 15);

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) prefetch(s);
  // Step `step` splits its A fragments into f[u] while the wgmmas of the
  // step before (fragments f[1 - u]) may still be running, waits for
  // those, adds their sums to the total and starts its own; a finished tile
  // is stored one step late, while the next tile's first wgmmas run.  Every
  // step runs the same instructions, wgmmas included, with no branch around
  // them (the compiler puts a wait wherever registers that a wgmma writes
  // meet at a join): the one or two steps past the last only drain the
  // pipeline, and what they multiply is never stored.
  const int rounds = (total + 2) & ~1;
  for (int step0 = 0; step0 < rounds; step0 += 2) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int step = step0 + u;
      const Where w = where(step);
      const uint32_t st =
          ring + static_cast<uint32_t>(step % kStages) * kTileBytes;
      const uint32_t bt = smem + (w.k0 / kBK) * 2 * kTileBytes;
      cp_async_wait<kStages - 3>();
      fence_proxy_async();
      __syncthreads();
      // the stage of step - 2: every warp has waited for its wgmmas
      prefetch(step + kStages - 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t raw[4];
        ldmatrix_x4(raw, st + swizzled(frag_row, 2 * kk + (lane >> 4)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // hi the nearest TF32 number
          glt_mma::split_tf32<true>(__uint_as_float(raw[q]), f[u].hi[kk][q],
                                    f[u].lo[kk][q]);
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          keep(f[0].hi[kk][q]);
          keep(f[0].lo[kk][q]);
          keep(f[1].hi[kk][q]);
          keep(f[1].lo[kk][q]);
        }
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        keep(part[i]);
        acc[i] += part[i];
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = descriptor(bt + kk * 32);
        const uint64_t dl = descriptor(bt + kTileBytes + kk * 32);
        wgmma_m64n128k8(part, f[u].lo[kk], dh, kk != 0);
        wgmma_m64n128k8(part, f[u].hi[kk], dl, 1);
        wgmma_m64n128k8(part, f[u].hi[kk], dh, 1);
      }
      wgmma_commit();
      if (prev.last) {
        store_tile(acc, p, z, prev.m0, n0, warp_row + g, t);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
      prev = w;
    }
  }
  wgmma_wait_all();
  cp_async_wait<0>();
}

// Launch the product on stream s; as many groups as fill the card once.
inline cudaError_t launch_product(Product p, cudaStream_t s) {
  const int mt = (p.m + kBM - 1) / kBM, nt = (p.n + kBN - 1) / kBN;
  if (p.batch <= 0 || mt <= 0 || nt <= 0 || p.depth <= 0) return cudaSuccess;
  if (p.depth > kMaxDepth) return cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(
      product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (rc != cudaSuccess) return rc;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.groups = std::min(std::max(sms / (p.batch * nt), 1), mt);
  const unsigned grid = static_cast<unsigned>(p.batch * nt * p.groups);
  product_kernel<<<grid, kThreads, kSmemBytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace glt_wgmma
