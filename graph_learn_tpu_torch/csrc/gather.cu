// Feature-row gather for Hopper (sm_90a): out[m] = table[idx[m]].
//
// Replaces the Pallas kernel graph_learn_tpu/ops/pallas/gather.py
// gather_rows (_gather_kernel), which streams rows HBM -> VMEM with 16
// per-row DMAs in flight and pads the indices to 4096-row blocks.
//
// Bound: bytes.  The kernel reads M rows of D*itemsize bytes at random
// rows of the table and writes them once, contiguously; there is no
// arithmetic.  At the serving path's deepest hop (M = 153 600 rows of a
// [200 000, 128] bf16 table) that is about 78.6 MB moved.
//
// Design: a group of `tpr` lanes copies one row (tpr = the power of two
// that covers the row's vectors, at most a warp), so a 256-byte bf16 row
// takes 16 lanes and a warp keeps two rows in flight.  Each lane moves
// 16-byte vectors where the row size and both base pointers allow it, else
// 8, 4, 2 or 1 bytes: the copy is bitwise and works for any dtype and any
// D.  No padding of M: each thread masks its own row.  Row offsets are
// computed in int64.  The indices must already lie in [0, N): the caller
// (ops/kernels/dispatch.py feature_gather) clips them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t m,
                                   int64_t vecs, int tpr_log2) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t row = t >> tpr_log2;
  if (row >= m) return;
  const int64_t lane = t & ((1 << tpr_log2) - 1);
  const V* src = table + static_cast<int64_t>(idx[row]) * vecs;
  V* dst = out + row * vecs;
  for (int64_t c = lane; c < vecs; c += (int64_t{1} << tpr_log2)) {
    dst[c] = src[c];
  }
}

template <typename V>
void launch(const void* table, const void* idx, void* out, int64_t m,
            int64_t row_bytes, cudaStream_t stream) {
  const int64_t vecs = row_bytes / static_cast<int64_t>(sizeof(V));
  int tpr_log2 = 0;
  while (tpr_log2 < 5 && (int64_t{1} << tpr_log2) < vecs) ++tpr_log2;
  const int block = 256;
  const int64_t threads = m << tpr_log2;
  const int64_t grid = (threads + block - 1) / block;
  gather_rows_kernel<V><<<static_cast<unsigned>(grid), block, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), m, vecs, tpr_log2);
}

}  // namespace

// table [N, row_bytes] (any dtype), idx [m] int32, out [m, row_bytes].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int glt_gather_rows(const void* table, const void* idx, void* out,
                               long long m, long long row_bytes,
                               void* stream) {
  if (m <= 0 || row_bytes <= 0) return 0;
  int vb = 16;
  while (vb > 1 && (row_bytes % vb != 0 ||
                    reinterpret_cast<uintptr_t>(table) % vb != 0 ||
                    reinterpret_cast<uintptr_t>(out) % vb != 0)) {
    vb >>= 1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vb) {
    case 16: launch<uint4>(table, idx, out, m, row_bytes, s); break;
    case 8: launch<uint2>(table, idx, out, m, row_bytes, s); break;
    case 4: launch<uint32_t>(table, idx, out, m, row_bytes, s); break;
    case 2: launch<uint16_t>(table, idx, out, m, row_bytes, s); break;
    default: launch<uint8_t>(table, idx, out, m, row_bytes, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
