// The warp-level bf16 tensor-core product shared by the union-block kernels
// (union_scan.cu, fused_proto.cu, kernel_probe.cu): 16 * MT rows of a row
// tile against 32 queries, both bf16 in shared memory, into float32
// accumulators. A bf16 x bf16 product is exact in float32, so only the
// order of the sum differs from an FMA loop over the same values.
#pragma once

#include <cuda_bf16.h>

#include "async_copy.cuh"

// The lane's ldmatrix addresses: rows (16 * MT of them, row stride ld) for
// the A operand, and the warp's 32 queries (row stride ld) for B.
__device__ __forceinline__ const __nv_bfloat16* mma_rows_ptr(const __nv_bfloat16* rows, int ld,
                                                             int lane) {
  return rows + (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* mma_queries_ptr(const __nv_bfloat16* queries,
                                                                int ld, int lane) {
  return queries + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}

// acc[mt][nt] += rows[16 mt .. +15] . queries[8 nt .. +7]^T over d columns
// (d a multiple of 16), from the lane pointers above. Per 16 columns: MT + 2
// ldmatrix.x4 and 4 MT mma.sync m16n8k16. Element e of tile (mt, nt) is row
// 16 mt + lane / 4 + 8 (e >> 1), query 8 nt + 2 (lane % 4) + (e & 1).
template <int MT>
__device__ __forceinline__ void warp_tile_product(float (&acc)[MT][4][4], const __nv_bfloat16* A,
                                                  const __nv_bfloat16* B, int ld, int d) {
#pragma unroll 4
  for (int kk = 0; kk < d; kk += 16) {
    unsigned a[MT][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], A + mt * 16 * ld + kk);
    ldmatrix_x4(b[0], B + kk);            // queries 0-15 of the warp's 32
    ldmatrix_x4(b[1], B + 16 * ld + kk);  // queries 16-31
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16_16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
  }
}
