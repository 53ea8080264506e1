// PQ decode: (n, m) uint8 codes -> (n, m * dsub) rows of the codebook's type.
//
// Replaces the TPU kernel rag_faiss_embedding_tpu/ops/pallas_pq.py::
// _decode_kernel (reached through pallas_pq.decode). Same result (the
// wrapper is ops/pq_decode.py):
//   out[r, s*dsub : (s+1)*dsub] = codebook[s, codes[r, s], :]
// The TPU kernel builds one-hot tiles and multiplies them by a block-diagonal
// grouped bf16 codebook on the MXU, because the TPU has no fast gather; one
// 1.0 times a bf16 value, summed in f32, rounds back to that value, so it
// emits the codeword exactly. The card gathers, so this kernel is a gather,
// bit-exact with the plain gather (decode_reference). It copies bytes, so
// one template serves bf16 codebooks (compute "bf16") and f32 ones
// (compute "f32"): the type only sets the byte width of a subvector.
//
// What bounds it on an H100: writes. A row is m bytes in and 2 * D bytes out
// (48 B against 768 B at D = 384, m = 48, bf16), so 1,048,576 rows write
// 805 MB: about 0.24 ms at 3.35 TB/s. Its paths launch it on 4,096 to
// 524,288 rows (a shard's union: 16,384; the 10M IVF-PQ's union segments:
// 180,224 to 360,448), where a launch writes 3-280 MB: there what a block
// does before its first store, and the host's launch, set much of the time.
//
// Design. The plan (subspace groups, rows per tile, threads, grid, staging)
// is chosen in Python from N and the codebook's shape (ops/pq_decode.plan)
// and handed in as an int array; a launch makes no CUDA call but the launch
// and cudaGetLastError (the shared-memory opt-in is cached per kernel and
// card by launch.cuh's prepare_on).
// - Gather source. Outside a band of N the codebook (at most 384 KiB) is
//   read where it lies, through L2 and L1 (__ldg): with no shared memory in
//   use, an SM's L1 holds a bf16 codebook whole, and small blocks keep
//   enough warps in flight to fill the write bandwidth. Inside the band
//   (thousands to tens of thousands of rows) the L1s are cold and every
//   gather would miss, so each block first copies its subspace group's
//   slice (24 KiB: a second grid dimension splits the subspaces) into shared
//   memory with cp.async, then walks its row tiles (ops/pq_decode.py holds
//   the measured ends of the band).
// - Lanes map to output chunks: consecutive threads take consecutive
//   VB-byte chunks of a row (VB = 16 where the subvector width and the
//   pointers allow), so a warp writes one contiguous span at any subvector
//   width (16-byte bf16 subvectors and 32-byte f32 ones alike). Each thread
//   keeps its column for the whole launch and walks rows, so the column's
//   subspace and offset are computed once.
// - Stores are evict-first (st.global.cs): the rows stream through L2
//   without pushing out the codebook that the gathers read there.
// - Tried and dropped (PERF.md): assembling tiles of rows in shared
//   memory and writing each with one Hopper bulk copy (cp.async.bulk),
//   double-buffered, lost to the threads' own stores at every shape (0.52
//   against 0.31 ms at 1M rows, bf16): a tile's copy waits for a barrier
//   after its gather, the threads' stores leave as each chunk arrives.
// Codes are read straight from global memory (32 consecutive bytes a warp).
// A code >= ksub is outside the contract; it is clamped so a bad input
// cannot read past the codebook.
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch.cuh"

#define MAX_THREADS 1024

template <int VB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned int; };
template <> struct Vec<2> { using T = unsigned short; };

// Copy n bytes global -> shared (dst 16-byte aligned) with every thread of
// the block: cp.async 16-byte copies where the source is aligned, bytes
// otherwise. Ends in a barrier.
__device__ inline void stage_bytes(uint8_t* __restrict__ dst,
                                   const uint8_t* __restrict__ src, size_t n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t nv = n >> 4;
    for (size_t i = threadIdx.x; i < nv; i += blockDim.x)
      cp_async16(dst + (i << 4), src + (i << 4), true);
    cp_async_commit();
    for (size_t i = (nv << 4) + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
    cp_async_wait<0>();
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
  __syncthreads();
}

// grid (row-tile walkers, subspace groups); block = rp rows x tw columns of
// VB-byte chunks. Group g decodes subspaces [g * mg, min(m, (g + 1) * mg))
// of every row; sub_bytes = dsub * size. STAGED: the group's codebook slice
// is copied into dynamic shared memory first.
template <int VB, bool STAGED>
__global__ void __launch_bounds__(MAX_THREADS, 2)
pq_decode_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ cb,
                 uint8_t* __restrict__ out, int n, int m, int ksub, int sub_bytes, int mg,
                 int tile_rows, int tw) {
  extern __shared__ __align__(16) uint8_t smem[];
  using V = typename Vec<VB>::T;
  const int m0 = blockIdx.y * mg;
  const int mg_here = min(mg, m - m0);
  const int cps = sub_bytes / VB;      // chunks per subvector
  const int ipr = mg_here * cps;       // chunks per row of this group
  const int out_row = m * sub_bytes;
  const int word_bytes = ksub * sub_bytes;  // one subspace's codebook
  const uint8_t* book = cb + (size_t)m0 * word_bytes;
  if constexpr (STAGED) {
    stage_bytes(smem, book, (size_t)mg_here * word_bytes);
    book = smem;
  }
  const int rp = blockDim.x / tw;
  const int tr = threadIdx.x / tw, tc = threadIdx.x - tr * tw;
  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int r0 = t * tile_rows;
    const int rows = min(tile_rows, n - r0);
    uint8_t* dst0 = out + (size_t)r0 * out_row + (size_t)m0 * sub_bytes;
    const uint8_t* code0 = codes + (size_t)r0 * m + m0;
    for (int j = tc; j < ipr; j += tw) {
      const int s = j / cps;
      const int part = (j - s * cps) * VB;
      const uint8_t* src = book + (size_t)s * word_bytes + part;
      uint8_t* dst = dst0 + s * sub_bytes + part;
#pragma unroll 4
      for (int r = tr; r < rows; r += rp) {
        const int c = min((int)__ldg(code0 + (size_t)r * m + s), ksub - 1);
        const V* p = reinterpret_cast<const V*>(src + c * sub_bytes);
        V v;
        if constexpr (STAGED) v = *p;
        else v = __ldg(p);
        __stcs(reinterpret_cast<V*>(dst + (size_t)r * out_row), v);  // evict-first
      }
    }
  }
}

template <bool STAGED>
static const void* kernel_for(int vb) {
  switch (vb) {
    case 16: return (const void*)pq_decode_kernel<16, STAGED>;
    case 8: return (const void*)pq_decode_kernel<8, STAGED>;
    case 4: return (const void*)pq_decode_kernel<4, STAGED>;
    default: return (const void*)pq_decode_kernel<2, STAGED>;
  }
}

// The plan's fields, in the order of ops/pq_decode._PLAN_FIELDS.
enum {
  P_M, P_KSUB, P_DSUB, P_ESIZE, P_DEVICE, P_STAGED, P_GROUPS, P_MG, P_TILE_ROWS, P_TW,
  P_THREADS, P_GRID_X, P_SMEM, P_FIELDS
};

extern "C" {

const char* rfe_pq_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// codes (n, m) uint8, contiguous; cb (m, ksub, dsub) of esize-byte values,
// contiguous; out (n, m * dsub) of the same type, contiguous. plan: the
// fields above, from ops/pq_decode.plan; device: the current device, which
// holds the operands. n == 0 launches nothing.
int rfe_pq_decode(const void* codes, const void* cb, void* out, int n, const int* plan,
                  void* stream) {
  const int m = plan[P_M], ksub = plan[P_KSUB], staged = plan[P_STAGED];
  int sub_bytes = plan[P_DSUB] * plan[P_ESIZE];
  if (n < 0 || m < 1 || ksub < 1 || ksub > 256 || sub_bytes < 1 || plan[P_TW] < 1 ||
      plan[P_THREADS] % plan[P_TW] != 0 || plan[P_THREADS] > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // widest chunk that the subvector width and the pointers the threads
  // read (an unstaged codebook) and write allow
  const uintptr_t align = reinterpret_cast<uintptr_t>(out) |
                          (staged ? 0 : reinterpret_cast<uintptr_t>(cb));
  int vb = 16;
  while (vb > 2 && (sub_bytes % vb != 0 || (align & (vb - 1)) != 0)) vb >>= 1;
  if (sub_bytes % vb != 0 || (align & (vb - 1)) != 0) return (int)cudaErrorMisalignedAddress;
  const void* fn = staged ? kernel_for<true>(vb) : kernel_for<false>(vb);
  const int smem = plan[P_SMEM];
  cudaError_t e = prepare_on(fn, smem, plan[P_DEVICE]);
  if (e != cudaSuccess) return (int)e;
  const uint8_t* codes_b = static_cast<const uint8_t*>(codes);
  const uint8_t* cb_b = static_cast<const uint8_t*>(cb);
  uint8_t* out_b = static_cast<uint8_t*>(out);
  int m_ = m, ksub_ = ksub, mg = plan[P_MG], tile_rows = plan[P_TILE_ROWS], tw = plan[P_TW];
  void* args[] = {(void*)&codes_b, (void*)&cb_b, (void*)&out_b, &n, &m_, &ksub_, &sub_bytes,
                  &mg, &tile_rows, &tw};
  e = cudaLaunchKernel(fn, dim3(plan[P_GRID_X], plan[P_GROUPS]), dim3(plan[P_THREADS]), args,
                       smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The number of plan fields rfe_pq_decode reads (a check on the binding).
int rfe_pq_decode_plan_fields() { return P_FIELDS; }

}  // extern "C"
