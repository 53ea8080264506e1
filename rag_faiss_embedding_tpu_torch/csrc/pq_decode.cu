// PQ decode: (n, m) uint8 codes -> (n, m * dsub) rows of the codebook's type.
//
// Replaces the TPU kernel rag_faiss_embedding_tpu/ops/pallas_pq.py::
// _decode_kernel (reached through pallas_pq.decode). Same result (the
// wrapper is ops/pq_decode.py):
//   out[r, s*dsub : (s+1)*dsub] = codebook[s, codes[r, s], :]
// The TPU kernel builds one-hot tiles and multiplies them by a block-diagonal
// grouped bf16 codebook on the MXU, because the TPU has no fast gather; one
// 1.0 times a bf16 value, summed in f32, rounds back to that value, so it
// emits the codeword exactly. The card gathers, so this kernel is a gather
// from a codebook staged in shared memory and bit-exact with the plain
// gather (decode_reference). It copies bytes, so one template serves bf16
// codebooks (compute "bf16") and f32 ones (compute "f32"): the type only
// sets the byte width of a subvector (dsub * 2 or dsub * 4).
//
// What bounds it on an H100: writes. A row is m bytes in and 2 * D bytes out
// (48 B against 768 B at D = 384, m = 48, bf16), so 1,048,576 rows write
// 805 MB: about 0.24 ms at 3.35 TB/s. The codebook is D * ksub * 2 bytes
// (192 KiB at D = 384, ksub = 256, bf16): it fits one block's 227 KB, but
// staging it per small block would cost more reads than the rows.
//
// Design. Each block stages its codebook slice once and then walks many row
// tiles (grid-stride; the grid is sized by the occupancy API to what the
// card holds at once, so each SM stages the codebook about once). A second
// grid dimension splits the subspaces into groups whose codebook slice fits
// in dynamic shared memory: this serves f32 codebooks (384 KiB at D = 384)
// and D = 768; a subspace too large for shared memory on its own is read
// from global memory instead (L2-resident). A row tile's codes are staged
// with 16-byte loads (coalesced, the tile is contiguous). Consecutive
// threads take consecutive (row, subspace) pairs in output order, and each
// copies its dsub values with the widest aligned store (16 B at bf16 dsub 8,
// narrower where dsub * size or the pointers are not 16-byte multiples), so
// a warp writes one contiguous span. A code >= ksub is outside the contract;
// it is clamped so a bad input cannot read past the codebook.
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 1024
#define CODE_TILE_BYTES 8192   // target bytes of codes staged per row tile
#define MAX_TILE_ROWS 1024
#define SMEM_LIMIT 232448      // dynamic shared memory one block may use (sm_90)

template <int VB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = unsigned int; };
template <> struct Vec<2> { using T = unsigned short; };

__host__ __device__ inline size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// Copy n bytes global -> shared (dst 16-byte aligned): 16-byte loads where
// the source is aligned, bytes otherwise.
__device__ inline void stage_bytes(uint8_t* __restrict__ dst,
                                   const uint8_t* __restrict__ src, size_t n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const size_t nv = n >> 4;
    for (size_t i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    for (size_t i = (nv << 4) + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// grid (row-tile walkers, subspace groups). Group g decodes subspaces
// [g * mg, min(m, (g + 1) * mg)) of every row; sub_bytes = dsub * size.
template <int VB, bool STAGED>
__global__ void __launch_bounds__(THREADS)
pq_decode_kernel(const uint8_t* __restrict__ codes, const uint8_t* __restrict__ cb,
                 uint8_t* __restrict__ out, int n, int m, int ksub, int sub_bytes,
                 int mg, int tile_rows, int cb_smem) {
  extern __shared__ __align__(16) uint8_t smem[];
  using V = typename Vec<VB>::T;
  const int m0 = blockIdx.y * mg;
  const int mg_here = min(mg, m - m0);
  const size_t word_bytes = (size_t)ksub * sub_bytes;  // one subspace's codebook
  const uint8_t* book = cb + m0 * word_bytes;
  uint8_t* tile = smem + cb_smem;
  if (STAGED) {
    stage_bytes(smem, book, mg_here * word_bytes);
    book = smem;
  }
  const size_t out_row = (size_t)m * sub_bytes;
  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int r0 = t * tile_rows;
    const int rows = min(tile_rows, n - r0);
    __syncthreads();  // the codebook is staged; the last tile's codes are used
    stage_bytes(tile, codes + (size_t)r0 * m, (size_t)rows * m);
    __syncthreads();
    const int pairs = rows * mg_here;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int r = p / mg_here;
      const int s = p - r * mg_here;
      const int c = min((int)tile[r * m + m0 + s], ksub - 1);
      const uint8_t* src = book + ((size_t)s * ksub + c) * sub_bytes;
      uint8_t* dst = out + (size_t)(r0 + r) * out_row + (size_t)(m0 + s) * sub_bytes;
#pragma unroll 4
      for (int o = 0; o < sub_bytes; o += VB)
        *reinterpret_cast<V*>(dst + o) = *reinterpret_cast<const V*>(src + o);
    }
  }
}

struct Plan {
  int groups, mg, tile_rows, smem, staged, cb_smem;
};

static bool make_plan(int m, int ksub, int dsub, int esize, Plan* p) {
  if (m < 1 || ksub < 1 || ksub > 256 || dsub < 1 || (esize != 2 && esize != 4))
    return false;
  const size_t sub_bytes = (size_t)dsub * esize;
  int rows = (int)(CODE_TILE_BYTES / m) / 16 * 16;
  rows = rows < 16 ? 16 : (rows > MAX_TILE_ROWS ? MAX_TILE_ROWS : rows);
  const size_t tile_bytes = round_up((size_t)rows * m, 16);
  if (tile_bytes >= SMEM_LIMIT) return false;
  const size_t word_bytes = (size_t)ksub * sub_bytes;
  const size_t per_group = (SMEM_LIMIT - tile_bytes) / word_bytes;
  p->tile_rows = rows;
  if (per_group >= 1) {
    const int groups = (int)((m + per_group - 1) / per_group);
    p->groups = groups;
    p->mg = (m + groups - 1) / groups;  // even groups
    p->cb_smem = (int)round_up(p->mg * word_bytes, 16);
    p->staged = 1;
  } else {  // one subspace alone overflows shared memory: read it from L2
    p->groups = 1;
    p->mg = m;
    p->cb_smem = 0;
    p->staged = 0;
  }
  p->smem = p->cb_smem + (int)tile_bytes;
  return true;
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

extern "C" {

const char* rfe_pq_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// plan = {subspace groups, subspaces per group, rows per tile, dynamic
// shared bytes, codebook staged (1) or read from L2 (0)}; returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
int rfe_pq_decode_plan(int m, int ksub, int dsub, int esize, int* plan) {
  Plan p;
  if (!make_plan(m, ksub, dsub, esize, &p)) return (int)cudaErrorInvalidValue;
  plan[0] = p.groups;
  plan[1] = p.mg;
  plan[2] = p.tile_rows;
  plan[3] = p.smem;
  plan[4] = p.staged;
  return 0;
}

// codes (n, m) uint8, contiguous; cb (m, ksub, dsub) of esize-byte values,
// contiguous; out (n, m * dsub) of the same type. n == 0 launches nothing.
int rfe_pq_decode(const void* codes, const void* cb, void* out, int n, int m,
                  int ksub, int dsub, int esize, void* stream) {
  Plan p;
  if (n < 0 || !make_plan(m, ksub, dsub, esize, &p)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int sub_bytes = dsub * esize;
  // widest store that the subvector width and both pointers allow
  const uintptr_t align = reinterpret_cast<uintptr_t>(out) |
                          (p.staged ? 0 : reinterpret_cast<uintptr_t>(cb));
  int vb = 16;
  while (vb > 2 && (sub_bytes % vb != 0 || (align & (vb - 1)) != 0)) vb >>= 1;
  if (sub_bytes % vb != 0 || (align & (vb - 1)) != 0) return (int)cudaErrorMisalignedAddress;
  const void* fn = p.staged ? kernel_for<true>(vb) : kernel_for<false>(vb);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, p.smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (n + p.tile_rows - 1) / p.tile_rows;
  int walkers = per_sm * sms / p.groups;
  walkers = walkers < 1 ? 1 : (walkers > n_tiles ? n_tiles : walkers);
  const uint8_t* codes_b = static_cast<const uint8_t*>(codes);
  const uint8_t* cb_b = static_cast<const uint8_t*>(cb);
  uint8_t* out_b = static_cast<uint8_t*>(out);
  void* args[] = {(void*)&codes_b, (void*)&cb_b, (void*)&out_b, &n, &m, &ksub,
                  (void*)&sub_bytes, &p.mg, &p.tile_rows, &p.cb_smem};
  e = cudaLaunchKernel(fn, dim3(walkers, p.groups), dim3(THREADS), args, p.smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
