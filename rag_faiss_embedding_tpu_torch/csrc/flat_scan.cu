// Exact flat scan: fused distance + top-k over a device-resident database.
//
// Replaces the TPU kernel rag_faiss_embedding_tpu/ops/pallas_scan.py::_scan_kernel
// (K1). Same contract: score = 2 q.x - ||x||^2 (L2) or q.x (IP), accumulated
// in float32; rows >= n_rows never come back; the top k per query is ordered
// by (score descending, row index ascending); slots with no live row hold
// index -1. The wrapper (ops/flat_scan.py) turns scores into distances.
//
// What bounds it on an H100:
//   * small Q (the single-request path): bytes. 1M x 384 f32 is 1.6 GB, about
//     0.5 ms at 3.35 TB/s, and every row is read once. The grid is split over
//     the database (stage 1, grid.y; the wrapper plans the splits from the
//     card's occupancy) so that every SM streams rows even at Q = 1; tiles
//     are read with 16-byte loads, several in flight per thread, and two
//     blocks share an SM so one's loads overlap the other's dot products.
//   * large Q (Q = 1024): FP32 FMA throughput, about 0.8 TFLOP per 1M-row
//     scan against 67 TFLOP/s. Each warp computes 4 queries x 64 rows from a
//     tile in shared memory, so one shared-memory read of a row feeds four
//     queries (QW = 4 for Q > 8; QW = 1 below, where the other three would be
//     padding). There are no tensor cores here: TF32 would break the
//     Precision.HIGHEST parity that float32 storage promises.
//
// Stage 1 (scan_partial): grid (ceil(Q / TQ), S). Each block stages TN rows at
// a time in shared memory (widened to f32), computes TQ x TN scores with FMA,
// and each warp merges its queries' scores into sorted top-k lists in shared
// memory. It writes (Q, S, k) partial lists. A row wider than the shared
// memory holds (D above about 800 in f32) is staged DC columns at a time, the
// queries' matching columns with it, and the dot products accumulate across
// the chunks; at D = 384 the whole row is one chunk and the queries are
// staged once. Stage 2 (merge_partials): one
// block per query merges the S * k candidates into the final (Q, k).
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define KMAX 64     // largest k the lists hold: two slots per lane
#define TN 64       // database rows per tile: two per lane
#define NWARPS 8
#define THREADS (NWARPS * 32)
#define FULL_MASK 0xffffffffu
#define STAGE_UNROLL 8  // 16-byte loads each thread keeps in flight

// (score desc, index asc): does (av, ai) rank before (bv, bi)? Index -1
// (an empty slot) compares as the largest index.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && (unsigned)ai < (unsigned)bi);
}

// Insert (v, i) into the sorted list (lv, li) of length k in shared memory.
// One warp owns the list; all 32 lanes call this with the same arguments,
// and the caller has checked that (v, i) ranks before the last entry.
__device__ void warp_insert(float* lv, int* li, int k, float v, int i, int lane) {
  int before = 0;
  for (int s = lane; s < k; s += 32) before += ranks_before(lv[s], li[s], v, i);
  for (int off = 16; off > 0; off >>= 1)
    before += __shfl_xor_sync(FULL_MASK, before, off);
  const int p = before;  // the candidate's position
  float nv[KMAX / 32];
  int ni[KMAX / 32];
#pragma unroll
  for (int j = 0; j < KMAX / 32; ++j) {
    const int s = lane + 32 * j;
    if (s < k) {
      if (s < p) { nv[j] = lv[s]; ni[j] = li[s]; }
      else if (s == p) { nv[j] = v; ni[j] = i; }
      else { nv[j] = lv[s - 1]; ni[j] = li[s - 1]; }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < KMAX / 32; ++j) {
    const int s = lane + 32 * j;
    if (s < k) { lv[s] = nv[j]; li[s] = ni[j]; }
  }
  __syncwarp();
}

// Offer one candidate per lane to the warp's list; better ones are inserted
// one at a time, in lane order.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k, float cv, int ci, int lane) {
  const bool better = ci >= 0 && ranks_before(cv, ci, lv[k - 1], li[k - 1]);
  unsigned pending = __ballot_sync(FULL_MASK, better);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float v = __shfl_sync(FULL_MASK, cv, src);
    const int i = __shfl_sync(FULL_MASK, ci, src);
    if (ranks_before(v, i, lv[k - 1], li[k - 1])) warp_insert(lv, li, k, v, i, lane);
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Widen 16 bytes of database row read from global memory into f32 shared
// memory: four floats, or eight bf16 values (bf16 is the top half of an f32).
__device__ __forceinline__ void store_widened(const uint4& a, float* dst, float) {
  *reinterpret_cast<uint4*>(dst) = a;
}
__device__ __forceinline__ void store_widened(const uint4& a, float* dst, __nv_bfloat16) {
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
  float4 lo, hi;
  lo.x = __uint_as_float(w[0] << 16); lo.y = __uint_as_float(w[0] & 0xffff0000u);
  lo.z = __uint_as_float(w[1] << 16); lo.w = __uint_as_float(w[1] & 0xffff0000u);
  hi.x = __uint_as_float(w[2] << 16); hi.y = __uint_as_float(w[2] & 0xffff0000u);
  hi.z = __uint_as_float(w[3] << 16); hi.w = __uint_as_float(w[3] & 0xffff0000u);
  *reinterpret_cast<float4*>(dst) = lo;
  *reinterpret_cast<float4*>(dst + 4) = hi;
}
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int value = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int value = 8; };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// Row stride of the tile in floats: a multiple of 4 (float4 reads) that is
// 4 mod 32, so the eight lanes of a float4 phase hit eight different
// 16-byte bank groups.
__host__ __device__ inline int tile_stride(int d) { return round_up(round_up(d, 4), 32) + 4; }

// dc: columns staged at once (round_up(d, 4) when the whole row fits).
// Lists are sized by k, not KMAX: at D = 384, QW = 1 and k <= 60 two blocks
// then fit on an SM, so one block's tile loads overlap the other's compute.
static size_t smem_bytes(int dc, int qw, int k) {
  const int tq = NWARPS * qw;
  return sizeof(float) * ((size_t)TN * tile_stride(dc) + (size_t)tq * dc + TN) +
         (sizeof(float) + sizeof(int)) * (size_t)tq * k;
}

// Stage columns [c0, c0 + cw) of queries q0 .. q0 + TQ - 1 into qs (row
// stride dc), widened to f32, zero past d and past nq.
template <typename T, int TQ>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, float* qs, int q0,
                                              int nq, int d, int dc, int c0, int cw) {
  for (int e = threadIdx.x; e < TQ * cw; e += THREADS) {
    const int r = e / cw, c = e - r * cw;
    const int gq = q0 + r, col = c0 + c;
    qs[r * dc + c] = (gq < nq && col < d) ? widen(q[(size_t)gq * d + col]) : 0.f;
  }
}

// Shared memory, not registers, bounds the blocks per SM, so the compiler
// may give a thread up to 255 registers (QW = 4 spilled at 64).
template <typename T, bool L2, int QW>
__global__ void __launch_bounds__(THREADS, 1)
scan_partial(const T* __restrict__ q, const T* __restrict__ db,
             const float* __restrict__ db_sq, float* __restrict__ part_v,
             int* __restrict__ part_i, int nq, int n_rows, int d, int k,
             int dc, int rows_per_split, int vec) {
  constexpr int TQ = NWARPS * QW;
  constexpr int V = VecWidth<T>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d4 = round_up(d, 4);
  const int dp = tile_stride(dc);
  const bool one_chunk = dc >= d4;
  float* tile = smem;                    // TN x dp
  float* qs = tile + TN * dp;            // TQ x dc
  float* sq = qs + TQ * dc;              // TN
  float* lvs = sq + TN;                  // TQ x k
  int* lis = reinterpret_cast<int*>(lvs + TQ * k);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n_rows, row_lo + rows_per_split);
  // queries of this warp: block slots warp*QW .. warp*QW + QW - 1
  const int live_q = min(QW, nq - (q0 + warp * QW));

  // with one chunk, the queries are staged once for every tile
  if (one_chunk) stage_queries<T, TQ>(q, qs, q0, nq, d, dc, 0, d4);
  for (int s = threadIdx.x; s < TQ * k; s += THREADS) {
    lvs[s] = -INFINITY;
    lis[s] = -1;
  }
  __syncthreads();

  bool first = true;
  for (int t0 = row_lo; t0 < row_hi; t0 += TN) {
    const int rows = min(TN, row_hi - t0);
    float acc[QW][2];
#pragma unroll
    for (int j = 0; j < QW; ++j) acc[j][0] = acc[j][1] = 0.f;
    for (int c0 = 0; c0 < d4; c0 += dc) {
      const int cw = min(dc, d4 - c0);  // a multiple of 4 (of V when vec)
      if (!first) __syncthreads();  // the previous chunk is consumed
      first = false;
      if (!one_chunk) stage_queries<T, TQ>(q, qs, q0, nq, d, dc, c0, cw);
      if (vec) {
        // 16-byte vectors, STAGE_UNROLL loads in flight per thread before any
        // store; with one chunk the tile is one contiguous run of them
        const T* base_ptr = db + (size_t)t0 * d + c0;
        const int per_row = cw / V, total = rows * per_row;
        const bool contiguous = cw == d;
        for (int base = threadIdx.x; base < total; base += THREADS * STAGE_UNROLL) {
          uint4 buf[STAGE_UNROLL];
#pragma unroll
          for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int e = base + u * THREADS;
            if (e < total) {
              const size_t off = contiguous ? (size_t)e * V
                                            : (size_t)(e / per_row) * d + (e % per_row) * V;
              buf[u] = *reinterpret_cast<const uint4*>(base_ptr + off);
            }
          }
#pragma unroll
          for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int e = base + u * THREADS;
            if (e < total) {
              const int r = e / per_row;
              store_widened(buf[u], tile + r * dp + (e - r * per_row) * V, T());
            }
          }
        }
      } else {
        for (int r = warp; r < rows; r += NWARPS) {
          const T* src = db + (size_t)(t0 + r) * d + c0;
          float* dst = tile + r * dp;
          for (int c = lane; c < cw; c += 32) dst[c] = c0 + c < d ? widen(src[c]) : 0.f;
        }
      }
      if (c0 == 0 && threadIdx.x < rows) sq[threadIdx.x] = L2 ? db_sq[t0 + threadIdx.x] : 0.f;
      __syncthreads();
      if (live_q <= 0) continue;  // warp-uniform

      const float* x0 = tile + lane * dp;
      const float* x1 = tile + (lane + 32) * dp;
      const float* qw0 = qs + warp * QW * dc;
#pragma unroll 4
      for (int c = 0; c < cw; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(x0 + c);
        const float4 b = *reinterpret_cast<const float4*>(x1 + c);
#pragma unroll
        for (int j = 0; j < QW; ++j) {
          const float4 u = *reinterpret_cast<const float4*>(qw0 + j * dc + c);
          acc[j][0] = fmaf(u.x, a.x, acc[j][0]);
          acc[j][0] = fmaf(u.y, a.y, acc[j][0]);
          acc[j][0] = fmaf(u.z, a.z, acc[j][0]);
          acc[j][0] = fmaf(u.w, a.w, acc[j][0]);
          acc[j][1] = fmaf(u.x, b.x, acc[j][1]);
          acc[j][1] = fmaf(u.y, b.y, acc[j][1]);
          acc[j][1] = fmaf(u.z, b.z, acc[j][1]);
          acc[j][1] = fmaf(u.w, b.w, acc[j][1]);
        }
      }
    }
    if (live_q <= 0) continue;  // warp-uniform
    const int i0 = lane < rows ? t0 + lane : -1;
    const int i1 = lane + 32 < rows ? t0 + lane + 32 : -1;
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      if (j >= live_q) break;  // warp-uniform
      float s0 = acc[j][0], s1 = acc[j][1];
      if (L2) {
        s0 = 2.f * s0 - sq[lane];
        s1 = 2.f * s1 - sq[lane + 32];
      }
      float* lv = lvs + (warp * QW + j) * k;
      int* li = lis + (warp * QW + j) * k;
      warp_offer(lv, li, k, s0, i0, lane);
      warp_offer(lv, li, k, s1, i1, lane);
    }
  }

  const int n_splits = gridDim.y;
  for (int j = 0; j < live_q; ++j) {
    const float* lv = lvs + (warp * QW + j) * k;
    const int* li = lis + (warp * QW + j) * k;
    const size_t base = ((size_t)(q0 + warp * QW + j) * n_splits + split) * k;
    for (int s = lane; s < k; s += 32) {
      part_v[base + s] = lv[s];
      part_i[base + s] = li[s];
    }
  }
}

// Stage 2: one block per query. Each warp merges a strided share of the
// n_cand = S * k partial candidates (the next chunk's loads issued before the
// current chunk is offered), then warp 0 merges the warps' lists.
__global__ void __launch_bounds__(THREADS)
merge_partials(const float* __restrict__ part_v, const int* __restrict__ part_i,
               float* __restrict__ out_v, int* __restrict__ out_i, int n_cand,
               int k) {
  __shared__ float lvs[NWARPS * KMAX];
  __shared__ int lis[NWARPS * KMAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qi = blockIdx.x;
  float* lv = lvs + warp * k;
  int* li = lis + warp * k;
  for (int s = lane; s < k; s += 32) { lv[s] = -INFINITY; li[s] = -1; }
  __syncwarp();
  const float* cv = part_v + qi * n_cand;
  const int* ci = part_i + qi * n_cand;
  int c = warp * 32 + lane;
  float v = c < n_cand ? cv[c] : -INFINITY;
  int i = c < n_cand ? ci[c] : -1;
  for (int c0 = warp * 32; c0 < n_cand; c0 += THREADS) {
    c = c0 + THREADS + lane;
    const float v_next = c < n_cand ? cv[c] : -INFINITY;
    const int i_next = c < n_cand ? ci[c] : -1;
    warp_offer(lv, li, k, v, i, lane);
    v = v_next;
    i = i_next;
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < NWARPS; ++w)
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int s = s0 + lane;
      warp_offer(lv, li, k, s < k ? lvs[w * k + s] : -INFINITY,
                 s < k ? lis[w * k + s] : -1, lane);
    }
  for (int s = lane; s < k; s += 32) {
    const bool found = li[s] >= 0;
    out_v[qi * k + s] = found ? lv[s] : -FLT_MAX;
    out_i[qi * k + s] = found ? li[s] : -1;
  }
}

// The stage-1 kernel for one (dtype, metric, QW), as a generic pointer.
static const void* scan_kernel(int is_bf16, int is_l2, int qw) {
  typedef __nv_bfloat16 bf16;
  if (is_bf16) {
    if (is_l2) return qw == 4 ? (const void*)scan_partial<bf16, true, 4> : (const void*)scan_partial<bf16, true, 1>;
    return qw == 4 ? (const void*)scan_partial<bf16, false, 4> : (const void*)scan_partial<bf16, false, 1>;
  }
  if (is_l2) return qw == 4 ? (const void*)scan_partial<float, true, 4> : (const void*)scan_partial<float, true, 1>;
  return qw == 4 ? (const void*)scan_partial<float, false, 4> : (const void*)scan_partial<float, false, 1>;
}

// Opt the kernel in to the dynamic shared memory it needs (above 48 KB).
static cudaError_t prepare(const void* fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// dc is the whole padded row, or a multiple of 8 below it (so chunk starts
// keep 16-byte row reads aligned for both dtypes).
static bool bad_shape(int d, int k, int qw, int dc) {
  const int d4 = round_up(d, 4);
  return d < 1 || k < 1 || k > KMAX || (qw != 1 && qw != 4) || dc < 4 ||
         dc % 4 != 0 || dc > d4 || (dc < d4 && dc % 8 != 0);
}

extern "C" {

int rfe_flat_scan_kmax(void) { return KMAX; }

// Rows a block keeps in one tile, and queries per block for a given QW.
int rfe_flat_scan_tile_rows(void) { return TN; }
int rfe_flat_scan_block_queries(int qw) { return NWARPS * qw; }

// Stage-1 blocks one SM holds at once for this shape, or -(CUDA error).
int rfe_flat_scan_blocks_per_sm(int d, int k, int is_l2, int is_bf16, int qw, int dc) {
  if (bad_shape(d, k, qw, dc)) return -(int)cudaErrorInvalidValue;
  const void* fn = scan_kernel(is_bf16, is_l2, qw);
  const size_t smem = smem_bytes(dc, qw, k);
  cudaError_t e = prepare(fn, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

const char* rfe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (nq, d) and db (>= n_rows, d): both float32 (is_bf16 = 0) or both
// bfloat16 (is_bf16 = 1), row-major and contiguous. db_sq (n_rows,) float32,
// read only for L2. part_v / part_i: (nq, n_splits, k) scratch. out_v /
// out_i: (nq, k). Split s covers rows [s * rows_per_split, (s + 1) *
// rows_per_split), clipped to n_rows; rows_per_split is a multiple of TN.
// dc: columns staged at once (see bad_shape). vec = 1 allows 16-byte row
// reads: d a multiple of 4 (f32) or 8 (bf16) and db 16-byte aligned.
int rfe_flat_scan(const void* q, const void* db, const void* db_sq,
                  void* part_v, void* part_i, void* out_v, void* out_i,
                  int nq, int n_rows, int d, int k, int is_l2, int is_bf16,
                  int qw, int dc, int rows_per_split, int n_splits, int vec,
                  void* stream) {
  if (nq < 1 || n_rows < 1 || n_splits < 1 || bad_shape(d, k, qw, dc) ||
      rows_per_split < 1 || rows_per_split % TN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = scan_kernel(is_bf16, is_l2, qw);
  const size_t smem = smem_bytes(dc, qw, k);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&q, &db, &db_sq, &part_v, &part_i, &nq, &n_rows, &d, &k,
                  &dc, &rows_per_split, &vec};
  const int tq = NWARPS * qw;
  e = cudaLaunchKernel(fn, dim3((nq + tq - 1) / tq, n_splits), dim3(THREADS),
                       args, smem, s);
  if (e != cudaSuccess) return (int)e;
  merge_partials<<<nq, THREADS, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(out_v), static_cast<int*>(out_i), n_splits * k, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
