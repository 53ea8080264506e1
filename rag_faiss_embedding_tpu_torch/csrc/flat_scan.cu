// Exact flat scan: fused distance + top-k over a device-resident database.
//
// Replaces the TPU kernel rag_faiss_embedding_tpu/ops/pallas_scan.py::_scan_kernel
// (K1). Same contract: score = 2 q.x - ||x||^2 (L2) or q.x (IP), accumulated
// in float32; rows >= n_rows never come back; the top k per query is ordered
// by (score descending, row index ascending); slots with no live row hold
// index -1. Stage 2 writes the public values itself: squared L2 distances
// max(||q||^2 - score, 0) or inner products, inf / -inf beside index -1.
//
// What bounds it on an H100:
//   * small Q (the single-request path): bytes. 1M x 384 f32 is 1.6 GB, about
//     0.5 ms at 3.35 TB/s, and every row is read once. The grid is split over
//     the database (stage 1, grid.y; the wrapper plans the splits from the
//     card's occupancy) so that every SM streams rows even at Q = 1; tiles
//     are read with 16-byte loads, several in flight per thread, and two
//     blocks share an SM so one's loads overlap the other's dot products.
//     Each warp scores one query against 64 rows of a whole-row tile
//     (scan_partial).
//   * large Q (Q = 1024): FP32 FMA throughput, 0.82 TFLOP per 1M-row scan
//     against 67 TFLOP/s. There are no tensor cores here: TF32 would break
//     the Precision.HIGHEST parity that float32 storage promises. The tiled
//     path (scan_tiled) is a register-tiled FP32 product: a block scores 128
//     queries x 128 rows, each thread an 8 x 8 micro-tile, from k-major slabs
//     of 16 columns, so one k-step reads 8 query and 8 row values from shared
//     memory for 64 FMAs (4 per float read; the warp-per-query loop did
//     ~1.3). Float32 slabs come in with cp.async, three in flight, while the
//     current one is multiplied (bf16 is loaded a slab ahead into registers
//     and widened as it is stored: cp.async cannot widen). Shared memory is
//     sized (k <= 45) so that two blocks share an SM: one selects while the
//     other multiplies.
//
// Selection on the tiled path: each query keeps a running threshold, its
// k-th (score, index), in shared memory. After a tile, a thread compares its
// 64 scores with their queries' thresholds; only those that rank before it
// go to a per-query candidate buffer, and one warp per query inserts them
// into its sorted list (the same insertion and order as scan_partial, so
// ties still go to the lowest index). Past the first tiles survivors are
// rare: about k ln(N / k) per query over a whole scan. A full candidate
// buffer leaves the rest pending for another round.
//
// Stage 1 writes (Q, S, k) partial lists, one per database split. Stage 2
// (merge_partials): one block per query merges the S * k candidates and
// writes the public (Q, k_out) values and ids, padding k_out > k with -1.
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "launch.cuh"

#define KMAX 64     // largest k the lists hold: two slots per lane
#define TN 64       // database rows per tile of scan_partial: two per lane
#define NWARPS 8
#define THREADS (NWARPS * 32)
#define FULL_MASK 0xffffffffu
#define STAGE_UNROLL 8  // 16-byte loads each thread keeps in flight

// scan_tiled
#define TT 128                  // queries and rows per block tile
#define TK 16                   // columns per slab
#define SLAB_LD (TT + 4)        // slab row stride in floats (16-byte rows)
#define STAGES 3                // f32 slabs in flight (cp.async ring)
#define CAND 16                 // candidate buffer per query per round
#define TILED_BLOCKS_PER_SM 2

enum Path { WARP = 0, TILED = 1 };

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

// Shared memory of one stage-1 block. scan_partial: its row tile, queries,
// norms and lists; dc is the columns staged at once (round_up(d, 4) when
// the whole row fits). Lists are sized by k, not KMAX: at D = 384 and k <=
// 60 two blocks then fit on an SM, so one block's tile loads overlap the
// other's compute. scan_tiled: its slab rings, thresholds, candidate
// buffers and lists.
static size_t smem_bytes(int path, int dc, int k) {
  if (path == TILED)
    return sizeof(float) * (2 * STAGES * TK * SLAB_LD + 3 * TT + 2 * TT * CAND) +
           (sizeof(float) + sizeof(int)) * (size_t)TT * k;
  return sizeof(float) * ((size_t)TN * tile_stride(dc) + (size_t)NWARPS * dc + TN) +
         (sizeof(float) + sizeof(int)) * (size_t)NWARPS * k;
}

// Stage columns [c0, c0 + cw) of queries q0 .. q0 + NWARPS - 1 into qs (row
// stride dc), widened to f32, zero past d and past nq.
template <typename T>
__device__ __forceinline__ void stage_queries(const T* __restrict__ q, float* qs, int q0,
                                              int nq, int d, int dc, int c0, int cw) {
  for (int e = threadIdx.x; e < NWARPS * cw; e += THREADS) {
    const int r = e / cw, c = e - r * cw;
    const int gq = q0 + r, col = c0 + c;
    qs[r * dc + c] = (gq < nq && col < d) ? widen(q[(size_t)gq * d + col]) : 0.f;
  }
}

// One query per warp (warp w of block b: query 8 b + w), against 64 rows
// of a whole-row tile at a time, two rows per lane. Shared memory, not
// registers, bounds the blocks per SM.
template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS, 1)
scan_partial(const T* __restrict__ q, const T* __restrict__ db,
             const float* __restrict__ db_sq, float* __restrict__ part_v,
             int* __restrict__ part_i, int nq, int n_rows, int d, int k,
             int dc, int rows_per_split, int vec) {
  constexpr int V = VecWidth<T>::value;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d4 = round_up(d, 4);
  const int dp = tile_stride(dc);
  const bool one_chunk = dc >= d4;
  float* tile = smem;                    // TN x dp
  float* qs = tile + TN * dp;            // NWARPS x dc
  float* sq = qs + NWARPS * dc;          // TN
  float* lv = sq + TN + (threadIdx.x >> 5) * k;  // this warp's list: k
  int* li = reinterpret_cast<int*>(sq + TN + NWARPS * k) + (threadIdx.x >> 5) * k;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * NWARPS;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n_rows, row_lo + rows_per_split);
  const bool live = q0 + warp < nq;  // warp-uniform

  // with one chunk, the queries are staged once for every tile
  if (one_chunk) stage_queries<T>(q, qs, q0, nq, d, dc, 0, d4);
  for (int s = lane; s < k; s += 32) {
    lv[s] = -INFINITY;
    li[s] = -1;
  }
  __syncthreads();

  bool first = true;
  for (int t0 = row_lo; t0 < row_hi; t0 += TN) {
    const int rows = min(TN, row_hi - t0);
    float acc0 = 0.f, acc1 = 0.f;
    for (int c0 = 0; c0 < d4; c0 += dc) {
      const int cw = min(dc, d4 - c0);  // a multiple of 4 (of V when vec)
      if (!first) __syncthreads();  // the previous chunk is consumed
      first = false;
      if (!one_chunk) stage_queries<T>(q, qs, q0, nq, d, dc, c0, cw);
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
      if (!live) continue;

      const float* x0 = tile + lane * dp;
      const float* x1 = tile + (lane + 32) * dp;
      const float* qw = qs + warp * dc;
#pragma unroll 4
      for (int c = 0; c < cw; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(x0 + c);
        const float4 b = *reinterpret_cast<const float4*>(x1 + c);
        const float4 u = *reinterpret_cast<const float4*>(qw + c);
        acc0 = fmaf(u.x, a.x, acc0);
        acc0 = fmaf(u.y, a.y, acc0);
        acc0 = fmaf(u.z, a.z, acc0);
        acc0 = fmaf(u.w, a.w, acc0);
        acc1 = fmaf(u.x, b.x, acc1);
        acc1 = fmaf(u.y, b.y, acc1);
        acc1 = fmaf(u.z, b.z, acc1);
        acc1 = fmaf(u.w, b.w, acc1);
      }
    }
    if (!live) continue;
    if (L2) {
      acc0 = 2.f * acc0 - sq[lane];
      acc1 = 2.f * acc1 - sq[lane + 32];
    }
    warp_offer(lv, li, k, acc0, lane < rows ? t0 + lane : -1, lane);
    warp_offer(lv, li, k, acc1, lane + 32 < rows ? t0 + lane + 32 : -1, lane);
  }

  if (!live) return;
  const size_t base = ((size_t)(q0 + warp) * gridDim.y + split) * k;
  for (int s = lane; s < k; s += 32) {
    part_v[base + s] = lv[s];
    part_i[base + s] = li[s];
  }
}

// ------------------------------------------------------------ scan_tiled
// A slab is TK columns [c0, c0 + TK) of 128 queries or rows, stored k-major:
// slab[column][query or row], column stride SLAB_LD.
//
// f32: thread t copies column c0 + t % TK of rows t / TK + 16 j (j < 8)
// straight into shared memory with 4-byte cp.async, zero past `limit` rows
// and past d columns: sixteen lanes read 64 contiguous bytes of a row.
__device__ __forceinline__ void slab_async(const float* __restrict__ src, float* dst,
                                           int first, int limit, int d, int c0) {
  constexpr int STEP = THREADS / TK;
  const int kk = threadIdx.x % TK, r0 = threadIdx.x / TK, col = c0 + kk;
  const float* p = src + (size_t)(first + r0) * d + col;
  const size_t step = (size_t)STEP * d;
  float* s = dst + kk * SLAB_LD + r0;
#pragma unroll
  for (int j = 0; j < TK * TT / THREADS; ++j) {
    const bool ok = col < d && first + r0 + j * STEP < limit;
    cp_async4(s + j * STEP, ok ? p : src, ok);
    p += step;
  }
}

// bf16: thread t reads 8 columns c0 + 8 (t % 2) .. + 7 of row t / 2 into
// registers (one 16-byte load where vec: d a multiple of 8, rows 16-byte
// aligned) ...
__device__ __forceinline__ void slab_load(const __nv_bfloat16* __restrict__ src, uint4& r,
                                          int first, int limit, int d, int c0, int vec) {
  const int row = first + threadIdx.x / 2, col = c0 + (threadIdx.x % 2) * 8;
  r = make_uint4(0, 0, 0, 0);
  if (row >= limit || col >= d) return;
  const unsigned short* p = reinterpret_cast<const unsigned short*>(src) + (size_t)row * d + col;
  if (vec) {
    r = *reinterpret_cast<const uint4*>(p);
    return;
  }
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < d) w[e / 2] |= (unsigned)p[e] << (16 * (e % 2));
  r = make_uint4(w[0], w[1], w[2], w[3]);
}

// ... and stores them widened to f32 (bf16 is the top half of an f32).
__device__ __forceinline__ void slab_store(const uint4& r, float* dst) {
  const int row = threadIdx.x / 2, kk0 = (threadIdx.x % 2) * 8;
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[(kk0 + 2 * i) * SLAB_LD + row] = __uint_as_float(w[i] << 16);
    dst[(kk0 + 2 * i + 1) * SLAB_LD + row] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
static_assert(THREADS == 2 * TT && TK == 16, "slab_load: two threads of 8 columns per row");

// Micro-tile coordinates: thread (tx, ty) = (tid % 16, tid / 16) holds
// queries QSLOT(i) and rows RSLOT(j), i, j < 8, of the block tile: two runs
// of 4, 64 apart, so a warp's float4 reads of a slab row touch 16 distinct
// 16-byte words (rows) or 2 (queries, broadcast).
#define QSLOT(i) (((i) < 4 ? 0 : 64 - 4) + ty * 4 + (i))
#define RSLOT(j) (((j) < 4 ? 0 : 64 - 4) + tx * 4 + (j))

template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS, TILED_BLOCKS_PER_SM)
scan_tiled(const T* __restrict__ q, const T* __restrict__ db,
           const float* __restrict__ db_sq, float* __restrict__ part_v,
           int* __restrict__ part_i, int nq, int n_rows, int d, int k,
           int rows_per_split, int vec) {
  constexpr bool ASYNC = std::is_same<T, float>::value;
  constexpr int SLAB = TK * SLAB_LD;
  constexpr int NBUF = ASYNC ? STAGES : 2;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // STAGES x TK x SLAB_LD
  float* xs = qs + STAGES * SLAB;                  // STAGES x TK x SLAB_LD
  float* thr_v = xs + STAGES * SLAB;               // TT: each query's k-th
  int* thr_i = reinterpret_cast<int*>(thr_v + TT);  // (score, index)
  int* cnt = thr_i + TT;                           // TT: candidates this round
  float* cand_v = reinterpret_cast<float*>(cnt + TT);          // TT x CAND
  int* cand_i = reinterpret_cast<int*>(cand_v + TT * CAND);   // TT x CAND
  float* lvs = reinterpret_cast<float*>(cand_i + TT * CAND);  // TT x k
  int* lis = reinterpret_cast<int*>(lvs + TT * k);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * TT;
  const int split = blockIdx.y;
  const int row_lo = split * rows_per_split;
  const int row_hi = min(n_rows, row_lo + rows_per_split);

  for (int s = tid; s < TT * k; s += THREADS) {
    lvs[s] = -INFINITY;
    lis[s] = -1;
  }
  for (int s = tid; s < TT; s += THREADS) {
    thr_v[s] = -INFINITY;
    thr_i[s] = -1;
    cnt[s] = 0;
  }

  // the next slab to bring in: tile ld_t0, columns ld_c0 ..
  int ld_t0 = row_lo, ld_c0 = 0;
  auto advance = [&]() {
    ld_c0 += TK;
    if (ld_c0 >= d) {
      ld_c0 = 0;
      ld_t0 += TT;
    }
  };
  auto stage = [&](int buf) {  // f32: issue the next slab's copies
    slab_async(reinterpret_cast<const float*>(q), qs + buf * SLAB, q0, nq, d, ld_c0);
    slab_async(reinterpret_cast<const float*>(db), xs + buf * SLAB, ld_t0, row_hi, d, ld_c0);
  };
  uint4 rq, rx;  // bf16: the next slab, in flight in registers
  auto load = [&]() {
    slab_load(reinterpret_cast<const __nv_bfloat16*>(q), rq, q0, nq, d, ld_c0, vec);
    slab_load(reinterpret_cast<const __nv_bfloat16*>(db), rx, ld_t0, row_hi, d, ld_c0, vec);
  };

  if constexpr (ASYNC) {
    for (int b = 0; b < STAGES - 1; ++b) {
      if (ld_t0 < row_hi) {
        stage(b);
        advance();
      }
      cp_async_commit();
    }
  } else if (ld_t0 < row_hi) {
    load();
    slab_store(rq, qs);
    slab_store(rx, xs);
    advance();
  }

  int buf = 0, wbuf = STAGES - 1;  // the current slab's buffer; the next copy's (f32)
  for (int t0 = row_lo; t0 < row_hi; t0 += TT) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < d; c0 += TK) {
      const bool more_slabs = ld_t0 < row_hi;
      if constexpr (ASYNC) {
        cp_async_wait<STAGES - 2>();  // this slab has landed (this thread's part)
        __syncthreads();              // ... everyone's; the previous one is consumed
        if (more_slabs) {
          stage(wbuf);
          advance();
        }
        cp_async_commit();
        wbuf = wbuf + 1 == NBUF ? 0 : wbuf + 1;
      } else {
        __syncthreads();  // this slab is stored; the previous one is consumed
        if (more_slabs) load();
      }
      const float* A = qs + buf * SLAB;
      const float* B = xs + buf * SLAB;
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(A + kk * SLAB_LD + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(A + kk * SLAB_LD + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(B + kk * SLAB_LD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(B + kk * SLAB_LD + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float x[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], x[j], acc[i][j]);
      }
      if constexpr (!ASYNC) {
        if (more_slabs) {
          slab_store(rq, qs + (buf ^ 1) * SLAB);
          slab_store(rx, xs + (buf ^ 1) * SLAB);
          advance();
        }
      }
      buf = buf + 1 == NBUF ? 0 : buf + 1;
    }

    // ---- the tile's scores are complete: select
    unsigned long long pend = 0;  // bit 8i + j: score (i, j) still to offer
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = t0 + RSLOT(j);
      const bool live = r < row_hi;
      const float xsq = L2 && live ? db_sq[r] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (L2) acc[i][j] = 2.f * acc[i][j] - xsq;
        if (live && q0 + QSLOT(i) < nq) pend |= 1ull << (8 * i + j);
      }
    }
    while (true) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (((pend >> (8 * i)) & 0xffull) == 0) continue;
        const int qq = QSLOT(i);
        const float tv = thr_v[qq];
        const int ti = thr_i[qq];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned long long bit = 1ull << (8 * i + j);
          if (!(pend & bit)) continue;
          const int r = t0 + RSLOT(j);
          if (ranks_before(acc[i][j], r, tv, ti)) {
            const int slot = atomicAdd(cnt + qq, 1);
            if (slot >= CAND) continue;  // buffer full: offered next round
            cand_v[qq * CAND + slot] = acc[i][j];
            cand_i[qq * CAND + slot] = r;
          }
          pend &= ~bit;
        }
      }
      const int more = __syncthreads_or(pend != 0);
      for (int qq = warp; qq < TT; qq += NWARPS) {
        const int n = min(cnt[qq], CAND);  // warp-uniform
        if (n == 0) continue;
        float* lv = lvs + qq * k;
        int* li = lis + qq * k;
        for (int c0 = 0; c0 < n; c0 += 32) {
          const int c = c0 + lane;
          warp_offer(lv, li, k, c < n ? cand_v[qq * CAND + c] : -INFINITY,
                     c < n ? cand_i[qq * CAND + c] : -1, lane);
        }
        __syncwarp();
        if (lane == 0) {
          thr_v[qq] = lv[k - 1];
          thr_i[qq] = li[k - 1];
          cnt[qq] = 0;
        }
      }
      __syncthreads();
      if (!more) break;
    }
  }

  __syncthreads();
  const int n_splits = gridDim.y;
  for (int qq = warp; qq < TT && q0 + qq < nq; qq += NWARPS) {
    const size_t base = ((size_t)(q0 + qq) * n_splits + split) * k;
    for (int s = lane; s < k; s += 32) {
      part_v[base + s] = lvs[qq * k + s];
      part_i[base + s] = lis[qq * k + s];
    }
  }
}

// Stage 2: one block per query. Each warp merges a strided share of the
// n_cand = S * k partial candidates (the next chunk's loads issued before the
// current chunk is offered), then warp 0 merges the warps' lists and writes
// the public values: L2 max(||q||^2 - score, 0) with ||q||^2 summed here in
// f32, IP the score; -1 with inf (-inf for IP) in slots no live row fills
// and in slots k .. k_out - 1 (k_out > k when the database has fewer rows
// than the caller asked for).
template <typename T, bool L2>
__global__ void __launch_bounds__(THREADS)
merge_partials(const float* __restrict__ part_v, const int* __restrict__ part_i,
               const T* __restrict__ q, float* __restrict__ out_v, int* __restrict__ out_i,
               int n_cand, int k, int k_out, int d) {
  __shared__ float lvs[NWARPS * KMAX];
  __shared__ int lis[NWARPS * KMAX];
  __shared__ float qsq_w[NWARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t qi = blockIdx.x;
  float qsq = 0.f;
  if (L2) {
    for (int c = threadIdx.x; c < d; c += THREADS) {
      const float x = widen(q[qi * d + c]);
      qsq = fmaf(x, x, qsq);
    }
    for (int off = 16; off > 0; off >>= 1) qsq += __shfl_xor_sync(FULL_MASK, qsq, off);
    if (lane == 0) qsq_w[warp] = qsq;
  }
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
  if (L2) {
    qsq = lane < NWARPS ? qsq_w[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) qsq += __shfl_xor_sync(FULL_MASK, qsq, off);
  }
  for (int s = lane; s < k_out; s += 32) {
    const bool found = s < k && li[s] >= 0 && lv[s] > -FLT_MAX;
    float val = L2 ? INFINITY : -INFINITY;
    if (found) val = L2 ? fmaxf(qsq - lv[s], 0.f) : lv[s];
    out_v[qi * k_out + s] = val;
    out_i[qi * k_out + s] = found ? li[s] : -1;
  }
}

// The stage-1 kernel for one (dtype, metric, path), as a generic pointer.
template <typename T, bool L2>
static const void* scan_for(int path) {
  return path == TILED ? (const void*)scan_tiled<T, L2> : (const void*)scan_partial<T, L2>;
}
static const void* scan_kernel(int is_bf16, int is_l2, int path) {
  typedef __nv_bfloat16 bf16;
  if (is_bf16) return is_l2 ? scan_for<bf16, true>(path) : scan_for<bf16, false>(path);
  return is_l2 ? scan_for<float, true>(path) : scan_for<float, false>(path);
}
static const void* merge_kernel(int is_bf16, int is_l2) {
  typedef __nv_bfloat16 bf16;
  if (is_bf16) return is_l2 ? (const void*)merge_partials<bf16, true> : (const void*)merge_partials<bf16, false>;
  return is_l2 ? (const void*)merge_partials<float, true> : (const void*)merge_partials<float, false>;
}

// dc (scan_partial only) is the whole padded row, or a multiple of 8 below
// it (so chunk starts keep 16-byte row reads aligned for both dtypes).
static bool bad_shape(int d, int k, int path, int dc) {
  if (d < 1 || k < 1 || k > KMAX || path < WARP || path > TILED) return true;
  if (path == TILED) return false;
  const int d4 = round_up(d, 4);
  return dc < 4 || dc % 4 != 0 || dc > d4 || (dc < d4 && dc % 8 != 0);
}

extern "C" {

int rfe_flat_scan_kmax(void) { return KMAX; }

// Rows a block scores per tile, and queries per block, on each path.
int rfe_flat_scan_tile_rows(int path) { return path == TILED ? TT : TN; }
int rfe_flat_scan_block_queries(int path) { return path == TILED ? TT : NWARPS; }

// Stage-1 blocks one SM holds at once for this shape, or -(CUDA error).
int rfe_flat_scan_blocks_per_sm(int d, int k, int is_l2, int is_bf16, int path, int dc) {
  if (bad_shape(d, k, path, dc)) return -(int)cudaErrorInvalidValue;
  const void* fn = scan_kernel(is_bf16, is_l2, path);
  const size_t smem = smem_bytes(path, dc, k);
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
// out_i: (nq, k_out), k_out >= k. Split s covers rows [s * rows_per_split,
// (s + 1) * rows_per_split), clipped to n_rows; rows_per_split is a
// multiple of the path's tile rows. path: 0 = scan_partial (one query per
// warp), 1 = scan_tiled. dc: columns staged at once (path 0, see
// bad_shape). vec = 1 allows 16-byte row reads: d a multiple of 4 (f32) or
// 8 (bf16), db and q 16-byte aligned.
int rfe_flat_scan(const void* q, const void* db, const void* db_sq,
                  void* part_v, void* part_i, void* out_v, void* out_i,
                  int nq, int n_rows, int d, int k, int k_out, int is_l2, int is_bf16,
                  int path, int dc, int rows_per_split, int n_splits, int vec,
                  void* stream) {
  const int tile_rows = rfe_flat_scan_tile_rows(path);
  if (nq < 1 || n_rows < 1 || n_splits < 1 || bad_shape(d, k, path, dc) || k_out < k ||
      rows_per_split < 1 || rows_per_split % tile_rows != 0 || (is_l2 && !db_sq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = scan_kernel(is_bf16, is_l2, path);
  const size_t smem = smem_bytes(path, dc, k);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const int tq = rfe_flat_scan_block_queries(path);
  const dim3 grid((nq + tq - 1) / tq, n_splits);
  if (path == TILED) {
    void* args[] = {&q, &db, &db_sq, &part_v, &part_i, &nq, &n_rows, &d, &k,
                    &rows_per_split, &vec};
    e = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, s);
  } else {
    void* args[] = {&q, &db, &db_sq, &part_v, &part_i, &nq, &n_rows, &d, &k,
                    &dc, &rows_per_split, &vec};
    e = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, s);
  }
  if (e != cudaSuccess) return (int)e;
  int n_cand = n_splits * k;
  void* margs[] = {&part_v, &part_i, (void*)&q, &out_v, &out_i, &n_cand, &k, &k_out, &d};
  e = cudaLaunchKernel(merge_kernel(is_bf16, is_l2), dim3(nq), dim3(THREADS), margs, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
