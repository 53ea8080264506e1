// Union-scan stage probe: the IVF union scan's scoring and binned selection
// on synthetic blocks, with the selection done four ways.
//
// Replaces the TPU kernel benchmarks/pallas_kernel_probe.py:57
// `make_kernel(variant)` (K6), reached through build (:129, pallas_call
// :147). Same contract (the wrapper is ops/kernel_probe.py):
//   * chunk c's bf16 queries (qc, D) are scored against the list blocks
//     u_all[c, 0..U) of (nlist+1, window, D) bf16 rows in float32:
//     s = 2 q.x - rsq, NEG_INF where the row id is < 0; aux3 (nlist+1, 2,
//     window) int32 holds rsq's float32 bits (row 0) and the ids (row 1);
//   * packed = (mono(s) & ~(2^nbits - 1)) | (b * bb + j), the block's union
//     position, for cell b and block j of the cell (U % bb == 0);
//   * "none": no selection; every one of the cap levels holds the packed
//     tile of the last block (U - 1);
//     "chain": each (query, slot) bin keeps its top cap packed values by an
//     int32 max/min chain over the U blocks in order, the bins in shared
//     memory, read, changed and written back for every block;
//     "temps": the same chain with the bins in registers through a cell of
//     bb blocks, shared memory touched once per cell (the same bits as
//     "chain");
//     "temps_f32": "temps" on the float32 view of the packed ints, with
//     jnp.maximum / jnp.minimum semantics: a NaN operand wins (the first
//     one, if both are), otherwise the larger / smaller value. A packed int
//     reads as a NaN only where its score is a negative subnormal or -0;
//     denormals are kept (no -ftz, no fast math). On negative scores the
//     float view orders backwards, so the probe's bins stay at INIT there:
//     that is the TPU probe's own semantics, reproduced, not repaired.
// Output (chunks, qc, cap * window) int32, level major.
//
// What bounds it on an H100. At the probe's shape (4 chunks of 256 queries,
// U 260 blocks of 256 x 384 bf16) a call reads 4 x 260 x 256 x (768 + 8) =
// 207 MB of blocks (0.06 ms at 3.35 TB/s) and does 2 x 1,024 x 66,560 x 384
// = 52.3 GFLOP: 0.053 ms on bf16 tensor cores, 0.78 ms of FP32 FMA at 67
// TFLOP/s. So the bytes bound it once the product runs on the tensor cores
// (the TPU ran it on the MXU).
//
// Design (probe_tc). The TPU walked the U blocks in order (a sequential
// grid axis) with the bins in VMEM scratch. Here the U blocks are walked in
// order inside one CUDA block, so the chain sees the blocks in the TPU's
// order (for temps_f32 a split-and-merge would not give the sequential
// chain's bits, and it would change what the probe times); the grid splits
// queries and slots only. A block holds PT_Q = 128 of a chunk's queries as
// bf16 in shared memory and PT_S = 16 slots. A step is two union blocks:
// their 16 slot rows each make one 32-row operand, which four warps multiply
// against 32 queries each with mma.sync m16n8k16 (bf16 -> f32,
// mma_tile.cuh); a ring of three steps streams in by cp.async, two ahead of
// the product. An accumulator element is a fixed (slot, query) pair, so its
// thread owns that bin: "temps" and "temps_f32" keep its cap values in
// registers through a cell, "chain" reads and writes them in shared memory
// for every block. The grid is (query tile, slot tile, chunk): 2 x 16 x 4 =
// 128 blocks at the probe's shape, one wave on 132 SMs. The price of filling
// the card without splitting U: each block reads its slot tile of every
// union block, so each tile is read once per query tile, 2 x 207 MB from L2
// (the two query tiles of a slot tile run side by side, so HBM sees it
// about once).
//
// The FMA kernel (probe_fma, the first design: 16 queries x 64 slots per
// block in f32, one slot x 4 queries per thread) serves the shapes the
// tensor-core block cannot take: D not a multiple of 16, or a D whose
// block does not fit in shared memory. The wrapper picks the kernel by
// shape before the launch (rfe_kernel_probe_tc_fits).
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch.cuh"
#include "mma_tile.cuh"

#define MAX_CAP 4

// probe_tc
#define PT_Q 128      // queries per block
#define PT_S 16       // slots per block
#define PT_NT 4       // 8-query n-tiles per warp: warp_tile_product's 32 queries
#define PT_THREADS (PT_Q / (8 * PT_NT) * 32)
#define PT_PAD 8      // bf16 padding per shared row: row stride 16 mod 128 bytes
#define BIN_LD (PT_S + 4)  // bin row stride: a warp's 4 query pairs hit distinct banks
#define PT_NBUF 3     // ring of steps (two union blocks each) in shared memory

// probe_fma
#define TN 64        // slots per block
#define TQ 16        // queries per block
#define QPT 4        // queries per thread
#define THREADS 256  // TN * TQ / QPT
#define STAGE_UNROLL 8

enum Variant { NONE = 0, CHAIN = 1, TEMPS = 2, TEMPS_F32 = 3 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// tile row stride in bf16 values: 16 bytes past a multiple of 128 bytes
__host__ __device__ inline int tile_stride(int d) { return round_up(d, 64) + 8; }

static size_t fma_smem_bytes(int d, int cap) {
  return sizeof(__nv_bfloat16) * (size_t)TN * tile_stride(d) + sizeof(float) * (size_t)TQ * d +
         (sizeof(float) + sizeof(int)) * TN + sizeof(int) * (size_t)cap * TQ * TN;
}

// queries and the ring's row tiles (bf16), their norms and ids, the bins
static size_t tc_smem_bytes(int d, int cap) {
  return sizeof(__nv_bfloat16) * (size_t)(PT_Q + PT_NBUF * 2 * PT_S) * (d + PT_PAD) +
         (sizeof(float) + sizeof(int)) * PT_NBUF * 2 * PT_S +
         sizeof(int) * (size_t)cap * PT_Q * BIN_LD;
}

// order-preserving f32 -> int32 (ops/pallas_scan.py::_monotone_i32)
__device__ __forceinline__ int mono_i32(float s) {
  const int b = __float_as_int(s);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

// jnp.maximum / jnp.minimum on float32: NaN propagates (the first operand's
// if both are NaN); bare fmaxf would drop it
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// one level-cascade of a bin: the demoted value moves down
template <int CAP>
__device__ __forceinline__ void chain_i32(int (&run)[CAP], int t) {
#pragma unroll
  for (int l = 0; l < CAP; ++l) {
    const int cur = run[l];
    run[l] = max(cur, t);
    t = min(cur, t);
  }
}
template <int CAP>
__device__ __forceinline__ void chain_f32(float (&run)[CAP], float t) {
#pragma unroll
  for (int l = 0; l < CAP; ++l) {
    const float cur = run[l];
    run[l] = nan_max(cur, t);
    t = nan_min(cur, t);
  }
}

// grid (ceil(qc / PT_Q), window / PT_S, chunks); arguments as probe_fma.
// Warp w owns queries 32 w .. + 31 of the block's. A step is a pair of
// union blocks (2 i, 2 i + 1), multiplied together as one 32-row A operand
// (eight independent accumulator chains a warp), then selected block by
// block in order. Element e of tile (h2, nt) is block 2 i + h2, slot
// lane / 4 + 8 (e >> 1), query 32 w + 8 nt + 2 (lane % 4) + (e & 1).
// d a multiple of 16.
template <int VARIANT, int CAP>
__global__ void __launch_bounds__(PT_THREADS)
probe_tc(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
         const __nv_bfloat16* __restrict__ codes, const int* __restrict__ aux,
         int* __restrict__ out, int qc, int d, int u, int window, int bb, int nbits,
         int init_packed) {
  extern __shared__ float4 smem4[];
  const int ld = d + PT_PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // PT_Q x ld
  __nv_bfloat16* rows = qs + PT_Q * ld;                  // PT_NBUF x 2 x PT_S x ld
  float* rsq_s = reinterpret_cast<float*>(rows + PT_NBUF * 2 * PT_S * ld);  // PT_NBUF x 2 x PT_S
  int* rid_s = reinterpret_cast<int*>(rsq_s + PT_NBUF * 2 * PT_S);          // PT_NBUF x 2 x PT_S
  int* bins = rid_s + PT_NBUF * 2 * PT_S;  // CAP x PT_Q x BIN_LD: "chain" / "temps*"

  const int q0 = blockIdx.x * PT_Q, slot0 = blockIdx.y * PT_S, chunk = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mask_hi = ~((1 << nbits) - 1);
  const int live_q = min(PT_Q, qc - q0);
  const bool warp_live = warp * 8 * PT_NT < live_q;  // warp-uniform
  const int pieces = d / 8;                   // 16-byte pieces per row
  const int nsteps = (u + 1) / 2;
  // this thread's 16-byte pieces of a tile are tid, tid + PT_THREADS, ..:
  // (row, piece) of the first, and the step, so no division per piece
  const int st_r = tid / pieces, st_c = tid - st_r * pieces;
  const int dr = PT_THREADS / pieces, dc = PT_THREADS - dr * pieces;

  // the block's queries, zero past qc: in the first copy group
  for (int e = tid; e < PT_Q * pieces; e += PT_THREADS) {
    const int r = e / pieces, c = (e - r * pieces) * 8;
    const bool ok = r < live_q;
    cp_async16(qs + r * ld + c, ok ? q + ((size_t)chunk * qc + q0 + r) * d + c : q, ok);
  }
  // step i: slots slot0 .. + PT_S - 1 of union blocks 2 i and 2 i + 1 (one
  // contiguous run each), their norms' bits and ids, into ring buffer buf;
  // past U the second half is left as it is, and never selected from
  auto stage = [&](int i, int buf) {
    for (int h2 = 0; h2 < 2 && 2 * i + h2 < u; ++h2) {
      const size_t blk = u_all[(size_t)chunk * u + 2 * i + h2];
      const __nv_bfloat16* src = codes + (blk * window + slot0) * d;
      __nv_bfloat16* dst = rows + (buf * 2 + h2) * PT_S * ld;
      for (int r = st_r, c = st_c; r < PT_S;) {
        cp_async16(dst + r * ld + c * 8, src + (size_t)r * d + c * 8, true);
        r += dr;
        c += dc;
        if (c >= pieces) {
          c -= pieces;
          ++r;
        }
      }
      if (tid < 2 * PT_S) {  // row 0 of aux: the norms' bits; row 1: the ids
        const int row = tid / PT_S, s = tid % PT_S;
        cp_async4((row ? rid_s : reinterpret_cast<int*>(rsq_s)) + (buf * 2 + h2) * PT_S + s,
                  aux + (blk * 2 + row) * window + slot0 + s, true);
      }
    }
  };
  // the bin of (level l, query qq of the block, slot s of the block)
  auto bin = [&](int l, int qq, int s) -> int& { return bins[(l * PT_Q + qq) * BIN_LD + s]; };
  const int qbase = warp * 8 * PT_NT + 2 * t4;  // + 8 nt + c: this thread's queries

  if (VARIANT != NONE && warp_live) {
#pragma unroll
    for (int nt = 0; nt < PT_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int l = 0; l < CAP; ++l) bin(l, qbase + nt * 8 + (e & 1), g + 8 * (e >> 1)) = init_packed;
  }
  int last[PT_NT][4];            // "none": the last packed tile
  int run_i[PT_NT][4][CAP];      // "temps": the bins through a cell
  float run_f[PT_NT][4][CAP];    // "temps_f32"

  for (int i = 0; i < PT_NBUF - 1; ++i) {
    if (i < nsteps) stage(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<PT_NBUF - 2>();  // step i has landed (this thread's copies)
    __syncthreads();               // ... everyone's; step i - 1's buffer is consumed
    if (i + PT_NBUF - 1 < nsteps) stage(i + PT_NBUF - 1, (i + PT_NBUF - 1) % PT_NBUF);
    cp_async_commit();
    const int buf = i % PT_NBUF;
    if (!warp_live) continue;
    float acc[2][PT_NT][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int nt = 0; nt < PT_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h2][nt][e] = 0.f;
    warp_tile_product<2>(acc, mma_rows_ptr(rows + buf * 2 * PT_S * ld, ld, lane),
                         mma_queries_ptr(qs + warp * 8 * PT_NT * ld, ld, lane), ld, d);
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {  // the two union blocks, in order
      const int ub = 2 * i + h2;
      if (ub >= u) break;
      const int jb = ub % bb;  // position in the cell
      if (jb == 0) {  // a cell starts: the bins come in
#pragma unroll
        for (int nt = 0; nt < PT_NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int l = 0; l < CAP; ++l) {
              const int b = bin(l, qbase + nt * 8 + (e & 1), g + 8 * (e >> 1));
              if (VARIANT == TEMPS) run_i[nt][e][l] = b;
              if (VARIANT == TEMPS_F32) run_f[nt][e][l] = __int_as_float(b);
            }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (buf * 2 + h2) * PT_S + g + 8 * h;
        const int id = rid_s[r];
        const float rsq = rsq_s[r];
#pragma unroll
        for (int nt = 0; nt < PT_NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * h + c;
            const float s = id >= 0 ? 2.f * acc[h2][nt][e] - rsq : -FLT_MAX;
            const int packed = (mono_i32(s) & mask_hi) | ub;
            if (VARIANT == NONE) {
              last[nt][e] = packed;
            } else if (VARIANT == CHAIN) {
              int t = packed;
#pragma unroll
              for (int l = 0; l < CAP; ++l) {  // read, change, write back
                int& b = bin(l, qbase + nt * 8 + c, g + 8 * h);
                const int cur = b;
                b = max(cur, t);
                t = min(cur, t);
              }
            } else if (VARIANT == TEMPS) {
              chain_i32<CAP>(run_i[nt][e], packed);
            } else {
              chain_f32<CAP>(run_f[nt][e], __int_as_float(packed));
            }
          }
      }
      if (jb == bb - 1 && (VARIANT == TEMPS || VARIANT == TEMPS_F32)) {  // the bins go out
#pragma unroll
        for (int nt = 0; nt < PT_NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int l = 0; l < CAP; ++l)
              bin(l, qbase + nt * 8 + (e & 1), g + 8 * (e >> 1)) =
                  VARIANT == TEMPS ? run_i[nt][e][l] : __float_as_int(run_f[nt][e][l]);
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int nt = 0; nt < PT_NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qq = qbase + nt * 8 + (e & 1), s = g + 8 * (e >> 1);
      if (q0 + qq >= qc) continue;
      int* dst = out + ((size_t)chunk * qc + q0 + qq) * CAP * window + slot0 + s;
#pragma unroll
      for (int l = 0; l < CAP; ++l) dst[(size_t)l * window] = VARIANT == NONE ? last[nt][e] : bin(l, qq, s);
    }
}

// grid (chunks, ceil(qc / TQ), window / TN). out (chunks, qc, cap * window).
// The sums run in column order (fmaf), as the plain version's.
template <int VARIANT, int CAP>
__global__ void __launch_bounds__(THREADS)
probe_fma(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
             const __nv_bfloat16* __restrict__ codes, const int* __restrict__ aux,
             int* __restrict__ out, int qc, int d, int u, int window, int bb, int nbits,
             int init_packed) {
  extern __shared__ float4 smem4[];
  const int stride = tile_stride(d);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem4);      // TN x stride
  float* qs = reinterpret_cast<float*>(tile + (size_t)TN * stride);     // TQ x d
  float* rsq_s = qs + TQ * d;                                           // TN
  int* rid_s = reinterpret_cast<int*>(rsq_s + TN);                      // TN
  int* bins = rid_s + TN;  // CAP x TQ x TN: the chain's bins, "chain" / "temps*"

  const int chunk = blockIdx.x, q0 = blockIdx.y * TQ, slot0 = blockIdx.z * TN;
  const int tid = threadIdx.x, r = tid % TN, g = tid / TN;  // slot, query group
  const int mask_hi = ~((1 << nbits) - 1);

  for (int e = tid; e < TQ * d; e += THREADS) {
    const int j = e / d, c = e - j * d;
    qs[e] = q0 + j < qc ? __bfloat162float(q[((size_t)chunk * qc + q0 + j) * d + c]) : 0.f;
  }
  // bin (level l, query j of this thread, slot r), in shared memory
  auto bin = [&](int l, int j) -> int& { return bins[(l * TQ + g * QPT + j) * TN + r]; };
  if (VARIANT != NONE) {
#pragma unroll
    for (int j = 0; j < QPT; ++j)
#pragma unroll
      for (int l = 0; l < CAP; ++l) bin(l, j) = init_packed;
  }
  int last[QPT];            // "none": the last packed tile
  int run_i[QPT][CAP];      // "temps": the bins through a cell
  float run_f[QPT][CAP];    // "temps_f32"

  const int per_row = d / 8, total = TN * per_row;
  for (int ub = 0; ub < u; ++ub) {
    const int jb = ub % bb;  // position in the cell
    const size_t row0 = (size_t)u_all[(size_t)chunk * u + ub] * window + slot0;
    const size_t blk = row0 / window;
    __syncthreads();  // the previous tile (at first the queries) is consumed / staged
    const __nv_bfloat16* src = codes + row0 * d;  // TN rows, one contiguous run
    for (int base = tid; base < total; base += THREADS * STAGE_UNROLL) {
      uint4 buf[STAGE_UNROLL];
#pragma unroll
      for (int k = 0; k < STAGE_UNROLL; ++k) {
        const int e = base + k * THREADS;
        if (e < total) buf[k] = *reinterpret_cast<const uint4*>(src + (size_t)e * 8);
      }
#pragma unroll
      for (int k = 0; k < STAGE_UNROLL; ++k) {
        const int e = base + k * THREADS;
        if (e < total) {
          const int rr = e / per_row;
          *reinterpret_cast<uint4*>(tile + (size_t)rr * stride + (e - rr * per_row) * 8) = buf[k];
        }
      }
    }
    if (tid < TN) {
      const int* a = aux + blk * 2 * window + (slot0 + tid);
      rsq_s[tid] = __int_as_float(a[0]);
      rid_s[tid] = a[window];
    }
    __syncthreads();

    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    const __nv_bfloat16* x = tile + (size_t)r * stride;
    const float* qg = qs + g * QPT * d;
#pragma unroll 2
    for (int c = 0; c < d; c += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(x + c);
      const unsigned w[4] = {a.x, a.y, a.z, a.w};
      float xv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an f32
        xv[2 * i] = __uint_as_float(w[i] << 16);
        xv[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          const float4 v = *reinterpret_cast<const float4*>(qg + j * d + c + h);
          acc[j] = fmaf(v.x, xv[h], acc[j]);
          acc[j] = fmaf(v.y, xv[h + 1], acc[j]);
          acc[j] = fmaf(v.z, xv[h + 2], acc[j]);
          acc[j] = fmaf(v.w, xv[h + 3], acc[j]);
        }
      }
    }
    if (VARIANT == TEMPS && jb == 0) {  // a cell starts: the bins come in
#pragma unroll
      for (int j = 0; j < QPT; ++j)
#pragma unroll
        for (int l = 0; l < CAP; ++l) run_i[j][l] = bin(l, j);
    }
    if (VARIANT == TEMPS_F32 && jb == 0) {
#pragma unroll
      for (int j = 0; j < QPT; ++j)
#pragma unroll
        for (int l = 0; l < CAP; ++l) run_f[j][l] = __int_as_float(bin(l, j));
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float s = rid_s[r] >= 0 ? 2.f * acc[j] - rsq_s[r] : -FLT_MAX;
      const int packed = (mono_i32(s) & mask_hi) | ub;
      if (VARIANT == NONE) {
        last[j] = packed;
      } else if (VARIANT == CHAIN) {
        int t = packed;
#pragma unroll
        for (int l = 0; l < CAP; ++l) {  // read, change, write back
          const int cur = bin(l, j);
          bin(l, j) = max(cur, t);
          t = min(cur, t);
        }
      } else if (VARIANT == TEMPS) {
        chain_i32<CAP>(run_i[j], packed);
      } else {
        chain_f32<CAP>(run_f[j], __int_as_float(packed));
      }
    }
    if (jb == bb - 1) {  // a cell ends: the bins go out
      if (VARIANT == TEMPS) {
#pragma unroll
        for (int j = 0; j < QPT; ++j)
#pragma unroll
          for (int l = 0; l < CAP; ++l) bin(l, j) = run_i[j][l];
      }
      if (VARIANT == TEMPS_F32) {
#pragma unroll
        for (int j = 0; j < QPT; ++j)
#pragma unroll
          for (int l = 0; l < CAP; ++l) bin(l, j) = __float_as_int(run_f[j][l]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + g * QPT + j;
    if (qi >= qc) break;
    int* dst = out + ((size_t)chunk * qc + qi) * CAP * window + slot0 + r;
#pragma unroll
    for (int l = 0; l < CAP; ++l) dst[(size_t)l * window] = VARIANT == NONE ? last[j] : bin(l, j);
  }
}

template <int VARIANT>
static const void* kernel_for_cap(int cap, int tc) {
  switch (cap) {
    case 1: return tc ? (const void*)probe_tc<VARIANT, 1> : (const void*)probe_fma<VARIANT, 1>;
    case 2: return tc ? (const void*)probe_tc<VARIANT, 2> : (const void*)probe_fma<VARIANT, 2>;
    case 3: return tc ? (const void*)probe_tc<VARIANT, 3> : (const void*)probe_fma<VARIANT, 3>;
    default: return tc ? (const void*)probe_tc<VARIANT, 4> : (const void*)probe_fma<VARIANT, 4>;
  }
}

static const void* probe_for(int variant, int cap, int tc) {
  switch (variant) {
    case NONE: return kernel_for_cap<NONE>(cap, tc);
    case CHAIN: return kernel_for_cap<CHAIN>(cap, tc);
    case TEMPS: return kernel_for_cap<TEMPS>(cap, tc);
    default: return kernel_for_cap<TEMPS_F32>(cap, tc);
  }
}

extern "C" {

int rfe_kernel_probe_max_cap(void) { return MAX_CAP; }
int rfe_kernel_probe_tile_rows(void) { return TN; }

const char* rfe_kernel_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 if the tensor-core kernel takes width d and cap on the current device
// (d a multiple of 16 whose block fits in shared memory), 0 if the FMA
// kernel must, or -(CUDA error).
int rfe_kernel_probe_tc_fits(int d, int cap) {
  if (d < 16 || d % 16 != 0 || cap < 1 || cap > MAX_CAP) return 0;
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  return tc_smem_bytes(d, cap) <= (size_t)optin ? 1 : 0;
}

// variant 0 / 1 / 2 / 3: none / chain / temps / temps_f32. q (chunks, qc,
// d) bf16; u_all (chunks, u) int32 block ids in [0, nlist]; codes (nlist+1,
// window, d) bf16; aux (nlist+1, 2, window) int32 (rsq bits, ids). out
// (chunks, qc, cap * window) int32. d a multiple of 8, window of TN, u of
// bb, 1 <= cap <= MAX_CAP, 2^nbits >= u, q and codes 16-byte aligned. The
// kernel is chosen by shape: probe_tc where rfe_kernel_probe_tc_fits(d,
// cap), else probe_fma.
int rfe_kernel_probe(int variant, const void* q, const void* u_all, const void* codes,
                     const void* aux, void* out, int chunks, int qc, int d, int u, int window,
                     int bb, int cap, int nbits, int init_packed, void* stream) {
  if (variant < NONE || variant > TEMPS_F32 || chunks < 1 || qc < 1 || d < 8 || d % 8 != 0 ||
      window < TN || window % TN != 0 || u < 1 || bb < 1 || u % bb != 0 || cap < 1 ||
      cap > MAX_CAP || nbits < 1 || nbits > 30 || (1 << nbits) < u ||
      (reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tc = rfe_kernel_probe_tc_fits(d, cap);
  if (tc < 0) return -tc;
  const void* fn = probe_for(variant, cap, tc);
  const size_t smem = tc ? tc_smem_bytes(d, cap) : fma_smem_bytes(d, cap);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&q, (void*)&u_all, (void*)&codes, (void*)&aux, &out, &qc, &d, &u,
                  &window, &bb, &nbits, &init_packed};
  const dim3 grid = tc ? dim3((qc + PT_Q - 1) / PT_Q, window / PT_S, chunks)
                       : dim3(chunks, (qc + TQ - 1) / TQ, window / TN);
  e = cudaLaunchKernel(fn, grid, dim3(tc ? PT_THREADS : THREADS), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
