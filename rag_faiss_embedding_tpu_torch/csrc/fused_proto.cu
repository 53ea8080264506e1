// Fused union-block top-k: for each (chunk, cell of bb union blocks), the
// exact top-kp rows of the cell per query.
//
// Replaces the TPU kernel benchmarks/pallas_fused_proto.py:71 `kern` (K5),
// reached through fused_pallas_chunks (:96, pallas_call :122) from
// search_pallas (:130). Same contract (the wrapper is ops/fused_proto.py):
//   * chunk c's bf16 queries (qc, D) are scored against every row of the bb
//     list blocks u_all[c, b*bb .. (b+1)*bb) of the block-padded storage
//     (nlist+1, window, D) bf16: s = 2 q.x - ||x||^2, accumulated in float32
//     (bf16 values widen exactly, so each product is exact and only the sum
//     order differs from the TPU's f32 accumulation), s = NEG_INF where the
//     row id is < 0;
//   * per query, kp passes of max-then-lowest-id over the cell's bb*window
//     rows, an id taken once per cell (pallas_scan._extract_topk masks by
//     id): the result is the kp best distinct ids, ordered by (score
//     descending, id ascending), each with its best score in the cell;
//   * slots past the cell's live rows hold NEG_INF and id -1 (the TPU
//     kernel's ids there are arbitrary).
// Output (chunks, ucap/bb, qc, kp) f32 scores and int32 ids.
//
// What bounds it on an H100. At the prototype's shape (4 chunks of 256
// queries, ucap 256 blocks of 256 x 384 bf16, bb 16) a call reads at most
// 4 x 256 x 256 x 384 x 2 = 201 MB of union blocks (0.06 ms at 3.35 TB/s)
// and does 2 x 1,024 x 65,536 x 384 = 51.5 GFLOP: about 0.05 ms on bf16
// tensor cores, 0.77 ms of FP32 FMA at 67 TFLOP/s. This kernel uses FP32 FMA
// (no wgmma yet), so the FMA rate bounds it; the cell's rows are re-read
// from L2 by each of a cell's query tiles.
//
// Design. A cell is bb * window * D * 2 = 3 MB, which the TPU held in VMEM;
// a block here has at most 227 KB of shared memory. So the grid is (chunk,
// cell, 32-query tile): 4 x 16 x 8 = 512 blocks at the prototype's shape.
// A block keeps its 32 queries resident in shared memory (widened to f32)
// and streams the cell's rows through a 64-row bf16 tile (16-byte loads,
// STAGE_UNROLL in flight per thread). Each warp owns 4 queries: every lane
// scores 2 rows x 4 queries from the tile, and the warp keeps a sorted top-kp
// list per query in shared memory (as csrc/flat_scan.cu does), inserting
// better candidates one at a time. An id already in the list is not
// inserted twice: a better score replaces its entry, a worse one is
// dropped, which gives the TPU's take-once-per-cell rule for any order of
// arrival. kp <= KPMAX = 32, one list slot per lane.
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#define KPMAX 32     // largest kp: one list slot per lane
#define TN 64        // rows per tile: two per lane
#define NWARPS 8
#define QW 4         // queries per warp
#define TQ (NWARPS * QW)
#define THREADS (NWARPS * 32)
#define STAGE_UNROLL 8
#define FULL_MASK 0xffffffffu

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// tile row stride in bf16 values: 16 bytes past a multiple of 128, so the
// eight lanes of a 16-byte load phase hit eight different bank groups
__host__ __device__ inline int tile_stride(int d) { return round_up(d, 64) + 8; }

static size_t smem_bytes(int d, int kp) {
  return sizeof(__nv_bfloat16) * (size_t)TN * tile_stride(d) + sizeof(float) * (size_t)TQ * d +
         (sizeof(float) + sizeof(int)) * ((size_t)TN + (size_t)TQ * kp);
}

// (score desc, id asc): does (av, ai) rank before (bv, bi)? Id -1 (an empty
// slot) compares as the largest id.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && (unsigned)ai < (unsigned)bi);
}

// Insert (v, i) into the warp's sorted list (lv, li) of length kp in shared
// memory; lane s holds slot s. All lanes call this with the same arguments.
// If id i is already listed, the better of its two entries stays.
__device__ void warp_insert(float* lv, int* li, int kp, float v, int i, int lane) {
  const bool mine = lane < kp;
  const float cv = mine ? lv[lane] : -FLT_MAX;
  const int ci = mine ? li[lane] : -1;
  int before = mine && ranks_before(cv, ci, v, i);
  int old = mine && ci == i ? lane : kp;  // the id's slot, kp if absent
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(FULL_MASK, before, off);
    old = min(old, __shfl_xor_sync(FULL_MASK, old, off));
  }
  if (old < kp && !ranks_before(v, i, lv[old], li[old])) return;  // warp-uniform
  // slots before p keep their entry, p takes the candidate, p+1 .. last
  // shift down by one, where last is the id's old slot (or the list's end)
  const int p = before, last = min(old, kp - 1);
  float nv = cv;
  int ni = ci;
  if (mine && lane == p) { nv = v; ni = i; }
  else if (mine && lane > p && lane <= last) { nv = lv[lane - 1]; ni = li[lane - 1]; }
  __syncwarp();
  if (mine) { lv[lane] = nv; li[lane] = ni; }
  __syncwarp();
}

// Offer one candidate per lane; those that rank before the list's last
// entry are inserted one at a time, in lane order. Dead rows (id < 0) and
// NEG_INF scores never enter.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int kp, float cv, int ci, int lane) {
  const bool better = ci >= 0 && cv > -FLT_MAX && ranks_before(cv, ci, lv[kp - 1], li[kp - 1]);
  unsigned pending = __ballot_sync(FULL_MASK, better);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const float v = __shfl_sync(FULL_MASK, cv, src);
    const int i = __shfl_sync(FULL_MASK, ci, src);
    if (ranks_before(v, i, lv[kp - 1], li[kp - 1])) warp_insert(lv, li, kp, v, i, lane);
  }
}

// 8 bf16 values of 16 bytes widened to f32 (bf16 is the top half of an f32)
__device__ __forceinline__ void widen8(const uint4& a, float (&x)[8]) {
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// grid (chunks, ucap / bb, ceil(qc / TQ)). q (chunks, qc, d) bf16; u_all
// (chunks, ucap) int32 block ids; codes (nlist+1, window, d) bf16; sq / ids
// (nlist+1, window) f32 / int32; out_v / out_i (chunks, ucap/bb, qc, kp).
__global__ void __launch_bounds__(THREADS)
block_topk_kernel(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
                  const __nv_bfloat16* __restrict__ codes, const float* __restrict__ sq,
                  const int* __restrict__ ids, float* __restrict__ out_v,
                  int* __restrict__ out_i, int qc, int d, int ucap, int window, int bb,
                  int kp) {
  extern __shared__ float4 smem4[];
  const int stride = tile_stride(d);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem4);  // TN x stride
  float* qs = reinterpret_cast<float*>(tile + (size_t)TN * stride);  // TQ x d
  float* sq_s = qs + TQ * d;                                         // TN
  int* rid_s = reinterpret_cast<int*>(sq_s + TN);                    // TN
  float* lvs = reinterpret_cast<float*>(rid_s + TN);                 // TQ x kp
  int* lis = reinterpret_cast<int*>(lvs + TQ * kp);                  // TQ x kp

  const int chunk = blockIdx.x, cell = blockIdx.y, q0 = blockIdx.z * TQ;
  const int nb = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int live_q = min(QW, qc - (q0 + warp * QW));  // this warp's queries

  for (int e = tid; e < TQ * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    qs[e] = q0 + r < qc ? __bfloat162float(q[((size_t)chunk * qc + q0 + r) * d + c]) : 0.f;
  }
  for (int s = tid; s < TQ * kp; s += THREADS) {
    lvs[s] = -FLT_MAX;
    lis[s] = -1;
  }

  const int per_row = d / 8, total = TN * per_row;
  const int tiles = bb * window / TN;
  const int* cell_blocks = u_all + (size_t)chunk * ucap + (size_t)cell * bb;
  for (int t = 0; t < tiles; ++t) {
    const int r0 = t * TN;  // the tile's first row within the cell
    const size_t row0 = (size_t)cell_blocks[r0 / window] * window + r0 % window;
    __syncthreads();  // the previous tile (at first the queries) is consumed / staged
    const __nv_bfloat16* src = codes + row0 * d;  // TN rows, one contiguous run
    for (int base = tid; base < total; base += THREADS * STAGE_UNROLL) {
      uint4 buf[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int e = base + u * THREADS;
        if (e < total) buf[u] = *reinterpret_cast<const uint4*>(src + (size_t)e * 8);
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int e = base + u * THREADS;
        if (e < total) {
          const int r = e / per_row;
          *reinterpret_cast<uint4*>(tile + (size_t)r * stride + (e - r * per_row) * 8) = buf[u];
        }
      }
    }
    if (tid < TN) {
      sq_s[tid] = sq[row0 + tid];
      rid_s[tid] = ids[row0 + tid];
    }
    __syncthreads();
    if (live_q <= 0) continue;  // warp-uniform

    float acc[QW][2];
#pragma unroll
    for (int j = 0; j < QW; ++j) acc[j][0] = acc[j][1] = 0.f;
    const __nv_bfloat16* x0 = tile + (size_t)lane * stride;
    const __nv_bfloat16* x1 = tile + (size_t)(lane + 32) * stride;
    const float* qw0 = qs + warp * QW * d;
#pragma unroll 2
    for (int c = 0; c < d; c += 8) {
      float a[8], b[8];
      widen8(*reinterpret_cast<const uint4*>(x0 + c), a);
      widen8(*reinterpret_cast<const uint4*>(x1 + c), b);
#pragma unroll
      for (int j = 0; j < QW; ++j) {
#pragma unroll
        for (int h = 0; h < 8; h += 4) {
          const float4 u = *reinterpret_cast<const float4*>(qw0 + j * d + c + h);
          acc[j][0] = fmaf(u.x, a[h], acc[j][0]);
          acc[j][0] = fmaf(u.y, a[h + 1], acc[j][0]);
          acc[j][0] = fmaf(u.z, a[h + 2], acc[j][0]);
          acc[j][0] = fmaf(u.w, a[h + 3], acc[j][0]);
          acc[j][1] = fmaf(u.x, b[h], acc[j][1]);
          acc[j][1] = fmaf(u.y, b[h + 1], acc[j][1]);
          acc[j][1] = fmaf(u.z, b[h + 2], acc[j][1]);
          acc[j][1] = fmaf(u.w, b[h + 3], acc[j][1]);
        }
      }
    }
    const int i0 = rid_s[lane], i1 = rid_s[lane + 32];
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      if (j >= live_q) break;  // warp-uniform
      const float s0 = i0 >= 0 ? 2.f * acc[j][0] - sq_s[lane] : -FLT_MAX;
      const float s1 = i1 >= 0 ? 2.f * acc[j][1] - sq_s[lane + 32] : -FLT_MAX;
      float* lv = lvs + (warp * QW + j) * kp;
      int* li = lis + (warp * QW + j) * kp;
      warp_offer(lv, li, kp, s0, i0, lane);
      warp_offer(lv, li, kp, s1, i1, lane);
    }
  }

  for (int j = 0; j < live_q; ++j) {
    const int qi = q0 + warp * QW + j;
    const size_t base = (((size_t)chunk * nb + cell) * qc + qi) * kp;
    if (lane < kp) {
      out_v[base + lane] = lvs[(warp * QW + j) * kp + lane];
      out_i[base + lane] = lis[(warp * QW + j) * kp + lane];
    }
  }
}

extern "C" {

int rfe_fused_proto_kp_max(void) { return KPMAX; }
int rfe_fused_proto_tile_rows(void) { return TN; }

const char* rfe_fused_proto_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (chunks, qc, d) bf16; u_all (chunks, ucap) int32 block ids in [0,
// nlist]; codes (nlist+1, window, d) bf16; sq (nlist+1, window) f32; ids
// (nlist+1, window) int32, -1 = dead. out_v / out_i (chunks, ucap/bb, qc,
// kp). d a multiple of 8, window of TN, ucap of bb, 1 <= kp <= KPMAX,
// q and codes 16-byte aligned.
int rfe_fused_proto(const void* q, const void* u_all, const void* codes, const void* sq,
                    const void* ids, void* out_v, void* out_i, int chunks, int qc, int d,
                    int ucap, int window, int bb, int kp, void* stream) {
  if (chunks < 1 || qc < 1 || d < 8 || d % 8 != 0 || window < TN || window % TN != 0 ||
      bb < 1 || ucap < bb || ucap % bb != 0 || kp < 1 || kp > KPMAX ||
      (reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, kp);
  cudaError_t e = cudaFuncSetAttribute(block_topk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(chunks, ucap / bb, (qc + TQ - 1) / TQ);
  block_topk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int*>(u_all),
      static_cast<const __nv_bfloat16*>(codes), static_cast<const float*>(sq),
      static_cast<const int*>(ids), static_cast<float*>(out_v), static_cast<int*>(out_i), qc, d,
      ucap, window, bb, kp);
  return (int)cudaGetLastError();
}

}  // extern "C"
