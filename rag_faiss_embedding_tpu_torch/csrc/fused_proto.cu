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
// 4 x 256 x 256 x 384 x 2 = 201 MB of union blocks (0.06 ms at 3.35 TB/s).
// Its live work (the real queries against the live rows of each chunk's
// distinct blocks) is 27.8 GFLOP on the 1M index: 0.028 ms on bf16 tensor
// cores, 0.415 ms of FP32 FMA. So the bytes bound it, and the product has
// to run on the tensor cores (the TPU ran it on the MXU) to come near them.
//
// Design (block_topk_tc). The TPU held a whole 3 MB cell in VMEM; here a
// block holds TC_Q = 128 of a chunk's queries as bf16 in shared memory and
// streams the cell's rows through 64-row tiles, the next tile coming in by
// cp.async under the current tile's product. The grid is (query tile,
// cell, chunk): 2 x 16 x 4 = 128 blocks at the prototype's shape, one wave
// on 132 SMs; a cell's two query tiles run side by side, so its second read
// mostly hits L2. Eight warps each multiply 32 rows x 32 queries with
// mma.sync m16n8k16 (bf16 -> f32, mma_tile.cuh, as K2's stage 1).
// Selection follows K1's tiled path (flat_scan.cu scan_tiled): each query
// keeps its kp-th (score, id) as a threshold in shared memory; after a tile,
// only the scores that rank before it go to a CAND-slot buffer per query (a
// full buffer leaves the rest for another round; the 8 lanes that hold a
// query's scores take their slots with one atomic), and thread q inserts
// query q's buffer into its sorted list, held in registers. An insertion
// keeps an id once: a better score replaces its entry, a worse one is
// dropped, which gives the take-once-per-cell rule for any order of
// arrival. kp <= KPMAX = 32. On the card the selection, not the product,
// sets the pace (PERF.md, the kernel table's findings).
//
// The FMA kernel (block_topk_fma, the first design: 32 queries per block in
// f32, 2 rows x 4 queries per lane, every row offered to the lists) serves
// the shapes the tensor-core block cannot take: D not a multiple of 16, or
// D > 400, where its shared memory does not fit. The wrapper picks the
// kernel by shape before the launch (rfe_fused_proto_tc_fits).
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

#define KPMAX 32     // largest kp: one list slot per lane
#define FULL_MASK 0xffffffffu

// block_topk_tc
#define TC_Q 128     // queries per block
#define TC_N 64      // rows per tile
#define TC_PAD 8     // bf16 padding per shared row: row stride 16 mod 128 bytes
#define TC_THREADS 256
#define CAND 16      // candidate buffer per query per round
#define CAND_LD (TC_Q + 1)  // slot-major buffer row: the drain's loads hit distinct banks

// block_topk_fma
#define TN 64        // rows per tile: two per lane
#define NWARPS 8
#define QW 4         // queries per warp
#define TQ (NWARPS * QW)
#define THREADS (NWARPS * 32)
#define STAGE_UNROLL 8

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// tile row stride in bf16 values: 16 bytes past a multiple of 128, so the
// eight lanes of a 16-byte load phase hit eight different bank groups
__host__ __device__ inline int tile_stride(int d) { return round_up(d, 64) + 8; }

static size_t fma_smem_bytes(int d, int kp) {
  return sizeof(__nv_bfloat16) * (size_t)TN * tile_stride(d) + sizeof(float) * (size_t)TQ * d +
         (sizeof(float) + sizeof(int)) * ((size_t)TN + (size_t)TQ * kp);
}

// queries and two row tiles (bf16), two tiles' norms and ids, the
// thresholds, candidate counts and candidate buffers
static size_t tc_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(TC_Q + 2 * TC_N) * (d + TC_PAD) +
         (sizeof(float) + sizeof(int)) * (2 * TC_N + TC_Q + CAND * CAND_LD) + sizeof(int) * TC_Q;
}

// (score desc, id asc): does (av, ai) rank before (bv, bi)? Id -1 (an empty
// slot) compares as the largest id.
__device__ __forceinline__ bool ranks_before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && (unsigned)ai < (unsigned)bi);
}

// ------------------------------------------------------------ block_topk_tc
// A sorted list of KPMAX (score, id) entries in one thread's registers:
// (score desc, id asc), distinct ids, empty slots (-FLT_MAX, -1) last; its
// first kp entries are the query's list. Insert (v, i): if id i is listed,
// the better entry stays; otherwise (v, i) takes its rank and the last
// entry falls off. Every loop is unrolled, so the list stays in registers,
// and each new entry is a select among old ones.
__device__ __forceinline__ void list_insert(float (&lv)[KPMAX], int (&li)[KPMAX], float v, int i) {
  int p = 0, pos = KPMAX;  // entries ranking before (v, i); the id's slot, KPMAX if absent
#pragma unroll
  for (int s = 0; s < KPMAX; ++s) {
    p += ranks_before(lv[s], li[s], v, i);
    pos = li[s] == i ? s : pos;
  }
  if (pos < p) return;  // the id is listed with a better score
  // slots before p keep their entry, p takes the candidate, p+1 .. last
  // shift down by one, where last is the id's old slot (or the list's end)
  const int last = min(pos, KPMAX - 1);
#pragma unroll
  for (int s = KPMAX - 1; s > 0; --s) {
    const bool down = s > p && s <= last;
    lv[s] = down ? lv[s - 1] : (s == p ? v : lv[s]);
    li[s] = down ? li[s - 1] : (s == p ? i : li[s]);
  }
  if (p == 0) {
    lv[0] = v;
    li[0] = i;
  }
}

// entry kp - 1 of a register list, without indexing by a variable
__device__ __forceinline__ void list_kth(const float (&lv)[KPMAX], const int (&li)[KPMAX], int kp,
                                         float& v, int& i) {
#pragma unroll
  for (int s = 0; s < KPMAX; ++s)
    if (s == kp - 1) {
      v = lv[s];
      i = li[s];
    }
}

// grid (ceil(qc / TC_Q), ucap / bb, chunks); arguments as block_topk_fma.
// Warp w multiplies rows 32 (w & 1) .. + 31 of a tile against queries
// 32 (w >> 1) .. + 31 of the block's; thread q < TC_Q keeps query q's list
// (KPMAX entries, the first kp of them the result). d a multiple of 16,
// window of TC_N.
__global__ void __launch_bounds__(TC_THREADS, 1)
block_topk_tc(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
              const __nv_bfloat16* __restrict__ codes, const float* __restrict__ sq,
              const int* __restrict__ ids, float* __restrict__ out_v,
              int* __restrict__ out_i, int qc, int d, int ucap, int window, int bb, int kp) {
  extern __shared__ float4 smem4[];
  const int ld = d + TC_PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // TC_Q x ld
  __nv_bfloat16* rows = qs + TC_Q * ld;                           // 2 x TC_N x ld
  float* sq_s = reinterpret_cast<float*>(rows + 2 * TC_N * ld);   // 2 x TC_N
  int* rid_s = reinterpret_cast<int*>(sq_s + 2 * TC_N);           // 2 x TC_N
  float* thr_v = reinterpret_cast<float*>(rid_s + 2 * TC_N);      // TC_Q: each query's
  int* thr_i = reinterpret_cast<int*>(thr_v + TC_Q);              // kp-th (score, id)
  int* cnt = thr_i + TC_Q;                                        // TC_Q
  float* cand_v = reinterpret_cast<float*>(cnt + TC_Q);           // CAND x CAND_LD
  int* cand_i = reinterpret_cast<int*>(cand_v + CAND * CAND_LD);  // CAND x CAND_LD

  const int q0 = blockIdx.x * TC_Q, cell = blockIdx.y, chunk = blockIdx.z;
  const int nb = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row / column pair
  const int live_q = min(TC_Q, qc - q0);
  const bool warp_live = wn * 32 < live_q;  // warp-uniform
  const int pieces = d / 8;                 // 16-byte pieces per row
  const int per_block = window / TC_N;      // tiles per union block
  const int tiles = bb * per_block;
  const int* cell_blocks = u_all + (size_t)chunk * ucap + (size_t)cell * bb;
  // this thread's 16-byte pieces of a tile are tid, tid + TC_THREADS, ..:
  // (row, piece) of the first, and the step, so no division per piece
  const int st_r = tid / pieces, st_c = tid - st_r * pieces;
  const int dr = TC_THREADS / pieces, dc = TC_THREADS - dr * pieces;

  // the block's queries, zero past qc: in the first copy group
  for (int e = tid; e < TC_Q * pieces; e += TC_THREADS) {
    const int r = e / pieces, c = (e - r * pieces) * 8;
    const bool ok = r < live_q;
    cp_async16(qs + r * ld + c, ok ? q + ((size_t)chunk * qc + q0 + r) * d + c : q, ok);
  }
  // tile t of the cell (TC_N contiguous rows of one union block), its norms
  // and ids, into buffer buf
  auto stage = [&](int t, int buf) {
    const size_t row0 = (size_t)cell_blocks[t / per_block] * window + (t % per_block) * TC_N;
    const __nv_bfloat16* src = codes + row0 * d;
    __nv_bfloat16* dst = rows + buf * TC_N * ld;
    for (int r = st_r, c = st_c; r < TC_N;) {
      cp_async16(dst + r * ld + c * 8, src + (size_t)r * d + c * 8, true);
      r += dr;
      c += dc;
      if (c >= pieces) {
        c -= pieces;
        ++r;
      }
    }
    if (tid < TC_N) {
      cp_async4(sq_s + buf * TC_N + tid, sq + row0 + tid, true);
      cp_async4(rid_s + buf * TC_N + tid, ids + row0 + tid, true);
    }
  };

  float lv[KPMAX];  // threads q < TC_Q: query q's list and its kp-th entry
  int li[KPMAX];
#pragma unroll
  for (int s = 0; s < KPMAX; ++s) {
    lv[s] = -FLT_MAX;
    li[s] = -1;
  }
  float kth_v = -FLT_MAX;
  int kth_i = -1;
  for (int s = tid; s < TC_Q; s += TC_THREADS) {
    thr_v[s] = -FLT_MAX;
    thr_i[s] = -1;
    cnt[s] = 0;
  }

  stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {  // the next tile streams in under this one's product
      stage(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and the queries, thresholds) visible to every warp

    // scores of element e of tile (mt, nt): row wm*32 + mt*16 + g + 8*(e >> 1),
    // query wn*32 + nt*8 + 2*t4 + (e & 1); bit (mt*4 + nt)*4 + e of pend
    float acc[2][4][4];
    int rid[2][2];
    unsigned pend = 0;
    if (warp_live) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      warp_tile_product<2>(acc, mma_rows_ptr(rows + (buf * TC_N + wm * 32) * ld, ld, lane),
                           mma_queries_ptr(qs + wn * 32 * ld, ld, lane), ld, d);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = buf * TC_N + wm * 32 + mt * 16 + g + 8 * h;
          const float n = sq_s[r];
          rid[mt][h] = rid_s[r];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float s = 2.f * acc[mt][nt][2 * h + c] - n;
              acc[mt][nt][2 * h + c] = s;
              if (rid[mt][h] >= 0 && s > -FLT_MAX && wn * 32 + nt * 8 + 2 * t4 + c < live_q)
                pend |= 1u << ((mt * 4 + nt) * 4 + 2 * h + c);
            }
        }
    }

    // rounds: scores that rank before their query's threshold go to its
    // buffer; thread q drains query q's buffer into its list. A thread holds
    // scores of 8 queries (j = 2 nt + c); a query's scores in a warp sit in
    // the 8 lanes of one t4 (lanes t4 + 4 g), which take their buffer slots
    // with one atomic. The 8 queries go through each step together, so
    // their shared-memory and shuffle latencies overlap.
    while (true) {
      if (__any_sync(FULL_MASK, pend)) {  // warp-uniform
        float tv[8];
        int ti[8], want[8], incl[8], slot[8];
        unsigned pass[8];  // bit 2 mt + h: that score ranks before the threshold
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qq = wn * 32 + (j >> 1) * 8 + 2 * t4 + (j & 1);
          tv[j] = thr_v[qq];
          ti[j] = thr_i[qq];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pass[j] = 0;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned bit = 1u << ((mt * 4 + (j >> 1)) * 4 + 2 * h + (j & 1));
              if (!(pend & bit)) continue;
              if (ranks_before(acc[mt][j >> 1][2 * h + (j & 1)], rid[mt][h], tv[j], ti[j]))
                pass[j] |= 1u << (2 * mt + h);
              else
                pend &= ~bit;
            }
          want[j] = __popc(pass[j]);
          incl[j] = want[j];
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)  // inclusive sums over a lane group, by g
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int y = __shfl_up_sync(FULL_MASK, incl[j], off);
            if (lane >= off) incl[j] += y;
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int total = __shfl_sync(FULL_MASK, incl[j], 28 + t4);
          const int qq = wn * 32 + (j >> 1) * 8 + 2 * t4 + (j & 1);
          slot[j] = g == 0 && total ? atomicAdd(cnt + qq, total) : 0;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qq = wn * 32 + (j >> 1) * 8 + 2 * t4 + (j & 1);
          int sl = __shfl_sync(FULL_MASK, slot[j], t4) + incl[j] - want[j];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!(pass[j] >> (2 * mt + h) & 1)) continue;
              if (sl < CAND) {  // else the buffer is full: offered next round
                cand_v[sl * CAND_LD + qq] = acc[mt][j >> 1][2 * h + (j & 1)];
                cand_i[sl * CAND_LD + qq] = rid[mt][h];
                pend &= ~(1u << ((mt * 4 + (j >> 1)) * 4 + 2 * h + (j & 1)));
              }
              ++sl;
            }
        }
      }
      const int more = __syncthreads_or(pend != 0);
      if (tid < TC_Q) {
        const int n = min(cnt[tid], CAND);
        for (int c = 0; c < n; ++c) {
          const float v = cand_v[c * CAND_LD + tid];
          const int i = cand_i[c * CAND_LD + tid];
          if (ranks_before(v, i, kth_v, kth_i)) {
            list_insert(lv, li, v, i);
            list_kth(lv, li, kp, kth_v, kth_i);
          }
        }
        thr_v[tid] = kth_v;
        thr_i[tid] = kth_i;
        cnt[tid] = 0;
      }
      __syncthreads();  // thresholds and counts set; tile t consumed if done
      if (!more) break;
    }
  }

  if (tid < live_q) {
    const size_t base = (((size_t)chunk * nb + cell) * qc + q0 + tid) * kp;
#pragma unroll
    for (int s = 0; s < KPMAX; ++s)
      if (s < kp) {
        out_v[base + s] = lv[s];
        out_i[base + s] = li[s];
      }
  }
}

// ----------------------------------------------------------- block_topk_fma
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
// The sums run in column order (fmaf), as the plain version's.
__global__ void __launch_bounds__(THREADS)
block_topk_fma(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
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

// 1 if the tensor-core kernel takes width d on the current device (d a
// multiple of 16 whose block fits in shared memory), 0 if the FMA kernel
// must, or -(CUDA error).
int rfe_fused_proto_tc_fits(int d) {
  if (d < 16 || d % 16 != 0) return 0;
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return -(int)e;
  return tc_smem_bytes(d) <= (size_t)optin ? 1 : 0;
}

// q (chunks, qc, d) bf16; u_all (chunks, ucap) int32 block ids in [0,
// nlist]; codes (nlist+1, window, d) bf16; sq (nlist+1, window) f32; ids
// (nlist+1, window) int32, -1 = dead. out_v / out_i (chunks, ucap/bb, qc,
// kp). d a multiple of 8, window of TN, ucap of bb, 1 <= kp <= KPMAX, q and
// codes 16-byte aligned. The kernel is chosen by shape: block_topk_tc where
// rfe_fused_proto_tc_fits(d), else block_topk_fma.
int rfe_fused_proto(const void* q, const void* u_all, const void* codes, const void* sq,
                    const void* ids, void* out_v, void* out_i, int chunks, int qc, int d,
                    int ucap, int window, int bb, int kp, void* stream) {
  if (chunks < 1 || qc < 1 || d < 8 || d % 8 != 0 || window < TN || window % TN != 0 ||
      bb < 1 || ucap < bb || ucap % bb != 0 || kp < 1 || kp > KPMAX ||
      (reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tc = rfe_fused_proto_tc_fits(d);
  if (tc < 0) return -tc;
  const void* fn = tc ? (const void*)block_topk_tc : (const void*)block_topk_fma;
  const size_t smem = tc ? tc_smem_bytes(d) : fma_smem_bytes(d, kp);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&q, (void*)&u_all, (void*)&codes, (void*)&sq, (void*)&ids,
                  &out_v, &out_i, &qc, &d, &ucap, &window, &bb, &kp};
  const dim3 grid = tc ? dim3((qc + TC_Q - 1) / TC_Q, ucap / bb, chunks)
                       : dim3(chunks, ucap / bb, (qc + TQ - 1) / TQ);
  e = cudaLaunchKernel(fn, grid, dim3(tc ? TC_THREADS : THREADS), args, smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
