// IVF union scan: per-chunk list-block scores, packed, top-`cap` per
// (query, slot) bin, and optionally the final top-`ktop` per query.
//
// Replaces the TPU kernels rag_faiss_embedding_tpu/ops/pallas_ivf.py::
// _make_kernel (K2, variant 1) and ::_make_kernel_v2 (K3, variant 2 with the
// in-kernel top-k), both reached through pallas_ivf.union_scan. Same
// contract (the wrapper is ops/union_scan.py):
//   * chunk c's queries (qc, D) are scored against every row of the list
//     blocks u_all[c, 0..U) of the block-padded storage (nlist+1, window, D),
//     in float32 (bf16 products are exact in f32, so only the sum order
//     differs from the TPU's f32 accumulation);
//   * variant 1: s = 2 q.x - rsq (L2) or q.x (IP), and s = NEG_INF where the
//     row id is < 0; variant 2: s = q.x - rsq, with queries pre-doubled for
//     L2 (by the wrapper), rsq zero for IP, and dead rows folded into rsq
//     (DEAD_SQ = 1e30). The TPU kernel reads a premasked rsq row made
//     outside it; here the fold happens as a block stages its norms, which
//     gives the same scores without a pass over every slot per call;
//   * packed = (mono(s) & ~(2^nbits - 1)) | j, j the block's union position;
//   * each (query, slot) bin keeps its top `cap` packed values over all U
//     blocks (a max/min chain), written level-major as (qc, cap * window);
//   * with ktop > 0, the top ktop of those cap * window candidates per query
//     (ties to the lowest lane) and their lanes, padded to kpad lanes with
//     init_packed / 0.
//
// What bounds it on an H100. At the 1M x 384 bf16 shape (nlist 8192, window
// 256) a chunk reads 128-256 list blocks of 256 x 384 bf16 (25-50 MB). At
// Q = 1 that is one chunk of 16 (padded) queries: bytes bound (~10-15 us of
// HBM time) if the read is spread over the card, but a block per chunk would
// leave 131 of 132 SMs idle. At Q = 1024 (8 chunks of 128) it is ~26 GFLOP:
// 0.03 ms on bf16 tensor cores, 0.4 ms of FP32 FMA, against 0.06 ms of bytes.
//
// Design. The selection is a set per bin: the low bits make a bin's values
// distinct, so the top `cap` do not depend on the order blocks arrive in.
// Stage 1 therefore splits the work four ways: grid x = chunk x union split,
// y = 64-slot tile of the window, z = query tile. A block walks the union
// blocks of its split, one 64-row slot tile at a time, and keeps its bins
// in registers for the whole walk; it writes them as a partial. Stage 2
// (merge_bins, one block per query) merges the splits' partial bins with
// the same max/min chain, giving the same bits as one pass over U, and for
// ktop runs the masked-max passes (block-wide argmax, lowest lane first) on
// the candidates it holds in shared memory.
//
// Stage 1, bf16 storage (scan_bins_tc): bf16 tensor cores, mma.sync
// m16n8k16 with f32 accumulation. A bf16 x bf16 product is exact in f32, so
// this computes the FMA loop's function up to summation order (the TPU
// kernel likewise takes bf16 at Precision.DEFAULT). A block holds 128 of a
// chunk's queries in shared memory, so at Q = 1024 each union block's rows
// are read once per chunk (16 queries per block read them 8 times). Eight
// warps each own 32 slots x 32 queries: per 16 columns, four ldmatrix.x4 and
// eight MMAs. An accumulator element is a fixed (slot, query) pair, so its
// thread keeps that bin's `cap` packed values in registers beside it and
// applies the packing and bin_insert in the epilogue of every block's
// product. The next union block's row tile (and its norms and ids) streams
// in with cp.async while the current one is multiplied.
//
// Stage 1, float32 storage (scan_bins): FP32 FMA, no TF32 (float32 storage
// keeps the Precision.HIGHEST promise). A block stages the 64 rows of its
// slot tile of one list block at a time in shared memory (16-byte loads, 8
// in flight per thread), each thread scores one row against 4 of the
// block's 16 queries and keeps those 4 bins in registers. It also serves
// bf16 rows too wide for the tensor-core block's shared memory (D > 440).
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch.cuh"

#define MAX_CAP 4
#define TN 64        // slots (rows of one list block) per stage-1 block
#define TQ 16        // queries per scan_bins block
#define QPT 4        // queries per thread
#define THREADS 256  // TN * TQ / QPT
#define MERGE_THREADS 256
#define STAGE_UNROLL 8
#define FULL_MASK 0xffffffffu
#define DEAD_SQ 1e30f  // variant 2's norm for dead rows (pallas_ivf._DEAD_SQ)
#define TC_Q 128     // queries per scan_bins_tc block
#define TC_PAD 8     // bf16 padding per shared row: row stride 16 mod 128 bytes

enum Mode { V1_L2 = 0, V1_IP = 1, V2_L2 = 2, V2_IP = 3 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename T> struct Row;
template <> struct Row<float> {
  static constexpr int V = 4;  // values per 16 bytes
  // tile row stride in elements: 16 bytes past a multiple of 128, so the
  // eight lanes of a 16-byte load phase hit eight different bank groups
  __host__ __device__ static int stride(int d) { return round_up(d, 32) + 4; }
  __device__ static void widen(const float* p, float (&x)[V]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static float scalar(float v) { return v; }
};
template <> struct Row<__nv_bfloat16> {
  static constexpr int V = 8;
  __host__ __device__ static int stride(int d) { return round_up(d, 64) + 8; }
  __device__ static void widen(const __nv_bfloat16* p, float (&x)[V]) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an f32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float scalar(__nv_bfloat16 v) { return __bfloat162float(v); }
};

// order-preserving f32 -> int32 (ops/pallas_scan.py::_monotone_i32)
__device__ __forceinline__ int mono_i32(float s) {
  const int b = __float_as_int(s);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

// insert t into a descending run of CAP values: the demoted value cascades
template <int CAP>
__device__ __forceinline__ void bin_insert(int (&run)[CAP], int t) {
#pragma unroll
  for (int l = 0; l < CAP; ++l) {
    const int cur = run[l];
    run[l] = max(cur, t);
    t = min(cur, t);
  }
}

template <typename T>
static size_t scan_smem_bytes(int d) {
  return sizeof(T) * (size_t)TN * Row<T>::stride(d) + sizeof(float) * (size_t)TQ * d +
         (sizeof(float) + sizeof(int)) * TN;
}

// Stage 1. part: (chunks, qc, n_splits, CAP, window) int32.
template <typename T, int CAP, int MODE>
__global__ void __launch_bounds__(THREADS)
scan_bins(const T* __restrict__ q, const int* __restrict__ u_all,
          const T* __restrict__ codes, const float* __restrict__ rsq,
          const int* __restrict__ ids, int* __restrict__ part, int qc, int d,
          int u, int window, int nbits, int init_packed, int per_split,
          int n_splits) {
  constexpr int V = Row<T>::V;
  extern __shared__ float4 smem4[];
  T* tile = reinterpret_cast<T*>(smem4);
  const int stride = Row<T>::stride(d);
  float* qs = reinterpret_cast<float*>(tile + (size_t)TN * stride);  // TQ x d
  float* rsq_s = qs + TQ * d;                                         // TN
  int* rid_s = reinterpret_cast<int*>(rsq_s + TN);                    // TN

  const int chunk = blockIdx.x / n_splits, split = blockIdx.x % n_splits;
  const int slot0 = blockIdx.y * TN;
  const int q0 = blockIdx.z * TQ;
  const int u_lo = split * per_split, u_hi = min(u, u_lo + per_split);
  const int tid = threadIdx.x;
  const int r = tid % TN, g = tid / TN;  // row, query group
  const int mask_hi = ~((1 << nbits) - 1);

  for (int e = tid; e < TQ * d; e += THREADS) {
    const int j = e / d, c = e - j * d;
    qs[e] = q0 + j < qc ? Row<T>::scalar(q[((size_t)chunk * qc + q0 + j) * d + c]) : 0.f;
  }
  int run[QPT][CAP];
#pragma unroll
  for (int j = 0; j < QPT; ++j)
#pragma unroll
    for (int l = 0; l < CAP; ++l) run[j][l] = init_packed;

  const int per_row = d / V, total = TN * per_row;
  for (int ub = u_lo; ub < u_hi; ++ub) {
    const size_t row0 = (size_t)u_all[(size_t)chunk * u + ub] * window + slot0;
    __syncthreads();  // the previous tile (and at first the queries) is staged / consumed
    const T* src = codes + row0 * d;  // TN rows, one contiguous run
    for (int base = tid; base < total; base += THREADS * STAGE_UNROLL) {
      uint4 buf[STAGE_UNROLL];
#pragma unroll
      for (int k = 0; k < STAGE_UNROLL; ++k) {
        const int e = base + k * THREADS;
        if (e < total) buf[k] = *reinterpret_cast<const uint4*>(src + (size_t)e * V);
      }
#pragma unroll
      for (int k = 0; k < STAGE_UNROLL; ++k) {
        const int e = base + k * THREADS;
        if (e < total) {
          const int rr = e / per_row;
          *reinterpret_cast<uint4*>(tile + (size_t)rr * stride + (e - rr * per_row) * V) = buf[k];
        }
      }
    }
    if (tid < TN) {
      const int id = ids[row0 + tid];
      float n = MODE == V1_L2 || MODE == V2_L2 ? rsq[row0 + tid] : 0.f;
      if (MODE >= V2_L2 && id < 0) n = DEAD_SQ;
      rsq_s[tid] = n;
      rid_s[tid] = id;
    }
    __syncthreads();

    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    const T* x = tile + (size_t)r * stride;
    const float* qg = qs + g * QPT * d;
#pragma unroll 2
    for (int c = 0; c < d; c += V) {
      float xv[V];
      Row<T>::widen(x + c, xv);
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
#pragma unroll
        for (int h = 0; h < V; h += 4) {
          const float4 w = *reinterpret_cast<const float4*>(qg + j * d + c + h);
          acc[j] = fmaf(w.x, xv[h], acc[j]);
          acc[j] = fmaf(w.y, xv[h + 1], acc[j]);
          acc[j] = fmaf(w.z, xv[h + 2], acc[j]);
          acc[j] = fmaf(w.w, xv[h + 3], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      float s;
      if (MODE >= V2_L2) {
        s = acc[j] - rsq_s[r];
      } else {
        s = MODE == V1_L2 ? 2.f * acc[j] - rsq_s[r] : acc[j];
        if (rid_s[r] < 0) s = -FLT_MAX;
      }
      bin_insert<CAP>(run[j], (mono_i32(s) & mask_hi) | ub);
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int qi = q0 + g * QPT + j;
    if (qi >= qc) break;
    int* dst = part + (((size_t)chunk * qc + qi) * n_splits + split) * CAP * window + slot0 + r;
#pragma unroll
    for (int l = 0; l < CAP; ++l) dst[(size_t)l * window] = run[j][l];
  }
}

// Stage 1 on bf16 tensor cores; part as scan_bins. 256 threads: warp w
// owns slots 32 (w & 1) .. + 31 of the block's 64 and queries 32 (w >> 1)
// .. + 31 of its 128. d is a multiple of 16.
template <int CAP, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
scan_bins_tc(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
             const __nv_bfloat16* __restrict__ codes, const float* __restrict__ rsq,
             const int* __restrict__ ids, int* __restrict__ part, int qc, int d,
             int u, int window, int nbits, int init_packed, int per_split,
             int n_splits) {
  extern __shared__ float4 smem4[];
  const int ld = d + TC_PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);   // TC_Q x ld
  __nv_bfloat16* rows = qs + TC_Q * ld;                            // 2 x TN x ld
  float* rsq_s = reinterpret_cast<float*>(rows + 2 * TN * ld);     // 2 x TN
  int* rid_s = reinterpret_cast<int*>(rsq_s + 2 * TN);             // 2 x TN

  const int chunk = blockIdx.x / n_splits, split = blockIdx.x % n_splits;
  const int slot0 = blockIdx.y * TN;
  const int q0 = blockIdx.z * TC_Q;
  const int u_lo = split * per_split, u_hi = min(u, u_lo + per_split);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;  // accumulator row / column pair
  const int mask_hi = ~((1 << nbits) - 1);
  const int live_q = min(TC_Q, qc - q0);
  const bool warp_live = wn * 32 < live_q;  // warp-uniform
  const int pieces = d / 8;                 // 16-byte pieces per row

  // the block's queries, zero past qc: in the first copy group
  for (int e = tid; e < TC_Q * pieces; e += THREADS) {
    const int r = e / pieces, c = (e - r * pieces) * 8;
    const bool ok = r < live_q;
    cp_async16(qs + r * ld + c, ok ? q + ((size_t)chunk * qc + q0 + r) * d + c : q, ok);
  }
  // the 64 slot rows of union block ub (one contiguous run), their norms
  // (zero for IP) and ids, into buffer buf
  auto stage = [&](int ub, int buf) {
    const size_t row0 = (size_t)u_all[(size_t)chunk * u + ub] * window + slot0;
    const __nv_bfloat16* src = codes + row0 * d;
    __nv_bfloat16* dst = rows + buf * TN * ld;
    for (int e = tid; e < TN * pieces; e += THREADS) {
      const int r = e / pieces, c = (e - r * pieces) * 8;
      cp_async16(dst + r * ld + c, src + (size_t)r * d + c, true);
    }
    if (tid < TN) {
      cp_async4(rsq_s + buf * TN + tid, rsq + row0 + tid, MODE == V1_L2 || MODE == V2_L2);
      cp_async4(rid_s + buf * TN + tid, ids + row0 + tid, true);
    }
  };

  int run[2][4][4][CAP];  // [m tile][n tile][accumulator element][level]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int l = 0; l < CAP; ++l) run[mt][nt][e][l] = init_packed;

  if (u_lo < u_hi) stage(u_lo, 0);
  cp_async_commit();
  for (int ub = u_lo; ub < u_hi; ++ub) {
    const int buf = (ub - u_lo) & 1;
    if (ub + 1 < u_hi) {  // the next tile streams in under this one's product
      stage(ub + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile ub (and the queries) visible to every warp
    if (warp_live) {
      float acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      const __nv_bfloat16* A = rows + (buf * TN + wm * 32 + (lane & 15)) * ld + (lane >> 4) * 8;
      const __nv_bfloat16* B = qs + (wn * 32 + (lane >> 4) * 8 + (lane & 7)) * ld +
                               ((lane >> 3) & 1) * 8;
#pragma unroll 4
      for (int kk = 0; kk < d; kk += 16) {
        unsigned a[2][4], b[2][4];
        ldmatrix_x4(a[0], A + kk);
        ldmatrix_x4(a[1], A + 16 * ld + kk);
        ldmatrix_x4(b[0], B + kk);            // queries 0-15 of the warp's 32
        ldmatrix_x4(b[1], B + 16 * ld + kk);  // queries 16-31
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16_16816(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                           b[nt >> 1][(nt & 1) * 2 + 1]);
      }
      // element e of tile (mt, nt): slot wm*32 + mt*16 + g + 8*(e >> 1),
      // query wn*32 + nt*8 + 2t + (e & 1)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = buf * TN + wm * 32 + mt * 16 + g + 8 * h;
          const int id = rid_s[r];
          float n = rsq_s[r];
          if (MODE >= V2_L2 && id < 0) n = DEAD_SQ;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float a_ = acc[mt][nt][2 * h + c];
              float s;
              if (MODE >= V2_L2) {
                s = a_ - n;
              } else {
                s = MODE == V1_L2 ? 2.f * a_ - n : a_;
                if (id < 0) s = -FLT_MAX;
              }
              bin_insert<CAP>(run[mt][nt][2 * h + c], (mono_i32(s) & mask_hi) | ub);
            }
        }
    }
    __syncthreads();  // tile ub consumed before it is restaged
  }

  if (!warp_live) return;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qi = q0 + wn * 32 + nt * 8 + 2 * t + c;
      if (qi >= qc) continue;
      int* dst = part + (((size_t)chunk * qc + qi) * n_splits + split) * CAP * window + slot0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slot = wm * 32 + mt * 16 + g + 8 * h;
#pragma unroll
          for (int l = 0; l < CAP; ++l) dst[(size_t)l * window + slot] = run[mt][nt][2 * h + c][l];
        }
    }
}

// Stage 2: one block per (chunk, query). Merge the n_splits partial bins of
// every slot; write them level-major, or keep them in shared memory and take
// the top ktop (value descending, lane ascending).
template <int CAP>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_bins(const int* __restrict__ part, int* __restrict__ out, int* __restrict__ lanes,
           int window, int n_splits, int init_packed, int ktop, int kpad) {
  extern __shared__ int cand[];  // CAP * window, when ktop > 0
  __shared__ int red_v[MERGE_THREADS / 32], red_l[MERGE_THREADS / 32];
  const size_t cq = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = CAP * window;
  for (int s = tid; s < window; s += MERGE_THREADS) {
    int run[CAP];
#pragma unroll
    for (int l = 0; l < CAP; ++l) run[l] = init_packed;
    const int* src = part + cq * n_splits * m + s;
    for (int sp = 0; sp < n_splits; ++sp)
#pragma unroll
      for (int l = 0; l < CAP; ++l) bin_insert<CAP>(run, src[(size_t)sp * m + l * window]);
#pragma unroll
    for (int l = 0; l < CAP; ++l) {
      if (ktop) cand[l * window + s] = run[l];
      else out[cq * m + l * window + s] = run[l];
    }
  }
  if (!ktop) return;
  __syncthreads();
  for (int p = 0; p < ktop; ++p) {
    int bv = INT_MIN, bl = m;
    for (int l = tid; l < m; l += MERGE_THREADS) {
      const int v = cand[l];
      if (v > bv) { bv = v; bl = l; }  // lanes rise, so ties keep the lowest
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(FULL_MASK, bv, off);
      const int ol = __shfl_xor_sync(FULL_MASK, bl, off);
      if (ov > bv || (ov == bv && ol < bl)) { bv = ov; bl = ol; }
    }
    if (lane == 0) { red_v[warp] = bv; red_l[warp] = bl; }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < MERGE_THREADS / 32; ++w)
        if (red_v[w] > bv || (red_v[w] == bv && red_l[w] < bl)) { bv = red_v[w]; bl = red_l[w]; }
      out[cq * kpad + p] = bv;
      lanes[cq * kpad + p] = bl;
      cand[bl] = INT_MIN;
    }
    __syncthreads();
  }
  for (int p = ktop + tid; p < kpad; p += MERGE_THREADS) {
    out[cq * kpad + p] = init_packed;
    lanes[cq * kpad + p] = 0;
  }
}

// The stage-1 kernel for (storage, cap, mode); TC: the tensor-core one
// (bf16 only).
template <typename T, int CAP, bool TC>
static const void* scan_for_mode(int mode) {
  if constexpr (TC) {
    if (mode == V1_L2) return (const void*)scan_bins_tc<CAP, V1_L2>;
    if (mode == V1_IP) return (const void*)scan_bins_tc<CAP, V1_IP>;
    if (mode == V2_L2) return (const void*)scan_bins_tc<CAP, V2_L2>;
    return (const void*)scan_bins_tc<CAP, V2_IP>;
  }
  if (mode == V1_L2) return (const void*)scan_bins<T, CAP, V1_L2>;
  if (mode == V1_IP) return (const void*)scan_bins<T, CAP, V1_IP>;
  if (mode == V2_L2) return (const void*)scan_bins<T, CAP, V2_L2>;
  return (const void*)scan_bins<T, CAP, V2_IP>;
}

template <typename T, bool TC>
static const void* scan_for_cap(int cap, int mode) {
  switch (cap) {
    case 1: return scan_for_mode<T, 1, TC>(mode);
    case 2: return scan_for_mode<T, 2, TC>(mode);
    case 3: return scan_for_mode<T, 3, TC>(mode);
    default: return scan_for_mode<T, 4, TC>(mode);
  }
}

static const void* scan_kernel(int is_bf16, int cap, int mode, int tc) {
  if (tc) return scan_for_cap<__nv_bfloat16, true>(cap, mode);
  return is_bf16 ? scan_for_cap<__nv_bfloat16, false>(cap, mode)
                 : scan_for_cap<float, false>(cap, mode);
}

static const void* merge_kernel(int cap) {
  switch (cap) {
    case 1: return (const void*)merge_bins<1>;
    case 2: return (const void*)merge_bins<2>;
    case 3: return (const void*)merge_bins<3>;
    default: return (const void*)merge_bins<4>;
  }
}

static size_t smem_for(int d, int is_bf16, int tc) {
  if (tc)  // queries, two row tiles, two tiles' norms and ids
    return sizeof(__nv_bfloat16) * (size_t)(TC_Q + 2 * TN) * (d + TC_PAD) +
           (sizeof(float) + sizeof(int)) * 2 * TN;
  return is_bf16 ? scan_smem_bytes<__nv_bfloat16>(d) : scan_smem_bytes<float>(d);
}

// A stage-1 shape the kernels cannot take. The tensor-core kernel takes
// bf16 with d a multiple of 16.
static bool bad_scan(int d, int is_bf16, int cap, int mode, int tc) {
  return d < 8 || d % 8 != 0 || cap < 1 || cap > MAX_CAP || mode < V1_L2 || mode > V2_IP ||
         (tc && (!is_bf16 || d % 16 != 0));
}

extern "C" {

int rfe_union_scan_max_cap(void) { return MAX_CAP; }
int rfe_union_scan_tile_rows(void) { return TN; }
int rfe_union_scan_block_queries(int tc) { return tc ? TC_Q : TQ; }

const char* rfe_union_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Stage-1 blocks one SM holds at once, or -(CUDA error): the tensor-core
// kernel (tc = 1) needs more shared memory than a block may have above
// d = 440.
int rfe_union_scan_blocks_per_sm(int d, int is_bf16, int cap, int mode, int tc) {
  if (bad_scan(d, is_bf16, cap, mode, tc)) return -(int)cudaErrorInvalidValue;
  const void* fn = scan_kernel(is_bf16, cap, mode, tc);
  const size_t smem = smem_for(d, is_bf16, tc);
  cudaError_t e = prepare(fn, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// q (chunks, qc, d) storage dtype (pre-doubled for variant-2 L2); u_all
// (chunks, u) int32 block ids in [0, nlist]; codes (nlist+1, window, d);
// rsq (slots,) f32 row norms (read for L2); ids (slots,) int32, -1 = dead. part: (chunks, qc, n_splits, cap, window) scratch. Without
// ktop, out is (chunks, qc, cap*window); with it, out and lanes are
// (chunks, qc, kpad). Split s covers union positions [s*per_split,
// (s+1)*per_split). d a multiple of 8 (of 16 for tc), window of TN,
// pointers 16-byte aligned. tc = 1: stage 1 on bf16 tensor cores.
int rfe_union_scan(const void* q, const void* u_all, const void* codes,
                   const void* rsq, const void* ids, void* part, void* out,
                   void* lanes, int chunks, int qc, int d, int u, int window,
                   int cap, int is_l2, int variant, int is_bf16, int nbits,
                   int init_packed, int ktop, int per_split, int n_splits,
                   int kpad, int tc, void* stream) {
  const int mode = 2 * (variant - 1) + (is_l2 ? 0 : 1);
  if (chunks < 1 || qc < 1 || u < 1 || bad_scan(d, is_bf16, cap, mode, tc) || window < TN ||
      window % TN != 0 || cap < 1 || cap > MAX_CAP || nbits < 1 || nbits > 30 ||
      (1 << nbits) < u || per_split < 1 || n_splits < 1 ||
      (long long)per_split * n_splits < u || (variant != 1 && variant != 2) ||
      ktop < 0 || ktop > kpad || (ktop && (variant != 2 || ktop >= cap * window)) ||
      (reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = scan_kernel(is_bf16, cap, mode, tc);
  const size_t smem = smem_for(d, is_bf16, tc);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&q, (void*)&u_all, (void*)&codes, (void*)&rsq, (void*)&ids,
                  &part, &qc, &d, &u, &window, &nbits, &init_packed, &per_split,
                  &n_splits};
  const int tq = rfe_union_scan_block_queries(tc);
  const dim3 grid(chunks * n_splits, window / TN, (qc + tq - 1) / tq);
  e = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  const void* mfn = merge_kernel(cap);
  const size_t msmem = ktop ? sizeof(int) * (size_t)cap * window : 0;
  e = prepare(mfn, msmem);
  if (e != cudaSuccess) return (int)e;
  void* margs[] = {&part, &out, &lanes, &window, &n_splits, &init_packed, &ktop, &kpad};
  e = cudaLaunchKernel(mfn, dim3(chunks * qc), dim3(MERGE_THREADS), margs, msmem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
