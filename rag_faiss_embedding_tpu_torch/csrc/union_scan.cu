// IVF union scan: per-chunk list-block scores, packed, top-`cap` per
// (query, slot) bin, and optionally the final top-`ktop` per query.
//
// Replaces the TPU kernels rag_faiss_embedding_tpu/ops/pallas_ivf.py::
// _make_kernel (K2, variant 1) and ::_make_kernel_v2 (K3, variant 2 with the
// in-kernel top-k), both reached through pallas_ivf.union_scan. Same
// contract (the wrapper is ops/union_scan.py):
//   * chunk c's queries (qc, D) are scored against every row of the list
//     blocks u_all[c, 0..U) of the block-padded storage (nlist+1, window, D),
//     in float32 (bf16 rows and queries are widened exactly, so a product is
//     exact and only the sum order differs from the TPU's f32 accumulation);
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
// 256) a chunk reads 128-256 list blocks of 256 x 384 bf16 (25-50 MB), once
// per 16-query tile. At Q = 1 that is one chunk of 16 (padded) queries:
// bytes bound (~10-15 us of HBM time) if the read is spread over the card,
// but a block per chunk would leave 131 of 132 SMs idle. At Q = 1024 (8
// chunks of 128) it is FP32-FMA bound: ~26 GFLOP against 67 TFLOP/s.
//
// Design. The selection is a set per bin: the low bits make a bin's values
// distinct, so the top `cap` do not depend on the order blocks arrive in.
// Stage 1 (scan_bins) therefore splits the work four ways: grid x = chunk x
// union split, y = 64-slot tile of the window, z = 16-query tile. A block
// stages the 64 rows of its slot tile of one list block at a time in shared
// memory (16-byte loads, 8 in flight per thread, in the storage dtype), each
// thread scores one row against 4 queries with FP32 FMA (no TF32: float32
// storage keeps the Precision.HIGHEST promise) and keeps those 4 bins in
// registers. It writes its bins as a partial. Stage 2 (merge_bins, one block
// per query) merges the splits' partial bins with the same max/min chain,
// giving the same bits as one pass over U, and for ktop runs the masked-max
// passes (block-wide argmax, lowest lane first) on the candidates it holds
// in shared memory.
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#define MAX_CAP 4
#define TN 64        // slots (rows of one list block) per stage-1 block
#define TQ 16        // queries per stage-1 block
#define QPT 4        // queries per thread
#define THREADS 256  // TN * TQ / QPT
#define MERGE_THREADS 256
#define STAGE_UNROLL 8
#define FULL_MASK 0xffffffffu
#define DEAD_SQ 1e30f  // variant 2's norm for dead rows (pallas_ivf._DEAD_SQ)

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

template <typename T, int CAP>
static const void* scan_for_mode(int mode) {
  if (mode == V1_L2) return (const void*)scan_bins<T, CAP, V1_L2>;
  if (mode == V1_IP) return (const void*)scan_bins<T, CAP, V1_IP>;
  if (mode == V2_L2) return (const void*)scan_bins<T, CAP, V2_L2>;
  return (const void*)scan_bins<T, CAP, V2_IP>;
}

template <typename T>
static const void* scan_for_cap(int cap, int mode) {
  switch (cap) {
    case 1: return scan_for_mode<T, 1>(mode);
    case 2: return scan_for_mode<T, 2>(mode);
    case 3: return scan_for_mode<T, 3>(mode);
    default: return scan_for_mode<T, 4>(mode);
  }
}

static const void* scan_kernel(int is_bf16, int cap, int mode) {
  return is_bf16 ? scan_for_cap<__nv_bfloat16>(cap, mode) : scan_for_cap<float>(cap, mode);
}

static const void* merge_kernel(int cap) {
  switch (cap) {
    case 1: return (const void*)merge_bins<1>;
    case 2: return (const void*)merge_bins<2>;
    case 3: return (const void*)merge_bins<3>;
    default: return (const void*)merge_bins<4>;
  }
}

static size_t smem_for(int d, int is_bf16) {
  return is_bf16 ? scan_smem_bytes<__nv_bfloat16>(d) : scan_smem_bytes<float>(d);
}

static cudaError_t prepare(const void* fn, size_t smem) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" {

int rfe_union_scan_max_cap(void) { return MAX_CAP; }
int rfe_union_scan_tile_rows(void) { return TN; }
int rfe_union_scan_block_queries(void) { return TQ; }

const char* rfe_union_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Stage-1 blocks one SM holds at once, or -(CUDA error).
int rfe_union_scan_blocks_per_sm(int d, int is_bf16, int cap, int mode) {
  if (d < 8 || d % 8 != 0 || cap < 1 || cap > MAX_CAP || mode < V1_L2 || mode > V2_IP)
    return -(int)cudaErrorInvalidValue;
  const void* fn = scan_kernel(is_bf16, cap, mode);
  const size_t smem = smem_for(d, is_bf16);
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
// (s+1)*per_split). d a multiple of 8, window of TN, pointers 16-byte aligned.
int rfe_union_scan(const void* q, const void* u_all, const void* codes,
                   const void* rsq, const void* ids, void* part, void* out,
                   void* lanes, int chunks, int qc, int d, int u, int window,
                   int cap, int is_l2, int variant, int is_bf16, int nbits,
                   int init_packed, int ktop, int per_split, int n_splits,
                   int kpad, void* stream) {
  const int mode = 2 * (variant - 1) + (is_l2 ? 0 : 1);
  if (chunks < 1 || qc < 1 || u < 1 || d < 8 || d % 8 != 0 || window < TN ||
      window % TN != 0 || cap < 1 || cap > MAX_CAP || nbits < 1 || nbits > 30 ||
      (1 << nbits) < u || per_split < 1 || n_splits < 1 ||
      (long long)per_split * n_splits < u || (variant != 1 && variant != 2) ||
      ktop < 0 || ktop > kpad || (ktop && (variant != 2 || ktop >= cap * window)) ||
      (reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = scan_kernel(is_bf16, cap, mode);
  const size_t smem = smem_for(d, is_bf16);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&q, (void*)&u_all, (void*)&codes, (void*)&rsq, (void*)&ids,
                  &part, &qc, &d, &u, &window, &nbits, &init_packed, &per_split,
                  &n_splits};
  const dim3 grid(chunks * n_splits, window / TN, (qc + TQ - 1) / TQ);
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
