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
// = 52.3 GFLOP: about 0.05 ms on bf16 tensor cores, 0.78 ms of FP32 FMA at
// 67 TFLOP/s. This kernel uses FP32 FMA, so the FMA rate bounds it; each
// block is re-read from L2 by the 16 query tiles of its chunk.
//
// Design. The TPU walked the U blocks in order (a sequential grid axis) with
// the bins in VMEM scratch. Here the U blocks are walked in order inside one
// CUDA block, so the chain sees the blocks in the TPU's order (for
// temps_f32 a split-and-merge would not give the sequential chain's bits,
// and it would change what the probe times). Queries and slots are split
// over the grid: (chunk, 16-query tile, 64-slot tile), 4 x 16 x 4 = 256
// blocks at the probe's shape. A block stages its 64 slots of one list
// block at a time in shared memory (16-byte loads, 8 in flight per thread),
// each thread scores one slot against 4 queries with FP32 FMA, and owns
// those 4 x cap bins.
//
// Entry points take raw device pointers and a stream, launch on that stream,
// allocate nothing, and return a cudaError_t as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <stdint.h>

#define MAX_CAP 4
#define TN 64        // slots per block
#define TQ 16        // queries per block
#define QPT 4        // queries per thread
#define THREADS 256  // TN * TQ / QPT
#define STAGE_UNROLL 8

enum Variant { NONE = 0, CHAIN = 1, TEMPS = 2, TEMPS_F32 = 3 };

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// tile row stride in bf16 values: 16 bytes past a multiple of 128 bytes
__host__ __device__ inline int tile_stride(int d) { return round_up(d, 64) + 8; }

static size_t smem_bytes(int d, int cap) {
  return sizeof(__nv_bfloat16) * (size_t)TN * tile_stride(d) + sizeof(float) * (size_t)TQ * d +
         (sizeof(float) + sizeof(int)) * TN + sizeof(int) * (size_t)cap * TQ * TN;
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

// grid (chunks, ceil(qc / TQ), window / TN). out (chunks, qc, cap * window).
template <int VARIANT, int CAP>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const __nv_bfloat16* __restrict__ q, const int* __restrict__ u_all,
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
static const void* kernel_for_cap(int cap) {
  switch (cap) {
    case 1: return (const void*)probe_kernel<VARIANT, 1>;
    case 2: return (const void*)probe_kernel<VARIANT, 2>;
    case 3: return (const void*)probe_kernel<VARIANT, 3>;
    default: return (const void*)probe_kernel<VARIANT, 4>;
  }
}

static const void* probe_for(int variant, int cap) {
  switch (variant) {
    case NONE: return kernel_for_cap<NONE>(cap);
    case CHAIN: return kernel_for_cap<CHAIN>(cap);
    case TEMPS: return kernel_for_cap<TEMPS>(cap);
    default: return kernel_for_cap<TEMPS_F32>(cap);
  }
}

extern "C" {

int rfe_kernel_probe_max_cap(void) { return MAX_CAP; }
int rfe_kernel_probe_tile_rows(void) { return TN; }

const char* rfe_kernel_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// variant 0 / 1 / 2 / 3: none / chain / temps / temps_f32. q (chunks, qc,
// d) bf16; u_all (chunks, u) int32 block ids in [0, nlist]; codes (nlist+1,
// window, d) bf16; aux (nlist+1, 2, window) int32 (rsq bits, ids). out
// (chunks, qc, cap * window) int32. d a multiple of 8, window of TN, u of
// bb, 1 <= cap <= MAX_CAP, 2^nbits >= u, q and codes 16-byte aligned.
int rfe_kernel_probe(int variant, const void* q, const void* u_all, const void* codes,
                     const void* aux, void* out, int chunks, int qc, int d, int u, int window,
                     int bb, int cap, int nbits, int init_packed, void* stream) {
  if (variant < NONE || variant > TEMPS_F32 || chunks < 1 || qc < 1 || d < 8 || d % 8 != 0 ||
      window < TN || window % TN != 0 || u < 1 || bb < 1 || u % bb != 0 || cap < 1 ||
      cap > MAX_CAP || nbits < 1 || nbits > 30 || (1 << nbits) < u ||
      (reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(q)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const void* fn = probe_for(variant, cap);
  const size_t smem = smem_bytes(d, cap);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&q, (void*)&u_all, (void*)&codes, (void*)&aux, &out, &qc, &d, &u,
                  &window, &bb, &nbits, &init_packed};
  const dim3 grid(chunks, (qc + TQ - 1) / TQ, window / TN);
  e = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
