// Kimi Delta Attention's two kernels (ops/kda.py), for sm_90a: the
// chunk-to-chunk state pass of the chunked prefill, and the one-token
// decode step (at the end of this file).
//
// Per head and chunk of C = 64 rows the intra-chunk part (plain torch, in
// parallel over every chunk) has made, in float32:
//   W   [C, K]  the chunk's WY keys          U0 [C, V]  its WY values
//   Q'  [C, K]  the queries less P W         O0 [C, V]  its intra-chunk output
//   Kh  [C, K]  the keys decayed to its end  gamma [K]  its whole decay
// and the pass carries the state S [K, V] through the chunks in order:
//   U = U0 - W S;   O = O0 + Q' S;   S <- gamma (.) S + Kh^T U.
//
// One block owns one head and VS = 32 of the state's 128 value columns (the
// columns evolve independently), so 32 heads x 4 slices is about one block
// per SM. Its float32 slice of S stays in shared memory across all chunks;
// each chunk's W^T | Q'^T and Kh are staged there, then two phases of
// register-tiled float32 FMA (4 x 4 outputs a thread) make U and O (phase 1)
// and the new S (phase 2). O goes to `out` token-major [rows, heads, V]; the
// last S to `s_out`.
//
// Layouts (float32): w, qp, kh [heads, chunks, C, K] and u0, o0 [heads,
// chunks, C, V], each with its rows evenly spaced (row r of chunk c of head
// h at ((h * chunks + c) * C + r) times its row stride, a multiple of 4;
// the prefill's u0 and w are the two halves of one solve's rows); gamma
// [heads, chunks, K], s0, s_out [heads, K, V] (they may be the same buffer)
// and out [chunks * C, heads, V], contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int C = 64;
constexpr int K = 128;
constexpr int V = 128;
constexpr int VS = 32;
constexpr int SLICES = V / VS;
constexpr int THREADS = 256;
constexpr int MP = 2 * C + 4;  // row pitch of mt: W^T | Q'^T, padded off the banks
constexpr int KP = K + 4;      // row pitch of kh
constexpr int SP = VS + 4;     // row pitch of s and u

struct Smem {
  float mt[K][MP];
  float kh[C][KP];
  float s[K][SP];
  float u[C][SP];
  float gam[K];
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__global__ void __launch_bounds__(THREADS, 1)
    kda_state_pass_kernel(const float* __restrict__ w, const float* __restrict__ qp,
                          const float* __restrict__ kh, const float* __restrict__ u0,
                          const float* __restrict__ o0, const float* __restrict__ gamma,
                          const float* s0, float* __restrict__ out, float* s_out, int heads,
                          int chunks, int w_rs, int qp_rs, int kh_rs, int u0_rs, int o0_rs) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int h = blockIdx.x / SLICES;
  const int v0 = (blockIdx.x % SLICES) * VS;
  const int tid = threadIdx.x;
  const int lane = tid % 32;  // 4 rows of [W; Q'] (phase 1), 4 keys (phase 2)
  const int c0 = (tid / 32) * 4;  // the thread's 4 value columns of the slice

  const float* s0h = s0 + (size_t)h * K * V;
  for (int i = tid; i < K * VS / 4; i += THREADS) {
    const int k = i / (VS / 4), j = (i % (VS / 4)) * 4;
    *reinterpret_cast<float4*>(&sm.s[k][j]) = *reinterpret_cast<const float4*>(s0h + k * V + v0 + j);
  }

  for (int ch = 0; ch < chunks; ++ch) {
    const size_t row = ((size_t)h * chunks + ch) * C;  // the chunk's first row
    const float* wc = w + row * w_rs;
    const float* qc = qp + row * qp_rs;
    const float* kc = kh + row * kh_rs;
    // W and Q' transposed into mt[k][c] and mt[k][C + c]: consecutive
    // threads take consecutive rows c, so the stores hit consecutive banks
    for (int i = tid; i < C * K / 4; i += THREADS) {
      const int c = i % C, k = (i / C) * 4;
      const float4 a = ld4(wc + c * w_rs + k), b = ld4(qc + c * qp_rs + k);
      sm.mt[k][c] = a.x, sm.mt[k + 1][c] = a.y, sm.mt[k + 2][c] = a.z, sm.mt[k + 3][c] = a.w;
      sm.mt[k][C + c] = b.x, sm.mt[k + 1][C + c] = b.y, sm.mt[k + 2][C + c] = b.z,
                    sm.mt[k + 3][C + c] = b.w;
    }
    for (int i = tid; i < C * K / 4; i += THREADS) {
      const int c = i / (K / 4), k = (i % (K / 4)) * 4;
      *reinterpret_cast<float4*>(&sm.kh[c][k]) = ld4(kc + c * kh_rs + k);
    }
    if (tid < K / 4)
      *reinterpret_cast<float4*>(&sm.gam[tid * 4]) = ld4(gamma + ((size_t)h * chunks + ch) * K + tid * 4);
    __syncthreads();

    // phase 1: rows 0..63 of [W; Q'] S are W S, rows 64..127 Q' S
    {
      const int r0 = lane * 4;
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        fma4x4(acc, *reinterpret_cast<const float4*>(&sm.mt[k][r0]),
               *reinterpret_cast<const float4*>(&sm.s[k][c0]));
      if (r0 < C) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = ld4(u0 + (row + r0 + i) * u0_rs + v0 + c0);
          *reinterpret_cast<float4*>(&sm.u[r0 + i][c0]) =
              make_float4(a.x - acc[i][0], a.y - acc[i][1], a.z - acc[i][2], a.w - acc[i][3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = r0 - C + i;
          const float4 a = ld4(o0 + (row + c) * o0_rs + v0 + c0);
          const size_t t = (size_t)ch * C + c;
          *reinterpret_cast<float4*>(out + (t * heads + h) * V + v0 + c0) =
              make_float4(a.x + acc[i][0], a.y + acc[i][1], a.z + acc[i][2], a.w + acc[i][3]);
        }
      }
    }
    __syncthreads();

    // phase 2: S <- gamma (.) S + Kh^T U, each thread its own 4 x 4 of S
    {
      const int k0 = lane * 4;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = sm.gam[k0 + i] * sm.s[k0 + i][c0 + j];
#pragma unroll 8
      for (int c = 0; c < C; ++c)
        fma4x4(acc, *reinterpret_cast<const float4*>(&sm.kh[c][k0]),
               *reinterpret_cast<const float4*>(&sm.u[c][c0]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(&sm.s[k0 + i][c0]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();  // S whole before the next chunk reads it; mt, kh, u free
  }

  float* sh = s_out + (size_t)h * K * V;
  for (int i = tid; i < K * VS / 4; i += THREADS) {
    const int k = i / (VS / 4), j = (i % (VS / 4)) * 4;
    *reinterpret_cast<float4*>(sh + k * V + v0 + j) = *reinterpret_cast<const float4*>(&sm.s[k][j]);
  }
}

// ---------------------------------------------------------------------------
// The decode step: one token through one KDA layer, after its projections.
// One block a head (DT = 256 threads), everything but the projections in one
// launch, so a decode step is a few launches a layer and not ~40 (a step is
// launch-bound: ~2,000 small kernels at ~3 us each).
//
//   q, k, v  = SiLU(sum_t conv[t] * window[t])       (window: the last 3
//              inputs and this one, bf16 [4, 3 D]; sums in float32, t in order)
//   q^ = q rsqrt(|q|^2 + l2_eps) * q_scale,  k^ = k rsqrt(|k|^2 + l2_eps)
//   beta = sigmoid(b[h]);  g, the log-decay of each key channel, is given
//   S <- Diag(exp g) S;  S <- S + beta k^ (v - S^T k^)^T;  o = S^T q^
//   out = bf16(RMSNorm(o) * o_norm * sigmoid(gate))      (per head, over V)
//
// Thread t owns value column t % 128 and rows (t / 128) * 64 .. + 63 of the
// head's S [K, V] (float32, updated in place): each warp reads and writes
// 128 consecutive bytes of a row.
constexpr int DT = 256;
constexpr int DK = 128;  // key and value width (K = V)
constexpr int DHALF = DK / 2;

__device__ __forceinline__ float block_sum_128(float x, float* red, int tid) {
  // the sum of x over threads 0..127 (4 warps), returned to those threads;
  // every thread of the block must call it
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (tid < DK && (tid & 31) == 0) red[tid >> 5] = x;
  __syncthreads();
  const float total = (red[0] + red[1]) + (red[2] + red[3]);
  __syncthreads();
  return total;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(DT, 1)
    kda_decode_kernel(const __nv_bfloat16* __restrict__ window, const float* __restrict__ conv,
                      const float* __restrict__ g, const __nv_bfloat16* __restrict__ gate,
                      const __nv_bfloat16* __restrict__ b, const float* __restrict__ o_norm,
                      float* __restrict__ state, __nv_bfloat16* __restrict__ out, int heads,
                      float l2_eps, float q_scale, float rms_eps) {
  __shared__ float qs[DK], ks[DK], vs[DK], dec[DK], part[2][DK], red[4];
  const int h = blockIdx.x, tid = threadIdx.x, width = 3 * heads * DK;
  const int c = tid % DK;
  // q and k (threads 0..127), v and the decay (threads 128..255), channel c
  float x0 = 0.f, x1 = 0.f;
  {
    const int ch0 = (tid < DK ? 0 : 2 * heads * DK) + h * DK + c;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      x0 = __fadd_rn(x0, __fmul_rn(__bfloat162float(window[t * width + ch0]), conv[t * width + ch0]));
      if (tid < DK) {
        const int ch1 = ch0 + heads * DK;
        x1 = __fadd_rn(x1, __fmul_rn(__bfloat162float(window[t * width + ch1]), conv[t * width + ch1]));
      }
    }
    x0 = x0 / (1.f + expf(-x0));
    x1 = x1 / (1.f + expf(-x1));
  }
  const float qq = block_sum_128(tid < DK ? x0 * x0 : 0.f, red, tid);
  const float kk = block_sum_128(tid < DK ? x1 * x1 : 0.f, red, tid);
  if (tid < DK) {
    qs[c] = x0 * rsqrtf(qq + l2_eps) * q_scale;
    ks[c] = x1 * rsqrtf(kk + l2_eps);
  } else {
    vs[c] = x0;
    dec[c] = expf(g[h * DK + c]);
  }
  __syncthreads();
  const float beta = sigmoidf_(__bfloat162float(b[h]));

  // S <- Diag(exp g) S, then the delta correction on this thread's 64 rows
  const int r0 = (tid / DK) * DHALF;
  float* sh = state + (size_t)h * DK * DK + c;
  float s[DHALF];
  float p = 0.f;
#pragma unroll
  for (int r = 0; r < DHALF; ++r) {
    s[r] = dec[r0 + r] * sh[(r0 + r) * DK];
    p = fmaf(ks[r0 + r], s[r], p);
  }
  part[tid / DK][c] = p;
  __syncthreads();
  const float nv = vs[c] - (part[0][c] + part[1][c]);
  __syncthreads();  // part is written again below
  float o = 0.f;
#pragma unroll
  for (int r = 0; r < DHALF; ++r) {
    const float sn = __fadd_rn(s[r], __fmul_rn(beta * ks[r0 + r], nv));
    sh[(r0 + r) * DK] = sn;
    o = fmaf(qs[r0 + r], sn, o);
  }
  part[tid / DK][c] = o;
  __syncthreads();
  o = part[0][c] + part[1][c];
  // RMSNorm over the head's V values, the output gate
  const float ms = block_sum_128(tid < DK ? o * o : 0.f, red, tid) / DK;
  if (tid < DK) {
    const float y = o * rsqrtf(ms + rms_eps) * o_norm[c] *
                    sigmoidf_(__bfloat162float(gate[h * DK + c]));
    out[h * DK + c] = __float2bfloat16(y);
  }
}

}  // namespace

extern "C" {

const char* rfe_kda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The pass over `chunks` chunks of `heads` heads (layouts above, the row
// strides in elements; every pointer 16-byte aligned, on the current
// device). chunks == 0 copies nothing and launches nothing.
int rfe_kda_state_pass(const float* w, const float* qp, const float* kh, const float* u0,
                       const float* o0, const float* gamma, const float* s0, float* out,
                       float* s_out, int heads, int chunks, int w_rs, int qp_rs, int kh_rs,
                       int u0_rs, int o0_rs, void* stream) {
  const int rs[5] = {w_rs, qp_rs, kh_rs, u0_rs, o0_rs};
  for (int r : rs)
    if (r < K || r % 4 != 0) return (int)cudaErrorInvalidValue;
  if (heads < 1 || chunks < 0) return (int)cudaErrorInvalidValue;
  if (chunks == 0) return 0;
  const void* fn = (const void*)kda_state_pass_kernel;
  cudaError_t e = prepare(fn, sizeof(Smem));
  if (e != cudaSuccess) return (int)e;
  kda_state_pass_kernel<<<heads * SLICES, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      w, qp, kh, u0, o0, gamma, s0, out, s_out, heads, chunks, w_rs, qp_rs, kh_rs, u0_rs, o0_rs);
  return (int)cudaGetLastError();
}

// One decode step of one KDA layer (the kernel above) for `heads` heads of
// 128: window bf16 [4, 3 heads 128], conv float32 [4, 3 heads 128], g
// float32 [heads 128], gate bf16 [heads 128], b bf16 [heads], o_norm float32
// [128], state float32 [heads, 128, 128] (updated in place), out bf16
// [heads 128]; all contiguous, on the current device.
int rfe_kda_decode_step(const void* window, const float* conv, const float* g, const void* gate,
                        const void* b, const float* o_norm, float* state, void* out, int heads,
                        float l2_eps, float q_scale, float rms_eps, void* stream) {
  if (heads < 1) return (int)cudaErrorInvalidValue;
  kda_decode_kernel<<<heads, DT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)window, conv, g, (const __nv_bfloat16*)gate, (const __nv_bfloat16*)b,
      o_norm, state, (__nv_bfloat16*)out, heads, l2_eps, q_scale, rms_eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
