// Causal prefill attention of DeepSeek-V2's latent attention (MLA), one
// layer: o = softmax(q k^T * scale, causal) v over n prompt rows and H heads,
// at MLA's own widths: q and k 192 deep (128 "nope" columns per head, then
// 64 rope columns), v 128 wide, and the 64 rope columns of k one key shared
// by every head.
//
// Replaces no TPU kernel: the JAX package has no DeepSeek model. It was
// added because PyTorch's scaled_dot_product_attention served this path
// with FlashAttention-2 at ~26% of its FLOP bound on an H100: v padded from
// 128 to 192 (1.5 times the PV work), the shared rope key copied into all
// 16 heads, q, k and v each built by a full copy a layer, and FA2's
// mma.sync, which reaches about a third of Hopper's tensor-core rate.
//
// What bounds it: tensor-core operations. A prompt of n rows does
// 2 H n(n+1)/2 (192 + 128) FLOP against O(n) bytes of q, k, v and o, about
// 2,000 FLOP a byte at n = 16,896, far above the H100's ~295. The design
// keeps the tensor cores fed:
//   * a block owns one head and BM = 128 query rows: two consumer
//     warpgroups of 64 rows each run wgmma (S = Q K^T with both operands in
//     shared memory, O += P V with P from registers), and one producer warp
//     keeps TMA loads in flight; setmaxnreg moves registers from the
//     producer warpgroup to the consumers;
//   * Q (128 x 192) is loaded once; key tiles of BN = 128 rows stream
//     through a two-stage ring, K (k_nope || the shared k_pe, 192 deep) and
//     V (128 wide) on barriers of their own, so S of a tile can start
//     before its V has landed and a K stage is refilled as soon as both
//     warpgroups have scored it;
//   * inside a warpgroup the next tile's S product and the last tile's PV
//     product go to the tensor cores as one batch, and the softmax of the
//     next tile runs while PV does; the two warpgroups interleave by
//     themselves (making them take turns measured no faster);
//   * between a batch and its wait nothing but a wgmma writes the products'
//     registers, and no branch or predicated instruction lies there: where
//     one does, ptxas serializes every wgmma of the kernel (C7513), which
//     cost a quarter of the time. So the softmax only reads the scores, the
//     key tiles that need a mask (the diagonal; it also holds the ragged end
//     of the prompt, rows past n being TMA's zeros, masked as keys after
//     every real query) run a loop of their own, and every consumer thread
//     arrives on the ring's barriers;
//   * key tiles above the diagonal are never loaded;
//   * blocks are issued longest first (the query tiles with the most keys),
//     so the causal triangle's short blocks fill the last wave.
// Tiles measured on an H100 (PERF.md): BN 128 with two stages beat BN 64
// with four.
// Operands are read where the caller has them: q_nope, k_nope and v as
// strided views (row and head strides given), k_pe as one [n, 64] slice;
// the output is [n, H * 128], contiguous.
//
// Numerics: bf16 operands; float32 scores; the online softmax in float32
// with the scale folded into exp2; P rounded to bf16 for the PV product;
// float32 accumulation; bf16 output.
//
// The entry point takes raw device pointers and a stream, launches on that
// stream, allocates nothing, and returns cudaGetLastError() as an int.

#include <cuda.h>  // CUtensorMap and its enums: types only, the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int BM = 128;  // query rows a block: two consumer warpgroups of 64
constexpr int BN = 128;  // keys a tile
constexpr int STAGES = 2;  // key tiles in flight
constexpr int D_NOPE = 128, D_ROPE = 64, D_V = 128;
constexpr int ATOM = 64;          // bf16 columns in one 128-byte swizzled row
constexpr int THREADS = 3 * 128;  // the producer warpgroup, then two consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

constexpr int Q_ATOM = BM * ATOM * 2;  // bytes of one 64-column slab of the Q tile
constexpr int KV_ATOM = BN * ATOM * 2;
constexpr int Q_BYTES = 3 * Q_ATOM;  // nope 0-63, nope 64-127, rope
constexpr int K_BYTES = 3 * KV_ATOM;
constexpr int V_BYTES = 2 * KV_ATOM;
constexpr int OFF_K = Q_BYTES;
constexpr int OFF_V = OFF_K + STAGES * K_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * V_BYTES;
// barriers: Q full; per stage K full, K empty, V full, V empty
constexpr int BAR_Q = 0, BAR_K_FULL = 1, BAR_K_EMPTY = BAR_K_FULL + STAGES,
              BAR_V_FULL = BAR_K_EMPTY + STAGES, BAR_V_EMPTY = BAR_V_FULL + STAGES,
              N_BARS = BAR_V_EMPTY + STAGES;
constexpr int SMEM_BYTES = OFF_BAR + N_BARS * 8 + 1024;  // + room to align the base to 1 KB
constexpr int CONSUMER_THREADS = 256;  // each consumer thread releases a stage once

static_assert(D_NOPE == 2 * ATOM && D_ROPE == ATOM && D_V == 2 * ATOM, "MLA widths");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

// --------------------------------------------------------------- mbarriers
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Every consumer thread arrives: one lane's arrive, behind a branch or a
// predicate, between a wgmma batch and its wait made ptxas serialize every
// wgmma of the kernel.
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled operand (what TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B): start address, leading and
// stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the points that hand them over: after a
// wait, before the registers are read; before a wgmma.fence, so that what
// feeds the products (accumulators, P's fragments) is computed before it.
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define ACC64                                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "    \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "     \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "      \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define ACC64_OPS(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
      "+f"(d[63])

// d (64 x 128, f32) (+)= A (64 x 16) B (128 x 16)^T, both K-major in shared
// memory; accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 128),
// B MN-major (its 128 columns contiguous) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue S = Q K^T for one key tile (12 k-steps of 16 over the 192 columns),
// from the descriptors of the tiles' starts: a k-step moves the start
// address 32 bytes along the 128-byte rows, a slab moves it a slab.
__device__ __forceinline__ void issue_scores(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < 12; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(s, q_desc + (((kk >> 2) * Q_ATOM + off) >> 4),
             k_desc + (((kk >> 2) * KV_ATOM + off) >> 4), kk > 0);
  }
}

// Issue O += P V for one key tile (8 k-steps of 16 keys, 2 KB of V apart).
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[8][4],
                                         uint64_t v_desc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs(o, p[kk], v_desc + ((kk * 16 * 128) >> 4));
}

// Score i of this thread's share of a tile; -inf where MASKED and the key
// comes after the row's query.
template <bool MASKED>
__device__ __forceinline__ float score(const float (&s)[64], int i, int key0, int q_row) {
  if (!MASKED) return s[i];
  const int key = key0 + 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
  return key > q_row + 8 * ((i >> 1) & 1) ? -INFINITY : s[i];
}

// The online softmax of one scored tile: mask keys after each row's query
// where the tile needs it (MASKED: the tiles that reach past the
// warpgroup's first row), update the row maxima `mx` and sums `l` (this
// thread's share), put the factor that rescales the rows' earlier output in
// `rescale`, and pack exp2(s * c - max * c) as bf16 into p. Branch-free, and
// s is only read: it runs while the PV batch is in flight.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(const float (&s)[64], uint32_t (&p)[8][4],
                                             float (&mx)[2], float (&l)[2], float (&rescale)[2],
                                             float c, int key0, int q_row) {
  float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      m = fmaxf(m, fmaxf(score<MASKED>(s, 4 * j + 2 * r, key0, q_row),
                         score<MASKED>(s, 4 * j + 2 * r + 1, key0, q_row)));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    base[r] = m == -INFINITY ? 0.f : m * c;  // a row with no key yet keeps 0
    rescale[r] = ex2(mx[r] * c - base[r]);   // mx = -inf at first: 0
    mx[r] = m;
  }
  // element 2e (+1) of k-step kk: column 16 kk + 8 (e >> 1) + ..., row r = e & 1
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e, r = e & 1;
      const float lo = ex2(fmaf(score<MASKED>(s, i, key0, q_row), c, -base[r]));
      const float hi = ex2(fmaf(score<MASKED>(s, i + 1, key0, q_row), c, -base[r]));
      sum[r] += lo + hi;
      p[kk][e] = pack_bf16(lo, hi);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * rescale[r] + sum[r];
}

__device__ __forceinline__ void rescale_rows(float (&o)[64], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= f[(i >> 1) & 1];
}

// One consumer warpgroup's state and its steps over the key tiles.
struct Consumer {
  uint32_t bars;
  uint64_t q_desc;
  uint32_t k_base, v_base;  // stage 0's K and V tiles
  int q_row;                // this thread's rows: q_row, q_row + 8
  float c;                  // softmax scale x log2(e)
  float o[64], s[64], mx[2], l[2], f[2];
  uint32_t p[8][4];

  __device__ __forceinline__ uint32_t bar(int i) const { return bars + 8u * i; }
  __device__ __forceinline__ uint64_t k_desc(int stage) const {
    return sw128_desc(k_base + stage * K_BYTES, 1, 64);
  }
  // V is MN-major: its two 64-column slabs KV_ATOM apart, 8-key groups 1 KB apart
  __device__ __forceinline__ uint64_t v_desc(int stage) const {
    return sw128_desc(v_base + stage * V_BYTES, KV_ATOM / 16, 64);
  }

  // Tile 0: its S, then its softmax.
  __device__ __forceinline__ void first(bool masked) {
    bar_wait(bar(BAR_K_FULL), 0);
    own(s);
    wg_fence();
    issue_scores(s, q_desc, k_desc(0));
    wg_commit();
    wg_wait<0>();
    own(s);
    bar_arrive(bar(BAR_K_EMPTY));
    if (masked) softmax_tile<true>(s, p, mx, l, f, c, 0, q_row);
    else softmax_tile<false>(s, p, mx, l, f, c, 0, q_row);
  }

  // Tile j >= 1: its S and the PV of tile j - 1 in flight together, its
  // softmax while PV runs; then O rescaled for it.
  template <bool MASKED>
  __device__ __forceinline__ void step(int j) {
    const int s_cur = j % STAGES, s_prev = (j - 1) % STAGES;
    bar_wait(bar(BAR_K_FULL + s_cur), (j / STAGES) & 1);
    bar_wait(bar(BAR_V_FULL + s_prev), ((j - 1) / STAGES) & 1);
    own(s);
    own(o);
    own(p);
    wg_fence();
    issue_scores(s, q_desc, k_desc(s_cur));
    wg_commit();
    issue_pv(o, p, v_desc(s_prev));
    wg_commit();
    wg_wait<1>();  // S is in
    own(s);
    bar_arrive(bar(BAR_K_EMPTY + s_cur));
    uint32_t p_next[8][4];
    softmax_tile<MASKED>(s, p_next, mx, l, f, c, j * BN, q_row);
    wg_wait<0>();  // PV is in: o and p are free again
    own(o);
    own(p);
    bar_arrive(bar(BAR_V_EMPTY + s_prev));
    rescale_rows(o, f);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[kk][e] = p_next[kk][e];
  }

  // The PV of the last tile.
  __device__ __forceinline__ void last(int nk) {
    const int s_last = (nk - 1) % STAGES;
    bar_wait(bar(BAR_V_FULL + s_last), ((nk - 1) / STAGES) & 1);
    own(o);
    own(p);
    wg_fence();
    issue_pv(o, p, v_desc(s_last));
    wg_commit();
    wg_wait<0>();
    own(o);
    bar_arrive(bar(BAR_V_EMPTY + s_last));
  }
};

// grid: H * ceil(n / BM) blocks, the query tiles with the most keys first;
// block: THREADS. Maps (bf16, 128-byte swizzle, boxes of 64 columns):
// q_nope / k_nope / v [n, H, 128] and q_pe [n, H, 64] in 3D (column, head,
// row), k_pe [n, 64] in 2D (column, row). out [n, H * 128].
__global__ void __launch_bounds__(THREADS, 1)
mla_prefill_kernel(const __grid_constant__ CUtensorMap map_q_nope,
                   const __grid_constant__ CUtensorMap map_q_pe,
                   const __grid_constant__ CUtensorMap map_k_nope,
                   const __grid_constant__ CUtensorMap map_k_pe,
                   const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                   int n, int heads, float c) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t bars = base + OFF_BAR;
  auto bar = [&](int i) { return bars + 8u * i; };

  const int n_tiles = (n + BM - 1) / BM;
  const int m = n_tiles - 1 - static_cast<int>(blockIdx.x) / heads;  // longest first
  const int h = static_cast<int>(blockIdx.x) % heads;
  const int n_keys = min((m + 1) * BM, n);
  const int nk = (n_keys + BN - 1) / BN;

  if (threadIdx.x == 0) {
    bar_init(bar(BAR_Q), 1);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(bar(BAR_K_FULL + s), 1);
      bar_init(bar(BAR_V_FULL + s), 1);
      bar_init(bar(BAR_K_EMPTY + s), CONSUMER_THREADS);
      bar_init(bar(BAR_V_EMPTY + s), CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      const int q0 = m * BM;
      bar_expect_tx(bar(BAR_Q), Q_BYTES);
      tma_load_3d(base, &map_q_nope, bar(BAR_Q), 0, h, q0);
      tma_load_3d(base + Q_ATOM, &map_q_nope, bar(BAR_Q), ATOM, h, q0);
      tma_load_3d(base + 2 * Q_ATOM, &map_q_pe, bar(BAR_Q), 0, h, q0);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;  // the first round finds them free
        const int k0 = j * BN;
        const uint32_t kt = base + OFF_K + s * K_BYTES, vt = base + OFF_V + s * V_BYTES;
        bar_wait(bar(BAR_K_EMPTY + s), parity);
        bar_expect_tx(bar(BAR_K_FULL + s), K_BYTES);
        tma_load_3d(kt, &map_k_nope, bar(BAR_K_FULL + s), 0, h, k0);
        tma_load_3d(kt + KV_ATOM, &map_k_nope, bar(BAR_K_FULL + s), ATOM, h, k0);
        tma_load_2d(kt + 2 * KV_ATOM, &map_k_pe, bar(BAR_K_FULL + s), 0, k0);
        bar_wait(bar(BAR_V_EMPTY + s), parity);
        bar_expect_tx(bar(BAR_V_FULL + s), V_BYTES);
        tma_load_3d(vt, &map_v, bar(BAR_V_FULL + s), 0, h, k0);
        tma_load_3d(vt + KV_ATOM, &map_v, bar(BAR_V_FULL + s), ATOM, h, k0);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // this warpgroup's 64 rows of the tile; the shuffle lets the compiler
    // keep it, and the descriptors made from it, in uniform registers
    const int cw = __shfl_sync(0xffffffffu, wg - 1, 0);
    const int t = threadIdx.x % 128, lane = t & 31;
    const int q_first = m * BM + cw * 64;
    Consumer w;
    w.bars = bars;
    w.q_desc = sw128_desc(base + cw * 64 * 128, 1, 64);  // 64 rows of 128 bytes
    w.k_base = base + OFF_K;
    w.v_base = base + OFF_V;
    w.q_row = q_first + 16 * (t >> 5) + (lane >> 2);
    w.c = c;
#pragma unroll
    for (int i = 0; i < 64; ++i) w.o[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) w.mx[r] = -INFINITY, w.l[r] = 0.f;

    // key tiles below this warpgroup's first row need no mask; those after
    // (the diagonal, and the ragged end of the prompt) do
    const int unmasked = min(nk, (q_first + 1) / BN);
    bar_wait(bar(BAR_Q), 0);
    w.first(unmasked == 0);
    int j = 1;
    for (; j < unmasked; ++j) w.step<false>(j);
    for (; j < nk; ++j) w.step<true>(j);
    w.last(nk);

    // the rows' sums over the quad, then o / l as bf16 (rows past n are not
    // written)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      w.l[r] += __shfl_xor_sync(0xffffffffu, w.l[r], 1);
      w.l[r] += __shfl_xor_sync(0xffffffffu, w.l[r], 2);
      w.l[r] = 1.f / w.l[r];
    }
    const size_t ld = static_cast<size_t>(heads) * D_V;
    __nv_bfloat16* o_head = out + static_cast<size_t>(h) * D_V + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = (i >> 1) & 1;
      const int q = w.q_row + 8 * r;
      if (q < n)
        *reinterpret_cast<uint32_t*>(o_head + q * ld + 8 * (i >> 2)) =
            pack_bf16(w.o[i] * w.l[r], w.o[i + 1] * w.l[r]);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 map of `rows` rows of `width` columns, with `heads` heads between
// them (rank 3: column, head, row) or none (heads == 0, rank 2: column,
// row), strides in elements; boxes of 64 columns x 1 head x box_rows rows,
// 128-byte swizzle; rows past the end read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int width, int heads, int rows,
              long long head_stride, long long row_stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t rank = heads > 0 ? 3 : 2;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3], unit[3] = {1, 1, 1};
  dims[0] = width;
  box[0] = ATOM;
  if (rank == 3) {
    dims[1] = heads, dims[2] = rows;
    strides[0] = head_stride * 2, strides[1] = row_stride * 2;
    box[1] = 1, box[2] = box_rows;
  } else {
    dims[1] = rows;
    strides[0] = row_stride * 2;
    box[1] = box_rows;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

const char* rfe_mla_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_nope [n, heads, 128], q_pe [n, heads, 64], k_nope [n, heads, 128], v
// [n, heads, 128]: bf16, unit column stride, row and head strides in
// elements (multiples of 8), pointers 16-byte aligned; k_pe [n, 64] bf16,
// row stride k_pe_row; out [n, heads * 128] bf16, contiguous. scale_log2:
// the softmax scale times log2(e). The current device holds the operands.
// n == 0 launches nothing.
int rfe_mla_prefill_attention(const void* q_nope, const void* q_pe, const void* k_nope,
                              const void* k_pe, const void* v, void* out, int n, int heads,
                              long long q_nope_row, long long q_nope_head, long long q_pe_row,
                              long long q_pe_head, long long k_nope_row, long long k_nope_head,
                              long long k_pe_row, long long v_row, long long v_head,
                              float scale_log2, void* stream) {
  if (n < 0 || heads < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  CUtensorMap mq, mqp, mk, mkp, mv;
  if (!make_map(&mq, q_nope, D_NOPE, heads, n, q_nope_head, q_nope_row, BM) ||
      !make_map(&mqp, q_pe, D_ROPE, heads, n, q_pe_head, q_pe_row, BM) ||
      !make_map(&mk, k_nope, D_NOPE, heads, n, k_nope_head, k_nope_row, BN) ||
      !make_map(&mkp, k_pe, D_ROPE, 0, n, 0, k_pe_row, BN) ||
      !make_map(&mv, v, D_V, heads, n, v_head, v_row, BN))
    return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)mla_prefill_kernel;
  cudaError_t e = prepare(fn, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int blocks = heads * ((n + BM - 1) / BM);
  mla_prefill_kernel<<<blocks, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      mq, mqp, mk, mkp, mv, static_cast<__nv_bfloat16*>(out), n, heads, scale_log2);
  return (int)cudaGetLastError();
}

}  // extern "C"
