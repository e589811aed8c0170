// Causal / non-causal attention with an online softmax, grouped-query heads,
// fp32 scores, running max and denominator; output in the input dtype, and
// on request the f32 log-sum-exp of every query row for the backward.
// The dtype picks the forward kernel, one each:
//   bf16 -- flash_tc_kernel, both products on the tensor cores (wgmma);
//   f32  -- flash_kernel, fp32 FMAs on the CUDA cores (exact f32 twin).
// The backward (dQ, dK, dV) is three kernels that the dtype picks as it
// picks the forward:
//   bf16 -- flash_bwd_delta_tc, then flash_bwd_dkdv_tc and flash_bwd_dq_tc,
//           every product on wgmma;
//   f32  -- flash_bwd_delta, then flash_bwd_dkdv and flash_bwd_dq, fp32
//           FMAs on the CUDA cores (the exact f32 twin).
//
// Replaces: the Pallas kernel src/repro/kernels/flash_attention.py,
//   flash_attention (grid (B*H, nq, nk), nk sequential, VMEM scratch
//   carrying m/l/acc across K blocks, causal blocks above the diagonal
//   skipped, mask value -1e30). The backward has no TPU counterpart: the
//   reference's LM forward is jnp code that XLA differentiates.
// What bounds it on the H100: operations. A causal (B,H,S,D) attention does
//   ~2*B*H*S^2*D multiply-adds against 4*B*H*S*D elements moved, i.e. ~S/2
//   FLOP per byte (1024 at S=2048), far above the ridge of either the fp32
//   CUDA cores or the bf16 tensor cores; the backward does 5 such products.
// What the bf16 design does about it: the tensor cores do both products.
//   A block of two warpgroups owns 128 query rows of one (batch, q head),
//   64 rows per warpgroup (wgmma's M). Q stays in shared memory; 64-key K
//   and V tiles arrive double-buffered by 16-byte cp.async, so the next tile
//   loads while this one computes (one barrier per tile: a tile is fetched
//   into the stage every thread has finished with). S = Q K^T is a wgmma
//   m64n64k16 from shared memory (both operands K-major: the head dim is
//   contiguous); the online softmax runs on S's accumulator fragment in
//   registers (fp32 m and l on raw scores; each probability one FFMA with
//   the scale folded in and one ex2.approx); P, rounded to bf16 as the
//   model's reference rounds its probabilities, is the register A operand of
//   O += P V (wgmma with V read N-major from shared memory). Scores never
//   leave the registers.
// Head dims: a tile's head dim is cut into 64-column regions of 128-byte
//   rows stored with wgmma's 128-byte swizzle, then, where D is an odd
//   multiple of 32, one 32-column region of 64-byte rows with the 64-byte
//   swizzle (D=32: that region alone; 96: 64 + 32; 128: 2 x 64; 256: 4 x 64),
//   so neither cp.async writes nor wgmma reads conflict on banks. Q K^T
//   walks the regions 16 columns a wgmma; O += P V is one m64n64k16 per
//   64-column region (m64n32k16 for the 32-column one), each on its own
//   slice of the O accumulator. Registers: the O accumulator is D/2 f32 a
//   thread (128 at D=256), so D <= 64 runs two blocks an SM (at most 128
//   registers a thread) and D >= 96 one block an SM (at most 255): no
//   spill at any D (chip_smoke.py fails the run on one).
// What the f32 design does: one block of 128 threads owns a 64-row query
//   tile and walks the 64-key tiles, staging K and V in shared memory as
//   fp32; each thread owns 4 query rows x 8 key columns of the score tile
//   and 4 rows x D/8 columns of the accumulator (register-tiled fp32 FMAs,
//   rows reduced with warp shuffles), P through shared memory.
// What the backward's design does (FA2's split, no atomics, so two calls
//   give the same bits): a pre-pass sums delta = rowsum(dO o O) in f32, one
//   warp a row; the dK/dV kernel gives one block to each (batch, kv head,
//   key block), walks the G query heads of its group and their query tiles
//   from the diagonal up in a fixed order, recomputes P = exp(scale Q K^T -
//   lse) (0 where masked) and dP = dO V^T, and sums dV += P^T dO and
//   dK += scale dS^T Q, dS = P o (dP - delta), in its registers; the dQ
//   kernel gives one block to each (batch, q head, query block), walks the
//   key tiles up to the diagonal and sums dQ = scale dS K. The backward
//   does 7 products of work (S and dP in both kernels) for the bound's 5.
// The bf16 backward on the tensor cores: as the forward, warpgroups of 64
//   resident rows each (wgmma's M), swizzled tiles, 64-row tiles of the
//   other side double-buffered by cp.async; two warpgroups a block, but one
//   at D = 64, where two independent blocks an SM were faster than one
//   block of two that meet at every tile's barrier. The delta pre-pass
//   reads 16-byte chunks, D/8 lanes a row. dK/dV keeps K and
//   V resident and streams Q and dO with their lse and delta; it computes
//   the scores transposed, S^T = K Q^T and dP^T = V dO^T (wgmma from shared
//   memory, both K-major), so that the accumulator fragment of P^T and
//   dS^T, rows keys and columns queries, is already the register A operand
//   of dV += P^T dO and dK += dS^T Q (wgmma with dO and Q read N-major, one
//   per head-dim region, as the forward's P V). dQ keeps Q and dO resident,
//   streams K and V, and runs S = Q K^T, dP = dO V^T, then dQ += dS K with
//   K N-major: the forward's P V with K for V. P and dS are rounded to bf16
//   as operands; S, dP, delta and every sum stay f32 (ref.flash_bwd_limit
//   bounds the rounding). Registers: dK/dV holds D/2 + D/2 accumulators a
//   thread beside 32 + 32 for S^T and dP^T, which fits 255 up to D = 128
//   (254 there, no spill). At D = 256 the accumulators alone would be 256,
//   so the block's two warpgroups share the same 64 rows and each sums half
//   the head dim (its own two 64-column regions), both computing S and dP
//   in full: the products the two would otherwise exchange through shared
//   memory are recomputed, which costs 2 of every 6 products' time at
//   D = 256 but keeps each warpgroup free of the other (no named barriers,
//   no exchange buffer in a shared memory already at 194 KB there). dQ
//   splits the same way at D = 256, where Q, dO and the K/V double buffer
//   of 128 rows would need 257 KB. Not pipelined: issuing tile t + 1's
//   scores with tile t's products, to run the softmax beside them, made
//   ptxas serialize the wgmmas (C7520, the per-warpgroup tile skip puts
//   them on a divergent path) and was no faster.
// What the f32 backward does: flash_bwd_dkdv and flash_bwd_dq as above on
//   the CUDA cores. Tiles of BT rows (64; 32 at D=256, for shared memory)
//   of Q, dO, K and V sit in shared memory as f32; 256 threads, 16 row
//   groups x 16 column lanes, each with BT/16 rows x BT/16 columns of a
//   score tile and BT/16 rows x D/16 columns of each accumulator.
// Shapes: any S (ragged tiles are masked: padded keys score -1e30, padded
//   query rows are not stored), D in {32, 64, 96, 128, 256}, H a multiple
//   of the kv heads K (query head h reads kv head h / (H/K)). Tensors are
//   read and written through their (batch, head, seq) strides with the last
//   dim contiguous, so the model's seq-major (B,S,H,D) projections need no
//   transposed copy; the bf16 kernels load 16-byte rows, so the strides
//   and base pointers of q, k, v (and dO) must be 16-byte aligned (the
//   wrapper checks). The log-sum-exp and delta are contiguous (B,H,S) f32.
// Causal tiles: key tiles above the diagonal are never loaded, the
//   diagonal tile is masked, and the longest query tiles are scheduled
//   first (the query tile is the slowest grid dimension, reversed). In the
//   dK/dV kernels, query tiles below the key block are never loaded and
//   the first key blocks, which walk the most query tiles, go first.
// Sliding window (``window`` > 0, a runtime argument, 0 = off): query qi
//   sees key kj iff kj > qi - window (and kj <= qi when causal), as the
//   reference's local layers mask (src/repro/models/layers.py:184-191).
//   Tiles are skipped on both sides: a query tile starts at key tile
//   (q0 - window + 1) / BK; in dK/dV a key block stops at the query tile of
//   its last key + window - 1; tiles that straddle the window's lower edge
//   are masked as the diagonal tiles are. A row whose first tile is wholly
//   under its window keeps m = -1e30 through it: its exponent offset is 0
//   there (every probability ex2(-huge) = 0), and the first tile it sees
//   rescales the running sums by exp(-1e30 - m) = 0.
// Logit softcap (``cap`` > 0, runtime, 0 = off): the scaled f32 score
//   becomes cap tanh(score / cap) (the accurate tanhf, never tanh.approx)
//   before the mask and the softmax, as the reference's _softcap
//   (src/repro/models/layers.py:95-98). The bf16 forward folds the scale
//   into its exp2 only without a cap; with one it caps the scaled score and
//   multiplies by log2(e). The backward recomputes t = tanh(score / cap)
//   and multiplies dS by dsc/dscore = 1 - t^2. Both are runtime values.
//   The tensor-core kernels are instantiated in three modes, picked at
//   launch (``mode_of``): 0 neither (window forced to 0, so the kernel is
//   the plain causal one), 1 the window, 2 the window and the cap. With
//   one instantiation for all, the runtime tests on window and cap inside
//   their loops cost the uncapped, unwindowed attention 3.5% (forward)
//   and 22% (backward) at the Llama shape (tools/flash_llama_ab.py, parent
//   against change on one card). The CUDA-core kernels, the f32 twin,
//   test both at run time.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// Element strides of a (B, heads, S, D) tensor; the D stride is 1.
struct Strides {
  int64_t b, h, s;
};

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// ---- f32: fp32 FMAs on the CUDA cores -------------------------------------

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per tile
constexpr int NT = 128;    // threads: 16 row groups x 8 column lanes
constexpr int RG = 4;      // query rows per thread
constexpr int CG = 8;      // key columns per thread (strided by 8)

template <int D>
constexpr int smem_floats() {
  return 3 * BQ * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int S, int G, int causal, int window,
             float cap, float scale, Strides sq, Strides sk, Strides sv,
             Strides so) {
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);         // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);         // [BK][D+1]
  float* Ps = Vs + BK * (D + 1);         // [BQ][BK+1]
  constexpr int DC = D / CG;             // accumulator columns per thread

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[r * (D + 1) + d] =
        q0 + r < S ? to_f32(qb[(q0 + r) * sq.s + d]) : 0.f;
  }

  float m[RG], l[RG], acc[RG][DC];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : (S + BK - 1) / BK;
  const int kt0 = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;
  const float cap_in = cap > 0.f ? 1.f / cap : 0.f;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                     // last tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < S;
      Ks[r * (D + 1) + d] = ok ? to_f32(kb[(k0 + r) * sk.s + d]) : 0.f;
      Vs[r * (D + 1) + d] = ok ? to_f32(vb[(k0 + r) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RG][CG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < CG; ++j) s[i][j] = 0.f;
    // d steps of loads in flight: at 8 with the softcap's tanhf beside
    // them, ptxas held D = 96 to 128 registers and spilled
    constexpr int QK_UNROLL = D == 96 ? 4 : 8;
#pragma unroll QK_UNROLL
    for (int d = 0; d < D; ++d) {
      float qv[RG], kv[CG];
#pragma unroll
      for (int i = 0; i < RG; ++i) qv[i] = Qs[(rg * RG + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CG; ++j) kv[j] = Ks[(cg + CG * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < CG; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int qi = q0 + rg * RG + i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const int kj = k0 + cg + CG * j;
        float x = s[i][j] * scale;
        if (cap > 0.f) x = cap * tanhf(x * cap_in);
        if (kj >= S || (causal && kj > qi) || (window > 0 && kj <= qi - window))
          x = NEG_INF;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      const float mo = m_new == NEG_INF ? 0.f : m_new;   // all masked so far
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const float p = expf(s[i][j] - mo);
        Ps[(rg * RG + i) * (BK + 1) + cg + CG * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RG], vv[DC];
#pragma unroll
      for (int i = 0; i < RG; ++i) pv[i] = Ps[(rg * RG + i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[kk * (D + 1) + cg + CG * j];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int qi = q0 + rg * RG + i;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[qi * so.s + cg + CG * j] = from_f32<T>(acc[i][j] / l[i]);
    if (lse != nullptr && cg == 0)       // m is on scaled scores
      lse[(static_cast<int64_t>(b) * gridDim.y + h) * S + qi] =
          m[i] + logf(l[i]);
  }
}


// ---- bf16: wgmma on the tensor cores -------------------------------------

namespace tc {

constexpr int NWG = 2;             // consumer warpgroups per block (1: as fast)
constexpr int NT = 128 * NWG;      // threads per block
constexpr int BQ = 64 * NWG;       // query rows per block, 64 per warpgroup
constexpr int BK = 64;             // keys per tile
constexpr int STAGES = 2;          // K/V double buffer (a deeper ring: no faster)
constexpr float LOG2E = 1.4426950408889634f;

// A tile of rows x D bf16: N64 regions of 64 columns (128-byte rows, 128B
// swizzle), then HAS32 regions of 32 columns (64-byte rows, 64B swizzle);
// each region holds all the tile's rows.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128 || D == 256,
                "head dims 32, 64, 96, 128, 256");
  static constexpr int N64 = D / 64;
  static constexpr int HAS32 = D % 64 == 32;
  static constexpr int CHUNKS = D / 8;          // 16-byte chunks per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // + 1024 to align the ring to the swizzle pattern's repeat
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
  // the O accumulator is D/2 registers a thread: two blocks an SM (at most
  // 128 registers) up to D = 64, one block (at most 255) above
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
};

// Byte offset of 16-byte chunk c of row r in a ROWS-row swizzled tile: the
// chunk index XOR the row's position in its 1024-byte (128B swizzle) or
// 512-byte (64B swizzle) repeat, as wgmma's swizzle modes read it.
template <int D, int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int N64 = Tile<D>::N64;
  if (c < N64 * 8)
    return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  return N64 * (ROWS * 128) + r * 64 + (((c - N64 * 8) ^ ((r >> 1) & 3)) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 fills the 16 bytes with zeros (rows past S)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async) -> async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from touching accumulators across an async wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N, fp32 in registers) = [d +] A (smem, K-major) B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32, a slice of the accumulator) = [d +] A (registers, bf16
// fragment) B (smem, N-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32, a slice of the accumulator) = [d +] A (registers, bf16
// fragment) B (smem, N-major)
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 2^x in one MUFU op (flushes denormals: a probability under 2^-126 of the
// row's largest is 0, as it is to the bf16 PV product anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(sc - lse) of a raw score s, for nl2 = -lse log2(e): sc = s scale
// without a cap, cap tanh(s scale / cap) with one (cap_in = scale / cap);
// f = dsc / d(s scale), the chain factor of dS (1 - t^2; unset without a
// cap)
template <bool CAP>
__device__ __forceinline__ float prob(float s, float nl2, float scale_log2,
                                      float cap, float cap_in, float& f) {
  if constexpr (CAP) {
    const float t = tanhf(s * cap_in);
    f = 1.f - t * t;
    return ex2(fmaf(cap * t, LOG2E, nl2));
  }
  return ex2(fmaf(s, scale_log2, nl2));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Descriptor of the k16 step ``kd`` (head-dim columns 16 kd..) of rows
// row0.. (a multiple of 8) of a ROWS-row K-major tile at ``base``.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int row0, int kd) {
  constexpr int N64 = Tile<D>::N64;
  if (kd < N64 * 4)
    return desc(base + (kd >> 2) * (ROWS * 128) + row0 * 128 + (kd & 3) * 32,
                16, 1024, 1);
  return desc(base + N64 * (ROWS * 128) + row0 * 64 + (kd - N64 * 4) * 32, 16,
              512, 2);
}

// ROWS x D rows [row0, row0 + ROWS) of a (S, D) slab with row stride
// `stride` into a swizzled tile, by NTH threads; rows past S are
// zero-filled.
template <int D, int ROWS, int NTH = NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          int64_t stride, int row0, int S,
                                          int tid) {
  constexpr int CH = Tile<D>::CHUNKS;
  static_assert(ROWS * CH % NTH == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NTH; ++it) {
    const int i = tid + it * NTH;
    const int r = i / CH, c = i % CH;
    const bool ok = row0 + r < S;
    const __nv_bfloat16* src =
        base + static_cast<int64_t>(ok ? row0 + r : 0) * stride + c * 8;
    cp_async16(dst + swz<D, ROWS>(r, c), src, ok);
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(NT, Tile<D>::MIN_BLOCKS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
                int G, int causal, int window, float cap, float scale,
                float scale_log2, Strides sq, Strides sk, Strides sv,
                Strides so) {
  using T = Tile<D>;
  constexpr int NO = D / 2;          // O accumulator registers per thread
  constexpr bool CAP = MODE == 2;
  if constexpr (MODE == 0) window = 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;
  const uint32_t sV = sK + STAGES * T::KV_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const int n_all = (S + BK - 1) / BK;
  const int n_kt = causal ? min(n_all, (q0 + BQ - 1) / BK + 1) : n_all;
  const int kt0 = window > 0 ? max(0, (q0 - window + 1) / BK) : 0;
  // the scores' unit in the exponent: raw scores (the scale folded into
  // ex2) without a cap, capped scaled scores with one
  const float unit = CAP ? 1.f : scale;
  const float unit_log2 = CAP ? LOG2E : scale_log2;
  const float cap_in = CAP ? scale / cap : 0.f;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;

  // Q and tile kt0 (commit group 0); tile kt + 1 is issued once every
  // thread has passed iteration kt's barrier, i.e. is done with tile kt - 1
  // and its stage
  load_tile<D, BQ>(sQ, qb, sq.s, q0, S, tid);
  load_tile<D, BK>(sK + (kt0 % STAGES) * T::KV_BYTES, kb, sk.s, kt0 * BK, S,
                   tid);
  load_tile<D, BK>(sV + (kt0 % STAGES) * T::KV_BYTES, vb, sv.s, kt0 * BK, S,
                   tid);
  cp_async_commit();

  // this thread's rows of the warpgroup's 64 (the accumulator fragment:
  // rows lane/4 and lane/4 + 8 of the warp's 16, columns 2 (lane%4) + {0,1}
  // of every 8)
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int kt = kt0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // tile kt is in shared memory
    if (kt + 1 < n_kt) {             // tile kt + 1 into the other stage
      const uint32_t nst = ((kt + 1) % STAGES) * T::KV_BYTES;
      load_tile<D, BK>(sK + nst, kb, sk.s, (kt + 1) * BK, S, tid);
      load_tile<D, BK>(sV + nst, vb, sv.s, (kt + 1) * BK, S, tid);
      cp_async_commit();
    }

    const int k0 = kt * BK;
    const uint32_t st = (kt % STAGES) * T::KV_BYTES;
    // a tile wholly above this warpgroup's diagonal or wholly under its
    // window, or a warpgroup wholly past S, has nothing to add
    if (qw0 < S && (!causal || k0 < qw0 + 64) &&
        !(window > 0 && k0 + BK - 1 <= qw0 - window)) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)      // 32 bytes of head dim each
        wgmma_ss_m64n64k16(s, desc_k<D, BQ>(sQ, wg * 64, kd),
                           desc_k<D, BK>(sK + st, 0, kd), kd);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);

      if constexpr (CAP) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = cap * tanhf(s[i] * cap_in);
      }
      // m, l and the max run on scores in ``unit`` (positive); each
      // probability is one FFMA and one ex2: 2^(s unit_log2 - m unit_log2)
      if ((causal && k0 + BK - 1 > qw0) || k0 + BK > S ||
          (window > 0 && k0 <= qw0 + 63 - window)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + j * 8 + cq + (e & 1);
            const int r = e < 2 ? r0 : r1;
            if (kj >= S || (causal && kj > r) ||
                (window > 0 && kj <= r - window))
              s[j * 4 + e] = NEG_INF;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j * 4], s[j * 4 + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[j * 4 + 2], s[j * 4 + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes sharing a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float a0 = ex2((m0 - mx0) * unit_log2);
      const float a1 = ex2((m1 - mx1) * unit_log2);
      m0 = mx0;
      m1 = mx1;
      // a row with every key so far masked (under its window) takes offset
      // 0: its probabilities are ex2(-huge) = 0, never the residue of
      // -1e30 u + 1e30 u (without a window no row is: key 0 comes first)
      const bool w = window > 0;
      const float b0 = w && mx0 == NEG_INF ? 0.f : -mx0 * unit_log2;
      const float b1 = w && mx1 == NEG_INF ? 0.f : -mx1 * unit_log2;
      uint32_t p[16];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = ex2(fmaf(s[j * 4], unit_log2, b0));
        const float p1 = ex2(fmaf(s[j * 4 + 1], unit_log2, b0));
        const float p2 = ex2(fmaf(s[j * 4 + 2], unit_log2, b1));
        const float p3 = ex2(fmaf(s[j * 4 + 3], unit_log2, b1));
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        p[j * 2] = pack_bf16(p0, p1);
        p[j * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        acc[j * 4] *= a0;
        acc[j * 4 + 1] *= a0;
        acc[j * 4 + 2] *= a1;
        acc[j * 4 + 3] *= a1;
      }

      // O += P V, 16 keys per wgmma, one per head-dim region: P's fragment
      // for keys 16 kk.. is the score fragment's column blocks 2 kk and
      // 2 kk + 1; region r's accumulator slice is acc[32 r..] (its columns
      // 64 r.. in the fragment's order)
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
#pragma unroll
        for (int r = 0; r < T::N64; ++r)
          wgmma_rs_m64n64k16(acc + 32 * r, a,
                             desc(sV + st + r * (BK * 128) + kk * 16 * 128,
                                  16, 1024, 1), 1);
        if constexpr (T::HAS32)
          wgmma_rs_m64n32k16(acc + 32 * T::N64, a,
                             desc(sV + st + T::N64 * (BK * 128) + kk * 16 * 64,
                                  16, 512, 2), 1);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * so.s + j * 8 + cq) =
          pack_bf16(acc[j * 4] / l0, acc[j * 4 + 1] / l0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * so.s + j * 8 + cq) =
          pack_bf16(acc[j * 4 + 2] / l1, acc[j * 4 + 3] / l1);
  }
  if (lse != nullptr && lane % 4 == 0) {  // m is in ``unit``
    float* lb = lse + (static_cast<int64_t>(b) * gridDim.x + h) * S;
    if (r0 < S) lb[r0] = m0 * unit + logf(l0);
    if (r1 < S) lb[r1] = m1 * unit + logf(l1);
  }
}

// ---- bf16 backward: wgmma on the tensor cores ------------------------------

// Warpgroups a block at D <= 128: one at D = 64 (two blocks an SM), two
// elsewhere, the faster of the two at each head dim as
// tools/flash_bwd_variants.py times them; -DFLASH_BWD_WGS=1 or 2 sets one
// count for every D <= 128, for that comparison.
#ifndef FLASH_BWD_WGS
#define FLASH_BWD_WGS 0
#endif
// A block's warpgroups and what they own. Each keeps ROWS resident rows
// (keys in dK/dV, queries in dQ) and streams 64-row tiles of the other side.
// D <= 128: each warpgroup owns 64 rows and every head-dim column (SPLIT 1).
// D = 256: the two own the same 64 rows and each sums half the head dim
// (SPLIT 2), computing S and dP twice.
template <int D>
struct Bwd {
  static constexpr int SPLIT = D == 256 ? 2 : 1;
  static constexpr int WGS = D == 256 ? 2                       // a block
                             : FLASH_BWD_WGS ? FLASH_BWD_WGS
                             : D == 64 ? 1 : 2;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int ROWS = 64 * WGS / SPLIT;  // resident rows a block
  static constexpr int DA = D / SPLIT;           // accumulated columns a wg
  static constexpr int NR = DA / 64;             // its 64-column regions
  static constexpr int HAS32 = DA % 64 == 32;    // and its 32-column one
  static constexpr int TR = 64;                  // rows of a streamed tile
  static constexpr int RES_BYTES = ROWS * D * 2;
  static constexpr int TILE_BYTES = TR * D * 2;
  // two resident tiles, two streamed tiles a stage (+ the streamed rows'
  // lse and delta in the dK/dV kernel), + 1024 for the swizzle's alignment
  static constexpr int SMEM_Q = 2 * RES_BYTES + 2 * STAGES * TILE_BYTES + 1024;
  static constexpr int SMEM_KV = SMEM_Q + 2 * STAGES * TR * 4;
  // dQ holds D/2 accumulator registers a thread, dK/dV twice that, each
  // beside the 64 of S and dP: 256 threads an SM at most 255 registers
  // each, so two blocks of one warpgroup, or one of two; two of two (at
  // most 128 registers) only for dQ at D = 32
  static constexpr int MIN_BLOCKS_Q = WGS == 1 || D <= 32 ? 2 : 1;
  static constexpr int MIN_BLOCKS_KV = WGS == 1 ? 2 : 1;
};

// delta[row] = sum_d dO[row, d] O[row, d] in f32 for bf16 O and dO: L
// lanes a (b, h, s) row (a power of two, at least D/8), each with one
// 16-byte chunk of both, summed by shuffles in a fixed order
template <int D>
__host__ __device__ constexpr int delta_lanes() {
  return D <= 32 ? 4 : D <= 64 ? 8 : D <= 128 ? 16 : 32;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_delta_tc(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dO,
                   float* __restrict__ delta, int64_t rows, int H, int S,
                   Strides so, Strides sdo) {
  constexpr int CH = D / 8, L = delta_lanes<D>();
  const int lane = threadIdx.x % L;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (NT / L) +
                      threadIdx.x / L;
  float acc = 0.f;
  if (row < rows && lane < CH) {     // every lane joins the shuffles
    const int s = static_cast<int>(row % S);
    const int64_t bh = row / S;
    const int h = static_cast<int>(bh % H);
    const int64_t b = bh / H;
    const uint4 x = *reinterpret_cast<const uint4*>(
        o + b * so.b + h * so.h + s * so.s + lane * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(
        dO + b * sdo.b + h * sdo.h + s * sdo.s + lane * 8);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 xf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 gf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&gs[i]));
      acc = fmaf(gf.x, xf.x, acc);
      acc = fmaf(gf.y, xf.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane == 0) delta[row] = acc;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// acc (64 x DA) += A (registers: bf16 fragment of 16 k-columns, kk-th of
// the 64-row tile) B (the kk-th 16 rows of a 64-row swizzled tile at
// ``tile``, read N-major, this warpgroup's head-dim regions from ``reg0``)
template <int D>
__device__ __forceinline__ void mma_rows(float* acc, const uint32_t (&a)[4],
                                         uint32_t tile, int kk, int reg0) {
  using W = Bwd<D>;
#pragma unroll
  for (int r = 0; r < W::NR; ++r)
    wgmma_rs_m64n64k16(acc + 32 * r, a,
                       desc(tile + (reg0 + r) * (W::TR * 128) + kk * 16 * 128,
                            16, 1024, 1), 1);
  if constexpr (W::HAS32)
    wgmma_rs_m64n32k16(acc + 32 * W::NR, a,
                       desc(tile + Tile<D>::N64 * (W::TR * 128) + kk * 16 * 64,
                            16, 512, 2), 1);
}

// s = A B^T and dp = A2 B2^T (64 x 64 each, f32): A, A2 the 64 resident
// rows from row0 of two ROWS-row tiles, B, B2 two streamed 64-row tiles,
// summed over the whole head dim
template <int D>
__device__ __forceinline__ void mma_scores(float (&s)[32], float (&dp)[32],
                                           uint32_t a, uint32_t a2,
                                           uint32_t b, uint32_t b2,
                                           int row0) {
  constexpr int ROWS = Bwd<D>::ROWS;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_ss_m64n64k16(s, desc_k<D, ROWS>(a, row0, kd),
                       desc_k<D, 64>(b, 0, kd), kd);
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd)
    wgmma_ss_m64n64k16(dp, desc_k<D, ROWS>(a2, row0, kd),
                       desc_k<D, 64>(b2, 0, kd), kd);
  wgmma_commit();
  wgmma_wait0();
  reg_fence(s);
  reg_fence(dp);
}

// Store a warpgroup's 64 x DA accumulator (rows r0, r1 of the fragment,
// columns col0..) times ``mul`` in bf16 to rows < S of a (S, D) slab.
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, int64_t stride,
                                          const float* acc, float mul, int r0,
                                          int r1, int col0, int S) {
#pragma unroll
  for (int j = 0; j < Bwd<D>::DA / 8; ++j) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(base + r0 * stride + col0 + j * 8) =
          pack_bf16(acc[j * 4] * mul, acc[j * 4 + 1] * mul);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(base + r1 * stride + col0 + j * 8) =
          pack_bf16(acc[j * 4 + 2] * mul, acc[j * 4 + 3] * mul);
  }
}

// dK and dV of one (batch, kv head, ROWS keys): K and V resident, the G
// query heads' 64-row Q and dO tiles (with their lse and delta) streamed in
// a fixed order, transposed scores so that P^T and dS^T come out of the
// accumulator as the register A operands of dV += P^T dO and dK += dS^T Q
template <int D, int MODE>
__global__ void __launch_bounds__(Bwd<D>::THREADS, Bwd<D>::MIN_BLOCKS_KV)
flash_bwd_dkdv_tc(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dO,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int S, int H, int G,
                  int causal, int window, float cap, float scale,
                  float scale_log2, Strides sq, Strides sk, Strides sv,
                  Strides sdo, Strides sdk, Strides sdv) {
  using W = Bwd<D>;
  constexpr int TR = W::TR, NTH = W::THREADS;
  constexpr bool CAP = MODE == 2;
  if constexpr (MODE == 0) window = 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + W::RES_BYTES;
  const uint32_t sQ = sV + W::RES_BYTES;            // [STAGES] tiles
  const uint32_t sG = sQ + STAGES * W::TILE_BYTES;  // dO, [STAGES] tiles
  const uint32_t sL = sG + STAGES * W::TILE_BYTES;  // lse, [STAGES][TR]
  const uint32_t sD = sL + STAGES * TR * 4;         // delta, [STAGES][TR]
  const float* fL = reinterpret_cast<const float*>(smem_raw + (sL - raw));
  const float* fD = reinterpret_cast<const float*>(smem_raw + (sD - raw));

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = static_cast<int>(blockIdx.z) * W::ROWS;  // longest first
  const int row0 = W::SPLIT == 1 ? wg * 64 : 0;   // this wg's keys in sK
  const int half = W::SPLIT == 1 ? 0 : wg;        // its head-dim half
  const int kw0 = k0 + row0;
  const int n_q = (S + TR - 1) / TR;
  const int qt0 = causal ? k0 / TR : 0;           // tiles below are masked
  // and tiles past the window of the block's last key
  const int qt1 = window > 0
                      ? min(n_q, (k0 + W::ROWS - 1 + window - 1) / TR + 1)
                      : n_q;
  const int per = qt1 - qt0, n_t = G * per;
  const float cap_in = cap > 0.f ? scale / cap : 0.f;

  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  auto load = [&](int t) {                        // tile t into its stage
    const int h = hk * G + t / per, q0 = (qt0 + t % per) * TR;
    const int st = t % STAGES;
    load_tile<D, TR, NTH>(sQ + st * W::TILE_BYTES, q + b * sq.b + h * sq.h,
                          sq.s, q0, S, tid);
    load_tile<D, TR, NTH>(sG + st * W::TILE_BYTES,
                          dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
    if (tid < 2 * TR) {
      const int i = tid % TR;
      const bool ok = q0 + i < S;
      const float* src = (tid < TR ? lse : delta) +
                         (static_cast<int64_t>(b) * H + h) * S +
                         (ok ? q0 + i : 0);
      cp_async4((tid < TR ? sL : sD) + (st * TR + i) * 4, src, ok);
    }
  };
  load_tile<D, W::ROWS, NTH>(sK, kb, sk.s, k0, S, tid);
  load_tile<D, W::ROWS, NTH>(sV, vb, sv.s, k0, S, tid);
  load(0);
  cp_async_commit();

  // the fragment's rows are keys kr0, kr1; its columns queries
  // q0 + 8 j + cq + {0, 1}
  const int kr0 = kw0 + warp * 16 + lane / 4, kr1 = kr0 + 8;
  const int cq = (lane % 4) * 2;
  float dka[W::DA / 2], dva[W::DA / 2];
#pragma unroll
  for (int i = 0; i < W::DA / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // tile t is in shared memory
    if (t + 1 < n_t) {
      load(t + 1);
      cp_async_commit();
    }
    const int q0 = (qt0 + t % per) * TR, st = t % STAGES;
    // keys past S, or a tile wholly above this warpgroup's keys or wholly
    // past their window, add nothing
    if (kw0 >= S || (causal && q0 + TR - 1 < kw0) ||
        (window > 0 && q0 >= kw0 + 63 + window))
      continue;
    const uint32_t tQ = sQ + st * W::TILE_BYTES, tG = sG + st * W::TILE_BYTES;
    float s[32], dp[32];
    mma_scores<D>(s, dp, sK, sV, tQ, tG, row0);   // S^T = K Q^T, dP^T = V dO^T

    // P^T and dS^T, 0 where the query is past S, before the key or past
    // its window
    const bool edge = (causal && q0 < kw0 + 63) || q0 + TR > S ||
                      (window > 0 && q0 + TR - 1 >= kw0 + window);
    uint32_t pa[16], da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = st * TR + j * 8 + cq;      // this thread's two queries
      const float2 l = *reinterpret_cast<const float2*>(fL + c);
      const float2 dl = *reinterpret_cast<const float2*>(fD + c);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float le = e & 1 ? l.y : l.x, de = e & 1 ? dl.y : dl.x;
        float f;
        p[e] = prob<CAP>(s[j * 4 + e], -le * LOG2E, scale_log2, cap, cap_in,
                         f);
        if (edge) {
          const int qi = q0 + j * 8 + cq + (e & 1);
          const int kr = e < 2 ? kr0 : kr1;
          if (qi >= S || (causal && kr > qi) ||
              (window > 0 && qi >= kr + window))
            p[e] = 0.f;
        }
        ds[e] = p[e] * (dp[j * 4 + e] - de);
        if constexpr (CAP) ds[e] *= f;
      }
      pa[j * 2] = pack_bf16(p[0], p[1]);
      pa[j * 2 + 1] = pack_bf16(p[2], p[3]);
      da[j * 2] = pack_bf16(ds[0], ds[1]);
      da[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q, 16 queries a wgmma
    reg_fence(dva);
    reg_fence(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      mma_rows<D>(dva, a, tG, kk, half * W::NR);
      const uint32_t a2[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                              da[4 * kk + 3]};
      mma_rows<D>(dka, a2, tQ, kk, half * W::NR);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dva);
    reg_fence(dka);
  }

  const int c0 = half * W::DA + cq;
  store_acc<D>(dk + b * sdk.b + hk * sdk.h, sdk.s, dka, scale, kr0, kr1, c0,
               S);
  store_acc<D>(dv + b * sdv.b + hk * sdv.h, sdv.s, dva, 1.f, kr0, kr1, c0, S);
}

// dQ of one (batch, q head, ROWS queries): Q and dO resident, 64-key K and
// V tiles streamed up to the diagonal; dS comes out of the accumulator as
// the register A operand of dQ += dS K (the forward's P V with K for V)
template <int D, int MODE>
__global__ void __launch_bounds__(Bwd<D>::THREADS, Bwd<D>::MIN_BLOCKS_Q)
flash_bwd_dq_tc(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int S, int H, int G,
                int causal, int window, float cap, float scale,
                float scale_log2, Strides sq, Strides sk, Strides sv,
                Strides sdo, Strides sdq) {
  using W = Bwd<D>;
  constexpr int TR = W::TR, NTH = W::THREADS;
  constexpr bool CAP = MODE == 2;
  if constexpr (MODE == 0) window = 0;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sG = sQ + W::RES_BYTES;            // dO
  const uint32_t sK = sG + W::RES_BYTES;            // [STAGES] tiles
  const uint32_t sV = sK + STAGES * W::TILE_BYTES;  // [STAGES] tiles

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / G;
  const int n_qb = (S + W::ROWS - 1) / W::ROWS;
  const int q0 = (n_qb - 1 - static_cast<int>(blockIdx.z)) * W::ROWS;
  const int row0 = W::SPLIT == 1 ? wg * 64 : 0;
  const int half = W::SPLIT == 1 ? 0 : wg;
  const int qw0 = q0 + row0;
  const int n_all = (S + TR - 1) / TR;
  const int n_kt = causal ? min(n_all, (q0 + W::ROWS - 1) / TR + 1) : n_all;
  const int kt0 = window > 0 ? max(0, (q0 - window + 1) / TR) : 0;
  const float cap_in = cap > 0.f ? scale / cap : 0.f;

  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  load_tile<D, W::ROWS, NTH>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_tile<D, W::ROWS, NTH>(sG, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                             tid);
  const uint32_t st0 = (kt0 % STAGES) * W::TILE_BYTES;
  load_tile<D, TR, NTH>(sK + st0, kb, sk.s, kt0 * TR, S, tid);
  load_tile<D, TR, NTH>(sV + st0, vb, sv.s, kt0 * TR, S, tid);
  cp_async_commit();

  const int r0 = qw0 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int cq = (lane % 4) * 2;
  const int64_t lrow = (static_cast<int64_t>(b) * H + h) * S;
  const float l0 = r0 < S ? lse[lrow + r0] * LOG2E : 0.f;
  const float l1 = r1 < S ? lse[lrow + r1] * LOG2E : 0.f;
  const float d0 = r0 < S ? delta[lrow + r0] : 0.f;
  const float d1 = r1 < S ? delta[lrow + r1] : 0.f;
  float acc[W::DA / 2];
#pragma unroll
  for (int i = 0; i < W::DA / 2; ++i) acc[i] = 0.f;

  for (int kt = kt0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // tile kt is in shared memory
    if (kt + 1 < n_kt) {
      const uint32_t nst = ((kt + 1) % STAGES) * W::TILE_BYTES;
      load_tile<D, TR, NTH>(sK + nst, kb, sk.s, (kt + 1) * TR, S, tid);
      load_tile<D, TR, NTH>(sV + nst, vb, sv.s, (kt + 1) * TR, S, tid);
      cp_async_commit();
    }
    const int k0 = kt * TR;
    // a tile wholly above this warpgroup's diagonal or wholly under its
    // window, or a warpgroup wholly past S, has nothing to add
    if (qw0 >= S || (causal && k0 > qw0 + 63) ||
        (window > 0 && k0 + TR - 1 <= qw0 - window))
      continue;
    const uint32_t st = (kt % STAGES) * W::TILE_BYTES;
    float s[32], dp[32];
    mma_scores<D>(s, dp, sQ, sG, sK + st, sV + st, row0);  // S, dP = dO V^T

    // dS, 0 where the key is past S, past the query or under its window
    const bool edge = (causal && k0 + TR - 1 > qw0) || k0 + TR > S ||
                      (window > 0 && k0 <= qw0 + 63 - window);
    uint32_t da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float f;
        float p = prob<CAP>(s[j * 4 + e], -(e < 2 ? l0 : l1), scale_log2,
                            cap, cap_in, f);
        if (edge) {
          const int kj = k0 + j * 8 + cq + (e & 1);
          const int r = e < 2 ? r0 : r1;
          if (kj >= S || (causal && kj > r) ||
              (window > 0 && kj <= r - window))
            p = 0.f;
        }
        ds[e] = p * (dp[j * 4 + e] - (e < 2 ? d0 : d1));
        if constexpr (CAP) ds[e] *= f;
      }
      da[j * 2] = pack_bf16(ds[0], ds[1]);
      da[j * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS K, 16 keys a wgmma
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                             da[4 * kk + 3]};
      mma_rows<D>(acc, a, sK + st, kk, half * W::NR);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc);
  }

  store_acc<D>(dq + b * sdq.b + h * sdq.h, sdq.s, acc, scale, r0, r1,
               half * W::DA + cq, S);
}

}  // namespace tc

// ---- backward: f32 FMAs on the CUDA cores ---------------------------------

namespace bwd {

constexpr int NT = 256;            // 16 row groups x 16 column lanes

template <int D>
struct Tile {
  static constexpr int BT = D <= 128 ? 64 : 32;   // rows of a tile
  static constexpr int RS = BT / 16;              // tile rows (and score
                                                  // columns) per thread
  static constexpr int DC = D / 16;               // accumulator columns
  static constexpr int LD = D + 1;                // padded row of Q, dO, K, V
  static constexpr int LP = BT + 1;               // padded row of P, dS
  static constexpr int SMEM = (4 * BT * LD + 2 * BT * LP + 2 * BT) * 4;
};

// rows [row0, row0 + BT) of a (S, D) slab into a padded f32 tile; rows past
// S are zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* base,
                                          int64_t stride, int row0, int S,
                                          int tid) {
  using W = Tile<D>;
  for (int i = tid; i < W::BT * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * W::LD + d] = row0 + r < S ? base[(row0 + r) * stride + d] : 0.f;
  }
}

// exp(sc - lse) of a raw score s where the key is visible (ok), else 0:
// sc = s scale, or cap tanh(s scale / cap) with a cap (cap_in = scale /
// cap); f = dsc / d(s scale), dS's chain factor (1 - t^2; 1 without a cap)
__device__ __forceinline__ float prob(float s, float lse, bool ok, float scale,
                                      float cap, float cap_in, float& f) {
  float sc = s * scale;
  f = 1.f;
  if (cap > 0.f) {
    const float t = tanhf(s * cap_in);
    sc = cap * t;
    f = 1.f - t * t;
  }
  return ok ? expf(sc - lse) : 0.f;
}

// delta[row] = sum_d dO[row, d] O[row, d] in f32, one warp a (b, h, s) row,
// lanes summed by shuffles in a fixed order
__global__ void __launch_bounds__(NT)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ dO,
                float* __restrict__ delta, int64_t rows, int H, int S, int D,
                Strides so, Strides sdo) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (NT / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int s = static_cast<int>(row % S);
  const int64_t bh = row / S;
  const int h = static_cast<int>(bh % H);
  const int64_t b = bh / H;
  const float* op = o + b * so.b + h * so.h + s * so.s;
  const float* gp = dO + b * sdo.b + h * sdo.h + s * sdo.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(gp[d], op[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// dK and dV of one (batch, kv head, key tile)
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int S, int H,
               int G, int causal, int window, float cap, float scale,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
               Strides sdv) {
  using W = Tile<D>;
  constexpr int BT = W::BT, RS = W::RS, DC = W::DC, LD = W::LD, LP = W::LP;
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BT][LD]
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* Os = Qs + BT * LD;          // dO
  float* Ps = Os + BT * LD;          // P^T  [key][query], [BT][LP]
  float* Ds = Ps + BT * LP;          // dS^T
  float* Ls = Ds + BT * LP;          // lse of the tile's queries
  float* Dl = Ls + BT;               // delta of the tile's queries

  const int tid = threadIdx.x, rg = tid / 16, cl = tid % 16;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BT, n_t = (S + BT - 1) / BT;
  // query tiles past the window of the tile's last key see none of it
  const int qt1 = window > 0 ? min(n_t, (k0 + BT - 1 + window - 1) / BT + 1)
                             : n_t;
  const float cap_in = cap > 0.f ? scale / cap : 0.f;
  load_rows<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S, tid);
  load_rows<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S, tid);

  float dka[RS][DC], dva[RS][DC];
#pragma unroll
  for (int i = 0; i < RS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* lh = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* dh = delta + (static_cast<int64_t>(b) * H + h) * S;
    for (int qt = causal ? kt : 0; qt < qt1; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();               // the last tile's readers are done
      load_rows<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
      load_rows<D>(Os, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
      for (int i = tid; i < BT; i += NT) {
        Ls[i] = q0 + i < S ? lh[q0 + i] : 0.f;
        Dl[i] = q0 + i < S ? dh[q0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: keys rg RS + i, queries cl + 16 j
      float s[RS][RS], dp[RS][RS];
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[RS], vr[RS], qc[RS], oc[RS];
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          kr[i] = Ks[(rg * RS + i) * LD + d];
          vr[i] = Vs[(rg * RS + i) * LD + d];
          qc[i] = Qs[(cl + 16 * i) * LD + d];
          oc[i] = Os[(cl + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int j = 0; j < RS; ++j) {
            s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], oc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) {
          const int key = k0 + rg * RS + i, jq = cl + 16 * j, qi = q0 + jq;
          const bool ok = key < S && qi < S && (!causal || key <= qi) &&
                          (window == 0 || qi < key + window);
          float f;
          const float p = prob(s[i][j], Ls[jq], ok, scale, cap, cap_in, f);
          Ps[(rg * RS + i) * LP + jq] = p;
          Ds[(rg * RS + i) * LP + jq] = p * (dp[i][j] - Dl[jq]) * f;
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys rg RS + i, columns cl + 16 c
#pragma unroll 4
      for (int j = 0; j < BT; ++j) {
        float pr[RS], dr[RS], oc[DC], qc[DC];
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          pr[i] = Ps[(rg * RS + i) * LP + j];
          dr[i] = Ds[(rg * RS + i) * LP + j];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          oc[c] = Os[j * LD + cl + 16 * c];
          qc[c] = Qs[j * LD + cl + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[i][c] = fmaf(pr[i], oc[c], dva[i][c]);
            dka[i][c] = fmaf(dr[i], qc[c], dka[i][c]);
          }
      }
    }
  }

  float* dkb = dk + b * sdk.b + hk * sdk.h;
  float* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int key = k0 + rg * RS + i;
    if (key >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[key * sdk.s + cl + 16 * c] = dka[i][c] * scale;
      dvb[key * sdv.s + cl + 16 * c] = dva[i][c];
    }
  }
}

// dQ of one (batch, q head, query tile)
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int S, int H, int G, int causal,
             int window, float cap, float scale, Strides sq, Strides sk,
             Strides sv, Strides sdo, Strides sdq) {
  using W = Tile<D>;
  constexpr int BT = W::BT, RS = W::RS, DC = W::DC, LD = W::LD, LP = W::LP;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BT][LD]
  float* Os = Qs + BT * LD;          // dO
  float* Ks = Os + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ds = Vs + BT * LD;          // dS [query][key], [BT][LP]
  float* Ls = Ds + 2 * BT * LP;
  float* Dl = Ls + BT;

  const int tid = threadIdx.x, rg = tid / 16, cl = tid % 16;
  const int n_t = (S + BT - 1) / BT;
  const int qt = n_t - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int q0 = qt * BT;
  load_rows<D>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_rows<D>(Os, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
  const int64_t lrow = (static_cast<int64_t>(b) * H + h) * S;
  for (int i = tid; i < BT; i += NT) {
    Ls[i] = q0 + i < S ? lse[lrow + q0 + i] : 0.f;
    Dl[i] = q0 + i < S ? delta[lrow + q0 + i] : 0.f;
  }

  float dqa[RS][DC];
#pragma unroll
  for (int i = 0; i < RS; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;

  const int n_kt = causal ? qt + 1 : n_t;
  const int kt0 = window > 0 ? max(0, (q0 - window + 1) / BT) : 0;
  const float cap_in = cap > 0.f ? scale / cap : 0.f;
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_rows<D>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S, tid);
    load_rows<D>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries rg RS + i, keys cl + 16 j
    float s[RS][RS], dp[RS][RS];
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < RS; ++j) s[i][j] = dp[i][j] = 0.f;
    // two d steps of loads in flight: at four, ptxas held the kernel to 128
    // registers and spilled at D = 96 and 128
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qr[RS], orw[RS], kc[RS], vc[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        qr[i] = Qs[(rg * RS + i) * LD + d];
        orw[i] = Os[(rg * RS + i) * LD + d];
        kc[i] = Ks[(cl + 16 * i) * LD + d];
        vc[i] = Vs[(cl + 16 * i) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(orw[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const int iq = rg * RS + i, qi = q0 + iq, key = k0 + cl + 16 * j;
        const bool ok = key < S && qi < S && (!causal || key <= qi) &&
                        (window == 0 || qi < key + window);
        float f;
        const float p = prob(s[i][j], Ls[iq], ok, scale, cap, cap_in, f);
        Ds[iq * LP + cl + 16 * j] = p * (dp[i][j] - Dl[iq]) * f;
      }
    __syncthreads();

    // dQ += dS K: queries rg RS + i, columns cl + 16 c
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float dr[RS], kc[DC];
#pragma unroll
      for (int i = 0; i < RS; ++i) dr[i] = Ds[(rg * RS + i) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kc[c] = Ks[j * LD + cl + 16 * c];
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dqa[i][c] = fmaf(dr[i], kc[c], dqa[i][c]);
    }
  }

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < RS; ++i) {
    const int qi = q0 + rg * RS + i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[qi * sdq.s + cl + 16 * c] = dqa[i][c] * scale;
  }
}

}  // namespace bwd

// Dynamic shared memory above 48 KB must be asked for; once per device.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, uint64_t* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && (*done >> dev & 1)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) *done |= uint64_t{1} << dev;
  return 0;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int64_t B, int64_t H, int64_t S, int64_t G,
               int causal, int window, float cap, float scale,
               const Strides* st, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  static uint64_t done = 0;
  const int e = allow_smem(flash_kernel<float, D>, smem, &done);
  if (e) return e;
  const dim3 grid(static_cast<unsigned>((S + BQ - 1) / BQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_kernel<float, D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse,
      static_cast<int>(S), static_cast<int>(G), causal, window, cap, scale,
      st[0], st[1], st[2], st[3]);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MODE>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int64_t B, int64_t H, int64_t S, int64_t G,
                int causal, int window, float cap, float scale,
                const Strides* st, cudaStream_t stream) {
  constexpr size_t smem = tc::Tile<D>::SMEM;
  static uint64_t done = 0;
  const int e = allow_smem(tc::flash_tc_kernel<D, MODE>, smem, &done);
  if (e) return e;
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B),
                  static_cast<unsigned>((S + tc::BQ - 1) / tc::BQ));
  tc::flash_tc_kernel<D, MODE><<<grid, tc::NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, static_cast<int>(S), static_cast<int>(G), causal, window, cap,
      scale, scale * tc::LOG2E, st[0], st[1], st[2], st[3]);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernels' mode: 0 no window and no cap, 1 a window, 2 a
// cap (and any window)
inline int mode_of(int window, float cap) {
  return cap > 0.f ? 2 : window > 0 ? 1 : 0;
}

template <int D>
int launch_fwd(int dtype, const void* q, const void* k, const void* v,
               void* o, float* lse, int64_t B, int64_t H, int64_t S,
               int64_t G, int causal, int window, float cap, float scale,
               const Strides* st, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, B, H, S, G, causal, window, cap,
                         scale, st, stream);
  switch (mode_of(window, cap)) {
    case 0:
      return launch_bf16<D, 0>(q, k, v, o, lse, B, H, S, G, causal, window,
                               cap, scale, st, stream);
    case 1:
      return launch_bf16<D, 1>(q, k, v, o, lse, B, H, S, G, causal, window,
                               cap, scale, st, stream);
    default:
      return launch_bf16<D, 2>(q, k, v, o, lse, B, H, S, G, causal, window,
                               cap, scale, st, stream);
  }
}

// st: q, k, v, o, dO, dq, dk, dv
template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dO, float* delta, void* dq,
               void* dk, void* dv, int64_t B, int64_t H, int64_t S,
               int64_t G, int causal, int window, float cap, float scale,
               const Strides* st, cudaStream_t stream) {
  using W = bwd::Tile<D>;
  static uint64_t done_kv = 0, done_q = 0;
  int e = allow_smem(bwd::flash_bwd_dkdv<D>, W::SMEM, &done_kv);
  if (e) return e;
  e = allow_smem(bwd::flash_bwd_dq<D>, W::SMEM, &done_q);
  if (e) return e;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dO);
  const int64_t rows = B * H * S;
  bwd::flash_bwd_delta<<<static_cast<unsigned>((rows + 7) / 8), bwd::NT, 0,
                            stream>>>(
      static_cast<const float*>(o), gt, delta, rows, static_cast<int>(H),
      static_cast<int>(S), D, st[3], st[4]);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const unsigned n_t = static_cast<unsigned>((S + W::BT - 1) / W::BT);
  bwd::flash_bwd_dkdv<D><<<dim3(n_t, static_cast<unsigned>(H / G),
                                   static_cast<unsigned>(B)),
                              bwd::NT, W::SMEM, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(G), causal,
      window, cap, scale, st[0], st[1], st[2], st[4], st[6], st[7]);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  bwd::flash_bwd_dq<D><<<dim3(n_t, static_cast<unsigned>(H),
                                 static_cast<unsigned>(B)),
                            bwd::NT, W::SMEM, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(G), causal, window, cap, scale,
      st[0], st[1], st[2], st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the delta pre-pass, then dK/dV and dQ on the tensor cores
template <int D, int MODE>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const float* lse, const void* dO, float* delta, void* dq,
                  void* dk, void* dv, int64_t B, int64_t H, int64_t S,
                  int64_t G, int causal, int window, float cap, float scale,
                  const Strides* st, cudaStream_t stream) {
  using W = tc::Bwd<D>;
  using bf = __nv_bfloat16;
  static uint64_t done_kv = 0, done_q = 0;
  int e = allow_smem(tc::flash_bwd_dkdv_tc<D, MODE>, W::SMEM_KV, &done_kv);
  if (e) return e;
  e = allow_smem(tc::flash_bwd_dq_tc<D, MODE>, W::SMEM_Q, &done_q);
  if (e) return e;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* gt = static_cast<const bf*>(dO);
  const int64_t rows = B * H * S;
  constexpr int per_block = tc::NT / tc::delta_lanes<D>();   // rows
  tc::flash_bwd_delta_tc<D><<<static_cast<unsigned>(
                                  (rows + per_block - 1) / per_block),
                              tc::NT, 0, stream>>>(
      static_cast<const bf*>(o), gt, delta, rows, static_cast<int>(H),
      static_cast<int>(S), st[3], st[4]);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const unsigned n_b = static_cast<unsigned>((S + W::ROWS - 1) / W::ROWS);
  tc::flash_bwd_dkdv_tc<D, MODE><<<dim3(static_cast<unsigned>(H / G),
                                  static_cast<unsigned>(B), n_b),
                             W::THREADS, W::SMEM_KV, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(G), causal,
      window, cap, scale, scale * tc::LOG2E, st[0], st[1], st[2], st[4], st[6],
      st[7]);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  tc::flash_bwd_dq_tc<D, MODE><<<dim3(static_cast<unsigned>(H),
                                static_cast<unsigned>(B), n_b),
                           W::THREADS, W::SMEM_Q, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<bf*>(dq), static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(G), causal, window, cap, scale,
      scale * tc::LOG2E, st[0], st[1], st[2], st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

// The dtype picks the route: f32 the CUDA-core kernels, bf16 wgmma.
template <int D>
int launch_bwd_dt(int dtype, const void* q, const void* k, const void* v,
                  const void* o, const float* lse, const void* dO,
                  float* delta, void* dq, void* dk, void* dv, int64_t B,
                  int64_t H, int64_t S, int64_t G, int causal, int window,
                  float cap, float scale, const Strides* st,
                  cudaStream_t stream) {
  if (dtype == 0)
    return launch_bwd_f32<D>(q, k, v, o, lse, dO, delta, dq, dk, dv, B, H, S,
                             G, causal, window, cap, scale, st, stream);
  switch (mode_of(window, cap)) {
    case 0:
      return launch_bwd_tc<D, 0>(q, k, v, o, lse, dO, delta, dq, dk, dv, B,
                                 H, S, G, causal, window, cap, scale, st,
                                 stream);
    case 1:
      return launch_bwd_tc<D, 1>(q, k, v, o, lse, dO, delta, dq, dk, dv, B,
                                 H, S, G, causal, window, cap, scale, st,
                                 stream);
    default:
      return launch_bwd_tc<D, 2>(q, k, v, o, lse, dO, delta, dq, dk, dv, B,
                                 H, S, G, causal, window, cap, scale, st,
                                 stream);
  }
}

}  // namespace

// q (B,H,S,D), k and v (B,H/G,S,D), o (B,H,S,D), each addressed through
// strides[12] = {b, h, s} of q, k, v, o (element strides; D is contiguous);
// lse, if not null, receives the f32 log-sum-exp of the scaled (capped,
// masked) scores of every query row, contiguous (B,H,S). window > 0: the
// sliding window (key kj > qi - window); cap > 0: the logit softcap; 0 turns
// either off. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int64_t B, int64_t H, int64_t S,
                                      int64_t D, int64_t G, int causal,
                                      int window, float cap, float scale,
                                      const int64_t* strides,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  switch (D) {
    case 32:
      return launch_fwd<32>(dtype, q, k, v, o, lse, B, H, S, G, causal,
                            window, cap, scale, st, s);
    case 64:
      return launch_fwd<64>(dtype, q, k, v, o, lse, B, H, S, G, causal,
                            window, cap, scale, st, s);
    case 96:
      return launch_fwd<96>(dtype, q, k, v, o, lse, B, H, S, G, causal,
                            window, cap, scale, st, s);
    case 128:
      return launch_fwd<128>(dtype, q, k, v, o, lse, B, H, S, G, causal,
                             window, cap, scale, st, s);
    case 256:
      return launch_fwd<256>(dtype, q, k, v, o, lse, B, H, S, G, causal,
                             window, cap, scale, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of flash_attention_launch: dq (B,H,S,D), dk and dv
// (B,H/G,S,D) from q, k, v, the forward's o and lse, and dO (B,H,S,D);
// delta is a (B,H,S) f32 scratch. strides[24] = {b, h, s} of q, k, v, o,
// dO, dq, dk, dv; causal, window and cap as the forward took them. Three
// launches in stream order (delta, dK/dV, dQ); returns the first launch
// error (0 = all launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dO, float* delta, void* dq, void* dk,
    void* dv, int64_t B, int64_t H, int64_t S, int64_t D, int64_t G,
    int causal, int window, float cap, float scale, const int64_t* strides,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  switch (D) {
    case 32:
      return launch_bwd_dt<32>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv,
                               B, H, S, G, causal, window, cap, scale, st, s);
    case 64:
      return launch_bwd_dt<64>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv,
                               B, H, S, G, causal, window, cap, scale, st, s);
    case 96:
      return launch_bwd_dt<96>(dtype, q, k, v, o, lse, dO, delta, dq, dk, dv,
                               B, H, S, G, causal, window, cap, scale, st, s);
    case 128:
      return launch_bwd_dt<128>(dtype, q, k, v, o, lse, dO, delta, dq, dk,
                                dv, B, H, S, G, causal, window, cap, scale,
                                st, s);
    case 256:
      return launch_bwd_dt<256>(dtype, q, k, v, o, lse, dO, delta, dq, dk,
                                dv, B, H, S, G, causal, window, cap, scale,
                                st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
