// Causal / non-causal attention with an online softmax, grouped-query heads,
// fp32 scores, running max, denominator and accumulator; output in the
// input dtype (f32 or bf16).
//
// Replaces: the Pallas kernel src/repro/kernels/flash_attention.py,
//   flash_attention (grid (B*H, nq, nk), nk sequential, VMEM scratch
//   carrying m/l/acc across K blocks, causal blocks above the diagonal
//   skipped, mask value -1e30).
// What bounds it on the H100: operations. A causal (B,H,S,D) attention does
//   ~2*B*H*S^2*D multiply-adds against 4*B*H*S*D elements moved, i.e. ~S/2
//   FLOP per byte (1024 at S=2048), far above the ridge of either the fp32
//   CUDA cores or the bf16 tensor cores.
// What the design does about it: it keeps every intermediate on chip. One
//   block of 128 threads owns a 64-row query tile of one (batch, q head); it
//   walks the 64-key tiles up to the diagonal (tiles above it are never
//   loaded), staging K and V in shared memory as fp32. Each thread owns 4
//   query rows x 8 key columns of the score tile and 4 rows x D/8 columns of
//   the accumulator, so the score and P.V products are register-tiled FMAs on
//   the CUDA cores; rows are reduced with warp shuffles across the 8 threads
//   that share them. The scores never reach device memory, so the bytes are
//   q, k, v read once per query tile and o written once. This first version
//   uses fp32 FMAs, not the tensor cores: the ops bound above is against
//   the tensor cores' bf16 rate, and wgmma tiles are the next step.
// Shapes: any S (ragged tiles are masked: padded keys score -1e30, padded
//   query rows are not stored), D in {32, 64}, H a multiple of the kv
//   heads K (query head h reads kv head h / (H/K)). Tensors are read and
//   written through their (batch, head, seq) strides with the last dim
//   contiguous, so the model's seq-major (B,S,H,D) projections need no
//   transposed copy.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;     // query rows per block
constexpr int BK = 64;     // keys per tile
constexpr int NT = 128;    // threads: 16 row groups x 8 column lanes
constexpr int RG = 4;      // query rows per thread
constexpr int CG = 8;      // key columns per thread (strided by 8)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Element strides of a (B, heads, S, D) tensor; the D stride is 1.
struct Strides {
  int64_t b, h, s;
};

template <int D>
constexpr int smem_floats() {
  return 3 * BQ * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int G,
             int causal, float scale, Strides sq, Strides sk, Strides sv,
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
  for (int kt = 0; kt < n_kt; ++kt) {
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
#pragma unroll 8
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
        if (kj >= S || (causal && kj > qi)) x = NEG_INF;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const float p = expf(s[i][j] - m_new);
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t H, int64_t S, int64_t G, int causal, float scale,
           const int64_t* st, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const dim3 grid(static_cast<unsigned>((S + BQ - 1) / BQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(S),
      static_cast<int>(G), causal, scale, sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int64_t D, const void* q, const void* k, const void* v, void* o,
             int64_t B, int64_t H, int64_t S, int64_t G, int causal,
             float scale, const int64_t* st, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, S, G, causal, scale, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, S, G, causal, scale, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,H,S,D), k and v (B,H/G,S,D), o (B,H,S,D), each addressed through
// strides[12] = {b, h, s} of q, k, v, o (element strides; D is contiguous).
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t B,
                                      int64_t H, int64_t S, int64_t D,
                                      int64_t G, int causal, float scale,
                                      const int64_t* strides, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, H, S, G, causal, scale, strides,
                           s);
  return launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, S, G, causal, scale,
                                 strides, s);
}
