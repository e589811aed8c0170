// Mamba-2 SSD inter-chunk state scan: s_0 = 0, s_{c+1} = s_c * decay_c +
// states_c, emitting s_c (the state before chunk c); fp32 decay and carry,
// output in the states' dtype (f32 or bf16).
//
// Replaces: the Pallas kernel src/repro/kernels/ssd_scan.py, ssd_chunk_scan
//   (grid (B*H, NC) with NC sequential, the (P, N) state held in VMEM
//   scratch across grid steps, after a transpose of the states to
//   (B*H, NC, P, N)).
// What bounds it on the H100: bytes. One multiply and one add per element
//   against one element read and one written, so the floor is
//   (states + decay + output) / 3.35 TB/s.
// What the design does about it: each element is read once and written once
//   and the state never leaves a register. One thread owns one (b, h, p, n)
//   state element and walks the NC chunks in order; threads of a block are
//   consecutive (p, n) of one (b, h), so with the model's (B,NC,H,P,N)
//   layout every warp load and store is one contiguous 128-byte (f32)
//   transaction. The states are read through their strides (no transposed
//   copy); the output is contiguous (B,NC,H,P,N). The chunk loop is
//   unrolled so the loads of several chunks are in flight at once; they do
//   not depend on the carry.
// Arithmetic: s * decay and + states are rounded separately (__fmul_rn,
//   __fadd_rn, no FMA contraction), as two PyTorch ops round them, so the
//   kernel is bit-equal to its plain version.
//
// The backward (no TPU counterpart: the reference model differentiates its
// segsum einsum with XLA) is the reverse scan, f32 carry:
//   lam_{NC-1} = g_{NC-1}, lam_c = g_c + lam_{c+1} decay_c,
//   dstates_c = lam_{c+1} (dstates_{NC-1} = 0),
//   ddecay_c = sum_{p,n} lam_{c+1} s_c (ddecay_{NC-1} = 0),
// g the output gradient and s the forward's output (saved, so nothing is
// recomputed). ssd_scan_bwd_kernel runs it one thread per (b, h, p, n) as the
// forward does, bit-equal in dstates to its plain version; ddecay is summed
// with no atomics, in a fixed order: each block sums its 256 elements' terms
// per chunk (warp shuffles, then the 8 warps in order) into a row of
// partials, and ssd_scan_bwd_reduce sums a (b, c, h)'s blocks in order.
// What bounds it: bytes, g and s read once and dstates written once.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;

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

// Element strides of states (b, c, h, p, n) and decay (b, c, h).
struct Strides {
  int64_t sb, sc, sh, sp, sn, db, dc, dh;
};

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ states, const float* __restrict__ decay,
                T* __restrict__ out, int NC, int H, int P, int N,
                Strides st) {
  const int pn = blockIdx.x * NT + threadIdx.x;
  if (pn >= P * N) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int p = pn / N, n = pn % N;
  const T* sp = states + b * st.sb + h * st.sh + p * st.sp + n * st.sn;
  const float* dp = decay + b * st.db + h * st.dh;
  const int64_t out_c = static_cast<int64_t>(H) * P * N;  // chunk stride
  T* op = out + (static_cast<int64_t>(b) * NC * H + h) * P * N + pn;
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < NC; ++c) {
    op[c * out_c] = from_f32<T>(s);
    s = __fadd_rn(__fmul_rn(s, dp[c * st.dc]),
                  to_f32(sp[c * st.sc]));
  }
}

template <typename T>
int launch(const void* states, const void* decay, void* out, int64_t B,
           int64_t NC, int64_t H, int64_t P, int64_t N, const int64_t* s,
           cudaStream_t stream) {
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  const dim3 grid(static_cast<unsigned>((P * N + NT - 1) / NT),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  ssd_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(states), static_cast<const float*>(decay),
      static_cast<T*>(out), static_cast<int>(NC), static_cast<int>(H),
      static_cast<int>(P), static_cast<int>(N), st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_kernel(const T* __restrict__ g, const T* __restrict__ out,
                    const float* __restrict__ decay, T* __restrict__ dstates,
                    float* __restrict__ partial, int NC, int H, int P, int N,
                    Strides gs, Strides ds) {
  __shared__ float red[NT / 32];
  const int pn = blockIdx.x * NT + threadIdx.x;
  const bool on = pn < P * N;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = on ? pn / N : 0, n = on ? pn % N : 0;
  const T* gp = g + b * gs.sb + h * gs.sh + p * gs.sp + n * gs.sn;
  const float* dp = decay + b * ds.db + h * ds.dh;
  const int64_t chunk = static_cast<int64_t>(H) * P * N;  // contiguous
  const int64_t base = (static_cast<int64_t>(b) * NC * H + h) * P * N + pn;
  const int nblk = gridDim.x;
  float lam = 0.f;                   // lam_{c+1}
  for (int c = NC - 1; c >= 0; --c) {
    float term = 0.f;
    if (on) {
      dstates[base + c * chunk] = from_f32<T>(lam);
      term = __fmul_rn(lam, to_f32(out[base + c * chunk]));
      lam = __fadd_rn(to_f32(gp[c * gs.sc]), __fmul_rn(lam, dp[c * ds.dc]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      term = __fadd_rn(term, __shfl_xor_sync(0xffffffffu, term, off));
    if (lane == 0) red[warp] = term;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < NT / 32; ++w) sum = __fadd_rn(sum, red[w]);
      partial[((static_cast<int64_t>(b) * NC + c) * H + h) * nblk +
              blockIdx.x] = sum;
    }
    __syncthreads();
  }
}

// ddecay[b, c, h] = the sum of the (b, c, h) row of partials, in order
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_reduce(const float* __restrict__ partial,
                    float* __restrict__ ddecay, int64_t rows, int nblk) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (r >= rows) return;
  float sum = 0.f;
  for (int i = 0; i < nblk; ++i) sum = __fadd_rn(sum, partial[r * nblk + i]);
  ddecay[r] = sum;
}

template <typename T>
int launch_bwd(const void* g, const void* out, const void* decay,
               void* dstates, float* ddecay, float* partial, int64_t B,
               int64_t NC, int64_t H, int64_t P, int64_t N, const int64_t* s,
               cudaStream_t stream) {
  const Strides gs{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
  const int nblk = static_cast<int>((P * N + NT - 1) / NT);
  const dim3 grid(static_cast<unsigned>(nblk), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  ssd_scan_bwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(out),
      static_cast<const float*>(decay), static_cast<T*>(dstates), partial,
      static_cast<int>(NC), static_cast<int>(H), static_cast<int>(P),
      static_cast<int>(N), gs, gs);
  const int e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const int64_t rows = B * NC * H;
  ssd_scan_bwd_reduce<<<static_cast<unsigned>((rows + NT - 1) / NT), NT, 0,
                        stream>>>(partial, ddecay, rows, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// states (B,NC,H,P,N) and float32 decay (B,NC,H) through strides[8] =
// {b, c, h, p, n} of states and {b, c, h} of decay (elements); out
// contiguous (B,NC,H,P,N). dtype: 0 = float32, 1 = bfloat16 (the states and
// out). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_chunk_scan_launch(const void* states, const void* decay,
                                     void* out, int64_t B, int64_t NC,
                                     int64_t H, int64_t P, int64_t N,
                                     const int64_t* strides, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(states, decay, out, B, NC, H, P, N, strides, s);
  return launch<__nv_bfloat16>(states, decay, out, B, NC, H, P, N, strides,
                               s);
}

// The backward of ssd_chunk_scan_launch: g (B,NC,H,P,N), the output
// gradient, through strides[8] = {b, c, h, p, n} of g and {b, c, h} of the
// float32 decay; out the forward's contiguous output; dstates contiguous
// (B,NC,H,P,N) in g's dtype, ddecay contiguous (B,NC,H) f32; partial a
// (B,NC,H,ceil(P N / 256)) f32 scratch. Two launches (the reverse scan, the
// ordered sum of ddecay); returns the first launch error (0 = launched).
extern "C" int ssd_chunk_scan_bwd_launch(const void* g, const void* out,
                                         const void* decay, void* dstates,
                                         float* ddecay, float* partial,
                                         int64_t B, int64_t NC, int64_t H,
                                         int64_t P, int64_t N,
                                         const int64_t* strides, int dtype,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, out, decay, dstates, ddecay, partial, B, NC,
                             H, P, N, strides, s);
  return launch_bwd<__nv_bfloat16>(g, out, decay, dstates, ddecay, partial, B,
                                   NC, H, P, N, strides, s);
}
