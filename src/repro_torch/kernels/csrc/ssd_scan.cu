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
