// Per-row symmetric INT8 quantization: s = max(absmax(row), 1e-8) / 127,
// codes = clip(round_half_even(x / s), -127, 127); f32 in, int8 codes and
// f32 scales out.
//
// Replaces: the Pallas kernel src/repro/kernels/quantize.py, quantize_rows
//   (one VPU pass over a 256-row VMEM tile: absmax and codes without a
//   second HBM read).
// What bounds it on the H100: bytes at every shape (4 B read + 1 B written
//   per element, a handful of operations each): the floor is
//   (5 M N + 4 M) / 3.35 TB/s, 12.5 us at (4096, 2048) and 3.1 us at
//   EDSNet's (122880, 16); the 256 x 512 calibration corner is launch-bound.
// What the design does about it: each row is read from device memory once.
//   quantize_rows_kernel holds the row in registers between the absmax and
//   the codes: a group of G lanes (kernels/quantize.plan: ceil(N/4) rounded
//   up to a power of two for N <= 128, so one warp holds 32/G rows of the
//   XR layers' narrow N = 16..96; a whole warp with VPL 16-byte vectors per
//   lane up to N = 2048) loads the row with 16-byte loads, reduces the
//   absmax with __shfl_xor_sync inside the group, and stores 4 codes per
//   lane at once. Rows whose N is not a multiple of 4, or whose base is not
//   16-byte aligned, take element loads and byte stores in the same kernel.
//   Longer rows (quantize_rows_kernel_long) take a block each: the absmax is
//   reduced through shared memory and the codes pass reads the row again,
//   from L2. The arithmetic is the reference's bit for bit: a true IEEE
//   division x / s (nvcc's default -prec-div=true; no fast-math, no
//   multiply by 1/s) and rintf, which rounds half to even as jnp.round and
//   torch.round do, so a .5 tie lands on the same code.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float scale_of(float absmax) {
  return fmaxf(absmax, 1e-8f) / 127.0f;
}

__device__ __forceinline__ int8_t code(float v, float sc) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / sc), -127.f), 127.f));
}

// Groups of G lanes (a power of two) per row, VPL float4 slots per lane:
// lane l of a group holds elements 4 (i G + l) .. + 3, i < VPL.
template <int VPL>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int64_t M, int N, int G,
                     int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane & (G - 1);
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * (THREADS / 32) + warp) * (32 / G) +
      lane / G;
  const bool live = row < M;
  const float* xr = x + (live ? row : 0) * N;
  float v[VPL][4];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = 4 * (i * G + gl);
    if (vec) {
      const float4 t = live && j < N
                           ? __ldcs(reinterpret_cast<const float4*>(xr + j))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][0] = t.x;
      v[i][1] = t.y;
      v[i][2] = t.z;
      v[i][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[i][e] = live && j + e < N ? __ldcs(xr + j + e) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(v[i][e]));
  }
  for (int o = G >> 1; o > 0; o >>= 1)     // within the group of G lanes
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!live) return;
  const float sc = scale_of(m);
  int8_t* qr = q + row * N;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = 4 * (i * G + gl);
    if (j >= N) continue;
    if (vec) {
      __stcs(reinterpret_cast<char4*>(qr + j),
             make_char4(code(v[i][0], sc), code(v[i][1], sc),
                        code(v[i][2], sc), code(v[i][3], sc)));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < N) qr[j + e] = code(v[i][e], sc);
    }
  }
  if (gl == 0) s[row] = sc;
}

// One block per row, for rows too long for the registers: absmax through
// shared memory, then a second read of the row (from L2) for the codes.
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel_long(const float* __restrict__ x,
                          int8_t* __restrict__ q, float* __restrict__ s,
                          int N, int vec) {
  __shared__ float part[THREADS / 32];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * N;
  int8_t* qr = q + row * N;
  const int t = threadIdx.x;
  float m = 0.f;
  if (vec) {
    for (int j = t; j < N / 4; j += THREADS) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr) + j);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int j = t; j < N; j += THREADS) m = fmaxf(m, fabsf(__ldg(xr + j)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((t & 31) == 0) part[t >> 5] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, part[w]);
  const float sc = scale_of(m);
  if (vec) {
    for (int j = t; j < N / 4; j += THREADS) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr) + j);
      reinterpret_cast<char4*>(qr)[j] = make_char4(
          code(v.x, sc), code(v.y, sc), code(v.z, sc), code(v.w, sc));
    }
  } else {
    for (int j = t; j < N; j += THREADS) qr[j] = code(__ldg(xr + j), sc);
  }
  if (t == 0) s[row] = sc;
}

}  // namespace

// x: (M, N) f32, q: (M, N) int8, s: (M,) f32, all contiguous; the lane
// plan from kernels/quantize.plan: G lanes per row and VPL 16-byte slots
// per lane, or VPL = 0 for a block per row; vec = 1 for 16-byte loads and
// 4-byte code stores (N % 4 == 0 and x 16-byte aligned). Returns
// cudaGetLastError() after the launch.
extern "C" int quantize_rows_launch(const void* x, void* q, void* s,
                                    int64_t M, int64_t N, int G, int VPL,
                                    int vec, int64_t blocks, void* stream) {
  const auto xf = static_cast<const float*>(x);
  const auto qc = static_cast<int8_t*>(q);
  const auto sf = static_cast<float*>(s);
  const auto st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(N);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (VPL) {
    case 0:
      quantize_rows_kernel_long<<<grid, THREADS, 0, st>>>(xf, qc, sf, n, vec);
      break;
    case 1:
      quantize_rows_kernel<1><<<grid, THREADS, 0, st>>>(xf, qc, sf, M, n, G,
                                                        vec);
      break;
    case 2:
      quantize_rows_kernel<2><<<grid, THREADS, 0, st>>>(xf, qc, sf, M, n, G,
                                                        vec);
      break;
    case 4:
      quantize_rows_kernel<4><<<grid, THREADS, 0, st>>>(xf, qc, sf, M, n, G,
                                                        vec);
      break;
    case 8:
      quantize_rows_kernel<8><<<grid, THREADS, 0, st>>>(xf, qc, sf, M, n, G,
                                                        vec);
      break;
    case 16:
      quantize_rows_kernel<16><<<grid, THREADS, 0, st>>>(xf, qc, sf, M, n, G,
                                                         vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
