// Per-row symmetric INT8 quantization: s = max(absmax(row), 1e-8) / 127,
// codes = clip(round_half_even(x / s), -127, 127); f32 in, int8 codes and
// f32 scales out.
//
// Replaces: the Pallas kernel src/repro/kernels/quantize.py, quantize_rows
//   (one VPU pass over a 256-row VMEM tile).
// What bounds it on the H100: bytes (4 B read + 1 B written per element, a
//   handful of operations each), so the floor is (5 M N + 4 M) / 3.35 TB/s.
// What the design does about it: one warp per row, eight rows per block, so
//   rows of any length N keep all lanes busy and the row's absmax is a
//   register reduction plus five shuffles -- no shared memory, no second
//   launch. The row is read a second time for the codes; that read is served
//   from L1/L2, not DRAM, at the row sizes this repository quantizes. The
//   arithmetic is the reference's bit for bit: a true IEEE division x / s
//   (nvcc's default -prec-div=true; no fast-math, no multiply by 1/s, no
//   __fdividef) and rintf, which rounds half to even as jnp.round and
//   torch.round do, so a .5 tie lands on the same code.
#include "common.cuh"

namespace {

constexpr int ROWS = 8;  // warps (rows) per block

__global__ void __launch_bounds__(32 * ROWS)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int64_t M, int64_t N) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.y;
  if (row >= M) return;  // whole warp: one row per warp
  const float* xr = x + row * N;
  float m = 0.f;
  for (int64_t j = threadIdx.x; j < N; j += 32) m = fmaxf(m, fabsf(xr[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float sc = fmaxf(m, 1e-8f) / 127.0f;
  int8_t* qr = q + row * N;
  for (int64_t j = threadIdx.x; j < N; j += 32) {
    const float v = fminf(fmaxf(rintf(xr[j] / sc), -127.f), 127.f);
    qr[j] = static_cast<int8_t>(v);
  }
  if (threadIdx.x == 0) s[row] = sc;
}

}  // namespace

// x: (M, N) f32, q: (M, N) int8, s: (M,) f32, all contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int quantize_rows_launch(const void* x, void* q, void* s,
                                    int64_t M, int64_t N, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + ROWS - 1) / ROWS));
  const dim3 block(32, ROWS);
  quantize_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), M, N);
  return static_cast<int>(cudaGetLastError());
}
