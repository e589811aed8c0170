// INT8 GEMM with int32 accumulation and a per-row x per-column dequant
// epilogue: out[m, n] = (float(sum_k a[m, k] * b[k, n]) * a_scale[m]) *
// b_scale[n], for any M, N, K (ragged edges masked).
//
// Replaces: the Pallas kernel src/repro/kernels/int8_matmul.py, int8_matmul
//   (an MXU GEMM over 128^3 tiles carrying an int32 VMEM accumulator across a
//   sequential K grid axis, dequant on the last K step).
// What bounds it on the H100: operations at large M, N, K (1,979 int8 TOP/s
//   dense on the tensor cores); at the shapes this repository runs (the
//   128^3 calibration corner, 1x1 projections with N <= 320) bytes and
//   launch latency.
// What the design does about it: this first version is simple and exact. A
//   block owns a 64 x 64 output tile and walks K in 32-deep steps: it stages
//   the A tile and the transposed B tile in shared memory (zero-filled past
//   the edges), and each of 256 threads keeps a 4 x 4 int32 accumulator in
//   registers fed by __dp4a (four s8 x s8 products + an int32 add per
//   instruction, exact). The K loop inside the block replaces the TPU's
//   sequential K grid axis. The epilogue runs once per output from registers,
//   so no int32 partial sum reaches device memory. Tensor-core mma/wgmma is
//   later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int KPAD = BK + 4;  // row stride in bytes: 9 words, odd -> no bank conflicts
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               const float* __restrict__ sa, const float* __restrict__ sb,
               float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM][KPAD];   // As[m][k]
  __shared__ __align__(16) int8_t Bs[BN][KPAD];   // Bs[n][k] (B transposed)
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int idx = t + i * THREADS;
      const int m = idx / BK, k = idx % BK;        // consecutive k per row
      const int gm = m0 + m, gk = k0 + k;
      As[m][k] = (gm < M && gk < K)
                     ? a[static_cast<int64_t>(gm) * K + gk] : int8_t(0);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int idx = t + i * THREADS;
      const int k = idx / BN, n = idx % BN;        // consecutive n per row
      const int gk = k0 + k, gn = n0 + n;
      Bs[n][k] = (gk < K && gn < N)
                     ? b[static_cast<int64_t>(gk) * N + gn] : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK; kw += 4) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const int*>(&As[ty + 16 * i][kw]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const int*>(&Bs[tx + 16 * j][kw]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    const float am = sa[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N)
        out[static_cast<int64_t>(gm) * N + gn] =
            (static_cast<float>(acc[i][j]) * am) * sb[gn];
    }
  }
}

}  // namespace

// a: (M, K) int8, b: (K, N) int8, a_scale: (M,) f32, b_scale: (N,) f32,
// out: (M, N) f32, all contiguous. Returns cudaGetLastError() after launch.
extern "C" int int8_matmul_launch(const void* a, const void* b,
                                  const void* a_scale, const void* b_scale,
                                  void* out, int64_t M, int64_t N, int64_t K,
                                  void* stream) {
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + BM - 1) / BM));
  int8_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
      static_cast<float*>(out), static_cast<int>(M), static_cast<int>(N),
      static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}
