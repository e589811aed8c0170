// NHWC stride-1 SAME 3x3 depthwise convolution, fp32 accumulation, output in
// the input's dtype (f32 or bf16).
//
// Replaces: the Pallas kernel src/repro/kernels/depthwise_conv.py,
//   depthwise_conv3x3_padded (a VPU kernel over a pre-padded input passed as
//   three row-shifted views, tiled th rows x 128 lanes of channels).
// What bounds it on the H100: bytes. 9 multiply-adds per output element
//   against one element read and one written (2.25 FLOP/byte in f32, 4.5 in
//   bf16), far below the card's ~20 FLOP/byte fp32 ridge, so the floor is
//   (input + output + weights) / 3.35 TB/s.
// What the design does about it: every input element is read from device
//   memory about once. A block owns TH rows x TW columns x 32 channels of the
//   output; it stages the (TH+2) x (TW+2) x 32 halo tile in shared memory
//   (SAME padding by bounds checks: out-of-image taps load 0, no padded
//   copy), so the 9 taps of its outputs re-read shared memory, not DRAM.
//   Threads map to channels (threadIdx.x), so a warp loads 32 neighbouring
//   channels of one pixel: one 128-byte (f32) or 64-byte (bf16) coalesced
//   transaction, on any C (a ragged last channel tile is masked) and any H,
//   W (ragged spatial tiles are masked) -- no tiling contract.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int TC = 32;  // channels per block: one warp across channels
constexpr int TH = 8;   // output rows per block: one warp per row
constexpr int TW = 16;  // output columns per block, walked by each thread

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
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// x, y: (B, H, W, C) contiguous; w: (C, 3, 3) contiguous (the model's
// (C, 1, 3, 3) depthwise weight as it is stored, so no transposed copy).
template <typename T>
__global__ void __launch_bounds__(TC * TH)
dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ y, int H, int W, int C, int tiles_w) {
  __shared__ float tile[TH + 2][TW + 2][TC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * TC + tx;
  const int h0 = (blockIdx.y / tiles_w) * TH;
  const int w0 = (blockIdx.y % tiles_w) * TW;
  const bool c_ok = c < C;
  const int64_t img = static_cast<int64_t>(blockIdx.z) * H * W * C;

  for (int p = ty; p < (TH + 2) * (TW + 2); p += TH) {
    const int r = p / (TW + 2), s = p % (TW + 2);
    const int hh = h0 + r - 1, ww = w0 + s - 1;
    float v = 0.f;
    if (c_ok && hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = to_f32(x[img + (static_cast<int64_t>(hh) * W + ww) * C + c]);
    tile[r][s][tx] = v;
  }
  float wr[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wr[k] = c_ok ? to_f32(w[c * 9 + k]) : 0.f;
  __syncthreads();

  const int h = h0 + ty;
  if (!c_ok || h >= H) return;
  T* yrow = y + img + static_cast<int64_t>(h) * W * C + c;
  for (int j = 0; j < TW && w0 + j < W; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj)
        acc = fmaf(tile[ty + di][j + dj][tx], wr[di * 3 + dj], acc);
    yrow[static_cast<int64_t>(w0 + j) * C] = from_f32<T>(acc);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int depthwise_conv3x3_launch(const void* x, const void* w, void* y,
                                        int64_t B, int64_t H, int64_t W,
                                        int64_t C, int dtype, void* stream) {
  const int tiles_w = static_cast<int>((W + TW - 1) / TW);
  const int tiles_h = static_cast<int>((H + TH - 1) / TH);
  const dim3 grid(static_cast<unsigned>((C + TC - 1) / TC),
                  static_cast<unsigned>(tiles_h * tiles_w),
                  static_cast<unsigned>(B));
  const dim3 block(TC, TH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dw3x3_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), static_cast<int>(H), static_cast<int>(W),
        static_cast<int>(C), tiles_w);
  } else {
    dw3x3_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), static_cast<int>(H),
        static_cast<int>(W), static_cast<int>(C), tiles_w);
  }
  return static_cast<int>(cudaGetLastError());
}
