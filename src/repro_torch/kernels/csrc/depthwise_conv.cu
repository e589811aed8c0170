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
// What the design does about it: no shared memory and few instructions per
//   byte. Each thread owns 4 neighbouring channels (one 16-byte load in f32,
//   8-byte in bf16) of one output column and walks TH output rows down it:
//   each input row (columns w-1..w+1) is loaded once and fed to the up to 3
//   outputs that use it, so each new output row costs 3 loads, not 9, and
//   the 36 weights of its 4 channels stay in registers. Neighbouring
//   threads take neighbouring channel groups, then neighbouring columns, so
//   a warp's loads are contiguous in NHWC memory; the column neighbours'
//   shared inputs come from L1. SAME padding by bounds checks (out-of-image
//   taps load 0, no padded copy).
// Tiles per layer (the wrapper picks them from (H, W, C), see
//   kernels/depthwise_conv.py): a block holds `cg_blk` channel groups x
//   `upb` output columns, where a "column" (unit) is one (image, row strip,
//   column) of the whole batch, so small maps (4x4, 8x8) fill whole blocks
//   with many images' columns instead of idling in a fixed spatial tile.
//   Channel groups past C (C not a multiple of 4 is masked element by
//   element, no separate kernel), columns past the batch and rows past H
//   are the only idle threads.
// The weight gradient of the same convolution (no TPU counterpart: the
// reference lets XLA transpose lax.conv) is the second half of this file,
// after depthwise_conv3x3_launch.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

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

// 4 channels of one pixel in one load: float4 (f32) or 4 x bf16 (uint2)
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ __forceinline__ static void unpack(const type& u, float (&v)[4]) {
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  __device__ __forceinline__ static type pack(const float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ __forceinline__ static void unpack(const type& u, float (&v)[4]) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  }
  __device__ __forceinline__ static type pack(const float (&v)[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};

// Channels c..c+3 of the pixel at element offset `off` (0 outside the
// image, and past C when C is not a multiple of 4).
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ x, int64_t off,
                                      int c, int C, bool in, float (&v)[4]) {
  if (VEC) {
    if (in) {
      Vec4<T>::unpack(*reinterpret_cast<const typename Vec4<T>::type*>(
                          x + off + c), v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = in && c + e < C ? to_f32(x[off + c + e]) : 0.f;
  }
}

// Input row hh, columns col-1..col+1, channels c..c+3, into row[s][e].
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ x, int64_t img,
                                         int hh, int col, int H, int W,
                                         int C, int c, float (&row)[3][4]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int ww = col - 1 + s;
    const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
    load4<T, VEC>(x, img + (static_cast<int64_t>(hh) * W + ww) * C, c, C, in,
                  row[s]);
  }
}

// x, y: (B, H, W, C) contiguous; w: (C, 3, 3) contiguous (the model's
// (C, 1, 3, 3) depthwise weight as it is stored, so no transposed copy).
// VEC: C % 4 == 0 (vector loads and stores); TH: output rows per thread.
template <typename T, bool VEC, int TH>
// At most 128 threads (the plan's MAX_THREADS) and 128 registers a thread,
// so 4 blocks fit an SM: a cap of 80 or 64 registers spills, and larger
// blocks fit fewer times (both measured slower on the H100).
__global__ void __launch_bounds__(128, 4)
dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ y, int H, int W, int C, int cg_blk, int upb,
             int n_strips, int n_units) {
  const int tid = threadIdx.x;
  const int c = (blockIdx.y * cg_blk + tid % cg_blk) * 4;
  const int unit = blockIdx.x * upb + tid / cg_blk;
  if (c >= C || unit >= n_units) return;
  const int col = unit % W;
  const int strip = (unit / W) % n_strips;
  const int b = unit / W / n_strips;
  const int h0 = strip * TH;

  // the 4 channels' 36 weights are contiguous: 9 vector loads when VEC
  float wr[9][4];
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      float v[4];
      Vec4<T>::unpack(*reinterpret_cast<const typename Vec4<T>::type*>(
                          w + c * 9 + 4 * i), v);
#pragma unroll
      for (int j = 0; j < 4; ++j) wr[(4 * i + j) % 9][(4 * i + j) / 9] = v[j];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        wr[t][e] = c + e < C ? to_f32(w[(c + e) * 9 + t]) : 0.f;
  }

  const int64_t img = static_cast<int64_t>(b) * H * W * C;
  // Input row h0 - 1 + i feeds outputs h0 + i - di (tap row di = 0, 1, 2),
  // so each output's 9 taps arrive in the plain version's order (di, then
  // dj) and only ~3 accumulators are live at once: the rows stream through
  // registers, each loaded once per thread.
  float acc[TH][4];
#pragma unroll
  for (int j = 0; j < TH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < TH + 2; ++i) {
    float row[3][4];
    load_row<T, VEC>(x, img, h0 - 1 + i, col, H, W, C, c, row);
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int j = i - di;
      if (j < 0 || j >= TH) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          acc[j][e] = fmaf(row[dj][e], wr[di * 3 + dj][e], acc[j][e]);
    }
    const int j = i - 2;                  // output h0 + j is complete
    if (j < 0 || h0 + j >= H) continue;
    const int64_t out =
        img + (static_cast<int64_t>(h0 + j) * W + col) * C + c;
    if (VEC) {
      *reinterpret_cast<typename Vec4<T>::type*>(y + out) =
          Vec4<T>::pack(acc[j]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < C) y[out + e] = from_f32<T>(acc[j][e]);
    }
  }
}

template <typename T, bool VEC>
int launch(const void* x, const void* w, void* y, int H, int W, int C,
           int th, int cg_blk, int upb, int n_chunks, int n_strips,
           int n_units, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n_units + upb - 1) / upb),
                  static_cast<unsigned>(n_chunks));
  const unsigned threads = static_cast<unsigned>(cg_blk * upb);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  switch (th) {
    case 1:
      dw3x3_kernel<T, VEC, 1><<<grid, threads, 0, stream>>>(
          xt, wt, yt, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    case 2:
      dw3x3_kernel<T, VEC, 2><<<grid, threads, 0, stream>>>(
          xt, wt, yt, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    case 4:
      dw3x3_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(
          xt, wt, yt, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    case 8:
      dw3x3_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(
          xt, wt, yt, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y (B,H,W,C) contiguous, w (C,1,3,3) contiguous. The tile (th rows per
// thread, cg_blk channel groups x upb columns per block, n_chunks blocks
// across the channel groups) comes from the wrapper's plan;
// n_units = B * n_strips * W with n_strips = ceil(H / th). vec: C % 4 == 0
// and x, w, y 16-byte (f32) / 8-byte (bf16) aligned. dtype: 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int depthwise_conv3x3_launch(const void* x, const void* w, void* y,
                                        int64_t B, int64_t H, int64_t W,
                                        int64_t C, int th, int cg_blk,
                                        int upb, int n_chunks, int vec,
                                        int dtype, void* stream) {
  const int64_t n_strips = (H + th - 1) / th;
  const int64_t n_units = B * n_strips * W;
  if (th <= 0 || cg_blk <= 0 || upb <= 0 || n_units > INT32_MAX ||
      H * W * C > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), ww = static_cast<int>(W),
            c = static_cast<int>(C), ns = static_cast<int>(n_strips),
            nu = static_cast<int>(n_units);
  if (dtype == 0)
    return vec ? launch<float, true>(x, w, y, h, ww, c, th, cg_blk, upb,
                                     n_chunks, ns, nu, s)
               : launch<float, false>(x, w, y, h, ww, c, th, cg_blk, upb,
                                      n_chunks, ns, nu, s);
  return vec ? launch<__nv_bfloat16, true>(x, w, y, h, ww, c, th, cg_blk, upb,
                                           n_chunks, ns, nu, s)
             : launch<__nv_bfloat16, false>(x, w, y, h, ww, c, th, cg_blk,
                                            upb, n_chunks, ns, nu, s);
}

// ---------------------------------------------------------------------------
// Weight gradient: dw[c, di, dj] = sum_{b,h,w} x[b, h+di-1, w+dj-1, c]
//                                              * g[b, h, w, c]   (f32)
//
// Replaces: nothing on the TPU (the reference differentiates lax.conv and
//   XLA writes the transpose); the input gradient reuses dw3x3_kernel on g
//   with the weights turned 180 degrees (kernels/depthwise_conv.py).
// What bounds it on the H100: bytes. Nine multiply-adds per element of x
//   and g, read once each (2.25 FLOP/byte), so the floor is
//   (x + g + dw) / 3.35 TB/s.
// What the design does about it: the forward's thread layout, read the other
//   way round. A thread owns 4 neighbouring channels of one column of a row
//   strip ("unit"), streams the strip's TH + 2 input rows (columns w-1..w+1)
//   and TH gradient rows through registers, and keeps the 4 x 9 sums in
//   f32 registers. It walks units u, u + stride, ... (a fixed assignment),
//   so the grid stays at about one wave whatever the map's size and the
//   per-block partials stay few. The block sums its threads' partials in
//   a fixed order in shared memory and writes one row of partials;
//   dw3x3_wgrad_reduce sums the rows, again in a fixed order. No float
//   atomics: two runs give the same bits.
// ---------------------------------------------------------------------------
namespace {

constexpr int kRedY = 16;        // rows of partials summed side by side

template <bool VEC>
__device__ __forceinline__ void load4f(const float* __restrict__ p,
                                       int64_t off, int c, int C, bool in,
                                       float (&v)[4]) {
  if (VEC) {
    if (in && c < C) {
      const float4 u = *reinterpret_cast<const float4*>(p + off + c);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = in && c + e < C ? p[off + c + e] : 0.f;
  }
}

// x, g: (B, H, W, C) contiguous f32. partial: (gridDim.x, Cp, 9) with
// Cp = gridDim.y * cg_blk * 4; block (bx, chunk) writes row bx, channels
// [chunk * cg_blk * 4, (chunk + 1) * cg_blk * 4).
template <bool VEC, int TH>
__global__ void __launch_bounds__(128, 4)
dw3x3_wgrad_partial(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ partial, int H, int W, int C,
                    int cg_blk, int upb, int n_strips, int n_units) {
  __shared__ float red[128][37];           // 36 sums a thread, padded
  const int tid = threadIdx.x;
  const int cgi = tid % cg_blk;
  const int slot = tid / cg_blk;
  const int c = (blockIdx.y * cg_blk + cgi) * 4;
  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const int stride = gridDim.x * upb;
  for (int unit = blockIdx.x * upb + slot; unit < n_units; unit += stride) {
    const int col = unit % W;
    const int strip = (unit / W) % n_strips;
    const int b = unit / W / n_strips;
    const int h0 = strip * TH;
    const int64_t img = static_cast<int64_t>(b) * H * W * C;
    // gq[d]: gradient row i - d of the strip (0 past the strip or the map)
    float gq[3][4];
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) gq[d][e] = 0.f;
    // input row h0 - 1 + i meets gradient rows i - di (tap row di). Two
    // rows an iteration: unrolled whole, the compiler hoists every row's
    // loads and needs more than the 128 registers 4 blocks an SM allow
#pragma unroll 2
    for (int i = 0; i < TH + 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gq[2][e] = gq[1][e];
        gq[1][e] = gq[0][e];
      }
      if (i < TH) {
        const bool in = h0 + i < H;
        load4f<VEC>(g, img + (static_cast<int64_t>(h0 + i) * W + col) * C,
                    c, C, in, gq[0]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) gq[0][e] = 0.f;
      }
      float row[3][4];
      const int hh = h0 - 1 + i;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int ww = col - 1 + s;
        const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
        load4f<VEC>(x, img + (static_cast<int64_t>(hh) * W + ww) * C, c, C,
                    in, row[s]);
      }
#pragma unroll
      for (int di = 0; di < 3; ++di) {
        if (i - di < 0 || i - di >= TH) continue;
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[di * 3 + dj][e] =
                fmaf(row[dj][e], gq[di][e], acc[di * 3 + dj][e]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[tid][t * 4 + e] = acc[t][e];
  __syncthreads();
  // one thread per (channel group, tap, channel): the block's slots in order
  const int64_t row_len = static_cast<int64_t>(gridDim.y) * cg_blk * 36;
  for (int k = tid; k < cg_blk * 36; k += blockDim.x) {
    const int gi = k / 36, te = k % 36;
    float s = 0.f;
    for (int u = 0; u < upb; ++u) s += red[u * cg_blk + gi][te];
    const int t = te / 4, e = te % 4;
    const int64_t ch =
        (static_cast<int64_t>(blockIdx.y) * cg_blk + gi) * 4 + e;
    partial[blockIdx.x * row_len + ch * 9 + t] = s;
  }
}

// dw[col] = sum over the rows r of partial[r, col], col < C * 9: thread
// (tx, ty) sums rows ty, ty + kRedY, ... in order, then ty = 0 sums the
// kRedY results in order.
__global__ void __launch_bounds__(32 * kRedY)
dw3x3_wgrad_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                   int rows, int64_t row_len, int n_out) {
  __shared__ float part[kRedY][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < n_out)
    for (int r = threadIdx.y; r < rows; r += kRedY)
      s += partial[r * row_len + col];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < n_out) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < kRedY; ++y) t += part[y][threadIdx.x];
    dw[col] = t;
  }
}

template <bool VEC>
int launch_wgrad(const float* x, const float* g, float* partial, float* dw,
                 int H, int W, int C, int th, int cg_blk, int upb,
                 int n_chunks, int nbx, int n_strips, int n_units,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nbx), static_cast<unsigned>(n_chunks));
  const unsigned threads = static_cast<unsigned>(cg_blk * upb);
  switch (th) {
    case 1:
      dw3x3_wgrad_partial<VEC, 1><<<grid, threads, 0, stream>>>(
          x, g, partial, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    case 2:
      dw3x3_wgrad_partial<VEC, 2><<<grid, threads, 0, stream>>>(
          x, g, partial, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    case 4:
      dw3x3_wgrad_partial<VEC, 4><<<grid, threads, 0, stream>>>(
          x, g, partial, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    case 8:
      dw3x3_wgrad_partial<VEC, 8><<<grid, threads, 0, stream>>>(
          x, g, partial, H, W, C, cg_blk, upb, n_strips, n_units);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_out = C * 9;
  const int64_t row_len = static_cast<int64_t>(n_chunks) * cg_blk * 36;
  dw3x3_wgrad_reduce<<<(n_out + 31) / 32, dim3(32, kRedY), 0, stream>>>(
      partial, dw, nbx, row_len, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g (B,H,W,C) contiguous f32; partial: nbx * n_chunks * cg_blk * 36
// floats of scratch; dw (C,1,3,3) contiguous f32, fully written. th rows a
// unit, cg_blk channel groups x upb units a block (at most 128 threads),
// n_chunks blocks across the channel groups and nbx blocks across the units
// (kernels/depthwise_conv.wgrad_plan). vec: C % 4 == 0 and x, g 16-byte
// aligned. Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int depthwise_conv3x3_wgrad_launch(
    const void* x, const void* g, void* partial, void* dw, int64_t B,
    int64_t H, int64_t W, int64_t C, int th, int cg_blk, int upb,
    int n_chunks, int nbx, int vec, void* stream) {
  const int64_t n_strips = (H + th - 1) / th;
  const int64_t n_units = B * n_strips * W;
  if (th <= 0 || cg_blk <= 0 || upb <= 0 || cg_blk * upb > 128 ||
      nbx <= 0 || n_chunks <= 0 ||
      n_units + static_cast<int64_t>(nbx) * upb > INT32_MAX ||
      H * W * C > INT32_MAX || C * 9 > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  const int h = static_cast<int>(H), ww = static_cast<int>(W),
            c = static_cast<int>(C), ns = static_cast<int>(n_strips),
            nu = static_cast<int>(n_units);
  return vec ? launch_wgrad<true>(xf, gf, pf, dwf, h, ww, c, th, cg_blk, upb,
                                  n_chunks, nbx, ns, nu, s)
             : launch_wgrad<false>(xf, gf, pf, dwf, h, ww, c, th, cg_blk,
                                   upb, n_chunks, nbx, ns, nu, s);
}
