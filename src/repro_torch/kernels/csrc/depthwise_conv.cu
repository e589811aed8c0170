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
//   XLA writes the transpose, src/repro/models/xr.py:222); the input
//   gradient reuses dw3x3_kernel on g with the weights turned 180 degrees
//   (kernels/depthwise_conv.py).
// What bounds it on the H100: bytes. Nine multiply-adds per element of x
//   and g, each read once (2.25 FLOP/byte), so the floor is
//   (x + g + dw) / 3.35 TB/s: 0.3-2.8 us at DetNet's b8 maps, where the
//   fixed cost of a launch and the chain of dependent steps inside it set
//   the time, and 2-19 us at EDSNet's b4 maps, where HBM's rate does.
// What the design does about it (kernels/depthwise_conv.wgrad_plan picks
//   every size named here):
//   * One launch, no float atomics. A "tile" is th rows x tw columns of one
//     image, for one chunk of cg_blk groups of 4 channels (grid y). Block
//     bx of a chunk takes tiles bx, bx + gridDim.x, ... The blocks of a
//     chunk form clusters of cs. Each block sums its threads' partials and
//     pushes the sums, 4 to a 16-byte remote store, into the shared memory
//     of the rank that owns them (distributed shared memory); after one
//     cluster barrier each rank sums its share over the ranks in order, in
//     its own shared memory. Where one cluster covers
//     the chunk (small maps) the ranks write dw: no scratch, no ticket.
//     Where several do (large maps) each writes its share of the cluster's
//     row of `rows`, takes that share's integer ticket (an acq_rel
//     atomicAdd), and the block that takes the last one sums the share's
//     rows in index order into dw. The ticket picks who sums, never the
//     order, so every run gives the same bits.
//   * Staged strips. A block copies its tile's x, (th + 2) x (tw + 2)
//     pixels with the halo, and g, th x tw pixels, into shared memory by
//     cp.async (16 bytes = 4 channels when C % 4 == 0 and x, g are 16-byte
//     aligned, 4 bytes else). The copy itself zero-fills the halo outside
//     the map and the channels past C (SAME padding, no bounds checks in
//     the sums). All of a tile's copies are in flight at once, and the
//     next tile's are issued before this one is summed (two stages). A
//     thread owns 4 channels of one column and walks the tile's rows: the
//     three column taps read shared memory, not device memory three times.
//     (A TMA route, one thread a tile, measured no faster on the H100.)
//   * The card filled. The plan shortens strips until a small map gives
//     every SM a block, and caps a large map at one wave of two blocks an
//     SM (th = 8, tw = 16 and 32 channels take 77 KB for two stages), each
//     block an equal share of tiles.
//   * A fixed order, bounded: each thread's chain of FMAs (per_thread x th
//     roundings), the block's tw columns in order (tw - 1), the cluster's
//     ranks in order (cs - 1) and the rows in order (n_clusters - 1):
//     WgradPlan.depth, the tests' bound.
//   * The tickets never left dirty. The counters (one per chunk and rank)
//     live in a buffer that the wrapper keeps per device and stream and
//     zeroes once, when it makes it. The block that takes a counter's last
//     ticket sets it back to 0 before the launch ends, so the next launch
//     on the stream finds zeros; a launch on another stream has its own
//     buffer, so two streams never share a counter; a launch that is
//     refused never runs, and one that faults leaves the CUDA context
//     unusable (the error is sticky), so no later launch reads what either
//     left.
// ---------------------------------------------------------------------------
namespace {

constexpr int kWgradThreads = 128;     // a block, at most (MAX_THREADS)
constexpr int kSideBySide = 4;         // 4-sum groups a thread adds at once
constexpr int kMaxCgBlk = 8;           // channel groups a block (MAX_CG_BLK)
constexpr int kMaxCluster = 16;        // blocks a cluster (non-portable)
constexpr int kRowsInFlight = 16;      // rows a last block loads at once
constexpr int kWgradMaxSmem = 200 * 1024;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  // src-size 0 fills the 16 bytes with zeros (outside the map, past C)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This block's rank in its cluster, and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return static_cast<int>(n);
}
// v into the shared memory of cluster rank `rank`, at the offset of the
// local shared address p (16-byte aligned). Each remote store holds up its
// warp far longer than a local one, so the sums travel 4 to a store.
__device__ __forceinline__ void st_cluster4(const float* p, int rank,
                                            float4 v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n"
      : "=r"(remote)
      : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
// Every thread of every block of the cluster: writes before, reads after.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The ticket: +1, ordered after this block's writes (the barrier before
// it and the release are cumulative) and before its reads after it.
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

struct WgradArgs {
  const float* x;
  const float* g;
  float* dw;
  float* rows;        // (n_chunks, n_clusters, cg_blk * 36); n_clusters > 1
  unsigned* ticket;   // (n_chunks, cs), zero between launches; n_clusters > 1
  int H, W, C;
  int tw, cg_blk;     // tile columns; channel groups a block
  int n_strips, n_segs, n_tiles;   // per chunk: ceil(H/th), ceil(W/tw)
  int n_clusters;     // clusters a chunk
};

// A stage: x's (th + 2) x (tw + 2) pixels, then from a 128-byte boundary
// g's th x tw, each pixel cg_blk groups of 4 channels, pixel-major. (Stages
// off 128-byte lines measured slower at the large maps.)
__host__ __device__ __forceinline__ int g_offset(int th, int tw,
                                                 int cg_blk) {
  return ((th + 2) * (tw + 2) * cg_blk * 4 + 31) / 32 * 32;     // floats
}
__host__ __device__ __forceinline__ int stage_floats(int th, int tw,
                                                     int cg_blk) {
  return (g_offset(th, tw, cg_blk) + th * tw * cg_blk * 4 + 31) / 32 * 32;
}

// Channels c..c+3 of the pixel at element offset `off` into shared memory
// at dst (16 bytes); zeros where !in and past C.
template <bool VEC>
__device__ __forceinline__ void copy4(uint32_t dst, const float* p,
                                      int64_t off, bool in, int c, int C) {
  if (VEC) {
    const bool ok = in && c < C;
    cp_async16(dst, p + (ok ? off + c : 0), ok);
  } else {
    const float* q = in ? p + off + c : p;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = in && c + e < C;
      cp_async4(dst + 4 * e, ok ? q + e : p, ok);
    }
  }
}

// Tile t of the chunk into the stage at s. Thread (slot, cgi) copies its
// channel group of columns slot, slot + tw, ... of every row (no division
// per copy); copies outside the map or past C fill zeros (SAME padding).
template <bool VEC, int TH>
__device__ __forceinline__ void stage_tile(const WgradArgs& a, int t, int c,
                                           int slot, int cgi, float* s) {
  const int seg = t % a.n_segs;
  const int strip = (t / a.n_segs) % a.n_strips;
  const int b = t / a.n_segs / a.n_strips;
  const int h0 = strip * TH, w0 = seg * a.tw;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  const int xw = a.tw + 2, wg = w0 + slot;
  const uint32_t gbase = base + 4u * g_offset(TH, a.tw, a.cg_blk);
  const int64_t img = static_cast<int64_t>(b) * a.H * a.W * a.C;
  const bool in_g = wg < a.W;
  // the 4-byte copies (edge shapes only) in a rolled loop: unrolled, their
  // addresses spilled registers at TH = 4
#pragma unroll(VEC ? TH + 2 : 1)
  for (int r = 0; r < TH + 2; ++r) {
    const int hh = h0 - 1 + r;
    const bool row = hh >= 0 && hh < a.H;
    const int64_t off = img + static_cast<int64_t>(hh) * a.W * a.C;
    for (int j = slot; j < xw; j += a.tw) {      // twice, or 3x if tw = 1
      const int ww = w0 - 1 + j;
      copy4<VEC>(base + 16u * ((r * xw + j) * a.cg_blk + cgi), a.x,
                 off + static_cast<int64_t>(ww) * a.C,
                 row && ww >= 0 && ww < a.W, c, a.C);
    }
    if (r < TH) {
      const bool grow = h0 + r < a.H;
      copy4<VEC>(gbase + 16u * ((r * a.tw + slot) * a.cg_blk + cgi), a.g,
                 off + (a.W + static_cast<int64_t>(wg)) * a.C,
                 grow && in_g, c, a.C);
    }
  }
}

// One staged tile into the thread's 36 sums: column `slot` of the tile,
// channel group `cgi`. Input row i of the tile (image row h0 - 1 + i) meets
// gradient rows i - di (tap row di), in the order of the plain version's
// taps, each an FMA into acc[di * 3 + dj].
template <int TH>
__device__ __forceinline__ void sum_tile(const float* s, int tw, int cg_blk,
                                         int slot, int cgi,
                                         float (&acc)[9][4]) {
  const int xw = tw + 2;
  const float* sg = s + g_offset(TH, tw, cg_blk);
  float gq[3][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) gq[d][e] = 0.f;
#pragma unroll
  for (int i = 0; i < TH + 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      gq[2][e] = gq[1][e];
      gq[1][e] = gq[0][e];
    }
    if (i < TH) {
      const float4 v = *reinterpret_cast<const float4*>(
          sg + ((i * tw + slot) * cg_blk + cgi) * 4);
      gq[0][0] = v.x; gq[0][1] = v.y; gq[0][2] = v.z; gq[0][3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) gq[0][e] = 0.f;
    }
    float row[3][4];
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      const float4 v = *reinterpret_cast<const float4*>(
          s + ((i * xw + slot + dj) * cg_blk + cgi) * 4);
      row[dj][0] = v.x; row[dj][1] = v.y; row[dj][2] = v.z; row[dj][3] = v.w;
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

// Sums k..k+3 of a chunk (k % 4 == 0: channel group k / 36, tap
// (k % 36) / 4, its 4 channels) into dw, for the channels that exist.
__device__ __forceinline__ void store_dw4(const WgradArgs& a, int c0, int k,
                                          float4 v) {
  const int ch = c0 + k / 36 * 4, tap = k % 36 / 4;
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (ch + i < a.C) a.dw[static_cast<int64_t>(ch + i) * 9 + tap] = e[i];
}

// grid (n_clusters * cs, n_chunks), clusters (cs, 1, 1), cg_blk * tw threads
// (thread = column slot * cg_blk + channel group), dynamic shared memory
// wgrad_smem_bytes.
template <bool VEC, int TH>
__global__ void __launch_bounds__(kWgradThreads)
dw3x3_wgrad_kernel(const WgradArgs a) {
  extern __shared__ __align__(128) float4 wgrad_smem[];
  // the ranks' sums of this rank's share
  __shared__ __align__(16) float inbox[kMaxCgBlk * 36 + 4 * kMaxCluster];
  __shared__ int last;                   // this block sums its share's rows
  float* smem = reinterpret_cast<float*>(wgrad_smem);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cgi = tid % a.cg_blk, slot = tid / a.cg_blk;
  const int chunk = blockIdx.y;
  const int c0 = chunk * a.cg_blk * 4, c = c0 + cgi * 4;
  const int stage = stage_floats(TH, a.tw, a.cg_blk);

  float acc[9][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // two stages: tile t + gridDim.x lands while tile t is summed
  int t = blockIdx.x, st = 0;
  if (t < a.n_tiles) stage_tile<VEC, TH>(a, t, c, slot, cgi, smem);
  cp_async_commit();
  for (; t < a.n_tiles; t += gridDim.x) {
    const int next = t + gridDim.x;
    if (next < a.n_tiles)
      stage_tile<VEC, TH>(a, next, c, slot, cgi, smem + (st ^ 1) * stage);
    cp_async_commit();
    cp_async_wait<1>();                  // tile t's copies have landed
    __syncthreads();
    sum_tile<TH>(smem + st * stage, a.tw, a.cg_blk, slot, cgi, acc);
    __syncthreads();                     // before its stage is refilled
    st ^= 1;
  }
  cp_async_wait<0>();

  // the block's sum of each of its K values, 4 at a time: its tw column
  // slots in order (the stages are free now), pushed into the shared memory
  // of the rank that owns the value's share of the cluster's sum, at this
  // rank's slot. A share is a multiple of 4 values, so a push never
  // straddles two ranks.
  const int cs = cluster_size(), rank = cluster_rank();
  const int K = a.cg_blk * 36;
  const int share = ((K + cs - 1) / cs + 3) / 4 * 4;
  float* red = smem;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
    *reinterpret_cast<float4*>(red + tid * 36 + tap * 4) =
        make_float4(acc[tap][0], acc[tap][1], acc[tap][2], acc[tap][3]);
  __syncthreads();
  for (int k = 4 * tid; k < K; k += 4 * kSideBySide * nt) {
    float4 v[kSideBySide];               // independent chains, loads overlap
#pragma unroll
    for (int u = 0; u < kSideBySide; ++u)
      if (k + 4 * u * nt < K)
        v[u] = *reinterpret_cast<const float4*>(red + k + 4 * u * nt);
    for (int s = 1; s < a.tw; ++s)
#pragma unroll
      for (int u = 0; u < kSideBySide; ++u)
        if (k + 4 * u * nt < K)
          add4(v[u], *reinterpret_cast<const float4*>(red + s * K + k +
                                                      4 * u * nt));
#pragma unroll
    for (int u = 0; u < kSideBySide; ++u) {
      const int kk = k + 4 * u * nt, owner = kk / share;
      if (kk < K)
        st_cluster4(inbox + rank * share + kk - owner * share, owner, v[u]);
    }
  }
  cluster_barrier();                     // every rank's pushes have landed

  // the cluster's sum of this rank's share: the ranks in order, from its
  // own shared memory (no rank touches another's after the barrier)
  const int k0 = rank * share, k1 = min(K, k0 + share);
  float* rows = a.rows + static_cast<int64_t>(chunk) * a.n_clusters * K;
  for (int k = k0 + 4 * tid; k < k1; k += 4 * nt) {
    float4 p[kMaxCluster];               // every rank's entry, loads overlap
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs)
        p[r] = *reinterpret_cast<const float4*>(inbox + r * share + k - k0);
    float4 v = p[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < cs) add4(v, p[r]);
    if (a.n_clusters == 1)
      store_dw4(a, c0, k, v);
    else
      *reinterpret_cast<float4*>(
          rows + static_cast<int64_t>(blockIdx.x / cs) * K + k) = v;
  }
  if (a.n_clusters == 1) return;

  // several clusters: the last of the chunk's clusters to write this share
  // of its row, picked by the share's ticket, sums the share's rows in
  // order and sets the ticket back to 0 for the next launch
  __syncthreads();
  if (tid == 0) {
    unsigned* ticket = a.ticket + chunk * cs + rank;
    last = take_ticket(ticket) == static_cast<unsigned>(a.n_clusters - 1);
    if (last) *ticket = 0u;
  }
  __syncthreads();
  if (!last) return;
  for (int k = k0 + 4 * tid; k < k1; k += 4 * nt) {
    float4 v = __ldcg(reinterpret_cast<const float4*>(rows + k));
    for (int j = 1; j < a.n_clusters; j += kRowsInFlight) {
      float4 p[kRowsInFlight];           // a batch of rows' loads in flight
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (j + u < a.n_clusters)
          p[u] = __ldcg(reinterpret_cast<const float4*>(
              rows + static_cast<int64_t>(j + u) * K + k));
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u)
        if (j + u < a.n_clusters) add4(v, p[u]);
    }
    store_dw4(a, c0, k, v);
  }
}

size_t wgrad_smem_bytes(int th, int tw, int cg_blk, int stages) {
  const size_t stage = static_cast<size_t>(stage_floats(th, tw, cg_blk)) *
                       4 * stages;
  const size_t red = static_cast<size_t>(cg_blk) * tw * 36 * 4;
  return stage > red ? stage : red;
}

// Dynamic shared memory above 48 KB and clusters above 8 blocks must be
// asked for; once per device.
template <typename Kernel>
int allow_wgrad(Kernel kernel, uint64_t* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && (*done >> dev & 1)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kWgradMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) *done |= uint64_t{1} << dev;
  return 0;
}

// Launch, or with `max_clusters` only ask how many such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters).
template <bool VEC, int TH>
int launch_wgrad(const WgradArgs& a, int cs, int n_chunks, int stages,
                 cudaStream_t stream, int* max_clusters) {
  static uint64_t done = 0;
  const auto kernel = dw3x3_wgrad_kernel<VEC, TH>;
  const int e = allow_wgrad(kernel, &done);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.n_clusters * cs),
                     static_cast<unsigned>(n_chunks));
  cfg.blockDim = dim3(static_cast<unsigned>(a.cg_blk * a.tw));
  cfg.dynamicSmemBytes = wgrad_smem_bytes(TH, a.tw, a.cg_blk, stages);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last_err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last_err);
}

template <bool VEC>
int dispatch_wgrad(const WgradArgs& a, int th, int cs, int n_chunks,
                   int stages, cudaStream_t stream, int* max_clusters) {
  switch (th) {
    case 1:
      return launch_wgrad<VEC, 1>(a, cs, n_chunks, stages, stream,
                                  max_clusters);
    case 2:
      return launch_wgrad<VEC, 2>(a, cs, n_chunks, stages, stream,
                                  max_clusters);
    case 4:
      return launch_wgrad<VEC, 4>(a, cs, n_chunks, stages, stream,
                                  max_clusters);
    case 8:
      return launch_wgrad<VEC, 8>(a, cs, n_chunks, stages, stream,
                                  max_clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int wgrad(const void* x, const void* g, void* dw, void* rows, void* ticket,
          int64_t B, int64_t H, int64_t W, int64_t C, int th, int tw,
          int cg_blk, int n_chunks, int cs, int n_clusters, int stages,
          int vec, void* stream, int* max_clusters) {
  if (th <= 0 || tw <= 0 || cg_blk <= 0 || cg_blk > kMaxCgBlk ||
      cg_blk * tw > kWgradThreads || cs <= 0 || cs > kMaxCluster ||
      n_clusters <= 0 || stages < 1 || stages > 2 || n_chunks <= 0 ||
      n_chunks > 65535 || static_cast<int64_t>(n_chunks) * cg_blk * 4 < C ||
      static_cast<int64_t>(n_clusters) * cs > 65535 ||
      wgrad_smem_bytes(th, tw, cg_blk, stages) > kWgradMaxSmem ||
      (!max_clusters && n_clusters > 1 && (!rows || !ticket)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_strips = (H + th - 1) / th, n_segs = (W + tw - 1) / tw;
  const int64_t n_tiles = B * n_strips * n_segs;
  if (n_tiles + static_cast<int64_t>(n_clusters) * cs > INT32_MAX ||
      H > INT32_MAX || W > INT32_MAX || C > INT32_MAX / 9)
    return static_cast<int>(cudaErrorInvalidValue);
  WgradArgs a;
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.dw = static_cast<float*>(dw);
  a.rows = static_cast<float*>(rows);
  a.ticket = static_cast<unsigned*>(ticket);
  a.H = static_cast<int>(H);
  a.W = static_cast<int>(W);
  a.C = static_cast<int>(C);
  a.tw = tw;
  a.cg_blk = cg_blk;
  a.n_strips = static_cast<int>(n_strips);
  a.n_segs = static_cast<int>(n_segs);
  a.n_tiles = static_cast<int>(n_tiles);
  a.n_clusters = n_clusters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch_wgrad<true>(a, th, cs, n_chunks, stages, s,
                                    max_clusters)
             : dispatch_wgrad<false>(a, th, cs, n_chunks, stages, s,
                                     max_clusters);
}

// The floor of a launch: a kernel that does nothing (chip_smoke.py times it
// beside the weight gradient, whose small maps take a few microseconds).
__global__ void launch_floor_kernel() {}

}  // namespace

// x, g (B,H,W,C) contiguous f32; dw (C,1,3,3) contiguous f32, fully
// written. Tiles of th rows x tw columns, cg_blk channel groups a block
// (cg_blk * tw <= 128 threads), n_chunks chunks of channel groups (grid
// y), n_clusters clusters of cs blocks a chunk (grid x), stages 1 or 2
// (kernels/depthwise_conv.wgrad_plan). With n_clusters > 1, rows holds
// n_chunks * n_clusters * cg_blk * 36 floats of scratch and ticket
// n_chunks * cs unsigned counters, zero before the launch and after it;
// else both may be null. vec: C % 4 == 0 and x, g 16-byte aligned.
// Returns the launch's CUDA error (0 = launched).
extern "C" int depthwise_conv3x3_wgrad_launch(
    const void* x, const void* g, void* dw, void* rows, void* ticket,
    int64_t B, int64_t H, int64_t W, int64_t C, int th, int tw, int cg_blk,
    int n_chunks, int cs, int n_clusters, int stages, int vec, void* stream) {
  return wgrad(x, g, dw, rows, ticket, B, H, W, C, th, tw, cg_blk, n_chunks,
               cs, n_clusters, stages, vec, stream, nullptr);
}

// The most clusters of that launch the card holds at once, into *out
// (cudaOccupancyMaxActiveClusters); returns the CUDA error.
extern "C" int depthwise_conv3x3_wgrad_max_clusters(
    int64_t B, int64_t H, int64_t W, int64_t C, int th, int tw, int cg_blk,
    int n_chunks, int cs, int n_clusters, int stages, int vec, int* out) {
  return wgrad(nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, C, th,
               tw, cg_blk, n_chunks, cs, n_clusters, stages, vec, nullptr,
               out);
}

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
