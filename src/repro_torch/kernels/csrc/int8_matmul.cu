// INT8 GEMM with int32 accumulation and a per-row x per-column dequant
// epilogue: out[m, n] = (float(sum_k a[m, k] * b[k, n]) * a_scale[m]) *
// b_scale[n], for any M, N, K (ragged edges zero-filled), on the int8
// tensor cores.
//
// Replaces: the Pallas kernel src/repro/kernels/int8_matmul.py, int8_matmul
//   (an MXU GEMM over 128^3 tiles carrying an int32 VMEM accumulator across a
//   sequential K grid axis, dequant on the last K step), and this file's
//   first version, __dp4a on the CUDA cores (about an eighth of the card's
//   int8 rate).
// What bounds it on the H100, by shape group:
//   * the 128^3 calibration corner: launch latency (its bytes take 30 ns);
//   * the XR 1x1 expand/project GEMMs (K, N <= 960): bytes, and mostly the
//     f32 output (4 M N bytes against M K + K N read);
//   * LM-size products such as (4096, 2048, 8192): operations, at the int8
//     tensor cores' 1,979 TOP/s. The kernel reaches about a quarter of
//     that rate and cuBLASLt's int8 GEMM about a third; the operand tiles'
//     trips from L2 into shared memory are the suspect (PERF.md).
// What the design does about it: the products run on the tensor cores as
//   wgmma.mma_async m64nNk32 .s32.s8.s8 with both operands in shared memory
//   (exact: s8 x s8 products summed in s32, no .satfinite). A block of one
//   or two warpgroups owns BM = 64 or 128 output rows (64 per warpgroup) and
//   BN columns; kernels/int8_matmul.plan picks BN per shape (N itself,
//   rounded up to an instantiated wgmma width, for N <= 256, so a block owns
//   whole output rows and its output is one contiguous span), BM and the
//   depth of the ring. M runs on the grid's x dimension. K runs in 128-byte
//   k-tiles (four k32 steps) through a ring of up to four slots, fetched
//   two tiles ahead by cp.async of 16, 8 or 4 bytes (the widest the row
//   stride and base allow; byte copies otherwise):
//   - A (M, K) row-major is K-major as wgmma wants it and lands in its
//     slot in the layout the descriptor names;
//   - B (K, N) row-major is N-major, and 8-bit wgmma operands must be
//     K-major (ldmatrix.trans moves 16-bit elements only), so B lands raw
//     (N-major, 16-byte chunks swizzled by k / 4) and is transposed in
//     shared memory one tile ahead, while the tensor cores run the current
//     tile: each thread reads 4 k-rows of 16 (or 8) n-bytes, transposes each
//     4 x 4 byte block with four byte permutes (prmt) and stores 4-byte
//     k-quads into one of two K-major tiles. Consecutive lanes take
//     consecutive k-quads, so reads and stores hit distinct banks.
//   The K-major tiles carry the 128-byte swizzle that the descriptors name
//   (16-byte chunk c of row r at r * 128 + ((c ^ (r % 8)) * 16)). Bytes of A
//   past K are never written: B is zero there. The epilogue dequantizes from
//   the accumulator fragment, (float(acc) * a_scale[m]) * b_scale[n] with
//   __fmul_rn (no contraction, the reference's order, bit-equal to it),
//   stages the f32 tile in shared memory over the ring and writes it with
//   coalesced 16-byte streaming stores; no int32 partial sum reaches device
//   memory.
#include "common.cuh"

namespace {

constexpr int BK = 128;          // k bytes per k-tile: four wgmma k32 steps
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may use

// The instantiated BN (wgmma N) and their accumulator fragments: for
// m64nNk32 .s32 each thread of the warpgroup holds N / 2 int32, element
// 4 j + e at row warp * 16 + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4)
// + e % 2. One body serves every width: the accumulator's operands are
// %0 .. %(N/2 - 1) (ACC<N/2>, its constraints D<N/2>), then the two
// descriptors and the scale-d flag at the indices DA, DB, SD.
template <int BN>
struct Wgmma;

#define ACC4 "%0, %1, %2, %3"
#define ACC8 ACC4 ", %4, %5, %6, %7"
#define ACC12 ACC8 ", %8, %9, %10, %11"
#define ACC16 ACC12 ", %12, %13, %14, %15"
#define ACC24 ACC16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define ACC32 ACC24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define ACC48                                                        \
  ACC32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
        "%44, %45, %46, %47"
#define ACC64                                                        \
  ACC48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
        "%60, %61, %62, %63"
#define ACC72 ACC64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define ACC80 ACC72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define ACC96                                                        \
  ACC80 ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
        "%92, %93, %94, %95"
#define ACC128                                                          \
  ACC96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, " \
        "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "    \
        "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"

#define D4(i) "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])
#define D8(i) D4(i), D4((i) + 4)
#define D16(i) D8(i), D8((i) + 8)
#define D32(i) D16(i), D16((i) + 16)
#define D64(i) D32(i), D32((i) + 32)

#define WGMMA(N, DA, DB, SD, REGS, ...)                                    \
  template <>                                                              \
  struct Wgmma<N> {                                                        \
    __device__ __forceinline__ static void mma(int (&d)[N / 2], uint64_t da, \
                                               uint64_t db) {              \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #SD ", 0;\n"                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" REGS    \
          "}, %" #DA ", %" #DB ", p;\n}\n"                                 \
          : __VA_ARGS__                                                    \
          : "l"(da), "l"(db), "r"(1));                                     \
    }                                                                      \
  };

WGMMA(8, 4, 5, 6, ACC4, D4(0))
WGMMA(16, 8, 9, 10, ACC8, D8(0))
WGMMA(24, 12, 13, 14, ACC12, D8(0), D4(8))
WGMMA(32, 16, 17, 18, ACC16, D16(0))
WGMMA(48, 24, 25, 26, ACC24, D16(0), D8(16))
WGMMA(64, 32, 33, 34, ACC32, D32(0))
WGMMA(96, 48, 49, 50, ACC48, D32(0), D16(32))
WGMMA(128, 64, 65, 66, ACC64, D64(0))
WGMMA(144, 72, 73, 74, ACC72, D64(0), D8(64))
WGMMA(160, 80, 81, 82, ACC80, D64(0), D16(64))
WGMMA(192, 96, 97, 98, ACC96, D64(0), D32(64))
WGMMA(256, 128, 129, 130, ACC128, D64(0), D64(64))


// Byte offset of 16-byte chunk c of row r in a K-major tile of 128-byte
// rows under the 128-byte swizzle (the pattern repeats every 8 rows).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address, leading byte offset 16 (unused in this mode),
// stride byte offset 1024 (8 rows), swizzle mode 1.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | uint64_t{1} << 62;
}

// N bytes global -> shared; src-size 0 writes N zero bytes instead
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(ok ? N : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n committed groups are pending (n > 2 waits for 2)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}
// generic-proxy writes (cp.async, st.shared) -> async-proxy reads (wgmma)
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
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Rows r0..r3 of a 4 x 4 byte block (byte e of r_i: k = i, n = e) ->
// c[e], the 4 k-bytes of column n = e, k = 0 in the low byte.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

struct Params {
  const int8_t* a;
  const int8_t* b;
  const float* sa;
  const float* sb;
  float* out;
  int64_t M;
  int N, K;
  int stages;   // ring depth: as many slots as K has k-tiles, up to 4, and
                // at least 3 where K has more
  int a_vec;    // bytes per A copy: 16, 8, 4 or 1
  int b_vec;    // bytes per B copy: 16, 8, 4 or 1
  int out_vec;  // floats per output store: 4 or 1
};

// Compile-time geometry of a BN-wide tile (kernels/int8_matmul.plan keeps
// the same numbers).
template <int BN>
struct Tile {
  // transpose unit: 4 k-rows x UN n-bytes
  static constexpr int UN = BN % 16 == 0 ? 16 : 8;
  static constexpr int UNITS = (BK / 4) * (BN / UN);
  // B as it arrives (N-major): BK rows of RP bytes, RP a multiple of 128 so
  // the chunk swizzle stays inside a row
  static constexpr int RP = (BN + 127) / 128 * 128;
  static constexpr int RAW = BK * RP;
  static constexpr int KMAJOR = BN * BK;   // B transposed, as wgmma reads it
  // f32 epilogue tile row stride, 8 (mod 32) floats: the fragment's float2
  // stores (8 rows x 4 lanes) hit distinct banks
  static constexpr int LD = BN + (40 - BN % 32) % 32;
};

// Byte offset of n-byte n of row k in the raw (N-major) B tile: 16-byte
// chunks XOR-swizzled by k / 4, so the transposer's 32 lanes (consecutive
// k-quads, one n-chunk) read distinct banks.
template <int BN>
__device__ __forceinline__ uint32_t raw_off(int k, int n) {
  return k * Tile<BN>::RP + ((((n >> 4) ^ (k >> 2)) & 7) << 4) +
         (((n >> 4) & ~7) << 4) + (n & 15);
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ uint2 ld_shared_v2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// A rows [m0, m0 + BM) x k-bytes [k0, k0 + BK) -> the slot's swizzled
// K-major A tile, VEC bytes a copy, zero past M. Bytes past K are not
// written: B is zero there, and int8 products of anything with zero are
// zero. gdst is the slot as a generic pointer, for the byte copies.
template <int VEC>
__device__ __forceinline__ void a_copy(uint32_t dst, uint8_t* gdst,
                                       const Params& p, int64_t m0, int BM,
                                       int k0, int tid, int nt) {
  auto copy = [&](int r, int c) {
    const int64_t gm = m0 + r;
    const bool ok = gm < p.M;
    const int8_t* src = p.a + (ok ? gm * p.K + k0 + c : 0);
    const uint32_t off = swz(r, c >> 4) + (c & 15);
    if constexpr (VEC == 1)
      gdst[off] = ok ? static_cast<uint8_t>(*src) : uint8_t{0};
    else
      cp_async<VEC>(dst + off, src, ok);
  };
  constexpr int PER_ROW = BK / VEC;
  if (p.K - k0 >= BK) {              // a whole k-tile: constant divisions
    for (int i = tid; i < BM * PER_ROW; i += nt)
      copy(i / PER_ROW, (i % PER_ROW) * VEC);
  } else {                           // the last k-tile: up to K only
    const int per_row = (p.K - k0 + VEC - 1) / VEC;
    for (int i = tid; i < BM * per_row; i += nt) {
      const int r = i / per_row;
      copy(r, (i - r * per_row) * VEC);
    }
  }
}

// B rows [k0, k0 + BK) x n-bytes [n0, n0 + BN) -> the slot's raw tile as
// they lie in memory (N-major), VEC bytes a copy, zero past K and N.
template <int BN, int VEC>
__device__ __forceinline__ void b_copy(uint32_t dst, uint8_t* gdst,
                                       const Params& p, int n0, int k0,
                                       int tid, int nt) {
  constexpr int PER_ROW = BN / VEC;
  for (int i = tid; i < BK * PER_ROW; i += nt) {
    const int k = i / PER_ROW, n = (i % PER_ROW) * VEC;
    const int gk = k0 + k, gn = n0 + n;
    const bool ok = gk < p.K && gn < p.N;
    const int8_t* src = p.b + (ok ? static_cast<int64_t>(gk) * p.N + gn : 0);
    const uint32_t off = raw_off<BN>(k, n);
    if constexpr (VEC == 1)
      gdst[off] = ok ? static_cast<uint8_t>(*src) : uint8_t{0};
    else
      cp_async<VEC>(dst + off, src, ok);
  }
}

// Stage k-tile t (k-bytes t * BK ..) into ring slot `slot`: A, then raw B.
template <int BN>
__device__ __forceinline__ void fetch(uint32_t slot, uint8_t* gslot,
                                      uint32_t a_bytes, const Params& p,
                                      int64_t m0, int BM, int n0, int t,
                                      int tid, int nt) {
  const int k0 = t * BK;
  switch (p.a_vec) {
    case 16: a_copy<16>(slot, gslot, p, m0, BM, k0, tid, nt); break;
    case 8: a_copy<8>(slot, gslot, p, m0, BM, k0, tid, nt); break;
    case 4: a_copy<4>(slot, gslot, p, m0, BM, k0, tid, nt); break;
    default: a_copy<1>(slot, gslot, p, m0, BM, k0, tid, nt);
  }
  const uint32_t b = slot + a_bytes;
  uint8_t* gb = gslot + a_bytes;
  if constexpr (BN % 16 == 0) {
    if (p.b_vec == 16) {
      b_copy<BN, 16>(b, gb, p, n0, k0, tid, nt);
      return;
    }
  }
  switch (p.b_vec) {
    case 16:
    case 8: b_copy<BN, 8>(b, gb, p, n0, k0, tid, nt); break;
    case 4: b_copy<BN, 4>(b, gb, p, n0, k0, tid, nt); break;
    default: b_copy<BN, 1>(b, gb, p, n0, k0, tid, nt);
  }
}

// Raw (N-major) B tile -> K-major B tile: unit u takes k-quad kq = u % 32
// (rows 4 kq .. + 3) of n-bytes (u / 32) UN .. + UN - 1, transposes each
// 4 x 4 byte block in registers (prmt) and stores every n-row's 4 k-bytes
// as one word at swz(n, kq / 4) + 4 (kq % 4). Consecutive lanes take
// consecutive k-quads: distinct banks on both sides.
template <int BN>
__device__ __forceinline__ void b_transpose(uint32_t raw, uint32_t kmaj,
                                            int tid, int nt) {
  using T = Tile<BN>;
  constexpr int NKQ = BK / 4;
  for (int u = tid; u < T::UNITS; u += nt) {
    const int kq = u % NKQ, nb = (u / NKQ) * T::UN;
    uint32_t w[4][T::UN / 4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t src = raw + raw_off<BN>(4 * kq + r, nb);
      if constexpr (T::UN == 16) {
        const uint4 v = ld_shared_v4(src);
        w[r][0] = v.x;
        w[r][1] = v.y;
        w[r][2] = v.z;
        w[r][3] = v.w;
      } else {
        const uint2 v = ld_shared_v2(src);
        w[r][0] = v.x;
        w[r][1] = v.y;
      }
    }
#pragma unroll
    for (int g = 0; g < T::UN / 4; ++g) {
      uint32_t c[4];
      transpose4(w[0][g], w[1][g], w[2][g], w[3][g], c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st_shared(kmaj + swz(nb + 4 * g + e, kq >> 2) + (kq & 3) * 4, c[e]);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(256)
int8_mm_kernel(const Params p) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzle's alignment
  uint8_t* gbase = smem_raw + (base - raw);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int BM = nt / 2;                          // 64 rows per warpgroup
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int nkt = (p.K + BK - 1) / BK;
  const int S = p.stages;
  // tiles fetched up front: all of them if the ring holds K, else S - 1
  const int P = S == nkt ? S : S - 1;
  const uint32_t a_bytes = BM * BK, slot_bytes = a_bytes + T::RAW;
  const uint32_t kmaj0 = base + S * slot_bytes;   // two K-major B tiles

  // The ring: slot t % S holds k-tile t's A (K-major, swizzled, as wgmma
  // reads it) and raw B. In iteration kt tile kt + P is fetched into the
  // slot tile kt - 1 used, the wgmmas of tile kt are issued, and while the
  // tensor cores run them tile kt + 1's B is transposed into the other
  // K-major tile.
  for (int t = 0; t < P; ++t) {
    fetch<BN>(base + t * slot_bytes, gbase + t * slot_bytes, a_bytes, p, m0,
              BM, n0, t, tid, nt);
    cp_async_commit();
  }
  cp_async_wait(P - 1);
  __syncthreads();
  b_transpose<BN>(base + a_bytes, kmaj0, tid, nt);

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    // this thread's copies of tiles kt and kt + 1 have landed (P + kt
    // groups committed so far)
    cp_async_wait(P + kt - min(kt + 2, nkt));
    fence_proxy_async();
    __syncthreads();   // everyone's: tiles kt and kt + 1 landed, B of kt
                       // transposed, the wgmmas of kt - 1 done
    if (kt + P < nkt) {
      const uint32_t s = ((kt + P) % S) * slot_bytes;
      fetch<BN>(base + s, gbase + s, a_bytes, p, m0, BM, n0, kt + P, tid, nt);
    }
    cp_async_commit();

    // four k32 steps; k past K is zero in B
    const uint32_t sa = base + (kt % S) * slot_bytes + wg * 64 * BK;
    const uint32_t sb = kmaj0 + (kt & 1) * T::KMAJOR;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      Wgmma<BN>::mma(acc, desc(sa + 32 * ks), desc(sb + 32 * ks));
    wgmma_commit();
    if (kt + 1 < nkt)                 // under the wgmmas
      b_transpose<BN>(base + ((kt + 1) % S) * slot_bytes + a_bytes,
                      kmaj0 + ((kt + 1) & 1) * T::KMAJOR, tid, nt);
    wgmma_wait0();
    reg_fence(acc);
  }

  // epilogue: dequant from the fragment into an f32 tile over the ring,
  // then coalesced stores of whole rows
  cp_async_wait(0);
  __syncthreads();
  float* tile = reinterpret_cast<float*>(gbase);
  const int rl0 = wg * 64 + warp * 16 + lane / 4, rl1 = rl0 + 8;
  const float sa0 = m0 + rl0 < p.M ? __ldg(p.sa + m0 + rl0) : 0.f;
  const float sa1 = m0 + rl1 < p.M ? __ldg(p.sa + m0 + rl1) : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const float sb0 = n0 + c < p.N ? __ldg(p.sb + n0 + c) : 0.f;
    const float sb1 = n0 + c + 1 < p.N ? __ldg(p.sb + n0 + c + 1) : 0.f;
    float2 v0, v1;
    v0.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j]), sa0), sb0);
    v0.y = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 1]), sa0), sb1);
    v1.x = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2]), sa1), sb0);
    v1.y = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 3]), sa1), sb1);
    *reinterpret_cast<float2*>(tile + rl0 * T::LD + c) = v0;
    *reinterpret_cast<float2*>(tile + rl1 * T::LD + c) = v1;
  }
  __syncthreads();
  const int rows = static_cast<int>(min(static_cast<int64_t>(BM), p.M - m0));
  const int cols = min(BN, p.N - n0);
  float* ob = p.out + m0 * p.N + n0;
  if (p.out_vec == 4) {
    constexpr int C4 = BN / 4;
    for (int i = tid; i < rows * C4; i += nt) {
      const int r = i / C4, c = (i % C4) * 4;
      if (c < cols)
        __stcs(reinterpret_cast<float4*>(ob + static_cast<int64_t>(r) * p.N +
                                         c),
               *reinterpret_cast<const float4*>(tile + r * T::LD + c));
    }
  } else {
    for (int i = tid; i < rows * BN; i += nt) {
      const int r = i / BN, c = i % BN;
      if (c < cols) ob[static_cast<int64_t>(r) * p.N + c] = tile[r * T::LD + c];
    }
  }
}

// Dynamic shared memory above 48 KB must be asked for; once per device.
template <typename Kernel>
int allow_smem(Kernel kernel, uint64_t* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && (*done >> dev & 1)) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) *done |= uint64_t{1} << dev;
  return 0;
}

template <int BN>
int launch(const Params& p, int threads, int64_t gx, int64_t gy, int smem,
           cudaStream_t stream) {
  static uint64_t done = 0;
  const int e = allow_smem(int8_mm_kernel<BN>, &done);
  if (e) return e;
  int8_mm_kernel<BN><<<dim3(static_cast<unsigned>(gx),
                            static_cast<unsigned>(gy)),
                       threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, K) int8, b: (K, N) int8, a_scale: (M,) f32, b_scale: (N,) f32,
// out: (M, N) f32, all contiguous; the tile plan (bn, threads, stages,
// copy widths, grid, shared memory) from kernels/int8_matmul.plan. Returns
// cudaGetLastError() after the launch.
extern "C" int int8_matmul_launch(const void* a, const void* b,
                                  const void* a_scale, const void* b_scale,
                                  void* out, int64_t M, int64_t N, int64_t K,
                                  int bn, int threads, int stages, int a_vec,
                                  int b_vec, int out_vec, int64_t grid_x,
                                  int64_t grid_y, int smem, void* stream) {
  const Params p{static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                 static_cast<const float*>(a_scale),
                 static_cast<const float*>(b_scale), static_cast<float*>(out),
                 M, static_cast<int>(N), static_cast<int>(K), stages, a_vec,
                 b_vec, out_vec};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: return launch<8>(p, threads, grid_x, grid_y, smem, s);
    case 16: return launch<16>(p, threads, grid_x, grid_y, smem, s);
    case 24: return launch<24>(p, threads, grid_x, grid_y, smem, s);
    case 32: return launch<32>(p, threads, grid_x, grid_y, smem, s);
    case 48: return launch<48>(p, threads, grid_x, grid_y, smem, s);
    case 64: return launch<64>(p, threads, grid_x, grid_y, smem, s);
    case 96: return launch<96>(p, threads, grid_x, grid_y, smem, s);
    case 128: return launch<128>(p, threads, grid_x, grid_y, smem, s);
    case 144: return launch<144>(p, threads, grid_x, grid_y, smem, s);
    case 160: return launch<160>(p, threads, grid_x, grid_y, smem, s);
    case 192: return launch<192>(p, threads, grid_x, grid_y, smem, s);
    case 256: return launch<256>(p, threads, grid_x, grid_y, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
