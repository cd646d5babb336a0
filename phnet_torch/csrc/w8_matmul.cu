// Weight-only int8 matmul: out[M, N] f32 = (bf16(x)[M, K] @ bf16(wq)[K, N])
// * sw[N], f32 accumulation.
//
// Replaces the TPU kernel phnet_tpu/ops/w8_pallas.py::_w8_matmul_kernel
// (wrapper w8_matmul_pallas), the drop-in for ops/quant.py::
// w8_matmul_prequant. It computes every generator product of the
// DynamicConv chains when ModelConfig.quantize = "w8".
//
// Numerics: x (f32 or bf16) is rounded to bf16 round-to-nearest-even
// (cvt.rn.bf16x2.f32), as astype(bfloat16) does; the int8 codes become bf16
// exactly (|v| <= 127); the tensor cores sum the products in f32, and the
// per-column scale multiplies the f32 sum. Only the summation order differs
// from the plain version. The order is fixed by the plan (tile width and
// split-K count, chosen from M, K, N and the SM count in ops/w8_matmul.py),
// so two calls give the same bits: split partials go to an f32 workspace
// and a second kernel sums them in split order (no atomics).
//
// What bounds each product on an H100 (132 SMs, 50 MB L2, 3.35 TB/s of
// HBM, 989 TFLOP/s of dense bf16), at 4 streams (M = 960):
//   gen1   [960, 64] @ [64, 8192]: bytes, its 31.5 MB f32 output (K is one
//          stage deep);
//   gen2_a [960, 4608] @ [4608, 1024]: operations (9.1 GFLOP), with only
//          8 x 8 output tiles of 128 x 128 for 132 SMs;
//   gen2_b [960, 1024] @ [1024, 8192]: operations (16.1 GFLOP);
//   out    [960, 2304] @ [2304, 64]: bytes (x is 8.8 MB), 8 output tiles.
// At 1 stream (M = 240) all four are bound by bytes, with a quarter of the
// tiles. Inside the card the wide products are bound by the L2 -> SM
// traffic rather than by the tensor cores: x is f32, so every column tile
// re-reads 4 bytes per element of x (4 M K N / BN bytes in all), twice what
// a bf16 GEMM moves.
//
// What the design does about it:
// - Enough CTAs: a CTA owns a 128 x BN output tile (BN = 64, 128 or 256)
//   over one K range; the wrapper (ops/w8_matmul.py::w8_plan) picks BN and
//   splits K, in units of 64, into as many ranges as fill one wave of CTAs
//   (a CTA holds a whole SM, so a grid just past a wave costs a second
//   one). Split partials go to an f32 workspace and
//   w8_matmul_splitk_reduce sums them in split order and applies sw.
// - Copy / compute overlap, warp-specialized: the first thread of a
//   convert warpgroup keeps a ring of stages fed with TMA loads
//   (cp.async.bulk.tensor, full / empty mbarrier pairs): the f32 x tile in
//   boxes of 128 bytes a row with the 128-byte swizzle, and the int8
//   weight tile (BK x BN bytes). TMA's zero fill handles ragged M, K and N.
//   The tensor maps are built on the host with cuTensorMapEncodeTiled,
//   reached through cudaGetDriverEntryPoint (no -lcuda), and passed by
//   value as __grid_constant__ parameters, so a launch captured in a CUDA
//   graph keeps them.
// - Tensor cores at the Hopper rate: two consumer warpgroups (64 rows
//   each) issue wgmma.m64nBNk16 with f32 accumulators in registers. A (x)
//   comes from registers: each thread reads its fragment from the swizzled
//   f32 stage and packs it with cvt.rn.bf16x2.f32, so there is no separate
//   cast pass over x. B (the weights) comes from shared memory: the
//   convert warpgroup turns each int8 stage into a bf16 stage of a second
//   ring, MN-major (N contiguous, as wq is stored) in the 128-byte-swizzled
//   layout that the B descriptor names (transpose flag set). The
//   conversion is a byte-permute / magic-number one, in the manner of
//   CUTLASS's mixed-input GEMMs, exact and free of int-to-float
//   conversions: a code b is (128 + (b & 127)) - (128 + 128 * sign), two
//   bf16 bit patterns built with one byte permute and two logic ops, and
//   one bf16x2 subtract.
// - Coalesced epilogue: the accumulators are staged through shared memory
//   (over the rings) and written as 16-byte stores along rows, which is
//   what the output-bound gen1 needs.
// The kernel runs 384 threads, so ptxas gives a thread at most 168
// registers: 256-wide tiles (128 accumulators) leave little room, and
// ptxas serializes their wgmmas where the A fragments do not fit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;          // tile rows: two wgmma warpgroups of 64
constexpr int BK = 64;           // K depth of a stage: 4 wgmma k16 steps
constexpr int KUNIT = 64;        // split-K granularity, elements of K
constexpr int kMma = 256;        // threads of the two wgmma warpgroups
constexpr int kThreads = kMma + 128;  // and the load / convert warpgroup

constexpr int X_BOX_BYTES = BM * 128;  // one TMA box of x: 128 rows x 128 B

// Shared-memory layout of one CTA (offsets from a 1024-aligned base): the
// ring of x and int8 stages (TMA), the bf16 B ring (converted), the
// barriers; the epilogue reuses the rings.
template <typename T, int BN>
struct Geometry {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int B_STAGES = BN == 256 ? 2 : 3;
  static constexpr int X_BOXES = BK * (int)sizeof(T) / 128;
  static constexpr int X_TILE_BYTES = X_BOXES * X_BOX_BYTES;
  static constexpr int W_TILE_BYTES = BK * BN;      // int8 stage
  static constexpr int B_TILE_BYTES = BK * BN * 2;  // bf16 B stage
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = X_OFF + STAGES * X_TILE_BYTES;
  static constexpr int B_OFF = W_OFF + STAGES * W_TILE_BYTES;
  static constexpr int RING_END = B_OFF + B_STAGES * B_TILE_BYTES;
  static constexpr int EPI_LD = BN + 4;             // floats a staged row
  static constexpr int EPI_BYTES = BM * EPI_LD * 4;
  static constexpr int BAR_OFF = RING_END > EPI_BYTES ? RING_END : EPI_BYTES;
  static constexpr int N_BARS = 2 * STAGES + 2 * B_STAGES;
  static constexpr int SMEM_BYTES = BAR_OFF + 8 * N_BARS + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// named barriers: 1 over the wgmma warpgroups, 2 over the convert warpgroup
__device__ __forceinline__ void mma_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMma) : "memory");
}
__device__ __forceinline__ void convert_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// wgmma descriptor of a bf16 tile in the 128-byte-swizzled MN-major layout:
// start address, leading byte offset (between 64-column atoms), stride byte
// offset (between 8-row groups of K), in 16-byte units.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, int J>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][J]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Two int8 codes (bytes `sel` picks into the low bytes of the two halves)
// as a bf16x2 word, exactly: a code b is (b & 127) - 128 * sign, so in bf16
// it is (128 + (b & 127)) - (128 + 128 * sign); both operands are exact
// bf16 bit patterns (0x4300 | (b & 127), and 0x4300 or 0x4380), and so is
// their difference, an integer in [-128, 127].
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0u, sel);
  const uint32_t mag = (p & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (p & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&mag),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&d);
}

// Elements (r, c), (r, c + 1) of x, from a stage of 128-byte-swizzled boxes
// (128 rows of 128 bytes each, box b holding columns b * 128 / sizeof(T)..),
// as bf16x2, low half first, rounded to nearest even.
__device__ __forceinline__ uint32_t x_pair(const uint8_t* tile, int r, int c,
                                           float) {
  const int byte = c * 4;
  const float2 v = *reinterpret_cast<const float2*>(
      tile + (byte >> 7) * X_BOX_BYTES + r * 128 +
      ((byte & 127) ^ ((r & 7) << 4)));
  __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&b);
}
__device__ __forceinline__ uint32_t x_pair(const uint8_t* tile, int r, int c,
                                           __nv_bfloat16) {
  const int byte = c * 2;
  return *reinterpret_cast<const uint32_t*>(
      tile + (byte >> 7) * X_BOX_BYTES + r * 128 +
      ((byte & 127) ^ ((r & 7) << 4)));
}

// One 128 x BN output tile of one K split. Threads 0..255 are the two wgmma
// warpgroups; 256..383 the convert warpgroup, whose first thread also
// issues the TMA loads. out is the output (splits == 1, scaled by sw here)
// or the workspace [splits, M, N] of raw partials.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    w8_matmul_kernel(const __grid_constant__ CUtensorMap tmap_x,
                     const __grid_constant__ CUtensorMap tmap_w,
                     const float* __restrict__ sw, float* __restrict__ out,
                     int M, int N, int K, int units, int splits) {
  using G = Geometry<T, BN>;
  constexpr int STAGES = G::STAGES;
  constexpr int B_STAGES = G::B_STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + G::BAR_OFF;       // x and int8 stage landed
  const uint32_t empty0 = full0 + 8 * STAGES;      // x stage read
  const uint32_t bfull0 = empty0 + 8 * STAGES;     // bf16 stage written
  const uint32_t bempty0 = bfull0 + 8 * B_STAGES;  // bf16 stage consumed

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int k_begin = (int)((long long)split * units / splits) * KUNIT;
  const int k_end =
      min((int)((long long)(split + 1) * units / splits) * KUNIT, K);
  const int n_iter = (k_end - k_begin + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kMma / 32);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(bfull0 + 8 * s, 1);
      mbar_init(bempty0 + 8 * s, kMma / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kMma) {
    // convert warpgroup; its first thread keeps STAGES - 1 stages of TMA
    // loads in flight
    const int t = tid - kMma;
    auto issue = [&](int p) {
      const int s = p % STAGES;
      const uint32_t full = full0 + 8 * s;
      const int k = k_begin + p * BK;
      mbar_expect_tx(full, G::X_TILE_BYTES + G::W_TILE_BYTES);
#pragma unroll
      for (int bx = 0; bx < G::X_BOXES; ++bx)
        tma_load_2d(sbase + G::X_OFF + s * G::X_TILE_BYTES + bx * X_BOX_BYTES,
                    &tmap_x, full, k + bx * (128 / (int)sizeof(T)), m0);
      tma_load_2d(sbase + G::W_OFF + s * G::W_TILE_BYTES, &tmap_w, full, n0,
                  k);
    };
    if (t == 0)
      for (int p = 0; p < STAGES - 1 && p < n_iter; ++p) issue(p);
    // int8 stage -> bf16 B stage, N contiguous, 128-byte swizzle (64
    // columns of 128 bytes a row per atom, atoms BK * 128 bytes apart), the
    // layout the B descriptor names; 8-byte chunks, loads batched ahead of
    // the conversions
    constexpr int CHUNKS = BK * BN / 8 / 128;  // per thread and stage
    constexpr int BATCH = CHUNKS < 8 ? CHUNKS : 8;
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int b = it % B_STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      mbar_wait(bempty0 + 8 * b, ((it / B_STAGES) & 1) ^ 1);
      const uint8_t* wt = smem + G::W_OFF + s * G::W_TILE_BYTES;
      uint8_t* bt = smem + G::B_OFF + b * G::B_TILE_BYTES;
#pragma unroll
      for (int q0 = 0; q0 < CHUNKS; q0 += BATCH) {
        uint2 w[BATCH];
#pragma unroll
        for (int q = 0; q < BATCH; ++q)
          w[q] = *reinterpret_cast<const uint2*>(wt + 8 * (t + (q0 + q) * 128));
#pragma unroll
        for (int q = 0; q < BATCH; ++q) {
          const int i = t + (q0 + q) * 128;
          const int r = i / (BN / 8);
          const int n = (i % (BN / 8)) * 8;
          uint4 v;
          v.x = dequant2(w[q].x, 0x4140);
          v.y = dequant2(w[q].x, 0x4342);
          v.z = dequant2(w[q].y, 0x4140);
          v.w = dequant2(w[q].y, 0x4342);
          *reinterpret_cast<uint4*>(bt + (n >> 6) * (BK * 128) + r * 128 +
                                    (((n & 63) * 2) ^ ((r & 7) << 4))) = v;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      convert_sync();  // bf16 stage complete; int8 stage fully read
      if (t == 0) {
        mbar_arrive(bfull0 + 8 * b);
        // refill the slot of stage it - 1 (its int8 tile was converted in
        // the last iteration) once the wgmma warps have read its x
        const int p = it + STAGES - 1;
        if (p < n_iter) {
          if (p >= STAGES) mbar_wait(empty0 + 8 * (p % STAGES),
                                     ((p / STAGES) & 1) ^ 1);
          issue(p);
        }
      }
    }
  } else {
    // wgmma warpgroups: A (x) from the x stage into registers (bf16, the
    // m16k16 fragment of each warp's 16 rows), B from the bf16 ring
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tg = lane & 3;
    const int row0 = wg * 64 + warp * 16 + g;  // tile rows row0, row0 + 8

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int b = it % B_STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint8_t* xt = smem + G::X_OFF + s * G::X_TILE_BYTES;
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[kk][j] = x_pair(xt, row0 + (j & 1) * 8,
                            kk * 16 + 2 * tg + (j >> 1) * 8, T());
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // x stage read
      mbar_wait(bfull0 + 8 * b, (it / B_STAGES) & 1);
      const uint32_t b_addr = sbase + G::B_OFF + b * G::B_TILE_BYTES;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t desc =
            desc_b128(b_addr + kk * 16 * 128, BK * 128, 1024);
        if constexpr (BN == 256) {
          wgmma_m64n256(acc, a[kk], desc);
        } else if constexpr (BN == 128) {
          wgmma_m64n128(acc, a[kk], desc);
        } else {
          wgmma_m64n64(acc, a[kk], desc);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      fence_regs(a);
      __syncwarp();
      if (lane == 0) mbar_arrive(bempty0 + 8 * b);
    }

    // epilogue: stage the tile in shared memory (over the rings, which are
    // idle: every stage was consumed), then 16-byte stores along rows
    mma_sync();
    float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(stage + (row0 + 8 * h) * G::EPI_LD +
                                   8 * i + 2 * tg) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    mma_sync();
    const bool partial = splits > 1;
    float* dst = out + (partial ? (size_t)split * M * N : 0);
#pragma unroll 4
    for (int idx = tid; idx < BM * BN / 4; idx += kMma) {
      const int r = idx / (BN / 4);
      const int c = (idx % (BN / 4)) * 4;
      const int gr = m0 + r;
      const int gc = n0 + c;
      if (gr < M && gc < N) {
        float4 v =
            *reinterpret_cast<const float4*>(stage + r * G::EPI_LD + c);
        if (!partial) {
          const float4 s4 = *reinterpret_cast<const float4*>(sw + gc);
          v.x *= s4.x;
          v.y *= s4.y;
          v.z *= s4.z;
          v.w *= s4.w;
        }
        *reinterpret_cast<float4*>(dst + (size_t)gr * N + gc) = v;
      }
    }
  }
}

// out = sw * (ws[0] + ws[1] + ... + ws[splits - 1]), summed in split order.
__global__ void __launch_bounds__(256)
    w8_matmul_splitk_reduce(const float* __restrict__ ws,
                            const float* __restrict__ sw,
                            float* __restrict__ out, int M, int N, int splits) {
  const size_t plane = (size_t)M * N;
  for (size_t e = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
       e < plane; e += 4 * (size_t)gridDim.x * blockDim.x) {
    float4 acc = *reinterpret_cast<const float4*>(ws + e);
    for (int s = 1; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(ws + s * plane + e);
      acc.x += p.x;
      acc.y += p.y;
      acc.z += p.z;
      acc.w += p.w;
    }
    const float4 s4 = *reinterpret_cast<const float4*>(sw + e % N);
    acc.x *= s4.x;
    acc.y *= s4.y;
    acc.z *= s4.z;
    acc.w *= s4.w;
    *reinterpret_cast<float4*>(out + e) = acc;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Host-side errors, below any cudaError_t.
constexpr int kErrNoEncode = -1;       // cuTensorMapEncodeTiled not found
constexpr int kErrArgs = -2;           // shapes, alignment or plan refused
constexpr int kErrEncodeBase = -1000;  // -1000 - CUresult of a failed encode

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 2-D row-major tensor [outer, inner] as a tensor map, boxes of
// [box_outer, box_inner].
int make_map(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
             uint64_t inner, uint64_t outer, uint64_t row_bytes,
             uint32_t box_inner, uint32_t box_outer, CUtensorMapSwizzle swz) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(map, dtype, 2, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase - (int)r;
}

template <typename T, int BN>
int launch(const T* x, const int8_t* wq, const float* sw, float* out,
           float* ws, int M, int K, int N, int splits, cudaStream_t stream) {
  using G = Geometry<T, BN>;
  const int units = (K + KUNIT - 1) / KUNIT;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)wq % 16 == 0) &&
                       ((uintptr_t)sw % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (M <= 0 || K <= 0 || K % 8 != 0 || N <= 0 || N % 16 != 0 || !aligned ||
      splits < 1 || splits > units ||
      (splits > 1 && (ws == nullptr || (uintptr_t)ws % 16 != 0)))
    return kErrArgs;
  // x [M, K] in boxes of 128 rows x 128 bytes (128-byte swizzle, the
  // pattern x_pair reads); wq [K, N] int8 in boxes of [BK, BN] bytes
  CUtensorMap map_x, map_w;
  int err = make_map(&map_x,
                     std::is_same<T, float>::value
                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     x, K, M, (uint64_t)K * sizeof(T), 128 / sizeof(T), BM,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, N, K, N, BN, BK,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  static bool smem_set = false;  // once per instantiation, before any capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8_matmul_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid(N / BN + (N % BN != 0), (M + BM - 1) / BM, splits);
  w8_matmul_kernel<T, BN><<<grid, kThreads, G::SMEM_BYTES, stream>>>(
      map_x, map_w, sw, splits > 1 ? ws : out, M, N, K, units, splits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long threads = (long long)M * N / 4;
  const int blocks = (int)((threads + 255) / 256 < 4096 ? (threads + 255) / 256
                                                        : 4096);
  w8_matmul_splitk_reduce<<<blocks, 256, 0, stream>>>(ws, sw, out, M, N,
                                                      splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const int8_t* wq, const float* sw, float* out,
             float* ws, int M, int K, int N, int block_n, int splits,
             cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (block_n == 256)
    return launch<T, 256>(xt, wq, sw, out, ws, M, K, N, splits, s);
  if (block_n == 128)
    return launch<T, 128>(xt, wq, sw, out, ws, M, K, N, splits, s);
  if (block_n == 64)
    return launch<T, 64>(xt, wq, sw, out, ws, M, K, N, splits, s);
  return kErrArgs;
}

}  // namespace

// x: [M, K] row-major, float32 (x_is_bf16 = 0) or bfloat16 (1); wq: [K, N]
// int8 row-major; sw: [N] f32; out: [M, N] f32 row-major; ws: f32 workspace
// [splits, M, N] (unused when splits == 1). The plan (block_n 64, 128 or
// 256; 1 <= splits <= ceil(K / 64)) comes from ops/w8_matmul.py::w8_plan.
// K must be a multiple of 8, N of 16, and every pointer 16-byte aligned
// (the wrapper pads otherwise). Launches on `stream` and returns 0, the
// cudaError_t of the first launch that failed, or a negative host-side
// error (-1: no cuTensorMapEncodeTiled, -2: arguments refused, -1000 - r:
// the tensor-map encode returned CUresult r).
extern "C" int w8_matmul_launch(const void* x, int x_is_bf16,
                                const int8_t* wq, const float* sw, float* out,
                                float* ws, int M, int K, int N, int block_n,
                                int splits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return dispatch<__nv_bfloat16>(x, wq, sw, out, ws, M, K, N, block_n,
                                   splits, s);
  return dispatch<float>(x, wq, sw, out, ws, M, K, N, block_n, splits, s);
}

// Dynamic shared memory of one CTA of the main kernel, in bytes.
extern "C" int w8_matmul_smem_bytes(int block_n) {
  return block_n == 256   ? Geometry<float, 256>::SMEM_BYTES
         : block_n == 128 ? Geometry<float, 128>::SMEM_BYTES
                          : Geometry<float, 64>::SMEM_BYTES;
}
