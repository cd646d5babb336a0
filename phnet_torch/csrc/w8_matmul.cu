// Weight-only int8 matmul: out[M, N] f32 = (bf16(x)[M, K] @ bf16(wq)[K, N])
// * sw[N], f32 accumulation.
//
// Replaces the TPU kernel phnet_tpu/ops/w8_pallas.py::_w8_matmul_kernel
// (wrapper w8_matmul_pallas), the drop-in for ops/quant.py::
// w8_matmul_prequant. It computes every generator product of the
// DynamicConv chains when ModelConfig.quantize = "w8".
//
// Numerics: x (f32 or bf16) is rounded to bf16 round-to-nearest-even, as
// astype(bfloat16) does; wq is int8 and becomes bf16 exactly (|v| <= 127);
// the products are summed in f32 by the tensor cores, and the per-column
// scale is applied to the f32 sum. Only the summation order differs from
// the plain version.
//
// What bounds it on an H100: operations for the wide products (the VIL
// second generator, [960, 4608] @ [4608, 1024] and [960, 1024] @
// [1024, 8192] at 4 streams, 9 and 16 GFLOP against 989 TFLOP/s of dense
// bf16), bytes for the narrow ones (the first generator writes a
// [960, 8192] f32 output from K = 64).
//
// What the design does about it, first as a simple kernel: the products run
// on the tensor cores (warp-level mma.sync m16n8k16, bf16 in, f32
// accumulate). A CTA of 8 warps owns a 64 x 128 output tile and walks K in
// steps of 32: the x tile is converted to bf16 on its way to shared memory;
// the int8 weight tile is stored in shared memory as int8 (transposed, so a
// thread's pair of k values is one 16-bit read) and dequantized to bf16 in
// registers when a warp builds its B fragments, so device memory and shared
// memory only ever move the int8 bytes. Ragged M, K and N are handled by
// zero-filling the tiles and masking the stores. No TMA, wgmma or
// multi-stage pipeline yet: those are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N, 32 x 32 each
constexpr int A_LD = BK + 8;   // bf16 per shared row of the x tile
constexpr int B_LD = BK + 4;   // bytes per shared row of the transposed wq tile

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

// Two int8 codes (low byte first) as a bf16x2 register, low half first.
__device__ __forceinline__ uint32_t dequant_pair(uint16_t codes) {
  const float lo = (float)(int8_t)(codes & 0xff);
  const float hi = (float)(int8_t)(codes >> 8);
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    w8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                     const float* __restrict__ sw, float* __restrict__ out,
                     int M, int K, int N, int vec_b) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(16) int8_t Bs[BN * B_LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: row of A / column of B
  const int tg = lane & 3;   // thread in group
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, BK] -> bf16 in shared memory; a warp reads one row's 32
    // consecutive elements
#pragma unroll
    for (int i = 0; i < BM * BK / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / BK;
      const int c = idx % BK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      As[r * A_LD + c] = (gm < M && gk < K)
                             ? to_bf16(x[(size_t)gm * K + gk])
                             : __float2bfloat16_rn(0.f);
    }
    // wq tile [BK, BN] int8 -> shared memory transposed to [BN, BK]; a
    // warp reads 4 rows of 32 bytes, one 4-byte word a thread
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / kThreads; ++i) {
      const int chunk = (tid + i * kThreads) >> 5;  // 0..31
      const int r = (chunk >> 2) * 4 + (lane >> 3);  // k row in the tile
      const int w = (chunk & 3) * 8 + (lane & 7);    // 4-byte word along N
      const int gk = k0 + r;
      const int gn = n0 + 4 * w;
      uint32_t word = 0;
      if (gk < K) {
        const int8_t* src = wq + (size_t)gk * N + gn;
        if (vec_b && gn + 3 < N) {
          word = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) word |= (uint32_t)(uint8_t)src[j] << (8 * j);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Bs[(4 * w + j) * B_LD + r] = (int8_t)((word >> (8 * j)) & 0xff);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* base =
            As + (wm * 32 + i * 16 + g) * A_LD + kk + 2 * tg;
        a[i][0] = *reinterpret_cast<const uint32_t*>(base);
        a[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * A_LD);
        a[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * A_LD + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = Bs + (wn * 32 + j * 8 + g) * B_LD + kk + 2 * tg;
        b[j][0] = dequant_pair(*reinterpret_cast<const uint16_t*>(base));
        b[j][1] = dequant_pair(*reinterpret_cast<const uint16_t*>(base + 8));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // epilogue: per-column scale, masked f32 stores
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + 2 * tg;
    const float s0 = col < N ? sw[col] : 0.f;
    const float s1 = col + 1 < N ? sw[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float* o = out + (size_t)row * N + col;
        if (col < N) o[0] = acc[i][j][2 * h] * s0;
        if (col + 1 < N) o[1] = acc[i][j][2 * h + 1] * s1;
      }
    }
  }
}

template <typename T>
int launch(const T* x, const int8_t* wq, const float* sw, float* out, int M,
           int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const int vec_b = (N % 4 == 0) && ((uintptr_t)wq % 4 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(x, wq, sw, out, M, K, N,
                                                     vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [M, K] row-major, float32 (x_is_bf16 = 0) or bfloat16 (1); wq: [K, N]
// int8 row-major; sw: [N] f32; out: [M, N] f32 row-major. Launches on
// `stream` and returns a cudaError_t (0 = launched).
extern "C" int w8_matmul_launch(const void* x, int x_is_bf16,
                                const int8_t* wq, const float* sw, float* out,
                                int M, int K, int N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_is_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), wq, sw, out, M, K, N,
                  s);
  return launch(static_cast<const float*>(x), wq, sw, out, M, K, N, s);
}
