// The adaptive router's residual chain: one CTA per anchor, over the
// planes of that anchor from a group of G streams.
//
// Replaces the TPU kernel phnet_tpu/ops/router_pallas.py::
// _router_blocks_kernel (wrapper fused_router_blocks). Per plane [C, P]:
// LN0, then `blocks` times: depthwise 3x3 (zero padding, per-anchor taps
// and bias) -> LN -> ReLU -> 3x3 -> LN -> + residual -> ReLU. Forward only.
//
// LayerNorm is the fast-variance form of the default JAX path
// (router_pallas.py::_ln: var = max(E[x^2] - E[x]^2, 0), eps 1e-5), and
// each 3x3 takes its taps in the plain version's order k = 3(dc+1)+(dp+1),
// so the kernel and its plain PyTorch version differ only in rounding:
// fused multiply-adds, where the bias enters, how the LayerNorm sums are
// grouped, and a multiply by 1 / (C * P) for the divide.
//
// What bounds it on an H100: not bytes and not the FP32 rate. At the
// serving shape (B = 4 streams, 960 planes of 64 x 36 f32) the bound is
// about 7.4 us (operations; the 17.7 MB of planes in and out take 5.3 us),
// but a plane is a chain of 8 convolutions and 9 plane-wide reductions,
// each waiting on the one before it. A design with one CTA a plane waits
// on that chain 960 times in three waves, with little work between its
// barriers. With the chain in one wave, what is left is the SM's instruction
// slots and its shared-memory / L1 data path, both about half used: the
// 3x3's shared reads, the writes that publish each plane, and the
// LayerNorm parameters, whose reads touch about 2.5 cache lines a warp
// where one would do, since a warp's points straddle rows of 36.
//
// What the design does about it:
// - One CTA takes the planes of one anchor from G streams (G in 1, 2, 4,
//   chosen by ops/router_chain.py::router_plan so that one wave holds the
//   tick): every barrier and every reduction serves G planes, the
//   anchor's 72 taps and 8 biases are loaded once into shared memory and
//   read as 16-byte broadcasts, and each LayerNorm parameter a thread
//   loads serves G planes. At B = 4 that is 240 CTAs, one wave at 2 CTAs
//   an SM.
// - A thread owns a strip of R = 8 channels at one point (288 threads for
//   64 x 36) and holds the strips of the plane being worked on in
//   registers (and x, the residual, too where registers allow: G <= 2).
//   Two shared planes a stream, x and the block's middle value, have a
//   zero halo (channels -1 and C, points -1 and P) written once, so the
//   3x3 has no divide and no bounds test: it takes the strip's own column
//   from registers and the two neighbouring columns and the rows above and
//   below the strip from shared memory, 2R + 6 reads for 9R multiply-adds.
//   A gap after every strip of rows keeps each warp's reads and writes free
//   of bank conflicts. A LayerNorm's barrier also ends every read of the
//   plane that is written next.
// - Each LayerNorm takes one barrier: a warp reduces its 2G sums with a
//   halving butterfly, writes them to a buffer double-buffered by the
//   LayerNorm's parity, and after the barrier every warp sums the warps'
//   partials in one fixed order, so every thread holds the same
//   statistics and two calls give the same bits. Each LayerNorm's scale
//   and bias are loaded right after the one before it.
// - C, P and the block count are template parameters for the path's shape
//   (64 x 36, 4 blocks), so the chain unrolls; other shapes run the same
//   kernel with them at run time.
//
// The bf16 mode (T = __nv_bfloat16) is the chain that the JAX package
// serves above 8 streams (AdaptiveRouter(chain_bf16=True)): the same
// kernel, with the shared planes and the output in bf16 and a round to
// bf16 where ops/router_chain.py::router_chain_plain(bf16=True) rounds:
// the taps and biases, each LayerNorm's output, each 3x3's output and the
// residual sum. Between those points it computes in f32, as the plain
// version does and in its order: a 3x3 sums its nine products in tap
// order and adds the bias last, a LayerNorm output is ((v - mean) * rs) *
// scale + bias, each op rounded on its own (__fmul_rn / __fadd_rn, so that
// nvcc contracts nothing into an fma). The halo planes then take half the
// bytes; their gap makes a strip's stride congruent to P mod 64 elements,
// so a warp's 32 points still read 16 or 17 distinct banks. The launch
// bounds, and so the occupancy (2 CTAs an SM at the path's shape, held by
// registers), are those of the f32 instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kR = 8;  // channels a thread owns at its point
constexpr float kEps = 1e-5f;
constexpr int kMaxThreads = 512;  // 128 registers a thread
constexpr int kTapStride = 12;    // floats of a conv's taps and bias

// Threads of a CTA for a [c, p] plane: one per strip, whole warps.
__host__ __device__ constexpr int cta_threads(int c, int p) {
  return ((c / kR) * p + 31) / 32 * 32;
}

// Where a [C, P] plane of T lives in shared memory: rows of W = P + 2
// with a zero halo (channels -1 and C, points -1 and P), and after every
// strip of kR channels a gap of `pad` elements that makes a strip's stride
// congruent to P mod M, M = 128 bytes / sizeof(T) (32 floats, 64 bf16).
// Thread t = strip * P + p then reads and writes element (t + const) mod
// M on every row: no bank conflict where a warp spans two strips.
template <typename T>
struct HaloPlane {
  static constexpr int M = 128 / sizeof(T);
  int W, pad;
  __host__ __device__ explicit HaloPlane(int P)
      : W(P + 2), pad((((P - kR * (P + 2)) % M) + M) % M) {}
  // elements of a plane, gaps included (bf16: rounded up to 16 bytes)
  __host__ __device__ int elems(int C) const {
    constexpr int kAlign = sizeof(T) == 4 ? 1 : 16 / sizeof(T);
    return ((C + 2) * W + (C / kR + 1) * pad + kAlign - 1) / kAlign * kAlign;
  }
  // index of (channel strip * kR, point p)
  __host__ __device__ int at(int strip, int p) const {
    return W + pad + strip * (kR * W + pad) + p + 1;
  }
  // index of (channel c, point p), c in [-1, C], p in [-1, P]
  __device__ int index(int c, int p) const {
    return W + pad + c * W + (c >= 0 ? c / kR : -1) * pad + p + 1;
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ void load_affine(float (&sc)[kR], float (&bi)[kR],
                                            const float* __restrict__ scale,
                                            const float* __restrict__ bias,
                                            int e0, int P) {
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    sc[r] = __ldg(scale + e0 + r * P);
    bi[r] = __ldg(bias + e0 + r * P);
  }
}

// LayerNorm of the G planes held in v with the affine parameters of the
// thread's strip (loaded one LayerNorm ahead). `red` is this LayerNorm's
// half of the reduction buffer, [n_warps][2G] (sum, sum of squares of
// each plane). A warp reduces its 2G values with a halving butterfly
// (a lane hands on the half it does not keep), so that L = 32 / 2G lanes
// end with each value; after the one barrier, the lanes of value k sum
// it over the warps in a fixed order and every lane fetches the 2G
// totals. Every thread gets the same bits. In the bf16 mode (T bf16) the
// output is ((v - mean) * rs) * scale + bias, op by op, rounded to bf16.
template <typename T, int kG>
__device__ __forceinline__ void layer_norm(float (&v)[kG][kR],
                                           const float (&sc)[kR],
                                           const float (&bi)[kR],
                                           float inv_cp, bool owner,
                                           float* red, int n_warps) {
  constexpr int V = 2 * kG, L = 32 / V;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float q[V];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    q[2 * g] = 0.f;
    q[2 * g + 1] = 0.f;
    if (owner) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        q[2 * g] += v[g][r];
        q[2 * g + 1] = fmaf(v[g][r], v[g][r], q[2 * g + 1]);
      }
    }
  }
#pragma unroll
  for (int n = V, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool up = lane & off;  // keeps the upper half of its n values
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float keep = up ? q[j + n / 2] : q[j];
      const float send = up ? q[j] : q[j + n / 2];
      q[j] = keep + __shfl_xor_sync(kAll, send, off);
    }
  }
  float part = q[0];  // value lane / L, over the lanes of this residue
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(kAll, part, off);
  if (lane % L == 0) red[(threadIdx.x >> 5) * V + lane / L] = part;
  __syncthreads();
  // the lanes of value k add it over warps k % L, k % L + L, ..., then
  // every lane fetches the 2G totals
  float tot = 0.f;
  for (int w = lane % L; w < n_warps; w += L) tot += red[w * V + lane / L];
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    tot += __shfl_xor_sync(kAll, tot, off);
  float sum[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sum[k] = __shfl_sync(kAll, tot, k * L);
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float mean = sum[2 * g] * inv_cp;
    const float mean2 = sum[2 * g + 1] * inv_cp;
    const float rs = rsqrtf(fmaxf(mean2 - mean * mean, 0.f) + kEps);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if constexpr (std::is_same_v<T, float>)
        v[g][r] = fmaf((v[g][r] - mean) * rs, sc[r], bi[r]);
      else
        v[g][r] = round_to<T>(__fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[g][r], mean), rs), sc[r]),
            bi[r]));
    }
  }
}

// v <- depthwise 3x3 + bias of the G planes whose thread's strips v
// holds, and whose halo copies are at s_pl: the strip's own column comes
// from v, the two neighbouring columns and the rows above and below the
// strip from shared memory. `at` is the strip's first element; s_k the
// conv's 9 taps and bias, 16-byte aligned (three broadcast reads). f32:
// the sum starts at the bias, products enter by fma; bf16: products and
// sums rounded one by one, in tap order, the bias last, the sum rounded to
// bf16.
template <typename T, int kG>
__device__ __forceinline__ void conv3x3(float (&v)[kG][kR],
                                        const T* s_pl, int plane, int at,
                                        HaloPlane<T> h, const float* s_k) {
  constexpr bool kF32 = std::is_same_v<T, float>;
  const float4 k03 = reinterpret_cast<const float4*>(s_k)[0];
  const float4 k47 = reinterpret_cast<const float4*>(s_k)[1];
  const float4 k8b = reinterpret_cast<const float4*>(s_k)[2];
  const float k[9] = {k03.x, k03.y, k03.z, k03.w, k47.x,
                      k47.y, k47.z, k47.w, k8b.x};
  const float b = k8b.y;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const T* src = s_pl + g * plane + at;
    float acc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = kF32 ? b : 0.f;
#pragma unroll
    for (int rr = 0; rr < kR + 2; ++rr) {  // input channel strip*kR - 1 + rr
      const int row = (rr - 1) * h.W + (rr == 0 ? -h.pad : 0) +
                      (rr == kR + 1 ? h.pad : 0);
      const bool own = rr >= 1 && rr <= kR;
      const float v0 = static_cast<float>(src[row - 1]);
      const float v2 = static_cast<float>(src[row + 1]);
      const float v1 =
          own ? v[g][own ? rr - 1 : 0] : static_cast<float>(src[row]);
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) {  // ascending dc for each output
        const int i = rr - 1 - dc;          // output channel strip*kR + i
        if (i >= 0 && i < kR) {
          const int k0 = 3 * (dc + 1);
          if constexpr (kF32) {
            acc[i] = fmaf(k[k0], v0, acc[i]);
            acc[i] = fmaf(k[k0 + 1], v1, acc[i]);
            acc[i] = fmaf(k[k0 + 2], v2, acc[i]);
          } else {
            acc[i] = __fadd_rn(acc[i], __fmul_rn(k[k0], v0));
            acc[i] = __fadd_rn(acc[i], __fmul_rn(k[k0 + 1], v1));
            acc[i] = __fadd_rn(acc[i], __fmul_rn(k[k0 + 2], v2));
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
      v[g][i] = kF32 ? acc[i] : round_to<T>(__fadd_rn(acc[i], b));
  }
}

template <typename T, int kG>
__device__ __forceinline__ void publish(const float (&v)[kG][kR], T* s_pl,
                                        int plane, int at, int W,
                                        bool owner) {
  if (!owner) return;
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      s_pl[g * plane + at + r * W] = static_cast<T>(v[g][r]);
}

// kC = kP = kB = 0: C, P and the block count at run time, up to
// kMaxThreads threads. T: the planes' and the output's type (float, or
// __nv_bfloat16 for the bf16 mode); x is float32 in both.
template <typename T, int kC, int kP, int kB, int kG>
__global__ void __launch_bounds__(kC > 0 ? cta_threads(kC, kP) : kMaxThreads,
                                  kC > 0 ? 2 : 1)
router_chain_kernel(const float* __restrict__ x,
                    const float* __restrict__ taps,
                    const float* __restrict__ bias,
                    const float* __restrict__ lnp, T* __restrict__ out,
                    int n_streams, int A, int c_rt, int p_rt,
                    int blocks_rt) {
  const int C = kC > 0 ? kC : c_rt;
  const int blocks = kB > 0 ? kB : blocks_rt;
  const int P = kP > 0 ? kP : p_rt;
  const HaloPlane<T> h(P);
  const int plane = h.elems(C), cp = C * P;
  const float inv_cp = 1.f / (float)cp;
  const int owners = (C / kR) * P;
  const int n_warps = kC > 0 ? cta_threads(kC, kP) / 32 : blockDim.x >> 5;

  extern __shared__ __align__(16) float smem[];
  float* s_red = smem;                                // [2][n_warps][2G]
  // [2 * blocks][kTapStride]: a conv's 9 taps, its bias, 2 zeros
  float* s_k = s_red + 2 * n_warps * 2 * kG;
  // [kG] halo planes each, 16-byte aligned: the two regions above are
  // whole multiples of 4 floats
  T* s_x = reinterpret_cast<T*>(s_k + 2 * blocks * kTapStride);
  T* s_y = s_x + kG * plane;

  const int t = threadIdx.x;
  // every thread owns a strip when the instance's threads are whole warps
  const bool owner = (kC > 0 && cta_threads(kC, kP) == owners) || t < owners;
  const int strip = owner ? t / P : 0;
  const int pt = owner ? t - strip * P : 0;
  const int e0 = strip * kR * P + pt;  // plane index of the strip's row 0
  const int at = h.at(strip, pt);      // halo-plane index of it

  const int a = blockIdx.x;
  const int s0 = blockIdx.y * kG;  // first stream of the group
  float xr[kG][kR], sc[kR], bi[kR];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const bool live = owner && s0 + g < n_streams;
    const float* xin = x + ((size_t)(s0 + g) * A + a) * cp + e0;
#pragma unroll
    for (int r = 0; r < kR; ++r) xr[g][r] = live ? xin[r * P] : 0.f;
  }
  load_affine(sc, bi, lnp, lnp + cp, e0, P);
  // zero the halos of the 2G planes: rows -1 and C, points -1 and P
  const int n_halo = 2 * h.W + 2 * C;
  for (int i = t; i < 2 * kG * n_halo; i += blockDim.x) {
    const int pl = i / n_halo, j = i - pl * n_halo;
    const bool row = j < 2 * h.W;
    const int c = row ? (j < h.W ? -1 : C) : (j - 2 * h.W) >> 1;
    const int pp = row ? (j < h.W ? j : j - h.W) - 1 : (j & 1 ? P : -1);
    s_x[pl * plane + h.index(c, pp)] = static_cast<T>(0.f);
  }
  for (int i = t; i < 2 * blocks * kTapStride; i += blockDim.x) {
    const int conv = i / kTapStride, j = i - conv * kTapStride;
    s_k[i] = round_to<T>(
        j < 9 ? taps[((size_t)a * blocks * 2 + conv) * 9 + j]
              : j == 9 ? bias[(size_t)a * blocks * 2 + conv] : 0.f);
  }

  // LN0; its barrier also publishes the zeroed halos, taps and biases
  layer_norm<T>(xr, sc, bi, inv_cp, owner, s_red, n_warps);
  load_affine(sc, bi, lnp + 2 * cp, lnp + 3 * cp, e0, P);
  publish(xr, s_x, plane, at, h.W, owner);
  // x in registers too where they allow (G <= 2), else read back from s_x
  constexpr bool kKeepX = kG <= 2;
  float xk[kKeepX ? kG : 1][kR];
  if constexpr (kKeepX) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) xk[g][r] = xr[g][r];
  }
  __syncthreads();

  // xr holds the thread's strips of the plane the next 3x3 reads; x
  // itself lives in s_x from here on
#pragma unroll
  for (int blk = 0; blk < blocks; ++blk) {
    const float* ln = lnp + (size_t)(2 + 4 * blk) * cp;
    conv3x3(xr, s_x, plane, at, h, s_k + 2 * blk * kTapStride);
    layer_norm<T>(xr, sc, bi, inv_cp, owner, s_red + n_warps * 2 * kG,
                  n_warps);
    load_affine(sc, bi, ln + 2 * cp, ln + 3 * cp, e0, P);
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) xr[g][r] = fmaxf(xr[g][r], 0.f);
    publish(xr, s_y, plane, at, h.W, owner);
    __syncthreads();
    conv3x3(xr, s_y, plane, at, h, s_k + (2 * blk + 1) * kTapStride);
    layer_norm<T>(xr, sc, bi, inv_cp, owner, s_red, n_warps);
    if (blk + 1 < blocks) load_affine(sc, bi, ln + 4 * cp, ln + 5 * cp, e0, P);
    // + residual: the thread's own strip of x, which no other thread
    // writes; every read of s_x by the block's first 3x3 ended at the
    // barrier of the LayerNorm after it
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if constexpr (kKeepX) {
          xr[g][r] = fmaxf(round_to<T>(xr[g][r] + xk[g][r]), 0.f);
          xk[g][r] = xr[g][r];
        } else {
          const float xs = static_cast<float>(s_x[g * plane + at + r * h.W]);
          xr[g][r] = fmaxf(round_to<T>(xr[g][r] + xs), 0.f);
        }
      }
    if (blk + 1 < blocks) {
      publish(xr, s_x, plane, at, h.W, owner);
      __syncthreads();
    }
  }

#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (!owner || s0 + g >= n_streams) continue;
    T* o = out + ((size_t)(s0 + g) * A + a) * cp + e0;
#pragma unroll
    for (int r = 0; r < kR; ++r) o[r * P] = static_cast<T>(xr[g][r]);
  }
}

template <typename T, int kC, int kP, int kB, int kG>
int launch(const float* x, const float* taps, const float* bias,
           const float* lnp, T* out, int n_streams, int A, int C, int P,
           int blocks, cudaStream_t stream) {
  const int threads = cta_threads(C, P);
  const size_t smem = (2 * (threads / 32) * kG * 2 +
                       (size_t)2 * blocks * kTapStride) * sizeof(float) +
                      2 * (size_t)kG * HaloPlane<T>(P).elems(C) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        router_chain_kernel<T, kC, kP, kB, kG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(A, (n_streams + kG - 1) / kG);
  router_chain_kernel<T, kC, kP, kB, kG><<<grid, threads, smem, stream>>>(
      x, taps, bias, lnp, out, n_streams, A, C, P, blocks);
  return (int)cudaGetLastError();
}

template <typename T, int kC, int kP, int kB>
int launch_group(const float* x, const float* taps, const float* bias,
                 const float* lnp, T* out, int n_streams, int A, int C,
                 int P, int blocks, int group, cudaStream_t s) {
  switch (group) {
    case 1:
      return launch<T, kC, kP, kB, 1>(x, taps, bias, lnp, out, n_streams, A,
                                      C, P, blocks, s);
    case 2:
      return launch<T, kC, kP, kB, 2>(x, taps, bias, lnp, out, n_streams, A,
                                      C, P, blocks, s);
    case 4:
      return launch<T, kC, kP, kB, 4>(x, taps, bias, lnp, out, n_streams, A,
                                      C, P, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_shape(const float* x, const float* taps, const float* bias,
                 const float* lnp, T* out, int N, int A, int C, int P,
                 int blocks, int group, cudaStream_t s) {
  if (C == 64 && P == 36 && blocks == 4)
    return launch_group<T, 64, 36, 4>(x, taps, bias, lnp, out, N / A, A, C, P,
                                      blocks, group, s);
  return launch_group<T, 0, 0, 0>(x, taps, bias, lnp, out, N / A, A, C, P,
                                  blocks, group, s);
}

}  // namespace

// x: [N, C, P] float32 with N a multiple of A (plane n belongs to anchor
// n % A, stream n / A); out: [N, C, P], float32, or bf16 when `bf16` is
// nonzero (the bf16 mode); taps: [A, blocks * 18]; bias: [A, blocks * 2];
// lnp: [2 + 4 * blocks, C, P]. `group`: planes of one anchor a CTA (1, 2
// or 4; ops/router_chain.py::router_plan). Returns a cudaError_t (0 =
// launched). Shapes the kernel does not take (C not a multiple of 8, or
// more than 512 threads: C * P > 4096) return cudaErrorInvalidValue.
extern "C" int router_chain_launch(const float* x, const float* taps,
                                   const float* bias, const float* lnp,
                                   void* out, int N, int A, int C, int P,
                                   int blocks, void* stream, int group,
                                   int bf16) {
  if (A <= 0 || C <= 0 || P <= 0 || N % A != 0 || C % kR != 0 ||
      cta_threads(C, P) > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_shape(x, taps, bias, lnp, static_cast<__nv_bfloat16*>(out),
                        N, A, C, P, blocks, group, s);
  return launch_shape(x, taps, bias, lnp, static_cast<float*>(out), N, A, C, P,
                      blocks, group, s);
}
