// Lane NMS from a stream's predictions to its keeps, in one launch: one CTA
// per stream.
//
// Replaces the TPU kernel phnet_tpu/ops/nms_pallas.py::_nms_kernel together
// with what lane_nms_pallas and PHNet._nms_keeps do around it (the argsort,
// the strip windows, the scatter of the keeps and the gather of the kept
// rows). Proposal j is suppressed by a kept i when their strip windows
// overlap (max(start) <= min(end)) and sum |xs_i - xs_j| over the overlap is
// < thresh * overlap length; at most top_k proposals are kept.
//
// The greedy walk over the stable descending score order keeps exactly the
// proposals that repeated picking gives: pick the valid, unsuppressed, not
// yet kept proposal of highest score (ties to the lowest index), keep it,
// suppress what it suppresses, stop at top_k picks or when none is left.
// The predicate is symmetric in floating point (|a - b| = |b - a|, the same
// window, the same summation order), so a later pick never suppresses an
// earlier keep, and every row the walk passes over between two keeps is
// kept or suppressed already. So there is no sort: each step is one
// block-wide argmax, and the pick sequence is keep_idx in anchor order, so
// there is no scatter either.
//
// What bounds it on an H100: latency. A stream reads ~41 KB (240 rows of
// 43 floats; OpenLane-V: ~75 KB, rows of 78) and does at most
// top_k * A * O adds; the floor is the launch,
// the load and top_k dependent picks. What the design does about it: the
// stream's rows are copied whole into shared memory by cp.async, 16 bytes
// a copy where the block is aligned, every copy in flight at once, while
// each thread loads its rows' start_y, length and score from device
// memory. Each pick is a warp max of a 64-bit key, one barrier (the
// partials are double buffered, so no second one) and a max over the
// warps' partials in a fixed order; each thread then tests the rows it
// owns against the pick. At the path's shape (O = 36, A <= 256: one row a
// thread) O is a template parameter: the thread's key, window and scaled
// xs sit in registers, the warp max is one redux.sync of the score half
// and a ballot for the lowest lane, and a test reads the pick's scaled xs
// as 9 broadcast float4s and makes 36 dependent adds. Other shapes
// (OpenLane-V's O = 72 among them) read both rows from shared memory and
// scale the xs where they are used.

// Bit-equality with the plain PyTorch version (phnet_torch/ops/nms.py):
// the strip windows are computed with the _rn intrinsics, so nvcc cannot
// contract start_y * n_strips + 0.5 (or the ends expression) into an fma
// that PyTorch's separately rounded passes do not compute; the end is the
// whole-expression trunc clamped to n_offsets - 1; the score key counts
// -0.0 as +0.0 and ranks NaN below every other score, as the stable
// argsort does. The distance is summed over the points in ascending order;
// the plain version's torch.sum adds in another order, which can decide a
// distance exactly at thresh * count differently.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRowsPerThread = 32;  // bits of the candidate mask
constexpr int kPathOffsets = 36;    // the path's O, unrolled

struct Params {
  const float* rows;            // [B, A, dim]
  const float* scores;          // (b, j) at b * score_sb + j * score_sa
  long long score_sb, score_sa;
  const unsigned char* valid;   // [B, A] bool, or null: score >= conf
  float* kept;                  // [B, top_k, dim], or null
  long long* keep_idx;          // [B, top_k], -1 past the picks
  long long* num_kept;          // [B]
  unsigned char* keep_mask;     // [B, A] bool
  int A, dim, col_start, col_len, col_xs, n_offsets, top_k;
  float xs_scale, len_scale, conf, thresh;
  bool copy16;                  // rows 16-byte aligned, A * dim % 4 == 0
};

// Shared memory: the warps' partials [2][kMaxWarps] and the keys [A] (8
// bytes each); from 16-byte boundaries the rows [A][dim] and, at the path's
// shape, the scaled xs [A][O]; the strip windows [A] (int2) and the picks
// [top_k].
struct Layout {
  size_t rows, xs, win, bytes;
  __host__ __device__ Layout(int A, int dim, int O, int top_k,
                             bool unrolled) {
    rows = ((2 * kMaxWarps + (size_t)A) * 8 + 15) / 16 * 16;
    xs = (rows + (size_t)A * dim * sizeof(float) + 15) / 16 * 16;
    win = xs + (unrolled ? (size_t)A * O * sizeof(float) : 0);
    bytes = win + (size_t)A * sizeof(int2) + (size_t)top_k * sizeof(int);
  }
};

// Candidate key: the score in an order-preserving unsigned map in the high
// half (-0.0 as +0.0, NaN as 1, below every other score), ~index in the
// low half (ties to the lowest index). Neither half is ever 0, so 0 means
// "no candidate".
__device__ __forceinline__ unsigned long long score_key(float s, int j) {
  unsigned int u = 1;
  if (!isnan(s)) {
    const unsigned int bits = __float_as_uint(s == 0.f ? 0.f : s);
    u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  }
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)j);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// The warp's largest key: by score, then by the lowest index.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  const unsigned int h = (unsigned int)(v >> 32);
  const unsigned int hi = __reduce_max_sync(0xffffffffu, h);
  const unsigned int lo =
      __reduce_max_sync(0xffffffffu, h == hi ? (unsigned int)v : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned int)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned int)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// The strip window of a row: separately rounded, as PyTorch computes it.
__device__ __forceinline__ int2 strip_window(float start_y, float length,
                                             int O) {
  const int start = __float2int_rz(
      truncf(__fadd_rn(__fmul_rn(start_y, (float)(O - 1)), 0.5f)));
  const float e = __fsub_rn(__fsub_rn(__fadd_rn((float)start, length), 0.5f),
                            __fsub_rn(length, 1.f) < 0.f ? 1.f : 0.f);
  return make_int2(start, min(__float2int_rz(truncf(e)), O - 1));
}

// Whether the pick (window wi, scaled xs xi(q)) suppresses a row (window
// wj, scaled xs xj(q)): the distance is summed over every point in
// ascending order, out-of-window points adding +0.0, so it is the exact
// ascending sum over the window.
template <int kO, typename Xi, typename Xj>
__device__ __forceinline__ bool suppresses(int2 wi, int2 wj, Xi xi, Xj xj,
                                           int O, float thresh) {
  const int ps = max(wi.x, wj.x), pe = min(wi.y, wj.y);
  if (pe < ps) return false;
  const int lo = max(ps, 0);
  float dist = 0.f;
  if (pe >= lo) {
    const unsigned int span = (unsigned int)(pe - lo);
#pragma unroll
    for (int q = 0; q < (kO > 0 ? kO : O); ++q) {
      const float d = fabsf(__fsub_rn(xi(q), xj(q)));
      dist = __fadd_rn(dist, (unsigned int)(q - lo) <= span ? d : 0.f);
    }
  }
  return dist < __fmul_rn(thresh, (float)(pe - ps + 1));
}

// kO > 0: O = kO (a multiple of 4) and A <= blockDim.x, one row a thread,
// its state in registers; kO = 0: any O, up to kRowsPerThread rows a
// thread.
template <int kO>
__global__ void __launch_bounds__(kMaxThreads) lane_nms_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int A = p.A, dim = p.dim, O = kO > 0 ? kO : p.n_offsets;
  const Layout lay(A, dim, O, p.top_k, kO > 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  unsigned long long* s_part = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* s_key = s_part + 2 * kMaxWarps;         // [A]
  float* s_rows = reinterpret_cast<float*>(smem + lay.rows);  // [A][dim]
  float* s_xs = reinterpret_cast<float*>(smem + lay.xs);      // [A][kO]
  int2* s_win = reinterpret_cast<int2*>(smem + lay.win);      // [A]
  int* s_pick = reinterpret_cast<int*>(s_win + A);            // [top_k]

  const int b = blockIdx.x;
  const float* g_rows = p.rows + (size_t)b * A * dim;

  // the rows, every copy in flight at once
  const int n = A * dim;
  if (p.copy16) {
    for (int e = 4 * tid; e < n; e += 4 * nthreads)
      copy_async16(s_rows + e, g_rows + e);
  } else {
    for (int e = tid; e < n; e += nthreads) copy_async4(s_rows + e, g_rows + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (tid < 2 * kMaxWarps) s_part[tid] = 0;  // absent warps' stay 0
  // meanwhile, from device memory: the strip windows, keys and candidate
  // bits of the rows this thread owns (j = tid + r * nthreads)
  unsigned int cand = 0, kept_bits = 0;
  unsigned long long my_key = 0;
  int2 my_win = make_int2(0, -1);
  for (int r = 0, j = tid; j < A; ++r, j += nthreads) {
    const float* row = g_rows + (size_t)j * dim;
    const float s = p.scores[b * p.score_sb + j * p.score_sa];
    const bool valid = p.valid ? p.valid[(size_t)b * A + j] != 0
                               : s >= p.conf;
    const int2 w = strip_window(row[p.col_start],
                                __fmul_rn(row[p.col_len], p.len_scale), O);
    s_win[j] = w;
    if constexpr (kO > 0) {
      my_key = score_key(s, j);
      my_win = w;
    } else {
      s_key[j] = score_key(s, j);
    }
    cand |= (unsigned int)valid << r;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // kO > 0: the thread's scaled xs, also stored for the picks to read
  // as float4s (the first pick's barrier orders the stores and the reads)
  float own[kO > 0 ? kO : 1];
  if constexpr (kO > 0) {
    if (tid < A) {
#pragma unroll
      for (int q = 0; q < kO; q += 4) {
        float4 v;
        v.x = own[q] = __fmul_rn(s_rows[tid * dim + p.col_xs + q], p.xs_scale);
        v.y = own[q + 1] =
            __fmul_rn(s_rows[tid * dim + p.col_xs + q + 1], p.xs_scale);
        v.z = own[q + 2] =
            __fmul_rn(s_rows[tid * dim + p.col_xs + q + 2], p.xs_scale);
        v.w = own[q + 3] =
            __fmul_rn(s_rows[tid * dim + p.col_xs + q + 3], p.xs_scale);
        *reinterpret_cast<float4*>(s_xs + tid * kO + q) = v;
      }
    }
  }

  int picks = 0;  // the same in every thread: all reduce the same partials
#pragma unroll 1
  for (int k = 0; k < p.top_k; ++k) {
    unsigned long long best = 0;
    if constexpr (kO > 0) {  // one row a lane: the lowest lane wins a tie
      const unsigned int h = cand & 1u ? (unsigned int)(my_key >> 32) : 0u;
      const unsigned int hi = __reduce_max_sync(0xffffffffu, h);
      const int first = __ffs(__ballot_sync(0xffffffffu, h == hi)) - 1;
      if (hi) best = (unsigned long long)hi << 32 |
                     (0xFFFFFFFFu - (unsigned int)(warp * 32 + first));
    } else {
      for (int r = 0, j = tid; j < A; ++r, j += nthreads)
        if (cand >> r & 1u) best = umax64(best, s_key[j]);
      best = warp_max(best);
    }
    unsigned long long* part = s_part + (k & 1) * kMaxWarps;
    if (lane == 0) part[warp] = best;
    __syncthreads();
    best = 0;
#pragma unroll
    for (int w = 0; w < kMaxWarps; w += 2) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(part + w);
      best = umax64(best, umax64(v.x, v.y));
    }
    if (best == 0) break;
    const int i = (int)(0xFFFFFFFFu - (unsigned int)best);
    if (tid == 0) s_pick[k] = i;
    picks = k + 1;

    // drop the candidates that i suppresses, i itself included
    const int2 wi = s_win[i];
    if constexpr (kO > 0) {
      if (cand & 1u) {
        bool drop = tid == i;
        if (drop) {
          kept_bits = 1u;
        } else {
          float xi[kO];
#pragma unroll
          for (int q = 0; q < kO; q += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(s_xs + i * kO + q);
            xi[q] = v.x, xi[q + 1] = v.y, xi[q + 2] = v.z, xi[q + 3] = v.w;
          }
          drop = suppresses<kO>(wi, my_win, [&](int q) { return xi[q]; },
                                [&](int q) { return own[q]; }, O, p.thresh);
        }
        if (drop) cand = 0;
      }
    } else {
      const float* xi = s_rows + i * dim + p.col_xs;
      for (int r = 0, j = tid; j < A; ++r, j += nthreads) {
        if (!(cand >> r & 1u)) continue;
        bool drop = j == i;
        if (drop) {
          kept_bits |= 1u << r;
        } else {
          const float* xj = s_rows + j * dim + p.col_xs;
          drop = suppresses<0>(
              wi, s_win[j], [&](int q) { return __fmul_rn(xi[q], p.xs_scale); },
              [&](int q) { return __fmul_rn(xj[q], p.xs_scale); }, O,
              p.thresh);
        }
        if (drop) cand &= ~(1u << r);
      }
    }
  }
  __syncthreads();  // s_pick

  for (int k = tid; k < p.top_k; k += nthreads)
    p.keep_idx[(size_t)b * p.top_k + k] = k < picks ? s_pick[k] : -1;
  if (tid == 0) p.num_kept[b] = picks;
  for (int r = 0, j = tid; j < A; ++r, j += nthreads)
    p.keep_mask[(size_t)b * A + j] = (unsigned char)(kept_bits >> r & 1u);
  if (p.kept) {  // empty slots hold row 0, as a gather at clamp(idx, 0) does
    float* g_kept = p.kept + (size_t)b * p.top_k * dim;
    for (int e = tid; e < p.top_k * dim; e += nthreads) {
      const int k = e / dim, c = e - k * dim;
      g_kept[e] = s_rows[(k < picks ? s_pick[k] : 0) * dim + c];
    }
  }
}

// One instance's launch; its dynamic shared memory limit is raised once
// per process, to the largest size launched so far.
template <int kO>
int launch(const Params& p, int B, int threads, cudaStream_t stream) {
  const size_t smem = Layout(p.A, p.dim, p.n_offsets, p.top_k, kO > 0).bytes;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        lane_nms_kernel<kO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  if (B > 0) lane_nms_kernel<kO><<<B, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// B streams of A rows of `dim` floats; columns col_start (start_y), col_len
// (length) and col_xs .. col_xs + n_offsets - 1 (xs); lengths are scaled by
// len_scale and xs by xs_scale on the way in. valid may be null (then
// score >= conf), kept may be null (no gather). Returns a cudaError_t:
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int lane_nms_launch(const float* rows, const float* scores,
                               long long score_sb, long long score_sa,
                               const unsigned char* valid, float* kept,
                               long long* keep_idx, long long* num_kept,
                               unsigned char* keep_mask, int B, int A, int dim,
                               int col_start, int col_len, int col_xs,
                               int n_offsets, float xs_scale, float len_scale,
                               float conf, float thresh, int top_k,
                               void* stream) {
  const int threads = A <= kMaxThreads ? (A + 31) / 32 * 32 : kMaxThreads;
  if (A <= 0 || n_offsets <= 0 || top_k < 0 || A > kRowsPerThread * threads ||
      col_start < 0 || col_start >= dim || col_len < 0 || col_len >= dim ||
      col_xs < 0 || col_xs + n_offsets > dim)
    return (int)cudaErrorInvalidValue;
  const bool copy16 = (size_t)rows % 16 == 0 && (size_t)A * dim % 4 == 0;
  const Params p{rows, scores, score_sb, score_sa, valid, kept, keep_idx,
                 num_kept, keep_mask, A, dim, col_start, col_len, col_xs,
                 n_offsets, top_k, xs_scale, len_scale, conf, thresh,
                 copy16};
  if (n_offsets == kPathOffsets && A <= kMaxThreads)
    return launch<kPathOffsets>(p, B, threads, (cudaStream_t)stream);
  return launch<0>(p, B, threads, (cudaStream_t)stream);
}
