// Blocked cosine top-k gallery matching for Hopper (sm_90a).
//
// Replaces the TPU kernel `_match_kernel` in src/repro/kernels/gallery_match.py
// (launched by `_launch` through `pl.pallas_call`): scores Q query templates
// against an N-row gallery and keeps the top-k matches per query.
//
// Contract kept from the TPU kernel:
//   * scores are IEEE fp32 dots (FMAs on the CUDA cores: no TF32, no tensor
//     cores), fp32 accumulation for every storage type;
//   * the query may be L2-normalized in the kernel, as q * 1/sqrt(max(sum q^2,
//     1e-18));
//   * an int8 gallery row's score is scaled by the row's fp32 scale *after*
//     the dot;
//   * the top-k is ordered by score descending, then gallery index ascending
//     (so ties go to the lowest index); k is clamped to N by the caller, which
//     also pads the k > N sentinels.
//
// What bounds it on an H100: at the query counts the serving path sends
// (a micro-batch of a few queries) it is memory-bound.  It has to read the
// N*D*itemsize bytes of gallery once per query tile, and does 2*BQ FLOPs per
// gallery element it reads.  Past about 40 fp32 queries per tile it turns
// into a bound on the fp32 FMA rate instead.  The design is simple: the
// gallery is split across blocks so every SM streams its own slice, each
// block reads its slice once for up to 32 queries with wide loads that
// overlap the scoring, and the (Q, N) score matrix never reaches device
// memory.  TMA, wgmma and a fused single pass are left to later work.
//
// Design:
//   pass 1, `match_partial_kernel`: grid (Q tiles of 32, S splits of N).  A
//     block stages its 32 queries in shared memory (fp32, normalized if asked)
//     and walks its contiguous slice of gallery rows in tiles of 64 rows,
//     converted to fp32 in shared memory.  Where a row is at most 512 bytes
//     (D = 128 in every storage type), a warp loads whole rows with one
//     16-byte load a lane and fetches the next tile into registers while
//     the block scores this one.  Warp w owns queries 4w..4w+3 and
//     lane l scores rows l and l+32 of the tile for them, so a warp's scores
//     stay in its registers.  Each warp keeps, per query, a sorted top-k list
//     spread over its lanes (entries l and l+32 in lane l); a score enters
//     only if it beats the k-th entry, found with one ballot, and is inserted
//     with a warp-wide shift.  The block writes its lists as (Q, S, k)
//     partials.
//   pass 2, `merge_kernel`: one warp per query merges the S*k partials with the
//     same list into the (Q, k) result.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "match_common.cuh"  // kMaxK, kNeg, to_f32, WarpTopK, merge_partials

namespace {

constexpr int kWarps = 8;                  // warps per block in pass 1
constexpr int kQPerWarp = 4;               // queries each warp owns
constexpr int kBQ = kWarps * kQPerWarp;    // queries per block
constexpr int kTN = 64;                    // gallery rows per shared tile

// Widen one 16-byte chunk of gallery values to fp32 in shared memory.
template <typename TG>
__device__ __forceinline__ void chunk_to_f32(const uint4& v, float* dst) {
  const TG* p = reinterpret_cast<const TG*>(&v);
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(TG); ++e) dst[e] = to_f32(p[e]);
}

// VEC: each gallery row is at most 32 chunks of 16 bytes and 16-byte
// aligned.  Warp w then loads rows w, w+8, ... of a tile with one 16-byte
// load a lane, and fetches the next tile into registers while it scores
// this one.  Otherwise every thread loads single elements.
template <typename TQ, typename TG, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
match_partial_kernel(const TQ* __restrict__ q, const TG* __restrict__ g,
                     const float* __restrict__ scale, int Q, int N, int D,
                     int k, int fuse_norm, int rows_per_split,
                     float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // (kBQ, D)
  float* g_s = smem + kBQ * D;          // (kTN, D + 1): the pad keeps the
                                        // lanes' rows in distinct banks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);

  for (int e = tid; e < kBQ * D; e += blockDim.x) {
    const int qi = q0 + e / D;
    q_s[e] = qi < Q ? to_f32(q[(size_t)qi * D + e % D]) : 0.0f;
  }
  __syncthreads();
  if (fuse_norm) {
    for (int j = 0; j < kQPerWarp; ++j) {
      float* row = q_s + (warp * kQPerWarp + j) * D;
      float ss = 0.0f;
      for (int d = lane; d < D; d += 32) ss += row[d] * row[d];
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-18f));
      __syncwarp();
      for (int d = lane; d < D; d += 32) row[d] *= inv;
    }
  }

  WarpTopK top[kQPerWarp];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) top[j].init();
  const int qw = q0 + warp * kQPerWarp;   // this warp's first query
  const int stride = D + 1;

  constexpr int kEPC = 16 / (int)sizeof(TG);   // gallery values a chunk
  constexpr int kRowsPerWarp = kTN / kWarps;
  const int row_chunks = D / kEPC;
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  uint4 pre[kRowsPerWarp];
  auto fetch = [&](int t0) {              // VEC: the tile at t0 -> registers
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int n = t0 + warp + kWarps * i;
      pre[i] = (lane < row_chunks && n < n_end)
                   ? __ldg(g4 + (size_t)n * row_chunks + lane)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if constexpr (VEC) fetch(n_begin);

  for (int t0 = n_begin; t0 < n_end; t0 += kTN) {
    __syncthreads();                      // the previous tile is consumed
    const int rows = min(kTN, n_end - t0);
    if constexpr (VEC) {
      if (lane < row_chunks) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          chunk_to_f32<TG>(pre[i], g_s + (warp + kWarps * i) * stride + lane * kEPC);
      }
    } else {
      for (int e = tid; e < kTN * D; e += blockDim.x) {
        const int r = e / D, c = e % D;
        g_s[r * stride + c] = r < rows ? to_f32(g[(size_t)(t0 + r) * D + c]) : 0.0f;
      }
    }
    __syncthreads();
    if constexpr (VEC) {
      if (t0 + kTN < n_end) fetch(t0 + kTN);  // in flight while scoring
    }
    if (qw >= Q) continue;                // warp-uniform: no live query
    float acc[kQPerWarp][2];
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) acc[j][0] = acc[j][1] = 0.0f;
    const float* ga = g_s + lane * stride;
    const float* gb = g_s + (lane + 32) * stride;
    const float* qa = q_s + warp * kQPerWarp * D;
    for (int d = 0; d < D; ++d) {
      const float va = ga[d], vb = gb[d];
#pragma unroll
      for (int j = 0; j < kQPerWarp; ++j) {
        const float qv = qa[j * D + d];
        acc[j][0] = fmaf(qv, va, acc[j][0]);
        acc[j][1] = fmaf(qv, vb, acc[j][1]);
      }
    }
    if (scale != nullptr) {               // int8: per-row scale after the dot
      const float sa = lane < rows ? scale[t0 + lane] : 0.0f;
      const float sb = lane + 32 < rows ? scale[t0 + lane + 32] : 0.0f;
#pragma unroll
      for (int j = 0; j < kQPerWarp; ++j) { acc[j][0] *= sa; acc[j][1] *= sb; }
    }
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) {
      if (qw + j >= Q) continue;          // warp-uniform
      float ts; int ti;
      top[j].kth(k, ts, ti);
      // candidates in ascending row order: rows t0+0..31, then t0+32..63
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        const float s = acc[j][h];
        unsigned m = __ballot_sync(0xffffffffu, r < rows && better(s, t0 + r, ts, ti));
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          const float cs = __shfl_sync(0xffffffffu, s, b);
          top[j].offer(cs, t0 + b + 32 * h, k);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    const int qi = qw + j;
    if (qi >= Q) continue;
    const size_t o = ((size_t)qi * S + split) * k;
    top[j].store(part_s + o, part_i + o, k);
  }
}

// One warp per query: merge its S*k partials into the (Q, k) result.
__global__ void __launch_bounds__(32)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             int S, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  const int qi = blockIdx.x;
  const int n = S * k;
  WarpTopK top;
  top.init();
  merge_partials(part_s + (size_t)qi * n, part_i + (size_t)qi * n, n, k, top);
  top.store(out_s + (size_t)qi * k, out_i + (size_t)qi * k, k);
}

template <typename TQ, typename TG>
int launch(const void* q, const void* g, const float* scale, int Q, int N,
           int D, int k, int fuse_norm, int splits, float* part_s,
           int* part_i, float* out_s, int* out_i, cudaStream_t stream) {
  const int rows_per_split = (N + splits - 1) / splits;
  const size_t smem = sizeof(float) * ((size_t)kBQ * D + (size_t)kTN * (D + 1));
  const size_t row_bytes = (size_t)D * sizeof(TG);
  const bool vec = row_bytes % 16 == 0 && row_bytes <= 32 * 16 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  auto kern = vec ? &match_partial_kernel<TQ, TG, true>
                  : &match_partial_kernel<TQ, TG, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kBQ - 1) / kBQ, splits);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TG*>(g), scale, Q, N, D, k,
      fuse_norm, rows_per_split, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, 32, 0, stream>>>(part_s, part_i, splits, k, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gm_max_k() { return kMaxK; }

// dtype: 0 = fp32 query and gallery, 1 = bf16 query and gallery,
// 2 = fp32 query with an int8 gallery and its fp32 per-row scale.
// part_s/part_i hold (Q, splits, k); out_s/out_i hold (Q, k).
// Returns a cudaError_t code: 0 when both launches were accepted.
int gm_match(int dtype, const void* q, const void* g, const void* scale,
             int Q, int N, int D, int k, int fuse_norm, int splits,
             void* part_s, void* part_i, void* out_s, void* out_i,
             void* stream) {
  if (k < 1 || k > kMaxK || Q < 1 || N < 1 || D < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  switch (dtype) {
    case 0:
      return launch<float, float>(q, g, nullptr, Q, N, D, k, fuse_norm, splits,
                                  ps, pi, os, oi, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, g, nullptr, Q, N, D, k,
                                                  fuse_norm, splits, ps, pi,
                                                  os, oi, st);
    case 2:
      return launch<float, int8_t>(q, g, static_cast<const float*>(scale), Q,
                                   N, D, k, fuse_norm, splits, ps, pi, os, oi,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* gm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
