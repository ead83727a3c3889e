// Exact rescore of each query's probed IVF cells, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rescore_kernel` in src/repro/kernels/ann_match.py
// (launched by `cell_rescore_pallas` through `pl.pallas_call`): the second
// level of the two-level ANN match.  The gallery shard is stored cell-major,
// each cell padded to L rows, as a (K*L, D) array; for query i and probe
// slot j the kernel scores the valid rows of cell ids[i, j] and keeps the
// query's top-k over all its probed cells.
//
// Contract kept from the TPU kernel:
//   * scores are IEEE fp32 dots (FMAs on the CUDA cores: no TF32, no tensor
//     cores); the query may be L2-normalized in the kernel, as
//     q * 1/sqrt(max(sum q^2, 1e-18)); an int8 row's score is multiplied by
//     the row's fp32 scale after the dot;
//   * rows at or past cell_lens[cid], and every row of a probe with cid = -1,
//     never enter the top-k;
//   * the output is (Q, k) scores and padded positions cid * L + row, with
//     (NEG, -1) in slots that no valid row fills;
//   * ties: the TPU kernel merges its carried top-k ahead of each new cell
//     and takes the first maximum, so among equal scores the earlier probe
//     slot wins, then the lower row in the cell.  This kernel ranks by the
//     order key j * L + row and turns it into cid * L + row only when it
//     stores the result.
//
// What bounds it on an H100: the bytes of the probed cells' valid rows.  At
// the serving shape (one query, 8 probes of cells of a few hundred rows)
// that is about a megabyte per shard, well under a microsecond at 3.35 TB/s,
// so the kernel is bound by launch and memory latency, not by bandwidth.
// The design spreads the probed rows over many blocks, so the latency of a
// cell's rows is paid once in parallel, and reads only valid rows: the probe
// table and cell_lens drive the pointer arithmetic, so pad rows and cid = -1
// probes are never touched (the TPU kernel DMAs the whole (L, D) tile and
// clamps cid = -1 to tile 0).
//
// Design:
//   pass 1, `rescore_partial_kernel`: grid (Q*c (query, slot) pairs, chunks of
//     kRows rows of the cell); one warp a block.  The warp stages its query in
//     shared memory (fp32, normalized if asked), then scores the chunk's
//     valid rows kBatch at a time: each lane reads one 16-byte piece of each
//     row (rows of at most 512 bytes, 16-byte aligned) or single elements
//     otherwise, and a butterfly shuffle sums each row's dot on every lane.
//     The warp keeps the chunk's top-k in a WarpTopK list and writes it as a
//     (Q, c*chunks, k) partial.
//   pass 2, `rescore_merge_kernel`: one warp per query merges the c*chunks*k
//     partials with the same list and stores scores and padded positions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "match_common.cuh"  // kMaxK, kNeg, to_f32, WarpTopK, merge_partials

namespace {

constexpr int kRows = 32;      // rows of one cell per block
constexpr int kBatch = 8;      // rows a warp has in flight at once
constexpr int kMaxD = 512;     // the staged query's shared-memory size

__device__ __forceinline__ float warp_sum(float x) {
  // a butterfly: every lane ends with the same sum, bit for bit
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Dot of one 16-byte piece of a row with the matching query values.
template <typename TG>
__device__ __forceinline__ float piece_dot(const uint4& v, const float* q) {
  const TG* p = reinterpret_cast<const TG*>(&v);
  float acc = 0.0f;
#pragma unroll
  for (int e = 0; e < 16 / (int)sizeof(TG); ++e) acc = fmaf(q[e], to_f32(p[e]), acc);
  return acc;
}

// VEC: each row is at most 32 pieces of 16 bytes and 16-byte aligned.
template <typename TQ, typename TG, bool VEC>
__global__ void __launch_bounds__(32)
rescore_partial_kernel(const TQ* __restrict__ q, const TG* __restrict__ cells,
                       const float* __restrict__ scale,
                       const int* __restrict__ ids, const int* __restrict__ lens,
                       int c, int D, int L, int k, int fuse_norm,
                       float* __restrict__ part_s, int* __restrict__ part_i) {
  __shared__ float q_s[kMaxD];
  const int lane = threadIdx.x;
  const int pair = blockIdx.x;                 // i * c + j
  const int qi = pair / c, slot = pair % c;
  const int chunk = blockIdx.y;
  const int cid = ids[pair];
  const int n_valid = cid < 0 ? 0 : lens[cid];
  const int r0 = chunk * kRows;
  const int r1 = min(r0 + kRows, n_valid);
  WarpTopK top;
  top.init();
  if (r0 < r1) {                               // warp-uniform
    float ss = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = to_f32(q[(size_t)qi * D + d]);
      q_s[d] = v;
      ss = fmaf(v, v, ss);
    }
    if (fuse_norm) {
      const float inv = 1.0f / sqrtf(fmaxf(warp_sum(ss), 1e-18f));
      for (int d = lane; d < D; d += 32) q_s[d] *= inv;
    }
    __syncwarp();
    const TG* cell = cells + (size_t)cid * L * D;
    const float* cell_scale = scale != nullptr ? scale + (size_t)cid * L : nullptr;
    constexpr int kEPP = 16 / (int)sizeof(TG);  // values a 16-byte piece
    const int pieces = D / kEPP;
    for (int r = r0; r < r1; r += kBatch) {
      float acc[kBatch];
      if constexpr (VEC) {
        const uint4* g4 = reinterpret_cast<const uint4*>(cell);
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = (lane < pieces && r + u < r1)
                     ? __ldg(g4 + (size_t)(r + u) * pieces + lane)
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          acc[u] = lane < pieces ? piece_dot<TG>(v[u], q_s + lane * kEPP) : 0.0f;
      } else {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) acc[u] = 0.0f;
        for (int d = lane; d < D; d += 32) {
          const float qv = q_s[d];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (r + u < r1) acc[u] = fmaf(qv, to_f32(cell[(size_t)(r + u) * D + d]), acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r + u < r1) {                      // warp-uniform
          float s = warp_sum(acc[u]);
          if (cell_scale != nullptr) s *= cell_scale[r + u];
          top.offer(s, slot * L + r + u, k);
        }
      }
    }
  }
  const size_t o = ((size_t)pair * gridDim.y + chunk) * k;
  top.store(part_s + o, part_i + o, k);
}

// One warp per query: merge its c*chunks*k partials, then turn each order
// key slot * L + row into the padded position ids[qi, slot] * L + row.
__global__ void __launch_bounds__(32)
rescore_merge_kernel(const float* __restrict__ part_s,
                     const int* __restrict__ part_i, const int* __restrict__ ids,
                     int c, int chunks, int L, int k, float* __restrict__ out_s,
                     int* __restrict__ out_i) {
  const int qi = blockIdx.x;
  const int n = c * chunks * k;
  WarpTopK top;
  top.init();
  merge_partials(part_s + (size_t)qi * n, part_i + (size_t)qi * n, n, k, top);
  const int* qids = ids + (size_t)qi * c;
  if (top.i0 >= 0) top.i0 = qids[top.i0 / L] * L + top.i0 % L;
  if (top.i1 >= 0) top.i1 = qids[top.i1 / L] * L + top.i1 % L;
  top.store(out_s + (size_t)qi * k, out_i + (size_t)qi * k, k);
}

template <typename TQ, typename TG>
int launch(const void* q, const void* cells, const float* scale,
           const int* ids, const int* lens, int Q, int c, int D, int L, int k,
           int fuse_norm, float* part_s, int* part_i, float* out_s,
           int* out_i, cudaStream_t stream) {
  const int chunks = (L + kRows - 1) / kRows;
  const size_t row_bytes = (size_t)D * sizeof(TG);
  const bool vec = row_bytes % 16 == 0 && row_bytes <= 32 * 16 &&
                   reinterpret_cast<uintptr_t>(cells) % 16 == 0;
  auto kern = vec ? &rescore_partial_kernel<TQ, TG, true>
                  : &rescore_partial_kernel<TQ, TG, false>;
  const dim3 grid((unsigned)Q * (unsigned)c, chunks);
  kern<<<grid, 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TG*>(cells), scale, ids,
      lens, c, D, L, k, fuse_norm, part_s, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rescore_merge_kernel<<<Q, 32, 0, stream>>>(part_s, part_i, ids, c, chunks,
                                              L, k, out_s, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cr_max_k() { return kMaxK; }
int cr_max_d() { return kMaxD; }
int cr_chunk_rows() { return kRows; }

// dtype: 0 = fp32 query and cells, 1 = bf16 query and cells, 2 = fp32 query
// with int8 cells and their fp32 per-row scale.  ids (Q, c) and lens (K,)
// are int32; part_s/part_i hold (Q, c, ceil(L / cr_chunk_rows()), k);
// out_s/out_i hold (Q, k).  Returns a cudaError_t code: 0 when both launches
// were accepted.
int cr_rescore(int dtype, const void* q, const void* cells, const void* scale,
               const void* ids, const void* lens, int Q, int c, int D, int L,
               int k, int fuse_norm, void* part_s, void* part_i, void* out_s,
               void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || Q < 1 || c < 1 || D < 1 || D > kMaxD || L < 1 ||
      (L + kRows - 1) / kRows > 65535 || (long long)Q * c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pid = static_cast<const int*>(ids);
  const int* pl = static_cast<const int*>(lens);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  switch (dtype) {
    case 0:
      return launch<float, float>(q, cells, nullptr, pid, pl, Q, c, D, L, k,
                                  fuse_norm, ps, pi, os, oi, st);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, cells, nullptr, pid, pl,
                                                  Q, c, D, L, k, fuse_norm,
                                                  ps, pi, os, oi, st);
    case 2:
      return launch<float, int8_t>(q, cells, static_cast<const float*>(scale),
                                   pid, pl, Q, c, D, L, k, fuse_norm, ps, pi,
                                   os, oi, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* cr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
