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
//     q * 1/sqrt(max(sum q^2, 1e-18)); a query for bf16 cells is rounded to
//     bf16 first; an int8 row's score is multiplied by the row's fp32 scale
//     after the dot;
//   * rows at or past cell_lens[cid], and every row of a probe with cid = -1,
//     are never loaded and never enter the top-k;
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
// so the kernel is bound by launch and memory latency, not by bandwidth:
// its time is the chain of dependent steps a call takes (the probe table,
// then the cell's length, then the rows, then the merge).  The probe table
// and cell_lens drive the pointer arithmetic, so pad rows and cid = -1
// probes are never touched (the TPU kernel DMAs the whole (L, D) tile and
// clamps cid = -1 to tile 0).  Two paths, chosen by the wrapper
// (`ann_match.plan`):
//
// fused path (D = 128, 16-byte aligned cells: every serving call), one
//   launch of `rescore_fused_kernel`.  Grid: Q * c (query, slot) pairs x
//   `chunks` blocks of W warps, each block making `passes` passes (W,
//   passes and chunks from `plan`: 4-warp one-pass blocks while every row
//   of the call fits in flight at once, else 1-warp blocks making passes).
//   In a pass, warp w takes the next 16 / 16 / 32 rows (fp32 / bf16 /
//   int8) of its pair's cell: 8 lanes a row, each with 16-byte loads of
//   every 8th chunk of the row (4 / 2 / 1 chunks a lane), so every lane
//   loads and all the warp's loads of the pass are in flight together.
//   Each lane loads its 16 query values (rounded to bf16 for bf16 cells)
//   into registers and normalizes them while the probe table and the
//   cell's length are looked up; no shared-memory stage.  The loads are
//   predicated on row < cell_lens[cid], and a block whose rows lie past
//   the cell's valid rows ends its passes.  The dots widen each chunk in
//   registers (`widen`) and are summed over the row's 8 lanes by the
//   transposing reduction (`row_sums`).  Results are (score, key) words
//   whose unsigned order is the lists' (`pack`).
//   k = 1: each warp's best word, then the block's, goes into the query's
//     word with one atomicMax, and the block counts its arrival on the
//     query's count; the last of the query's c * chunks blocks takes the
//     word (leaving 0), leaves the count at 0 and stores the result.
//   k > 1: each pass ranks the block's candidates and its list so far by
//     counts in shared memory into the next list; the block stores its
//     list as its partial and arrives; the last block ranks the query's
//     partials (only those at or above a bound on the k-th) and stores
//     the result.
//   Words and lists order by (score, key) with unique keys, so the result
//   depends neither on block order nor on the grid.
//
// two-pass path (every other call: D != 128, a misaligned array),
//   `rescore_partial_kernel` + `rescore_merge_kernel`:
//   pass 1: grid (Q*c (query, slot) pairs, chunks of kRows rows of the cell);
//     one warp a block.  The warp stages its query in shared memory (fp32,
//     normalized if asked), then scores the chunk's valid rows kBatch at a
//     time: each lane reads one 16-byte piece of each row (rows of at most
//     512 bytes, 16-byte aligned) or single elements otherwise, and a
//     butterfly shuffle sums each row's dot on every lane.  The warp keeps
//     the chunk's top-k in a WarpTopK list and writes it as a (Q, c*chunks,
//     k) partial.
//   pass 2: one warp per query merges the c*chunks*k partials with the same
//     list and stores scores and padded positions.
//   Rows wider than kMaxD values are scored in chunks of kMaxD: the warp
//   stages each chunk of its query in turn, and each lane's dot goes on
//   accumulating over the same values in the same order.
//   k above kMaxK (the most entries a warp's list holds): ceil(k / kMaxK)
//   rounds of the two kernels, one after another on the stream, each
//   finding the next kMaxK entries.  The order (score descending, then the
//   order key) is total, so round r admits only the rows that rank strictly
//   after the last entry of round r - 1 for that query (read from the
//   output, where that round left its order key); a block whose query has
//   run out of rows scores nothing.  Every round takes this path, so every
//   row's dot is summed in the same order in each.  A last kernel turns the
//   order keys into padded positions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "match_common.cuh"  // kMaxK, kNeg, to_f32, the 8-lanes-a-row layout
                              // (RowGroup, widen, row_sums), WarpTopK,
                              // merge_partials

namespace {

constexpr int kRows = 32;      // rows of one cell per block
constexpr int kBatch = 8;      // rows a warp has in flight at once
constexpr int kMaxD = 512;     // the staged query's shared-memory size:
                               // wider rows are scored a chunk at a time

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
// after_s / after_i: a later round's cursor (ld_after apart a query), null
// in the first round.
template <typename TQ, typename TG, bool VEC>
__global__ void __launch_bounds__(32)
rescore_partial_kernel(const TQ* __restrict__ q, const TG* __restrict__ cells,
                       const float* __restrict__ scale,
                       const int* __restrict__ ids, const int* __restrict__ lens,
                       int c, int D, int L, int k, int fuse_norm,
                       const float* __restrict__ after_s,
                       const int* __restrict__ after_i, int ld_after,
                       float* __restrict__ part_s, int* __restrict__ part_i) {
  __shared__ float q_s[kMaxD];
  const int lane = threadIdx.x;
  const int pair = blockIdx.x;                 // i * c + j
  const int qi = pair / c, slot = pair % c;
  const int chunk = blockIdx.y;
  const int cid = ids[pair];
  const bool cursor = after_i != nullptr;
  const float cur_s = cursor ? after_s[(size_t)qi * ld_after] : 0.0f;
  const int cur_i = cursor ? after_i[(size_t)qi * ld_after] : -1;
  // a query that ran out of rows in the round before scores nothing
  const int n_valid = cid < 0 || (cursor && cur_i < 0) ? 0 : lens[cid];
  const int r0 = chunk * kRows;
  const int r1 = min(r0 + kRows, n_valid);
  const bool wide = D > kMaxD;                 // VEC is false then
  WarpTopK top;
  top.init();
  if (r0 < r1) {                               // warp-uniform
    float ss = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = to_f32(q[(size_t)qi * D + d]);
      if (!wide) q_s[d] = v;
      ss = fmaf(v, v, ss);
    }
    float inv = 1.0f;
    if (fuse_norm) {
      inv = 1.0f / sqrtf(fmaxf(warp_sum(ss), 1e-18f));
      if (!wide)
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
        // one chunk of kMaxD values at a time; a lane takes values lane,
        // lane + 32, ... of the row in order, however it is chunked
        for (int d0 = 0; d0 < D; d0 += kMaxD) {
          const int dc = min(kMaxD, D - d0);
          if (wide) {                          // this chunk of the query
            __syncwarp();
            for (int d = lane; d < dc; d += 32)
              q_s[d] = to_f32(q[(size_t)qi * D + d0 + d]) * inv;
            __syncwarp();
          }
          for (int d = lane; d < dc; d += 32) {
            const float qv = q_s[d];
#pragma unroll
            for (int u = 0; u < kBatch; ++u)
              if (r + u < r1)
                acc[u] = fmaf(qv, to_f32(cell[(size_t)(r + u) * D + d0 + d]), acc[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (r + u < r1) {                      // warp-uniform
          float s = warp_sum(acc[u]);
          if (cell_scale != nullptr) s *= cell_scale[r + u];
          const int key = slot * L + r + u;
          if (!cursor || better(cur_s, cur_i, s, key)) top.offer(s, key, k);
        }
      }
    }
  }
  const size_t o = ((size_t)pair * gridDim.y + chunk) * k;
  top.store(part_s + o, part_i + o, k);
}

// One warp per query: merge its c*chunks*k partials into row qi of the
// result (ld_out apart a query); unless `keys`, turn each order key
// slot * L + row into the padded position ids[qi, slot] * L + row.
__global__ void __launch_bounds__(32)
rescore_merge_kernel(const float* __restrict__ part_s,
                     const int* __restrict__ part_i, const int* __restrict__ ids,
                     int c, int chunks, int L, int k, float* __restrict__ out_s,
                     int* __restrict__ out_i, int ld_out, int keys) {
  const int qi = blockIdx.x;
  const int n = c * chunks * k;
  WarpTopK top;
  top.init();
  merge_partials(part_s + (size_t)qi * n, part_i + (size_t)qi * n, n, k, top);
  const int* qids = ids + (size_t)qi * c;
  if (!keys) {
    if (top.i0 >= 0) top.i0 = qids[top.i0 / L] * L + top.i0 % L;
    if (top.i1 >= 0) top.i1 = qids[top.i1 / L] * L + top.i1 % L;
  }
  top.store(out_s + (size_t)qi * ld_out, out_i + (size_t)qi * ld_out, k);
}

// After several rounds: every order key of the (Q, k) result into its
// padded position, one block a query.
__global__ void keys_to_positions_kernel(const int* __restrict__ ids, int c,
                                         int L, int k, int* __restrict__ out_i) {
  const int qi = blockIdx.x;
  const int* qids = ids + (size_t)qi * c;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int key = out_i[(size_t)qi * k + t];
    if (key >= 0) out_i[(size_t)qi * k + t] = qids[key / L] * L + key % L;
  }
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
  const bool rounds = k > kMaxK;               // several: keys until the end
  for (int c0 = 0; c0 < k; c0 += kMaxK) {
    const int kr = min(kMaxK, k - c0);
    kern<<<grid, 32, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TG*>(cells), scale, ids,
        lens, c, D, L, kr, fuse_norm, c0 ? out_s + c0 - 1 : nullptr,
        c0 ? out_i + c0 - 1 : nullptr, k, part_s, part_i);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rescore_merge_kernel<<<Q, 32, 0, stream>>>(part_s, part_i, ids, c, chunks,
                                                L, kr, out_s + c0, out_i + c0,
                                                k, (int)rounds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (rounds)
    keys_to_positions_kernel<<<Q, 128, 0, stream>>>(ids, c, L, k, out_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused path
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 4;      // warps a block of the fused path, at most
constexpr int kFp32Groups = 2;    // groups of rows a warp in fp32: 16 rows,
                                  // as bf16's one group

// A query value as the kernel scores it against TG cells: a query for bf16
// cells is rounded to bf16 first (one that is bf16 already stays as it is).
template <typename TG, typename TQ>
__device__ __forceinline__ float query_value(TQ x) {
  if constexpr (std::is_same<TG, __nv_bfloat16>::value &&
                std::is_same<TQ, float>::value)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return to_f32(x);
}

// (score, key) as one 64-bit word whose unsigned order is the lists' order:
// the score's bits made monotonic (-0 taken as +0, as the lists compare it)
// above 2^32 - 1 - key.  0 is no entry.
__device__ __forceinline__ unsigned long long pack(float s, int key) {
  const unsigned b = __float_as_uint(s + 0.0f);
  const unsigned hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)hi << 32) | (0xffffffffu - (unsigned)key);
}
__device__ __forceinline__ float packed_score(unsigned long long w) {
  const unsigned hi = (unsigned)(w >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}
__device__ __forceinline__ int packed_key(unsigned long long w) {
  return w == 0ull ? -1 : (int)(0xffffffffu - (unsigned)w);
}

// How many of the n words at p (shared memory) rank above w: a count with
// no early exit, 8 independent loads in flight.
__device__ __forceinline__ int count_above(const unsigned long long* p, int n,
                                           unsigned long long w) {
  int a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int f = 0;
  for (; f + 8 <= n; f += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] += p[f + u] > w;
  }
  for (; f < n; ++f) a[0] += p[f] > w;
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// The same over words in global memory that other blocks wrote.
__device__ __forceinline__ int count_above_global(
    const unsigned long long* p, int n, unsigned long long w) {
  int a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int f = 0;
  for (; f + 8 <= n; f += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) a[u] += __ldcg(p + f + u) > w;
  }
  for (; f < n; ++f) a[0] += __ldcg(p + f) > w;
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// NG groups of rows a warp, all loaded before any is scored; `passes`
// passes of the block over consecutive rows; K1: k = 1.
template <typename TQ, typename TG, int NG, bool K1>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
rescore_fused_kernel(const TQ* __restrict__ q, const TG* __restrict__ cells,
                     const float* __restrict__ scale,
                     const int* __restrict__ ids, const int* __restrict__ lens,
                     int c, int L, int k, int fuse_norm, int chunks,
                     int passes, unsigned long long* __restrict__ part,
                     unsigned* __restrict__ arrivals,
                     unsigned long long* __restrict__ best,
                     float* __restrict__ out_s, int* __restrict__ out_i) {
  using G = RowGroup<TG>;
  constexpr int kWarpRows = NG * G::kRows;
  constexpr int kPool = 512;
  static_assert(kMaxWarps * kWarpRows <= kPool, "a pass fits the pool");
  __shared__ unsigned long long pool[kPool];   // a pass's candidates, then
                                               // the last block's partials
  __shared__ unsigned long long run[2][kMaxK]; // k > 1: the block's list so
                                               // far, and the next one
  __shared__ unsigned long long wbest[kMaxWarps];
  __shared__ unsigned long long surv[kPool];   // the last block's words
                                               // that can be in the top k
  __shared__ int slot_cid[32];                 // its probe table, count of
  __shared__ int n_filled, n_surv;             // words and of those words
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int j = lane % kLPR;                // which 8th of the row's chunks
  const int p = lane / kLPR;                // which row of a step
  const int pair = blockIdx.x / chunks;     // qi * c + slot
  const int chunk = blockIdx.x - pair * chunks;
  const int qi = pair / c, slot = pair - qi * c;
  const int blocks = c * chunks;            // the query's blocks
  const int n_pool = W * kWarpRows;         // rows a block scores a pass
  const int b0 = chunk * passes * n_pool;   // the block's first row

  // the probe, the query's probe table (lane l holds slot l, which the
  // last block needs) and this lane's query values are loaded together
  const int cid = ids[pair];
  const int lane_cid = lane < c ? ids[(size_t)qi * c + lane] : -1;
  float qr[G::kQE];
#pragma unroll
  for (int cc = 0; cc < G::kC; ++cc)
#pragma unroll
    for (int e = 0; e < G::kEPC; ++e)
      qr[cc * G::kEPC + e] = query_value<TG>(
          q[(size_t)qi * kRowD + (j + kLPR * cc) * G::kEPC + e]);
  const int n_valid = cid < 0 ? 0 : lens[cid];
  if (fuse_norm) {                          // the same sum in every lane
    float ss = 0.0f;
#pragma unroll
    for (int e = 0; e < G::kQE; ++e) ss = fmaf(qr[e], qr[e], ss);
#pragma unroll
    for (int o = 1; o < kLPR; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-18f));
#pragma unroll
    for (int e = 0; e < G::kQE; ++e) qr[e] *= inv;
  }

  // Lane (j, p) ends each pass with the dot of row w0 + g * kRows + own of
  // each of its warp's groups g, and is the one lane of its replicas that
  // offers it if `owner`.
  const int own = ((j >> (3 - G::kTLevels)) * kStepRows) + p;
  const bool owner = (j & ((1 << (3 - G::kTLevels)) - 1)) == 0;
  const uint4* g4 = reinterpret_cast<const uint4*>(cells) +
                    (size_t)(cid < 0 ? 0 : cid) * L * G::kRowChunks;
  unsigned long long mine = 0ull;           // K1: this lane's best so far
  int cur = 0;                              // k > 1: run[cur] is the list
  for (int t = threadIdx.x; !K1 && t < k; t += blockDim.x) run[0][t] = 0ull;
  if (!K1 && threadIdx.x == 0) n_filled = n_surv = 0;
  for (int pass = 0; pass < passes; ++pass) {
    if (b0 + pass * n_pool >= n_valid) break;   // block-uniform: done
    const int w0 = b0 + pass * n_pool + warp * kWarpRows;
    float sn[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) sn[g] = kNeg;
    if (w0 < n_valid) {                     // warp-uniform: every load in
      uint4 v[NG][G::kV][G::kC];            // flight, then the dots
      float sc[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int s = 0; s < G::kV; ++s) {
          const int row = w0 + g * G::kRows + s * kStepRows + p;
#pragma unroll
          for (int cc = 0; cc < G::kC; ++cc)
            v[g][s][cc] = row < n_valid
                ? __ldg(g4 + (size_t)row * G::kRowChunks + j + kLPR * cc)
                : make_uint4(0u, 0u, 0u, 0u);
        }
        const int row = w0 + g * G::kRows + own;
        sc[g] = 1.0f;
        if constexpr (sizeof(TG) == 1)
          sc[g] = row < n_valid ? __ldg(scale + (size_t)cid * L + row) : 0.0f;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float acc[G::kV];
#pragma unroll
        for (int s = 0; s < G::kV; ++s) acc[s] = 0.0f;
#pragma unroll
        for (int s = 0; s < G::kV; ++s)
#pragma unroll
          for (int cc = 0; cc < G::kC; ++cc) {
            float x[G::kEPC];
            widen(v[g][s][cc], x);
#pragma unroll
            for (int e = 0; e < G::kEPC; ++e)
              acc[s] = fmaf(qr[cc * G::kEPC + e], x[e], acc[s]);
          }
        sn[g] = row_sums<G::kV>(acc, lane);
        if constexpr (sizeof(TG) == 1) sn[g] *= sc[g];  // int8: scale after the dot
      }
    }
    if constexpr (K1) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int row = w0 + g * G::kRows + own;
        if (owner && row < n_valid)
          mine = max(mine, pack(sn[g], slot * L + row));
      }
    } else {
      // the pass's candidates and the list so far, as words, through
      // shared memory: each that fewer than k of them rank before goes to
      // that place of the next list (a candidate that does not beat the
      // list's k-th cannot); each rank is a count over all of them
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (owner) {
          const int row = w0 + g * G::kRows + own;
          pool[(warp * NG + g) * G::kRows + own] =
              row < n_valid ? pack(sn[g], slot * L + row) : 0ull;
        }
      for (int t = threadIdx.x; t < k; t += blockDim.x) run[cur ^ 1][t] = 0ull;
      __syncthreads();
      const unsigned long long* rl = run[cur];
      const unsigned long long kth = rl[k - 1];
      for (int e = threadIdx.x; e < n_pool + k; e += blockDim.x) {
        const unsigned long long w = e < n_pool ? pool[e] : rl[e - n_pool];
        if (w == 0ull || w < kth) continue;
        const int rank = count_above(pool, n_pool, w) + count_above(rl, k, w);
        if (rank < k) run[cur ^ 1][rank] = w;
      }
      __syncthreads();
      cur ^= 1;
    }
  }

  if constexpr (K1) {
    // k = 1: the warp's best word, the block's best of those into the
    // query's word with one atomicMax, then the arrival; the last block
    // takes the word (leaving 0), and the count back to 0
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mine = max(mine, __shfl_xor_sync(0xffffffffu, mine, o));
    if (lane == 0) wbest[warp] = mine;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long b = 0ull;
      for (int w = 0; w < W; ++w) b = max(b, wbest[w]);
      if (b != 0ull) atomicMax(best + qi, b);
      __threadfence();                      // the word, then arrive
      last = atomicAdd(arrivals + qi, 1u) == (unsigned)blocks - 1;
      if (last) {
        __threadfence();
        wbest[0] = atomicExch(best + qi, 0ull);
        arrivals[qi] = 0u;
      }
    }
    __syncthreads();
    if (!last || warp != 0) return;
    const unsigned long long b = wbest[0];
    const int key = packed_key(b);
    const int s = key >= 0 ? key / L : 0;
    int id = __shfl_sync(0xffffffffu, lane_cid, s & 31);
    if (lane == 0) {
      if (s >= 32) id = ids[(size_t)qi * c + s];
      out_s[qi] = key >= 0 ? packed_score(b) : kNeg;
      out_i[qi] = key >= 0 ? id * L + key % L : -1;
    }
    return;
  } else {
    // k > 1: the block's list is its partial; then the arrival
    __syncthreads();
    for (int t = threadIdx.x; t < k; t += blockDim.x)
      part[(size_t)blockIdx.x * k + t] = run[cur][t];
    __threadfence();                        // this block's partial, then arrive
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(arrivals + qi, 1u) == (unsigned)blocks - 1;
    __syncthreads();
    if (!last) return;

    // the last block of the query: its partials are the query's blocks'
    // lists, each sorted.  A list whose k places are filled has k words
    // at or above its k-th, so the query's k-th is at or above the best
    // of those (tau), and only words at or above tau are ranked, each by
    // a count over all the words; one of rank below k is stored there,
    // its key turned into ids[qi, slot] * L + row, and sentinels fill the
    // places past the query's words.  The words go through shared memory
    // if they fit (as they do unless k or the blocks a query are large).
    __threadfence();
    const int total = blocks * k;
    const unsigned long long* pw = part + (size_t)qi * total;
    const bool staged = total <= kPool;     // block-uniform
    int filled = 0;
    unsigned long long tau = 0ull;
    for (int e0 = threadIdx.x; e0 < total; e0 += 8 * blockDim.x) {
      unsigned long long w[8];              // 8 loads in flight a thread
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        w[u] = e < total ? __ldcg(pw + e) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        filled += w[u] != 0ull;
        if (e % k == k - 1) tau = max(tau, w[u]);
        if (staged && e < total) pool[e] = w[u];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tau = max(tau, __shfl_xor_sync(0xffffffffu, tau, o));
    if (lane == 0) wbest[warp] = tau;
    if (warp == 0) slot_cid[lane] = lane_cid;
    if (filled) atomicAdd(&n_filled, filled);
    __syncthreads();
    for (int v = 0; v < W; ++v) tau = max(tau, wbest[v]);
    // the words at or above tau, gathered (they are few), then one count
    // each over all the words
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const unsigned long long w = staged ? pool[e] : __ldcg(pw + e);
      if (w != 0ull && w >= tau) {
        const int at = atomicAdd(&n_surv, 1);
        if (at < kPool) surv[at] = w;
      }
    }
    __syncthreads();
    const int n = n_surv;                   // block-uniform
    for (int e = threadIdx.x; e < (n <= kPool ? n : total);
         e += blockDim.x) {
      const unsigned long long w =
          n <= kPool ? surv[e] : staged ? pool[e] : __ldcg(pw + e);
      if (w == 0ull || w < tau) continue;
      const int rank = staged ? count_above(pool, total, w)
                              : count_above_global(pw, total, w);
      if (rank < k) {
        const int key = packed_key(w);
        const int sl = key / L;
        const int id = sl < 32 ? slot_cid[sl] : ids[(size_t)qi * c + sl];
        out_s[(size_t)qi * k + rank] = packed_score(w);
        out_i[(size_t)qi * k + rank] = id * L + key % L;
      }
    }
    for (int t = n_filled + threadIdx.x; t < k; t += blockDim.x) {
      out_s[(size_t)qi * k + t] = kNeg;
      out_i[(size_t)qi * k + t] = -1;
    }
    if (threadIdx.x == 0) arrivals[qi] = 0u;
  }
}

// The fused kernel for TQ / TG with NG groups of rows a warp.
template <typename TQ, typename TG, int NG>
int launch_fused(const void* q, const void* cells, const float* scale,
                 const int* ids, const int* lens, int Q, int c, int L, int k,
                 int fuse_norm, int warps, int passes, int chunks,
                 unsigned long long* part, unsigned* arrivals,
                 unsigned long long* best, float* out_s, int* out_i,
                 cudaStream_t stream) {
  const int rows = passes * warps * NG * RowGroup<TG>::kRows;  // a block's
  if (passes < 1 || chunks != (L + rows - 1) / rows ||
      (long long)Q * c * chunks > 0x7fffffffLL ||
      (long long)c * chunks * k > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  auto kern = k == 1 ? &rescore_fused_kernel<TQ, TG, NG, true>
                     : &rescore_fused_kernel<TQ, TG, NG, false>;
  kern<<<Q * c * chunks, warps * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TG*>(cells), scale, ids,
      lens, c, L, k, fuse_norm, chunks, passes, part, arrivals, best, out_s,
      out_i);
  return (int)cudaGetLastError();
}

// The latency floor: a kernel that does nothing, on a grid of one's choice.
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int cr_max_k() { return kMaxK; }
int cr_max_d() { return kMaxD; }
int cr_chunk_rows() { return kRows; }

// The two-pass path, at any k and D.  dtype: 0 = fp32 query and cells,
// 1 = bf16 query and cells, 2 = fp32 query with int8 cells and their fp32
// per-row scale.  ids (Q, c) and lens (K,) are int32; part_s/part_i hold
// (Q, c, ceil(L / cr_chunk_rows()), min(k, cr_max_k())); out_s/out_i hold
// (Q, k).  ceil(k / cr_max_k()) rounds of two launches, and one more launch
// where there are several.  Returns a cudaError_t code: 0 when every launch
// was accepted.
int cr_rescore(int dtype, const void* q, const void* cells, const void* scale,
               const void* ids, const void* lens, int Q, int c, int D, int L,
               int k, int fuse_norm, void* part_s, void* part_i, void* out_s,
               void* out_i, void* stream) {
  if (k < 1 || Q < 1 || c < 1 || D < 1 || L < 1 ||
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

int cr_max_warps() { return kMaxWarps; }
int cr_warp_rows(int dtype) {
  switch (dtype) {
    case 0: return kFp32Groups * RowGroup<float>::kRows;
    case 1: case 3: return RowGroup<__nv_bfloat16>::kRows;
    case 2: return RowGroup<int8_t>::kRows;
    default: return 0;
  }
}

// The fused path: D = kRowD (128) and cells 16-byte aligned; one launch.
// dtype as cr_rescore's, plus 3 = fp32 query with bf16 cells (the kernel
// rounds the query to bf16).  A block of `warps` (1, 2 or 4) warps
// makes `passes` passes over cr_warp_rows(dtype) rows a warp, and each
// (query, slot) pair has `chunks` = ceil(L / (passes * warps * those))
// blocks.  `part` holds (Q, c, chunks, k) 64-bit words (k > 1); `arrivals` holds
// Q unsigned ints and `best` Q unsigned 64-bit words (k = 1), all 0 before
// the launch and left at 0 by it (the wrapper keeps them for each device
// and stream, and zeroes them after an error).  Returns a cudaError_t
// code: 0 when the launch was accepted.
int cr_rescore_fused(int dtype, const void* q, const void* cells,
                     const void* scale, const void* ids, const void* lens,
                     int Q, int c, int D, int L, int k, int fuse_norm,
                     int warps, int passes, int chunks, void* part,
                     void* arrivals, void* best, void* out_s, void* out_i,
                     void* stream) {
  if (k < 1 || k > kMaxK || Q < 1 || c < 1 || D != kRowD || L < 1 ||
      (warps != 1 && warps != 2 && warps != kMaxWarps) ||
      (long long)c * L > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(cells) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pid = static_cast<const int*>(ids);
  const int* pl = static_cast<const int*>(lens);
  unsigned long long* pw = static_cast<unsigned long long*>(part);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  unsigned long long* pb = static_cast<unsigned long long*>(best);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  switch (dtype) {
    case 0:
      return launch_fused<float, float, kFp32Groups>(
          q, cells, nullptr, pid, pl, Q, c, L, k, fuse_norm, warps, passes,
          chunks, pw, arr, pb, os, oi, st);
    case 1:
      return launch_fused<__nv_bfloat16, __nv_bfloat16, 1>(
          q, cells, nullptr, pid, pl, Q, c, L, k, fuse_norm, warps, passes,
          chunks, pw, arr, pb, os, oi, st);
    case 2:
      return launch_fused<float, int8_t, 1>(
          q, cells, static_cast<const float*>(scale), pid, pl, Q, c, L, k,
          fuse_norm, warps, passes, chunks, pw, arr, pb, os, oi, st);
    case 3:
      return launch_fused<float, __nv_bfloat16, 1>(
          q, cells, nullptr, pid, pl, Q, c, L, k, fuse_norm, warps, passes,
          chunks, pw, arr, pb, os, oi, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel on `blocks` blocks of `threads` threads: the time of a
// launch that does no work.  Returns a cudaError_t code.
int cr_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* cr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
