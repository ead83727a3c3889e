// Cosine top-k gallery matching for Hopper (sm_90a).
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
// (one to a few queries against a 262,144-row shard) it has to read the
// N*D*itemsize bytes of gallery once and does 2*Q FLOPs per value it reads,
// so it is bound by the memory rate (40 / 20 / 10 us for fp32 / bf16 / int8
// at that shard).  Past about 40 fp32 queries per pass it turns into a bound
// on the fp32 FMA rate instead.  Two paths, chosen by the wrapper
// (`gallery_match.plan`):
//
// small-Q path (Q <= kSmallQ, Q * k <= 32, D = 128, 16-byte aligned rows:
//   above that Q * k the per-warp lists below take more insertions than the
//   path saves), one launch of
//   `match_small_kernel`: a persistent grid (as many 8-warp blocks as fit on
//   the SMs) whose warps all score.  A warp walks groups of rows with a grid
//   stride.  A row is read by 8 lanes, each with 16-byte loads of every 8th
//   chunk (4 chunks a lane in fp32, 2 in bf16, 1 in int8), and a group is 8
//   such loads a lane: 8 / 16 / 32 rows, all loads in flight together.  The
//   next group's loads are issued before this group is scored (the first
//   group's before the query's), except in int8 above 4 queries, where the
//   second set of registers would cost occupancy.  Each lane holds its 16
//   values of every query in registers as fp32 (normalized by each warp
//   once), widens the gallery in registers (bf16 by a 16-bit shift, int8 by
//   placing each byte in the mantissa of 2^23 and subtracting 2^23 + 128,
//   both exact, no I2F), and keeps one partial dot per row of the group.  A
//   transposing reduction over the row's 8 lanes (xor shuffles, each level
//   halving the values a lane holds) leaves one lane of each row with its
//   dot; those lanes filter it into the warp's top-k list with one ballot,
//   and the survivors are offered best first.  Nothing is staged in shared
//   memory and there is no barrier in the row loop.  At the end each block
//   merges its warps' lists through shared memory into one (Q, S, k)
//   partial and counts its arrival; the last block to arrive merges the S
//   partials into the (Q, k) result and resets the count.  Every row's dot
//   is summed in the same order (the reduction pairs lanes j and j^4, then
//   j^2, then j^1, whatever the row's place in its group), so equal rows
//   score equal, and the lists are ordered by (score, index): the result
//   depends neither on block order nor on the grid size.
//
// tiled path (every other call), `match_partial_kernel` + `merge_kernel`:
//   grid (Q tiles of 32, S splits of N).  A block stages its 32 queries in
//   shared memory (fp32, normalized if asked) and walks its contiguous slice
//   of gallery rows in tiles of 64 rows, converted to fp32 in shared memory.
//   Where a row is at most 512 bytes (D = 128 in every storage type), a warp
//   loads whole rows with one 16-byte load a lane and fetches the next tile
//   into registers while the block scores this one.  Warp w owns queries
//   4w..4w+3 and lane l scores rows l and l+32 of the tile for them, so a
//   warp's scores stay in its registers.  Each warp keeps, per query, a
//   sorted top-k list spread over its lanes (entries l and l+32 in lane l); a
//   score enters only if it beats the k-th entry, found with one ballot, and
//   is inserted with a warp-wide shift.  The block writes its lists as (Q, S,
//   k) partials, and one warp per query merges them into the (Q, k) result.
//   Rows wider than kMaxD values are scored in chunks of kMaxD: the block
//   stages each chunk of its queries and of the tile in turn, and the dots
//   go on accumulating in the same registers, in the same order.
//
// k above kMaxK (the most entries a warp's list holds): the call runs
//   ceil(k / kMaxK) rounds of the tiled path, one after another on the
//   stream, each finding the next kMaxK entries.  The order (score
//   descending, index ascending) is total, so round r admits only the rows
//   that rank strictly after the last entry of round r - 1 for that query
//   (read from the output, where that round stored it); a block whose
//   queries have all run out of rows scores nothing.  Every round takes the
//   same path, so every row's dot is summed in the same order in each: no
//   row moves by an ulp between rounds to be lost or repeated.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "match_common.cuh"  // kMaxK, kNeg, to_f32, the 8-lanes-a-row layout
                              // (RowGroup, widen, row_sums), WarpTopK,
                              // merge_partials

namespace {

constexpr int kWarps = 8;                  // warps per block in pass 1
constexpr int kQPerWarp = 4;               // queries each warp owns
constexpr int kBQ = kWarps * kQPerWarp;    // queries per block
constexpr int kTN = 64;                    // gallery rows per shared tile
constexpr int kMaxD = 512;                 // row values staged at once

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
// this one.  Otherwise every thread loads single elements.  WIDE: rows of
// more than kMaxD values, staged and scored a chunk of kMaxD at a time.
// after_s / after_i: a later round's cursor (ld_after apart a query), null
// in the first round.
template <typename TQ, typename TG, bool VEC, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
match_partial_kernel(const TQ* __restrict__ q, const TG* __restrict__ g,
                     const float* __restrict__ scale, int Q, int N, int D,
                     int k, int fuse_norm, int rows_per_split,
                     const float* __restrict__ after_s,
                     const int* __restrict__ after_i, int ld_after,
                     float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ float smem[];
  const int DC = WIDE ? kMaxD : D;      // row values staged at once
  float* q_s = smem;                    // (kBQ, DC)
  float* g_s = smem + kBQ * DC;         // (kTN, DC + 1): the pad keeps the
                                        // lanes' rows in distinct banks
  __shared__ float q_inv[kBQ];          // WIDE: each query's 1 / norm, or 1
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int qw = q0 + warp * kQPerWarp;   // this warp's first query

  // a later round's cursor: each query's last entry of the round before
  const bool cursor = after_i != nullptr;
  float cur_s[kQPerWarp];
  int cur_i[kQPerWarp];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    const bool has = cursor && qw + j < Q;
    cur_s[j] = has ? after_s[(size_t)(qw + j) * ld_after] : 0.0f;
    cur_i[j] = has ? after_i[(size_t)(qw + j) * ld_after] : -1;
  }
  // block-uniform: false once every query of the block has run out of rows
  const bool live = !cursor || __syncthreads_or(
      tid < kBQ && q0 + tid < Q &&
      after_i[(size_t)(q0 + tid) * ld_after] >= 0);

  if constexpr (!WIDE) {
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
  } else {
    // the same sum of squares as above, read from device memory; each
    // chunk is staged later already scaled by its query's 1 / norm
    for (int j = 0; j < kQPerWarp; ++j) {
      const int qi = qw + j;
      float ss = 0.0f;
      if (fuse_norm && qi < Q) {          // warp-uniform
        for (int d = lane; d < D; d += 32) {
          const float v = to_f32(q[(size_t)qi * D + d]);
          ss += v * v;
        }
      }
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0)
        q_inv[warp * kQPerWarp + j] =
            fuse_norm ? 1.0f / sqrtf(fmaxf(ss, 1e-18f)) : 1.0f;
    }
  }

  WarpTopK top[kQPerWarp];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) top[j].init();
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
  if constexpr (VEC) {
    if (live) fetch(n_begin);
  }

  for (int t0 = n_begin; live && t0 < n_end; t0 += kTN) {
    const int rows = min(kTN, n_end - t0);
    float acc[kQPerWarp][2];
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) acc[j][0] = acc[j][1] = 0.0f;
    if constexpr (!WIDE) {
      __syncthreads();                    // the previous tile is consumed
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
      if (qw >= Q) continue;              // warp-uniform: no live query
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
    } else {
      // a chunk at a time: the block's queries and the tile, that chunk of
      // each, into shared memory, then its multiply-adds
      for (int d0 = 0; d0 < D; d0 += kMaxD) {
        const int dc = min(kMaxD, D - d0);
        __syncthreads();                  // the previous chunk is consumed
        for (int e = tid; e < kBQ * dc; e += blockDim.x) {
          const int r = e / dc, c = e % dc;
          const int qi = q0 + r;
          q_s[r * dc + c] =
              qi < Q ? to_f32(q[(size_t)qi * D + d0 + c]) * q_inv[r] : 0.0f;
        }
        for (int e = tid; e < kTN * dc; e += blockDim.x) {
          const int r = e / dc, c = e % dc;
          g_s[r * (dc + 1) + c] =
              r < rows ? to_f32(g[(size_t)(t0 + r) * D + d0 + c]) : 0.0f;
        }
        __syncthreads();
        if (qw >= Q) continue;            // warp-uniform: no live query
        const float* ga = g_s + lane * (dc + 1);
        const float* gb = g_s + (lane + 32) * (dc + 1);
        const float* qa = q_s + warp * kQPerWarp * dc;
        for (int d = 0; d < dc; ++d) {
          const float va = ga[d], vb = gb[d];
#pragma unroll
          for (int j = 0; j < kQPerWarp; ++j) {
            const float qv = qa[j * dc + d];
            acc[j][0] = fmaf(qv, va, acc[j][0]);
            acc[j][1] = fmaf(qv, vb, acc[j][1]);
          }
        }
      }
      if (qw >= Q) continue;
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
      // candidates in ascending row order: rows t0+0..31, then t0+32..63;
      // in a later round only those that rank after the cursor
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        const float s = acc[j][h];
        const bool after = !cursor ||
            (cur_i[j] >= 0 && better(cur_s[j], cur_i[j], s, t0 + r));
        unsigned m = __ballot_sync(0xffffffffu, r < rows && after &&
                                                better(s, t0 + r, ts, ti));
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

// One warp per query: merge its S*k partials into row qi of the result,
// ld_out apart a query.
__global__ void __launch_bounds__(32)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             int S, int k, float* __restrict__ out_s, int* __restrict__ out_i,
             int ld_out) {
  const int qi = blockIdx.x;
  const int n = S * k;
  WarpTopK top;
  top.init();
  merge_partials(part_s + (size_t)qi * n, part_i + (size_t)qi * n, n, k, top);
  top.store(out_s + (size_t)qi * ld_out, out_i + (size_t)qi * ld_out, k);
}

// The tiled path: ceil(k / kMaxK) rounds of the two kernels, round r
// filling columns r * kMaxK on of the (Q, k) result.
template <typename TQ, typename TG>
int launch(const void* q, const void* g, const float* scale, int Q, int N,
           int D, int k, int fuse_norm, int splits, float* part_s,
           int* part_i, float* out_s, int* out_i, cudaStream_t stream) {
  const int rows_per_split = (N + splits - 1) / splits;
  const bool wide = D > kMaxD;
  const size_t dc = wide ? kMaxD : D;
  const size_t smem = sizeof(float) * ((size_t)kBQ * dc + (size_t)kTN * (dc + 1));
  const size_t row_bytes = (size_t)D * sizeof(TG);
  const bool vec = row_bytes % 16 == 0 && row_bytes <= 32 * 16 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0;
  auto kern = wide ? &match_partial_kernel<TQ, TG, false, true>
              : vec ? &match_partial_kernel<TQ, TG, true, false>
                    : &match_partial_kernel<TQ, TG, false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kBQ - 1) / kBQ, splits);
  for (int c0 = 0; c0 < k; c0 += kMaxK) {
    const int kr = min(kMaxK, k - c0);
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const TQ*>(q), static_cast<const TG*>(g), scale, Q, N, D,
        kr, fuse_norm, rows_per_split, c0 ? out_s + c0 - 1 : nullptr,
        c0 ? out_i + c0 - 1 : nullptr, k, part_s, part_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    merge_kernel<<<Q, 32, 0, stream>>>(part_s, part_i, splits, kr,
                                       out_s + c0, out_i + c0, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// The small-Q path
// ---------------------------------------------------------------------------

constexpr int kSmallQ = 8;        // the most queries the path takes (Q_S)
constexpr int kSmallD = 128;      // the row width it takes
static_assert(kSmallD == kRowD, "the row layout is for 128-wide rows");
constexpr int kSW = 8;            // warps a block
static_assert(kSmallQ <= kSW, "a block merges one query per warp");

template <typename TQ, typename TG, int NQ>
__global__ void __launch_bounds__(kSW * 32, NQ <= 2 ? 2 : 1)
match_small_kernel(const TQ* __restrict__ q, const TG* __restrict__ g,
                   const float* __restrict__ scale, int N, int k,
                   int fuse_norm, float* __restrict__ part_s,
                   int* __restrict__ part_i, unsigned* __restrict__ arrivals,
                   float* __restrict__ out_s, int* __restrict__ out_i) {
  using L = RowGroup<TG>;
  // load the next group while scoring this one, except where the second
  // set of registers would cost int8 its occupancy (measured slower, and
  // spilling at 8 queries)
  constexpr bool kPrefetch = sizeof(TG) > 1 || NQ <= 4;
  extern __shared__ float smem[];      // (NQ, kSW, k) scores, then indices
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = lane % kLPR;            // which 8th of the row's chunks
  const int p = lane / kLPR;            // which row of a step

  // the group row whose dot this lane ends with, and whether it is the one
  // lane of its replicas that offers it
  const int own = ((j >> (3 - L::kTLevels)) * kStepRows) + p;
  const bool owner = (j & ((1 << (3 - L::kTLevels)) - 1)) == 0;
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  const int groups = (N + L::kRows - 1) / L::kRows;

  // a group's loads (and its owner rows' int8 scales) into registers
  auto load = [&](int grp, uint4 (&v)[L::kV][L::kC], float& sc) {
    const int base = grp * L::kRows;
#pragma unroll
    for (int s = 0; s < L::kV; ++s) {
      const int row = base + s * kStepRows + p;
#pragma unroll
      for (int c = 0; c < L::kC; ++c)
        v[s][c] = row < N
            ? __ldg(g4 + (size_t)row * L::kRowChunks + j + kLPR * c)
            : make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (sizeof(TG) == 1)
      sc = base + own < N ? __ldg(scale + base + own) : 0.0f;
  };
  const int first = blockIdx.x * kSW + warp;
  const int stride = gridDim.x * kSW;
  uint4 nv[L::kV][L::kC];
  float nsc = 1.0f;
  // with the prefetch, the first group's loads fly during the query's
  if (kPrefetch && first < groups) load(first, nv, nsc);

  // this lane's query values: chunks j, j + 8, ... of each query, in fp32
  float qr[NQ][L::kQE];
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
#pragma unroll
    for (int c = 0; c < L::kC; ++c)
#pragma unroll
      for (int e = 0; e < L::kEPC; ++e)
        qr[n][c * L::kEPC + e] =
            to_f32(q[n * kSmallD + (j + kLPR * c) * L::kEPC + e]);
    if (fuse_norm) {                    // the same sum in every lane
      float ss = 0.0f;
#pragma unroll
      for (int e = 0; e < L::kQE; ++e) ss = fmaf(qr[n][e], qr[n][e], ss);
#pragma unroll
      for (int o = 1; o < kLPR; o <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      const float inv = 1.0f / sqrtf(fmaxf(ss, 1e-18f));
#pragma unroll
      for (int e = 0; e < L::kQE; ++e) qr[n][e] *= inv;
    }
  }

  WarpTopK top[NQ];
#pragma unroll
  for (int n = 0; n < NQ; ++n) top[n].init();
  for (int grp = first; grp < groups; grp += stride) {
    if (!kPrefetch) load(grp, nv, nsc);
    uint4 v[L::kV][L::kC];
#pragma unroll
    for (int s = 0; s < L::kV; ++s)
#pragma unroll
      for (int c = 0; c < L::kC; ++c) v[s][c] = nv[s][c];
    const float sc = nsc;
    if (kPrefetch && grp + stride < groups) load(grp + stride, nv, nsc);
    const int row = grp * L::kRows + own;

    float acc[NQ][L::kV];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int s = 0; s < L::kV; ++s) acc[n][s] = 0.0f;
#pragma unroll
    for (int s = 0; s < L::kV; ++s)
#pragma unroll
      for (int c = 0; c < L::kC; ++c) {
        float x[L::kEPC];
        widen(v[s][c], x);
#pragma unroll
        for (int e = 0; e < L::kEPC; ++e)
#pragma unroll
          for (int n = 0; n < NQ; ++n)
            acc[n][s] = fmaf(qr[n][c * L::kEPC + e], x[e], acc[n][s]);
      }
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float sn = row_sums<L::kV>(acc[n], lane);
      if constexpr (sizeof(TG) == 1) sn *= sc;   // int8: scale after the dot
      float ts; int ti;
      top[n].kth(k, ts, ti);
      top[n].offer_all(__ballot_sync(0xffffffffu, owner && row < N &&
                                                  better(sn, row, ts, ti)),
                       sn, row, k);
    }
  }

  // the block's warps' lists -> one (NQ, k) partial of this block
  float* bs = smem;
  int* bi = reinterpret_cast<int*>(smem + NQ * kSW * k);
#pragma unroll
  for (int n = 0; n < NQ; ++n)
    top[n].store(bs + (n * kSW + warp) * k, bi + (n * kSW + warp) * k, k);
  __syncthreads();
  const int S = gridDim.x;
  if (warp < NQ) {
    WarpTopK t;
    t.init();
    merge_partials<true>(bs + warp * kSW * k, bi + warp * kSW * k, kSW * k,
                         k, t);
    const size_t o = ((size_t)warp * S + blockIdx.x) * k;
    t.store(part_s + o, part_i + o, k);
  }

  // the last block to arrive merges the S partials of each query: kSW / NQ
  // warps a query, each over a share of them, then one of them over their
  // lists; it leaves the arrival count at 0 for the next launch
  __shared__ bool last;
  __threadfence();                      // this block's partial, then arrive
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals, 1u) == (unsigned)S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int wpq = kSW / NQ;
  const int n = warp / wpq, w = warp % wpq;
  if (n < NQ) {
    const int total = S * k;
    const int lo = (int)((long long)total * w / wpq);
    const int hi = (int)((long long)total * (w + 1) / wpq);
    WarpTopK t;
    t.init();
    merge_partials<true, 4, true>(part_s + (size_t)n * total + lo,
                                  part_i + (size_t)n * total + lo, hi - lo, k,
                                  t);
    t.store(bs + warp * k, bi + warp * k, k);
  }
  __syncthreads();
  if (n < NQ && w == 0) {
    WarpTopK t;
    t.init();
    merge_partials<true>(bs + warp * k, bi + warp * k, wpq * k, k, t);
    t.store(out_s + (size_t)n * k, out_i + (size_t)n * k, k);
  }
  if (threadIdx.x == 0) *arrivals = 0u;
}

// Dispatch Q in [1, kSmallQ] to its instantiation.
template <typename TQ, typename TG, int NQ = 1>
int launch_small(int Q, const void* q, const void* g, const float* scale,
                 int N, int k, int fuse_norm, int splits, float* part_s,
                 int* part_i, unsigned* arrivals, float* out_s, int* out_i,
                 cudaStream_t stream) {
  if constexpr (NQ < kSmallQ) {
    if (Q > NQ)
      return launch_small<TQ, TG, NQ + 1>(Q, q, g, scale, N, k, fuse_norm,
                                          splits, part_s, part_i, arrivals,
                                          out_s, out_i, stream);
  }
  if (Q != NQ) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NQ * kSW * k * (sizeof(float) + sizeof(int));
  match_small_kernel<TQ, TG, NQ><<<splits, kSW * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TG*>(g), scale, N, k,
      fuse_norm, part_s, part_i, arrivals, out_s, out_i);
  return (int)cudaGetLastError();
}

// Blocks of the small-Q kernel for (TQ, TG, Q) that fit on one SM at once.
template <typename TQ, typename TG, int NQ = 1>
int small_blocks_per_sm(int Q, int k, int* blocks) {
  if constexpr (NQ < kSmallQ) {
    if (Q > NQ) return small_blocks_per_sm<TQ, TG, NQ + 1>(Q, k, blocks);
  }
  if (Q != NQ) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NQ * kSW * k * (sizeof(float) + sizeof(int));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, match_small_kernel<TQ, TG, NQ>, kSW * 32, smem);
}

}  // namespace

extern "C" {

int gm_max_k() { return kMaxK; }

// The tiled path, at any k and D.  dtype: 0 = fp32 query and gallery,
// 1 = bf16 query and gallery, 2 = fp32 query with an int8 gallery and its
// fp32 per-row scale.  part_s/part_i hold (Q, splits, min(k, kMaxK));
// out_s/out_i hold (Q, k).  ceil(k / kMaxK) rounds of two launches each.
// Returns a cudaError_t code: 0 when every launch was accepted.
int gm_match(int dtype, const void* q, const void* g, const void* scale,
             int Q, int N, int D, int k, int fuse_norm, int splits,
             void* part_s, void* part_i, void* out_s, void* out_i,
             void* stream) {
  if (k < 1 || Q < 1 || N < 1 || D < 1 || splits < 1)
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

int gm_small_q() { return kSmallQ; }
int gm_small_d() { return kSmallD; }

// The small-Q path: Q <= gm_small_q(), D = gm_small_d(), the gallery
// 16-byte aligned; the arguments are gm_match's, `splits` the number of
// blocks (see gm_small_blocks_per_sm), and `arrivals` one unsigned int that
// is 0 before the launch and that the launch leaves at 0 (the wrapper keeps
// one for each device and stream, and zeroes it again after an error).
// One launch.  Returns a cudaError_t code.
int gm_match_small(int dtype, const void* q, const void* g, const void* scale,
                   int Q, int N, int D, int k, int fuse_norm, int splits,
                   void* part_s, void* part_i, void* arrivals, void* out_s,
                   void* out_i, void* stream) {
  if (k < 1 || k > kMaxK || Q < 1 || Q > kSmallQ || N < 1 || D != kSmallD ||
      splits < 1 || reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  switch (dtype) {
    case 0:
      return launch_small<float, float>(Q, q, g, nullptr, N, k, fuse_norm,
                                        splits, ps, pi, arr, os, oi, st);
    case 1:
      return launch_small<__nv_bfloat16, __nv_bfloat16>(
          Q, q, g, nullptr, N, k, fuse_norm, splits, ps, pi, arr, os, oi, st);
    case 2:
      return launch_small<float, int8_t>(Q, q, g,
                                         static_cast<const float*>(scale), N,
                                         k, fuse_norm, splits, ps, pi, arr, os,
                                         oi, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// How many blocks of the small-Q kernel for (dtype, Q, k) fit on one SM of
// the current device, into *blocks.  Returns a cudaError_t code.
int gm_small_blocks_per_sm(int dtype, int Q, int k, int* blocks) {
  if (k < 1 || k > kMaxK || Q < 1 || Q > kSmallQ)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return small_blocks_per_sm<float, float>(Q, k, blocks);
    case 1:
      return small_blocks_per_sm<__nv_bfloat16, __nv_bfloat16>(Q, k, blocks);
    case 2: return small_blocks_per_sm<float, int8_t>(Q, k, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
