// What the port's match kernels (gallery_match.cu, cell_rescore.cu) share:
// widening of the storage types to fp32, the 8-lanes-a-row dot reduction,
// and warp-held top-k lists.
//
// Rows of 128 values read by 8 lanes: lane j of a row loads its 16-byte
// chunks j, j + 8, ... (4 in fp32, 2 in bf16, 1 in int8), widens them to
// fp32 in registers (`widen`, exact) and keeps one partial dot per row;
// `row_sums` then adds the 8 partial dots of each row.  Every row's dot is
// summed in the same order wherever the row sits in its group, so equal
// rows score equal.
//
// A list is ordered by score descending, then by a non-negative int key
// ascending (a gallery index, or the rescore's probe-slot order key), so ties
// go to the lowest key.  An entry with key < 0 is empty and ranks after every
// filled one.  One warp holds one list of up to kMaxK entries in registers:
// lane l holds entries l and l + 32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 64;                  // two list entries per lane
constexpr float kNeg = -3.0e38f;           // the TPU kernels' NEG sentinel
constexpr int kLPR = 8;                    // lanes reading one 128-wide row
constexpr int kRowD = 128;                 // the row width of that layout
constexpr int kStepRows = 32 / kLPR;       // rows a warp reads in one step
constexpr int kLoads = 8;                  // 16-byte loads a lane has in
                                           // flight for one group of rows

// The lane layout of a group of 128-wide rows of TG values: kLoads 16-byte
// loads a lane, kV steps of kStepRows rows, kRows = 8 / 16 / 32 rows.
template <typename TG>
struct RowGroup {
  static constexpr int kEPC = 16 / (int)sizeof(TG);      // values a chunk
  static constexpr int kRowChunks = kRowD / kEPC;        // 32 / 16 / 8
  static constexpr int kC = kRowChunks / kLPR;           // chunks a lane a row
  static constexpr int kV = kLoads / kC;                 // steps a group
  static constexpr int kRows = kV * kStepRows;           // rows a group
  static constexpr int kQE = kC * kEPC;                  // query values a lane
  static constexpr int kTLevels = kV == 8 ? 3 : kV == 4 ? 2 : kV == 2 ? 1 : 0;
};


__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// Widen one 16-byte chunk to fp32 in registers, exactly.
__device__ __forceinline__ void widen(const uint4& v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void widen(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {            // bf16 is the top half of an fp32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& v, float (&x)[16]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // b ^ 0x80 is b + 128 as an unsigned byte; as the low mantissa byte of
    // 2^23 (0x4B000000) it is the float 2^23 + b + 128
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * i + b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b))
                     - 8388736.0f;
  }
}

// Sum each of the V partial dots a lane holds over the 8 lanes of its row
// (lane bits 0-2): each transposing level sends half of the values to the
// partner lane and keeps the other half, then the remaining levels are a
// butterfly.  Afterwards value s of the group lives in lanes whose bits
// 2, 1, 0 read s (top bits first), replicated over the low 3 - log2(V) bits.
template <int V>
__device__ __forceinline__ float row_sums(float (&a)[V], int lane) {
#pragma unroll
  for (int lvl = 0; lvl < 3; ++lvl) {
    const int o = (kLPR / 2) >> lvl;
    const int h = V >> (lvl + 1);
    if (h >= 1) {
      const bool hi = lane & o;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float keep = hi ? a[i + h] : a[i];
        const float send = hi ? a[i] : a[i + h];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], o);
    }
  }
  return a[0];
}

// Does (s1, i1) rank before (s2, i2)?
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  if (i2 < 0) return true;
  if (i1 < 0) return false;
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

struct WarpTopK {
  float s0, s1;
  int i0, i1;

  __device__ void init() { s0 = s1 = kNeg; i0 = i1 = -1; }

  // The k-th entry, broadcast to every lane.
  __device__ __forceinline__ void kth(int k, float& s, int& i) const {
    const int slot = k - 1;
    const float ss = slot < 32 ? s0 : s1;
    const int ii = slot < 32 ? i0 : i1;
    s = __shfl_sync(0xffffffffu, ss, slot & 31);
    i = __shfl_sync(0xffffffffu, ii, slot & 31);
  }

  // Insert (cs, ci), uniform across the warp, if it ranks before entry k-1.
  __device__ void offer(float cs, int ci, int k) {
    const int lane = threadIdx.x & 31;
    float ts; int ti;
    kth(k, ts, ti);
    if (!better(cs, ci, ts, ti)) return;
    const unsigned b0 = __ballot_sync(0xffffffffu, lane < k && better(s0, i0, cs, ci));
    const unsigned b1 = __ballot_sync(0xffffffffu, lane + 32 < k && better(s1, i1, cs, ci));
    const int pos = __popc(b0) + __popc(b1);
    // shift entries pos..k-2 one place down the list, then write the newcomer
    const float up_s0 = __shfl_up_sync(0xffffffffu, s0, 1);
    const int up_i0 = __shfl_up_sync(0xffffffffu, i0, 1);
    const float up_s1 = __shfl_up_sync(0xffffffffu, s1, 1);
    const int up_i1 = __shfl_up_sync(0xffffffffu, i1, 1);
    const float e31_s = __shfl_sync(0xffffffffu, s0, 31);
    const int e31_i = __shfl_sync(0xffffffffu, i0, 31);
    if (lane > pos) { s0 = up_s0; i0 = up_i0; }
    else if (lane == pos) { s0 = cs; i0 = ci; }
    const int e1 = lane + 32;
    if (e1 > pos) {
      s1 = lane == 0 ? e31_s : up_s1;
      i1 = lane == 0 ? e31_i : up_i1;
    } else if (e1 == pos) { s1 = cs; i1 = ci; }
  }

  // Offer the candidates (cs, ci) of the lanes in the uniform mask m, best
  // first, dropping after each insertion those that no longer beat entry
  // k-1.  The list ends as if each had been offered in turn, but where many
  // candidates pass the filter at small k (a list filling up), only a few
  // insertions (each a chain of dependent shuffles) are made.
  __device__ void offer_all(unsigned m, float cs, int ci, int k) {
    const int lane = threadIdx.x & 31;
    while (m) {
      const bool in = (m >> lane) & 1u;
      int bl = __ffs(m) - 1;
      float bs;
      int bi;
      if (m & (m - 1)) {                 // the best of several: an argmax
        bs = in ? cs : kNeg;             // over (score, key, lane)
        bi = in ? ci : -1;
        bl = in ? lane : 32;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float os = __shfl_xor_sync(0xffffffffu, bs, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
          if (better(os, oi, bs, bi) || (!better(bs, bi, os, oi) && ol < bl)) {
            bs = os; bi = oi; bl = ol;
          }
        }
      } else {
        bs = __shfl_sync(0xffffffffu, cs, bl);
        bi = __shfl_sync(0xffffffffu, ci, bl);
      }
      offer(bs, bi, k);
      float ts; int ti;
      kth(k, ts, ti);
      m = __ballot_sync(0xffffffffu, in && lane != bl && better(cs, ci, ts, ti));
    }
  }

  // Write entries 0..k-1 (empty entries as the (NEG, -1) sentinel).
  __device__ void store(float* out_s, int* out_i, int k) const {
    const int lane = threadIdx.x & 31;
    if (lane < k) { out_s[lane] = i0 < 0 ? kNeg : s0; out_i[lane] = i0; }
    if (lane + 32 < k) { out_s[lane + 32] = i1 < 0 ? kNeg : s1; out_i[lane + 32] = i1; }
  }
};

// Merge n partial entries (ps[c], pi[c]) into `top`, one warp, 32 at a time:
// a candidate enters only if it beats the k-th entry, found with one ballot.
// The gallery-match kernel's small-Q path asks for more: BestFirst offers
// the ones that pass with `offer_all`, U loads a lane are in flight at once,
// and L2 loads skip the L1 cache (partials that other blocks of the same
// launch wrote).
template <bool BestFirst = false, int U = 1, bool L2 = false>
__device__ void merge_partials(const float* __restrict__ ps,
                               const int* __restrict__ pi, int n, int k,
                               WarpTopK& top) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32 * U) {
    float s[U];
    int i[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + 32 * u + lane;
      s[u] = c < n ? (L2 ? __ldcg(ps + c) : ps[c]) : kNeg;
      i[u] = c < n ? (L2 ? __ldcg(pi + c) : pi[c]) : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float ts; int ti;
      top.kth(k, ts, ti);
      unsigned m = __ballot_sync(0xffffffffu,
                                 i[u] >= 0 && better(s[u], i[u], ts, ti));
      if constexpr (BestFirst) {
        top.offer_all(m, s[u], i[u], k);
      } else {
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1;
          top.offer(__shfl_sync(0xffffffffu, s[u], b),
                    __shfl_sync(0xffffffffu, i[u], b), k);
        }
      }
    }
  }
}

}  // namespace
