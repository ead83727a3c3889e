// What the port's match kernels (gallery_match.cu, cell_rescore.cu) share:
// widening of the storage types to fp32, and warp-held top-k lists.
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

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
