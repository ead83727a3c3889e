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

  // Write entries 0..k-1 (empty entries as the (NEG, -1) sentinel).
  __device__ void store(float* out_s, int* out_i, int k) const {
    const int lane = threadIdx.x & 31;
    if (lane < k) { out_s[lane] = i0 < 0 ? kNeg : s0; out_i[lane] = i0; }
    if (lane + 32 < k) { out_s[lane + 32] = i1 < 0 ? kNeg : s1; out_i[lane + 32] = i1; }
  }
};

// Merge n partial entries (ps[c], pi[c]) into `top`, one warp, 32 at a time:
// a candidate enters only if it beats the k-th entry, found with one ballot.
__device__ void merge_partials(const float* __restrict__ ps,
                               const int* __restrict__ pi, int n, int k,
                               WarpTopK& top) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    const int c = base + lane;
    const float s = c < n ? ps[c] : kNeg;
    const int i = c < n ? pi[c] : -1;
    float ts; int ti;
    top.kth(k, ts, ti);
    unsigned m = __ballot_sync(0xffffffffu, i >= 0 && better(s, i, ts, ti));
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      top.offer(__shfl_sync(0xffffffffu, s, b), __shfl_sync(0xffffffffu, i, b), k);
    }
  }
}

}  // namespace
