// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attention.py
// (launched by `flash_attention_pallas` through `pl.pallas_call`).
//
// Contract kept from the TPU kernel:
//   * q (B, H, Sq, D), k (B, Kh, Sk, D), v (B, Kh, Sk, Dv), fp32 or bf16, any
//     strides over (b, h, s) with the feature dimension contiguous; the output
//     has q's type.  Query head h reads kv head h / (H / Kh) (GQA, MQA).
//   * scores are fp32 dots (bf16 products are exact in fp32), times `scale`;
//     masked scores are NEG = -2e38, never -inf.  Causal is left-aligned
//     (query i sees keys j <= i, whatever Sk - Sq is); a window keeps
//     i - j < window; keys j >= Sk are masked.
//   * online softmax in fp32: m, l and the output accumulator carried across
//     key tiles; p is rounded to v's type before the PV product (it matters
//     in bf16), l sums the unrounded p; out = acc / max(l, 1e-20).
//   * a key tile is skipped only when the whole tile is masked for the whole
//     query tile (the TPU kernel's block skipping).  At the start of a row,
//     fully masked entries give exp(NEG - NEG) = 1; the first valid key then
//     gives corr = exp(NEG - m) = 0, which wipes them, as on the TPU.
//
// What bounds it on an H100: at the serving shapes (S = 2048, D = 64 or 80)
// it does ~4 S D flops per byte of q, k, v and o, far above the card's
// ridge, so the bound is arithmetic: the bf16 tensor cores (989 TFLOP/s) for
// bf16 inputs, the fp32 FMA units (67 TFLOP/s) for fp32 inputs.  This first
// kernel computes on the fp32 FMA units in both types (exact, simple), so in
// bf16 it sits far from its bound; tensor cores (mma/wgmma) and TMA loads
// are later work.  What the design does: a block owns one (b, h, 64-query
// tile) and loops over the key tiles inside the block (no accumulator can
// carry across blocks on Hopper); q, the current k and v tiles and the
// probabilities live in shared memory as fp32 (rows padded by one float so
// the 16 lanes of a row group hit distinct banks); m, l and the output stay
// in registers.  The (Sq, Sk) score matrix never reaches device memory.
// Blocks of the latest query tiles, which see the most keys, start first.
//
// Thread layout: 256 threads as a 16 x 16 grid (ty, tx).  Thread (ty, tx)
// owns query rows ty + 16 i (i < 4), scores against keys tx + 16 j (j < 4) of
// the tile, and output columns tx + 16 c (c < NC, NC = ceil(Dv / 16) rounded
// up to an instantiated width).  The 16 threads of a row group are one half
// of a warp, so row maxima and sums reduce with four xor shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;
constexpr float kNeg = -2.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to the storage type T and widened again
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Params {
  int B, H, Kh, Sq, Sk, D, Dv;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale;
  int causal, window;
};

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Params p) {
  extern __shared__ float smem[];
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + 1, ldv = Dv + 1, ldp = kBK + 1;
  float* qs = smem;                    // (kBQ, D + 1)
  float* ks = qs + kBQ * ldq;          // (kBK, D + 1)
  float* vs = ks + kBK * ldq;          // (kBK, Dv + 1)
  float* ps = vs + kBK * ldv;          // (kBQ, kBK + 1) probabilities

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int kh = h / (p.H / p.Kh);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;   // latest tiles first
  const T* qb = q + b * p.sqb + h * p.sqh;
  const T* kb = k + b * p.skb + kh * p.skh;
  const T* vb = v + b * p.svb + kh * p.svh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qi = q_lo + r;
    qs[r * ldq + d] = qi < p.Sq ? to_f32(qb[qi * p.sqs + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // the key tiles this query tile needs (whole-tile skipping)
  const int nkt = (p.Sk + kBK - 1) / kBK;
  int kt_end = nkt;
  if (p.causal) kt_end = min(nkt, (q_lo + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (p.window) {
    const int lo = q_lo - p.window + 1;     // the earliest key a row may see
    kt_begin = lo > 0 ? lo / kBK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBK;
    __syncthreads();                   // the last tile's k, v and p are used
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int kj = k_lo + r;
      ks[r * ldq + d] = kj < p.Sk ? to_f32(kb[kj * p.sks + d]) : 0.0f;
    }
    for (int e = tid; e < kBK * Dv; e += kThreads) {
      const int r = e / Dv, d = e - r * Dv;
      const int kj = k_lo + r;
      vs[r * ldv + d] = kj < p.Sk ? to_f32(vb[kj * p.svs + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_lo + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k_lo + tx + 16 * j;
        bool ok = kj < p.Sk;
        if (p.causal) ok = ok && qi >= kj;
        if (p.window) ok = ok && qi - kj < p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        rs += pv;
        ps[(ty + 16 * i) * ldp + tx + 16 * j] = round_as(pv, T());
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty + 16 * i) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < Dv ? vs[j * ldv + col] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_lo + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + b * p.sob + h * p.soh + qi * p.sos;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) store(orow + col, acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* q, const void* k, const void* v, void* o,
              const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kBQ + kBK) * (p.D + 1) + (size_t)kBK * (p.Dv + 1) +
       (size_t)kBQ * (kBK + 1));
  auto kern = &flash_fwd_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  const int need = (p.Dv + 15) / 16;
  if (need <= 1) return launch_nc<T, 1>(q, k, v, o, p, stream);
  if (need <= 2) return launch_nc<T, 2>(q, k, v, o, p, stream);
  if (need <= 4) return launch_nc<T, 4>(q, k, v, o, p, stream);
  if (need <= 5) return launch_nc<T, 5>(q, k, v, o, p, stream);
  if (need <= 8) return launch_nc<T, 8>(q, k, v, o, p, stream);
  if (need <= 12) return launch_nc<T, 12>(q, k, v, o, p, stream);
  if (need <= 16) return launch_nc<T, 16>(q, k, v, o, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike).  strides holds 12 element
// strides: q's, k's, v's and o's over (b, h, s), in that order; the feature
// dimension of each is contiguous.  Returns a cudaError_t code: 0 when the
// launch was accepted.
int fa_forward(int dtype, const void* q, const void* k, const void* v,
               void* o, int B, int H, int Kh, int Sq, int Sk, int D, int Dv,
               const long long* strides, float scale, int causal, int window,
               void* stream) {
  if (B < 1 || H < 1 || Kh < 1 || H % Kh != 0 || Sq < 1 || Sk < 1 ||
      D < 1 || Dv < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  Params p{B, H, Kh, Sq, Sk, D, Dv,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, o, p, st);
    case 1: return launch<__nv_bfloat16>(q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
