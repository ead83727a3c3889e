// The backward of the blocked online-softmax (flash) attention, for Hopper
// (sm_90a): dq, dk and dv of flash_attention.cu's forward.
//
// Replaces no TPU kernel: the reference differentiates its jnp attention
// (`flash_attention_jnp`) with XLA and has no backward kernel.  It stands in
// for the plain backward (autograd through `flash_attention_plain`) on the
// card, whose gradient it reproduces.
//
// The FlashAttention-2 backward (Dao 2023), from the forward's per-row
// log-sum-exp (lse, written by the forward's LSE instances):
//   (1) fa_bwd_delta:  D_i = rowsum(dO_i o O_i) in fp32;
//   (2) dK and dV:     one block per (b, kv head, key tile) loops over the
//       query heads of its GQA group and the query tiles that see its keys,
//       recomputes S = Q K^T scale and P = exp(S - lse) (0 where masked),
//       and sums dV += P^T dO, dP = dO V^T, dS = P o (dP - D),
//       dK += dS^T Q in registers; it writes dK (times scale) and dV once;
//   (3) dQ:            one block per (b, head, query tile) loops over the
//       key tiles its rows see and sums dQ += dS K the same way.
// No float atomics: every sum runs in a fixed order, so two calls give the
// same bits (and a sharded step the unsharded one's).  Tiles that the
// masks remove entirely are skipped (the forward's tile ranges).
//
// A row that no key is visible to (a window with Sq >= Sk + window) is the
// plain softmax's uniform 1 / Sk over every key, and masked_fill gives its
// scores no gradient: its dQ and its dK share are 0, and each key's dV gets
// pinv * dO_i (pinv = 1 / Sk rounded to v's type, as the plain version's
// probabilities).  The kernels find such rows from the masks (i >= Sk +
// window - 1), not from lse (NEG there, with log Sk absorbed), and the
// dK/dV kernel adds their share after its main loop.
//
// Precision, as the forward's: bf16 operands on the tensor cores
// (mma.sync m16n8k16, fp32 sums; P and dS rounded to bf16 as operands, as
// the forward rounds P), fp32 exactly on the FMA units (no TF32).
//
// What bounds it on an H100: about 2.5 times the forward's products (S, dP,
// dV, dK and dQ; this design computes S and dP twice, once for dK/dV and
// once for dQ, 3.5 times), so arithmetic: the bf16 tensor cores for bf16,
// the fp32 FMA units for fp32, as the forward.  Operands come from shared
// memory (fp32: 16 x 16 threads, each a register tile of rows ty + 16 i and
// columns tx + 16 j, float4 reads along the reduced dimension; bf16: a warp
// a 16-row strip, fragments read from shared memory, and the S and dP
// accumulators reused in registers as the next product's A fragments).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_head_dims.cuh"

namespace {

constexpr float kNeg = -2.0e38f;
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory a block
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  int B, H, Kh, Sq, Sk, D, Dv;
  // element strides over (b, h, s) of q, k, v, o, do, dq, dk, dv
  long long sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
  float scale;
  int causal, window;
  float pinv;          // the weight of a row that no key is visible to
};

__device__ __forceinline__ bool key_ok(const Params& p, int qi, int kj) {
  return qi < p.Sq && kj < p.Sk && (!p.causal || qi >= kj) &&
         (!p.window || qi - kj < p.window);
}

// the key tiles [begin, end) of size bk that query rows [q_lo, q_lo + bq)
// see (the forward's tile_range)
__device__ __forceinline__ void key_tiles(const Params& p, int q_lo, int bq,
                                          int bk, int& begin, int& end) {
  const int nkt = (p.Sk + bk - 1) / bk;
  end = p.causal ? min(nkt, (q_lo + bq - 1) / bk + 1) : nkt;
  const int lo = q_lo - p.window + 1;
  begin = (p.window && lo > 0) ? min(lo / bk, end) : 0;
}

// the query tiles [begin, end) of size bq whose rows see any key of
// [k_lo, k_lo + bk)
__device__ __forceinline__ void query_tiles(const Params& p, int k_lo, int bk,
                                            int bq, int& begin, int& end) {
  const int k_hi = min(k_lo + bk, p.Sk) - 1;
  const int first = p.causal ? k_lo : 0;
  const int last = p.window ? min(p.Sq - 1, k_hi + p.window - 1) : p.Sq - 1;
  begin = first / bq;
  end = first <= last ? last / bq + 1 : begin;
}

// the first row that no key is visible to (Sq when there is none)
__device__ __forceinline__ int first_blind_row(const Params& p) {
  return p.window ? max(0, min(p.Sq, p.Sk + p.window - 1)) : p.Sq;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// (1) D = rowsum(dO o O): a warp a row
// ---------------------------------------------------------------------------

constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, const Params p) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int i = row % p.Sq, h = (row / p.Sq) % p.H, b = row / p.Sq / p.H;
  const T* orow = o + b * p.so[0] + h * p.so[1] + i * p.so[2];
  const T* drow = dout + b * p.sdo[0] + h * p.sdo[1] + i * p.sdo[2];
  float s = 0.0f;
  for (int c = lane; c < p.Dv; c += 32) s = fmaf(to_f(orow[c]), to_f(drow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// rows [r0, r0 + nrows) of `cols` elements of a (b, h, s)-strided tensor
// into shared memory (row pitch ld), zero past `rows` (the tensor's end);
// 16 bytes a load, each thread's kBatch loads in flight before it stores
// the first
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long ss, int r0, int nrows,
                                          int rows, int cols, int tid,
                                          int nthreads) {
  constexpr int V = 16 / sizeof(T), kBatch = 4;   // elements of 16 bytes
  const int per = cols / V, n = nrows * per;
  for (int e0 = tid; e0 < n; e0 += kBatch * nthreads) {
    uint4 val[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthreads, r = e / per, c = (e - r * per) * V;
      val[u] = e < n && r0 + r < rows
                   ? *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nthreads, r = e / per, c = (e - r * per) * V;
      if (e < n) *reinterpret_cast<uint4*>(dst + r * ld + c) = val[u];
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMAs, 16 x 16 threads
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;

// shared memory of the fp32 kernels at tile T: two (T, D + 4) tiles (q, k),
// two (T, Dv + 4) (do, v), two (T, T + 4) (P, dS), lse and D
__host__ __device__ constexpr size_t f32_bwd_smem(int T, int D, int Dv) {
  return sizeof(float) * (2 * (size_t)T * (D + 4) + 2 * (size_t)T * (Dv + 4) +
                          2 * (size_t)T * (T + 4) + 2 * (size_t)T);
}

// acc[i][j] (+)= sum_d a[ty + 16 i][d] b[tx + 16 j][d]: rows of two shared
// tiles, the reduced dimension contiguous (a multiple of 4)
template <int RT>
__device__ __forceinline__ void dot_tile(float (&acc)[RT][RT], const float* a,
                                         const float* b, int ld, int n, int tx,
                                         int ty) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < n; d += 4) {
    float4 x[RT], y[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < RT; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_r w[ty + 16 i][r] m[r][tx + 16 c] over r < T: w a
// (T, T + 4) shared tile, m a (T, ldm) one; columns past `cols` skipped
template <int RT, int NC, int T>
__device__ __forceinline__ void mul_tile(float (&acc)[RT][NC], const float* w,
                                         const float* m, int ldm, int cols,
                                         int tx, int ty) {
  constexpr int ldw = T + 4;
#pragma unroll 2
  for (int r = 0; r < T; r += 4) {
    float4 wr[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      wr[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * ldw + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        mv[c] = col < cols ? m[(r + rr) * ldm + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float wv = rr == 0 ? wr[i].x : rr == 1 ? wr[i].y
                       : rr == 2 ? wr[i].z : wr[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(wv, mv[c], acc[i][c]);
      }
    }
  }
}

// (2) dK and dV, fp32: a block per (key tile, kv head, b)
template <int D, int DV, int T>
__global__ void __launch_bounds__(kF32Threads)
fa_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv,
                const Params p) {
  constexpr int RT = T / 16, NK = D / 16, NV = DV / 16;
  constexpr int ldk = D + 4, ldv = DV + 4, ldw = T + 4;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* qs = ks + T * ldk;
  float* vs = qs + T * ldk;
  float* dos = vs + T * ldv;
  float* ps = dos + T * ldv;        // P^T: (key, query)
  float* dss = ps + T * ldw;        // dS^T
  float* ls = dss + T * ldw;        // lse of the query tile's rows
  float* ds = ls + T;               // D of the query tile's rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_lo = blockIdx.x * T, kh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.Kh;
  load_rows(ks, ldk, k + b * p.sk[0] + kh * p.sk[1], p.sk[2], k_lo, T, p.Sk, D,
            tid, kF32Threads);
  load_rows(vs, ldv, v + b * p.sv[0] + kh * p.sv[1], p.sv[2], k_lo, T, p.Sk,
            DV, tid, kF32Threads);

  float adk[RT][NK], adv[RT][NV];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < NK; ++c) adk[i][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < NV; ++c) adv[i][c] = 0.0f;
  }
  int qt_begin, qt_end;
  query_tiles(p, k_lo, T, T, qt_begin, qt_end);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * T;
      __syncthreads();                 // the last tile's q, do, P, dS are used
      load_rows(qs, ldk, q + b * p.sq[0] + h * p.sq[1], p.sq[2], q_lo, T,
                p.Sq, D, tid, kF32Threads);
      load_rows(dos, ldv, dout + b * p.sdo[0] + h * p.sdo[1], p.sdo[2], q_lo,
                T, p.Sq, DV, tid, kF32Threads);
      if (tid < T) {
        const bool in = q_lo + tid < p.Sq;
        ls[tid] = in ? lse[row0 + q_lo + tid] : 0.0f;
        ds[tid] = in ? delta[row0 + q_lo + tid] : 0.0f;
      }
      __syncthreads();
      float s[RT][RT], dp[RT][RT];
      dot_tile<RT>(s, ks, qs, ldk, D, tx, ty);     // S^T: (key, query)
      dot_tile<RT>(dp, vs, dos, ldv, DV, tx, ty);  // dP^T
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int kr = ty + 16 * i, qr = tx + 16 * j;
          const float pv = key_ok(p, q_lo + qr, k_lo + kr)
                               ? expf(s[i][j] * p.scale - ls[qr]) : 0.0f;
          ps[kr * ldw + qr] = pv;
          dss[kr * ldw + qr] = pv * (dp[i][j] - ds[qr]);
        }
      __syncthreads();
      mul_tile<RT, NV, T>(adv, ps, dos, ldv, DV, tx, ty);
      mul_tile<RT, NK, T>(adk, dss, qs, ldk, D, tx, ty);
    }
  }
  // the rows no key is visible to: pinv dO_i into every key's dV
  const int blind = first_blind_row(p);
  if (blind < p.Sq) {
    float add[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      add[c] = 0.0f;
      const int col = tx + 16 * c;
      for (int g = 0; g < G; ++g) {
        const float* src = dout + b * p.sdo[0] + (kh * G + g) * p.sdo[1] + col;
        for (int i = blind; i < p.Sq; ++i) add[c] += src[i * p.sdo[2]];
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < NV; ++c) adv[i][c] = fmaf(p.pinv, add[c], adv[i][c]);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kj = k_lo + ty + 16 * i;
    if (kj >= p.Sk) continue;
    float* krow = dk + b * p.sdk[0] + kh * p.sdk[1] + kj * p.sdk[2];
    float* vrow = dv + b * p.sdv[0] + kh * p.sdv[1] + kj * p.sdv[2];
#pragma unroll
    for (int c = 0; c < NK; ++c) krow[tx + 16 * c] = adk[i][c] * p.scale;
#pragma unroll
    for (int c = 0; c < NV; ++c) vrow[tx + 16 * c] = adv[i][c];
  }
}

// (3) dQ, fp32: a block per (query tile, head, b), the latest tiles first
template <int D, int DV, int T>
__global__ void __launch_bounds__(kF32Threads)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, const Params p) {
  constexpr int RT = T / 16, NK = D / 16;
  constexpr int ldk = D + 4, ldv = DV + 4, ldw = T + 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + T * ldk;
  float* dos = ks + T * ldk;
  float* vs = dos + T * ldv;
  float* dss = vs + T * ldv;        // dS: (query, key)
  float* ls = dss + 2 * T * ldw;
  float* ds = ls + T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nqt = (p.Sq + T - 1) / T;
  const int q_lo = (nqt - 1 - blockIdx.x) * T, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.Kh);
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  load_rows(qs, ldk, q + b * p.sq[0] + h * p.sq[1], p.sq[2], q_lo, T, p.Sq, D,
            tid, kF32Threads);
  load_rows(dos, ldv, dout + b * p.sdo[0] + h * p.sdo[1], p.sdo[2], q_lo, T,
            p.Sq, DV, tid, kF32Threads);
  if (tid < T) {
    const bool in = q_lo + tid < p.Sq;
    ls[tid] = in ? lse[row0 + q_lo + tid] : 0.0f;
    ds[tid] = in ? delta[row0 + q_lo + tid] : 0.0f;
  }
  float adq[RT][NK];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < NK; ++c) adq[i][c] = 0.0f;
  int kt_begin, kt_end;
  key_tiles(p, q_lo, T, T, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * T;
    __syncthreads();                   // the last tile's k, v and dS are used
    load_rows(ks, ldk, k + b * p.sk[0] + kh * p.sk[1], p.sk[2], k_lo, T, p.Sk,
              D, tid, kF32Threads);
    load_rows(vs, ldv, v + b * p.sv[0] + kh * p.sv[1], p.sv[2], k_lo, T, p.Sk,
              DV, tid, kF32Threads);
    __syncthreads();
    float s[RT][RT], dp[RT][RT];
    dot_tile<RT>(s, qs, ks, ldk, D, tx, ty);       // S: (query, key)
    dot_tile<RT>(dp, dos, vs, ldv, DV, tx, ty);    // dP
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int qr = ty + 16 * i, kr = tx + 16 * j;
        const float pv = key_ok(p, q_lo + qr, k_lo + kr)
                             ? expf(s[i][j] * p.scale - ls[qr]) : 0.0f;
        dss[qr * ldw + kr] = pv * (dp[i][j] - ds[qr]);
      }
    __syncthreads();
    mul_tile<RT, NK, T>(adq, dss, ks, ldk, D, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q_lo + ty + 16 * i;
    if (qi >= p.Sq) continue;
    float* row = dq + b * p.sdq[0] + h * p.sdq[1] + qi * p.sdq[2];
#pragma unroll
    for (int c = 0; c < NK; ++c) row[tx + 16 * c] = adq[i][c] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 (bf16 operands, fp32 sums), a warp a 16-row strip
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kBfWarps = 4;
constexpr int kBfThreads = 32 * kBfWarps;
constexpr int kBfKeys = 64;        // keys of a dK/dV block (16 a warp)
constexpr int kBfQ = 32;           // query rows a step of the dK/dV loop
constexpr int kBfRows = 64;        // query rows of a dQ block (16 a warp)
constexpr int kBfStep = 32;        // keys a step of the dQ loop
constexpr int kBfCols = 128;       // output columns a block (wider: passes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ld2(const bf16* lo, const bf16* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16) x columns [k0, k0 + 16) of a
// row-major shared tile (lane: g = lane / 4, t = lane % 4)
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int r0, int k0, int g, int t) {
  a[0] = ld32(s + (r0 + g) * ld + k0 + 2 * t);
  a[1] = ld32(s + (r0 + g + 8) * ld + k0 + 2 * t);
  a[2] = ld32(s + (r0 + g) * ld + k0 + 8 + 2 * t);
  a[3] = ld32(s + (r0 + g + 8) * ld + k0 + 8 + 2 * t);
}

// acc[n] (16 x 8 tile n) = A[16 x K] B[K x 8N], B^T row-major in shared
// memory (row n of the tile is column n of B; K contiguous): a rows from
// `a` (row-major, K contiguous)
template <int N>
__device__ __forceinline__ void mma_nt(float (&acc)[N][4], const bf16* a,
                                       int lda, int r0, const bf16* bt,
                                       int ldb, int K, int g, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t fa[4];
    frag_a(fa, a, lda, r0, k0, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bf16* row = bt + (8 * n + g) * ldb + k0 + 2 * t;
      mma(acc[n], fa, ld32(row), ld32(row + 8));
    }
  }
}

// acc[n] += W[16 x K] M[K x (c0 + 8n ...)], W given as the fp32 fragments
// w[2K / 16][4] of a 16 x K accumulator (rounded to bf16 here), M row-major
// in shared memory (its columns contiguous); n-tiles at or past `cols`
// skipped
template <int K, int N>
__device__ __forceinline__ void mma_acc(float (&acc)[N][4],
                                        const float (&w)[K / 8][4],
                                        const bf16* m, int ldm, int c0,
                                        int cols, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t fa[4] = {pack_bf16(w[2 * kk][0], w[2 * kk][1]),
                            pack_bf16(w[2 * kk][2], w[2 * kk][3]),
                            pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                            pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3])};
    const bf16* r0 = m + (16 * kk + 2 * t) * ldm;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int col = c0 + 8 * n + g;
      if (c0 + 8 * n >= cols) break;
      mma(acc[n], fa, ld2(r0 + col, r0 + ldm + col),
          ld2(r0 + 8 * ldm + col, r0 + 9 * ldm + col));
    }
  }
}

template <int D, int DV>
struct BfTiles {
  static constexpr int CK = D > kBfCols ? kBfCols : D;    // dK / dQ columns
  static constexpr int CV = DV > kBfCols ? kBfCols : DV;  // dV columns
  static constexpr int kPasses = (D + CK - 1) / CK > (DV + CV - 1) / CV
                                     ? (D + CK - 1) / CK
                                     : (DV + CV - 1) / CV;
  static constexpr int kPassesQ = (D + CK - 1) / CK;
  static constexpr int ldk = D + 8, ldv = DV + 8;   // 16 bytes of padding
  static constexpr size_t kSmemKV =
      sizeof(bf16) * ((size_t)kBfKeys * (ldk + ldv) + (size_t)kBfQ * (ldk + ldv)) +
      sizeof(float) * 2 * kBfQ;
  static constexpr size_t kSmemQ =
      sizeof(bf16) * ((size_t)kBfRows * (ldk + ldv) + (size_t)kBfStep * (ldk + ldv));
};

// (2) dK and dV, bf16: a block per (key tile, kv head x column pass, b)
template <int D, int DV>
__global__ void __launch_bounds__(kBfThreads)
fa_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const Params p) {
  using Tl = BfTiles<D, DV>;
  constexpr int ldk = Tl::ldk, ldv = Tl::ldv, CK = Tl::CK, CV = Tl::CV;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBfKeys * ldk;
  bf16* qs = vs + kBfKeys * ldv;
  bf16* dos = qs + kBfQ * ldk;
  float* ls = reinterpret_cast<float*>(dos + kBfQ * ldv);
  float* ds = ls + kBfQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k_lo = blockIdx.x * kBfKeys, b = blockIdx.z;
  const int kh = blockIdx.y / Tl::kPasses, pass = blockIdx.y % Tl::kPasses;
  const int ck0 = pass * CK, cv0 = pass * CV;     // this pass's columns
  const int G = p.H / p.Kh, kw = 16 * warp;      // the warp's keys
  const float sl2 = p.scale * kLog2e;
  load_rows(ks, ldk, k + b * p.sk[0] + kh * p.sk[1], p.sk[2], k_lo, kBfKeys,
            p.Sk, D, tid, kBfThreads);
  load_rows(vs, ldv, v + b * p.sv[0] + kh * p.sv[1], p.sv[2], k_lo, kBfKeys,
            p.Sk, DV, tid, kBfThreads);

  float adk[CK / 8][4], adv[CV / 8][4];
#pragma unroll
  for (int n = 0; n < CK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < CV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adv[n][e] = 0.0f;
  int qt_begin, qt_end;
  query_tiles(p, k_lo, kBfKeys, kBfQ, qt_begin, qt_end);
  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    const long long row0 = ((long long)b * p.H + h) * p.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * kBfQ;
      __syncthreads();
      load_rows(qs, ldk, q + b * p.sq[0] + h * p.sq[1], p.sq[2], q_lo, kBfQ,
                p.Sq, D, tid, kBfThreads);
      load_rows(dos, ldv, dout + b * p.sdo[0] + h * p.sdo[1], p.sdo[2], q_lo,
                kBfQ, p.Sq, DV, tid, kBfThreads);
      if (tid < kBfQ) {
        const bool in = q_lo + tid < p.Sq;
        ls[tid] = in ? lse[row0 + q_lo + tid] * kLog2e : 0.0f;
        ds[tid] = in ? delta[row0 + q_lo + tid] : 0.0f;
      }
      __syncthreads();
      // S^T and dP^T of the warp's 16 keys against the 32 queries
      float s[kBfQ / 8][4], dp[kBfQ / 8][4];
      mma_nt<kBfQ / 8>(s, ks, ldk, kw, qs, ldk, D, g, t);
      mma_nt<kBfQ / 8>(dp, vs, ldv, kw, dos, ldv, DV, g, t);
#pragma unroll
      for (int n = 0; n < kBfQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = kw + g + 8 * (e >> 1), qr = 8 * n + 2 * t + (e & 1);
          const float pv = key_ok(p, q_lo + qr, k_lo + kr)
                               ? exp2f(fmaf(s[n][e], sl2, -ls[qr])) : 0.0f;
          s[n][e] = pv;                              // P^T
          dp[n][e] = pv * (dp[n][e] - ds[qr]);       // dS^T
        }
      mma_acc<kBfQ, CV / 8>(adv, s, dos, ldv, cv0, DV, g, t);
      mma_acc<kBfQ, CK / 8>(adk, dp, qs, ldk, ck0, D, g, t);
    }
  }
  const int blind = first_blind_row(p);
#pragma unroll
  for (int n = 0; n < CV / 8; ++n) {
    const int col = cv0 + 8 * n + 2 * t;
    if (col >= DV) break;
    if (blind < p.Sq) {
      float add[2] = {0.0f, 0.0f};
      for (int hg = 0; hg < G; ++hg) {
        const bf16* src = dout + b * p.sdo[0] + (kh * G + hg) * p.sdo[1] + col;
        for (int i = blind; i < p.Sq; ++i) {
          add[0] += __bfloat162float(src[i * p.sdo[2]]);
          add[1] += __bfloat162float(src[i * p.sdo[2] + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) adv[n][e] = fmaf(p.pinv, add[e & 1], adv[n][e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = k_lo + kw + g + 8 * r;
      if (kj < p.Sk)
        *reinterpret_cast<__nv_bfloat162*>(
            dv + b * p.sdv[0] + kh * p.sdv[1] + kj * p.sdv[2] + col) =
            __floats2bfloat162_rn(adv[n][2 * r], adv[n][2 * r + 1]);
    }
  }
#pragma unroll
  for (int n = 0; n < CK / 8; ++n) {
    const int col = ck0 + 8 * n + 2 * t;
    if (col >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kj = k_lo + kw + g + 8 * r;
      if (kj < p.Sk)
        *reinterpret_cast<__nv_bfloat162*>(
            dk + b * p.sdk[0] + kh * p.sdk[1] + kj * p.sdk[2] + col) =
            __floats2bfloat162_rn(adk[n][2 * r] * p.scale,
                                  adk[n][2 * r + 1] * p.scale);
    }
  }
}

// (3) dQ, bf16: a block per (query tile, head x column pass, b)
template <int D, int DV>
__global__ void __launch_bounds__(kBfThreads)
fa_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, const Params p) {
  using Tl = BfTiles<D, DV>;
  constexpr int ldk = Tl::ldk, ldv = Tl::ldv, CK = Tl::CK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kBfRows * ldk;
  bf16* ks = dos + kBfRows * ldv;
  bf16* vs = ks + kBfStep * ldk;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nqt = (p.Sq + kBfRows - 1) / kBfRows;
  const int q_lo = (nqt - 1 - blockIdx.x) * kBfRows, b = blockIdx.z;
  const int h = blockIdx.y / Tl::kPassesQ, pass = blockIdx.y % Tl::kPassesQ;
  const int c0 = pass * CK, kh = h / (p.H / p.Kh), qw = 16 * warp;
  const float sl2 = p.scale * kLog2e;
  const long long row0 = ((long long)b * p.H + h) * p.Sq;
  load_rows(qs, ldk, q + b * p.sq[0] + h * p.sq[1], p.sq[2], q_lo, kBfRows,
            p.Sq, D, tid, kBfThreads);
  load_rows(dos, ldv, dout + b * p.sdo[0] + h * p.sdo[1], p.sdo[2], q_lo,
            kBfRows, p.Sq, DV, tid, kBfThreads);
  float lr[2], dr[2];                   // the thread's rows qw + g (+ 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q_lo + qw + g + 8 * r;
    lr[r] = qi < p.Sq ? lse[row0 + qi] * kLog2e : 0.0f;
    dr[r] = qi < p.Sq ? delta[row0 + qi] : 0.0f;
  }
  float adq[CK / 8][4];
#pragma unroll
  for (int n = 0; n < CK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.0f;
  int kt_begin, kt_end;
  key_tiles(p, q_lo, kBfRows, kBfStep, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBfStep;
    __syncthreads();
    load_rows(ks, ldk, k + b * p.sk[0] + kh * p.sk[1], p.sk[2], k_lo, kBfStep,
              p.Sk, D, tid, kBfThreads);
    load_rows(vs, ldv, v + b * p.sv[0] + kh * p.sv[1], p.sv[2], k_lo, kBfStep,
              p.Sk, DV, tid, kBfThreads);
    __syncthreads();
    float s[kBfStep / 8][4], dp[kBfStep / 8][4];
    mma_nt<kBfStep / 8>(s, qs, ldk, qw, ks, ldk, D, g, t);
    mma_nt<kBfStep / 8>(dp, dos, ldv, qw, vs, ldv, DV, g, t);
#pragma unroll
    for (int n = 0; n < kBfStep / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, qr = qw + g + 8 * r;
        const int kr = 8 * n + 2 * t + (e & 1);
        const float pv = key_ok(p, q_lo + qr, k_lo + kr)
                             ? exp2f(fmaf(s[n][e], sl2, -lr[r])) : 0.0f;
        dp[n][e] = pv * (dp[n][e] - dr[r]);          // dS
      }
    mma_acc<kBfStep, CK / 8>(adq, dp, ks, ldk, c0, D, g, t);
  }
#pragma unroll
  for (int n = 0; n < CK / 8; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    if (col >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q_lo + qw + g + 8 * r;
      if (qi < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            dq + b * p.sdq[0] + h * p.sdq[1] + qi * p.sdq[2] + col) =
            __floats2bfloat162_rn(adq[n][2 * r] * p.scale,
                                  adq[n][2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
};

template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_delta(const Ptrs& a, const Params& p, cudaStream_t st) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  fa_bwd_delta<T><<<(unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps),
                    32 * kDeltaWarps, 0, st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, p);
  return (int)cudaGetLastError();
}

// fp32: 64-row tiles where the shared tiles fit 227 KB, else 32
template <int D, int DV>
int launch_f32(const Ptrs& a, const Params& p, cudaStream_t st) {
  constexpr int T = f32_bwd_smem(64, D, DV) <= (size_t)kMaxSmem ? 64 : 32;
  constexpr size_t smem = f32_bwd_smem(T, D, DV);
  static_assert(smem <= (size_t)kMaxSmem, "the fp32 backward tiles exceed 227 KB");
  int err = launch_delta<float>(a, p, st);
  if (err) return err;
  auto kdkdv = &fa_bwd_dkdv_f32<D, DV, T>;
  if ((err = set_smem(kdkdv, smem))) return err;
  kdkdv<<<dim3((p.Sk + T - 1) / T, p.Kh, p.B), kF32Threads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv), p);
  if ((err = (int)cudaGetLastError())) return err;
  auto kdq = &fa_bwd_dq_f32<D, DV, T>;
  if ((err = set_smem(kdq, smem))) return err;
  kdq<<<dim3((p.Sq + T - 1) / T, p.H, p.B), kF32Threads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, static_cast<float*>(a.dq), p);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_bf16(const Ptrs& a, const Params& p, cudaStream_t st) {
  using Tl = BfTiles<D, DV>;
  static_assert(Tl::kSmemKV <= (size_t)kMaxSmem && Tl::kSmemQ <= (size_t)kMaxSmem,
                "the bf16 backward tiles exceed 227 KB");
  int err = launch_delta<bf16>(a, p, st);
  if (err) return err;
  auto kdkdv = &fa_bwd_dkdv_bf16<D, DV>;
  if ((err = set_smem(kdkdv, Tl::kSmemKV))) return err;
  kdkdv<<<dim3((p.Sk + kBfKeys - 1) / kBfKeys, p.Kh * Tl::kPasses, p.B),
          kBfThreads, Tl::kSmemKV, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), p);
  if ((err = (int)cudaGetLastError())) return err;
  auto kdq = &fa_bwd_dq_bf16<D, DV>;
  if ((err = set_smem(kdq, Tl::kSmemQ))) return err;
  kdq<<<dim3((p.Sq + kBfRows - 1) / kBfRows, p.H * Tl::kPassesQ, p.B),
        kBfThreads, Tl::kSmemQ, st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), p);
  return (int)cudaGetLastError();
}

int launch(int dtype, const Ptrs& a, const Params& p, cudaStream_t st) {
#define FA_CASE(D_, DV_)                                          \
  if (p.D == D_ && p.Dv == DV_)                                   \
    return dtype ? launch_bf16<D_, DV_>(a, p, st)                 \
                 : launch_f32<D_, DV_>(a, p, st);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, do, dq, dk and dv alike).  lse is
// the forward's fp32 (B, H, Sq) log-sum-exp (fa_forward_lse), delta an fp32
// (B, H, Sq) scratch.  strides holds 24 element strides, over (b, h, s) of
// q, k, v, o, do, dq, dk and dv in that order; the feature dimension of each
// is contiguous, (D, Dv) is a pair of FA_HEAD_DIMS, and the base addresses
// and strides of q, k, v and do are multiples of 16 bytes.  pinv is the
// weight that a row no key is visible to gives each key (1 / Sk in v's
// type).  Three launches on `stream`; returns the first cudaError_t code that
// is not 0, else 0.
int fa_backward(int dtype, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const float* lse,
                float* delta, void* dq, void* dk, void* dv, int B, int H,
                int Kh, int Sq, int Sk, int D, int Dv,
                const long long* strides, float scale, int causal, int window,
                float pinv, void* stream) {
  if (B < 1 || H < 1 || Kh < 1 || H % Kh != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || (dtype != 0 && dtype != 1) || B > 65535 ||
      (long long)H * 2 > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B; p.H = H; p.Kh = Kh; p.Sq = Sq; p.Sk = Sk; p.D = D; p.Dv = Dv;
  long long* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.pinv = pinv;
  Ptrs a{q, k, v, o, dout, lse, delta, dq, dk, dv};
  return launch(dtype, a, p, static_cast<cudaStream_t>(stream));
}

const char* fa_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
