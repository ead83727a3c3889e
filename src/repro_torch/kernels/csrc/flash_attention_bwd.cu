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
// masks remove entirely are skipped (the forward's tile ranges).  dK/dV and
// dQ stay two kernels (S and dP are computed twice: 3.5 times the forward's
// products, where a dQ summed across key tiles would need 2.5): the
// deterministic alternative, dQ added in key-tile order into an fp32
// scratch under a semaphore per query tile (FlashAttention-3), serialises
// the key tiles of a query tile on that semaphore, and the two-kernel design
// needs no scratch, no spin and no ordering between blocks.
//
// A row that no key is visible to (a window with Sq >= Sk + window) is the
// plain softmax's uniform 1 / Sk over every key, and masked_fill gives its
// scores no gradient: its dQ and its dK share are 0, and each key's dV gets
// pinv * dO_i (pinv = 1 / Sk rounded to v's type, as the plain version's
// probabilities).  The kernels find such rows from the masks (i >= Sk +
// window - 1), not from lse (NEG there, with log Sk absorbed), and the
// dK/dV kernels add their share after their main loop.
//
// Two paths, chosen by the wrapper's pure `plan_backward` (path argument):
//
// "wgmma" (path 0), for D = Dv in FA_BWD_WGMMA_DIMS (the training head dims
// 64 and 80, and 128), both dtypes: every product on the tensor cores by
// warpgroup `wgmma` (64-row tiles, fp32 accumulators in registers), its
// operand tiles brought by TMA, as the forward's bf16 path.  One kernel
// template serves dK/dV and dQ (fa_bwd_wgmma<..., DQ>): a block holds a
// stationary tile of 128 rows (keys with their V rows for dK/dV, queries
// with their dO rows for dQ; 64 a consumer warpgroup) and streams the other
// side's tiles (queries with dO, or keys with V; 64 rows, 32 where two
// stages of 64 do not fit 227 KB) through a two-stage ring in shared memory
// that one producer thread keeps full by TMA (mbarriers: full with the
// transaction bytes, empty with one arrival per consumer warp).  A consumer
// issues S (or S^T) and dP (or dP^T) as shared x shared wgmmas, forms P and
// dS in the accumulators' registers, and issues dV += P^T dO and
// dK += dS^T Q (or dQ += dS K) with P and dS as wgmma's register A operand
// and the streamed tile as an MN-major B (the forward's PV product).
//   * bf16: one product each, P and dS rounded to bf16 operands (as the
//     forward rounds P).
//   * fp32: split bf16 operands, the SSD forward's scheme (mamba2_ssd.cu):
//     hi = bf16(x), lo = bf16(x - hi) hold x to 2^-17 of itself, and each
//     product is hi.hi + hi.lo + lo.hi into one fp32 accumulator (the
//     dropped lo.lo is below 2^-17 of it).  fa_bwd_split writes q, k, v
//     and dO once a call as contiguous bf16 hi and lo planes, which TMA
//     reads; P and dS are split in registers.  Three tensor-core products
//     for each fp32 product, against the FMA units' 67 TFLOP/s.
//   Shared memory: every tile is 64-column atoms of rows x 128 bytes with
//   the 128-byte swizzle (the forward's layout; D = 80 takes two atoms,
//   columns 80..127 zero-filled by TMA), 128 stationary rows and two
//   stages: 132 KB at fp32 D = 64, 198 KB at fp32 D = 80 or 128 (32-row
//   stages), 66 / 132 KB in bf16.
//
// "general" (path 1), every pair of FA_HEAD_DIMS in both dtypes (MLA
// 192 / 128, gemma3 240, the smoke pairs): bf16 operands on the tensor
// cores by mma.sync m16n8k16 (fp32 sums; P and dS rounded to bf16 as
// operands), fp32 exactly on the FMA units (no TF32).  Operands come from
// shared memory (fp32: 16 x 16 threads, each a register tile of rows
// ty + 16 i and columns tx + 16 j, float4 reads along the reduced
// dimension; bf16: a warp a 16-row strip, fragments read from shared
// memory, and the S and dP accumulators reused in registers as the next
// product's A fragments).
//
// What bounds it on an H100: about 2.5 times the forward's products (S, dP,
// dV, dK and dQ; both paths compute S and dP twice, 3.5 times), so
// arithmetic: the bf16 tensor cores for bf16 and for the split fp32
// products (three bf16 products each), the fp32 FMA units for the general
// path's fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

#include "flash_head_dims.cuh"
#include "hopper_wgmma.cuh"

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
// "wgmma" path: TMA + warpgroup products, fp32 through split bf16 operands
// ---------------------------------------------------------------------------

// the D = Dv of the wgmma path (plan_backward reads the list from here)
#define FA_BWD_WGMMA_DIMS(X) X(64) X(80) X(128)

constexpr int kSplitThreads = 256;

// hi = bf16(x) and lo = bf16(x - hi) of a (b, h, s)-strided fp32 tensor
// whose rows of W floats are contiguous and 16-byte aligned, into two
// contiguous (B, Hn, S, W) bf16 planes: 4 elements a thread
__global__ void __launch_bounds__(kSplitThreads)
fa_bwd_split(const float* __restrict__ src, long long sb, long long sh,
             long long ss, int Hn, int S, int W, long long n,
             bf16* __restrict__ hi, bf16* __restrict__ lo) {
  const long long e = 4 * ((long long)blockIdx.x * kSplitThreads + threadIdx.x);
  if (e >= n) return;
  const long long row = e / W;
  const int col = (int)(e - row * W), s = (int)(row % S);
  const long long bh = row / S;
  const int h = (int)(bh % Hn), b = (int)(bh / Hn);
  const float4 v =
      *reinterpret_cast<const float4*>(src + b * sb + h * sh + s * ss + col);
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - f0.x, v.y - f0.y);
  const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - f1.x, v.w - f1.y);
  uint2 ho, lw;
  ho.x = *reinterpret_cast<const uint32_t*>(&h0);
  ho.y = *reinterpret_cast<const uint32_t*>(&h1);
  lw.x = *reinterpret_cast<const uint32_t*>(&l0);
  lw.y = *reinterpret_cast<const uint32_t*>(&l1);
  *reinterpret_cast<uint2*>(hi + e) = ho;
  *reinterpret_cast<uint2*>(lo + e) = lw;
}

// (a, b) as bf16 pairs hi and lo: a = hi.x + lo.x, b = hi.y + lo.y to 2^-17
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The tiles of the wgmma path at head dims (D, DV), split (fp32) or not:
// NP planes (hi, and lo where split) of each tile; RS stationary rows (64 a
// consumer warpgroup), BQ streamed rows a stage, kStages stages.  A tile of
// W columns is (W + 63) / 64 atoms of rows x 128 bytes, 128-byte swizzled.
template <int D, int DV, bool SPLIT>
struct WgTiles {
  static constexpr int DA = (D + 63) / 64, VA = (DV + 63) / 64;
  static constexpr int NP = SPLIT ? 2 : 1;
  static constexpr int NW = 2;                        // consumer warpgroups
  static constexpr int RS = 64 * NW;
  static constexpr int kStages = 2;
  static constexpr int kRowBytes = 128 * (DA + VA) * NP;
  static constexpr int BQ =
      (RS + kStages * 64) * kRowBytes + 2048 <= kMaxSmem ? 64 : 32;
  static constexpr int kThreads = 128 * (NW + 1);
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int kAtomX = RS * 128, kAtomY = BQ * 128;
  // one plane of each tile
  static constexpr int kX1 = DA * kAtomX, kX2 = VA * kAtomX;
  static constexpr int kY1 = DA * kAtomY, kY2 = VA * kAtomY;
  static constexpr int kXBytes = NP * (kX1 + kX2);    // the stationary tiles
  static constexpr int kYBytes = NP * (kY1 + kY2);    // a stage
  static constexpr int kYOff = kXBytes;
  // each stage's streamed rows' (lse log2(e), D) as float2 (dK/dV)
  static constexpr int kLdOff = kYOff + kStages * kYBytes;
  static constexpr int kBarOff = kLdOff + kStages * BQ * 8;
  // + the barriers, + 1024 to align the base to the swizzle's 1024 bytes
  static constexpr int kSmem = kBarOff + 128 + 1024;
};

template <bool SPLIT> struct WgType { typedef bf16 T; };
template <> struct WgType<true> { typedef float T; };

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// acc (+)= X Y^T over the k16 steps of W columns: X the warpgroup's 64
// stationary rows, Y the stage's streamed rows, both K-major; split:
// hi.hi + hi.lo + lo.hi
template <int W, int BQ, int AX, int AY, bool SPLIT>
__device__ __forceinline__ void wg_scores(float (&acc)[BQ / 2], uint32_t xh,
                                          uint32_t xl, uint32_t yh,
                                          uint32_t yl) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const uint32_t off_x = (kk / 4) * AX + (kk % 4) * 32;
    const uint32_t off_y = (kk / 4) * AY + (kk % 4) * 32;
    wgmma_ss<BQ>(acc, gmma_desc(xh + off_x, 16), gmma_desc(yh + off_y, 16),
                 kk > 0);
    if (SPLIT) {
      wgmma_ss<BQ>(acc, gmma_desc(xh + off_x, 16), gmma_desc(yl + off_y, 16),
                   1);
      wgmma_ss<BQ>(acc, gmma_desc(xl + off_x, 16), gmma_desc(yh + off_y, 16),
                   1);
    }
  }
}

// acc += A Y: A given as the register fragments (hi, lo) of a 64 x BQ
// accumulator, Y the stage's (BQ, W) tile read MN-major (its W columns
// contiguous, atoms AY bytes apart); split: hi.hi + hi.lo + lo.hi
template <int W, int BQ, int AY, bool SPLIT>
__device__ __forceinline__ void wg_update(float (&acc)[W / 2],
                                          uint32_t (&ah)[BQ / 16][4],
                                          uint32_t (&al)[BQ / 16][4],
                                          uint32_t yh, uint32_t yl) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    wgmma_rs<W>(acc, ah[kk], gmma_desc(yh + kk * 16 * 128, AY));
    if (SPLIT) {
      wgmma_rs<W>(acc, ah[kk], gmma_desc(yl + kk * 16 * 128, AY));
      wgmma_rs<W>(acc, al[kk], gmma_desc(yh + kk * 16 * 128, AY));
    }
  }
}

// the accumulator's values of a 64 x BQ product as bf16 A fragments (hi,
// and lo where split): its 8 values of 16 columns are the 4 registers of
// one k16 step
template <int BQ, bool SPLIT>
__device__ __forceinline__ void wg_frags(const float (&s)[BQ / 2],
                                         uint32_t (&h)[BQ / 16][4],
                                         uint32_t (&l)[BQ / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (SPLIT)
        split_pair(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1], h[kk][j],
                   l[kk][j]);
      else
        h[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    }
}

// (2) and (3) on the wgmma path.  DQ = false: dK and dV, a block per (key
// tile of RS keys, kv head, b); the stationary tiles X1, X2 are k and v, the
// streamed Y1, Y2 q and dO of each query head of the group and each query
// tile that sees the keys; o1 = dk, o2 = dv.  DQ = true: dQ, a block per
// (query tile, head, b), latest tiles first; X1, X2 are q and dO, Y1, Y2
// k and v of each key tile the rows see; o1 = dq.  Maps with suffix l are
// the lo planes (split) and unused otherwise.  A consumer thread's part of
// a 64 x BQ accumulator: s[i] is stationary row r0 + 8 ((i >> 1) & 1) and
// streamed row y_lo + 8 (i >> 2) + cq + (i & 1).
template <int D, int DV, bool DQ, bool SPLIT>
__global__ void __launch_bounds__(WgTiles<D, DV, SPLIT>::kThreads, 1)
fa_bwd_wgmma(const __grid_constant__ CUtensorMap x1h,
             const __grid_constant__ CUtensorMap x1l,
             const __grid_constant__ CUtensorMap x2h,
             const __grid_constant__ CUtensorMap x2l,
             const __grid_constant__ CUtensorMap y1h,
             const __grid_constant__ CUtensorMap y1l,
             const __grid_constant__ CUtensorMap y2h,
             const __grid_constant__ CUtensorMap y2l,
             const float* __restrict__ lse, const float* __restrict__ delta,
             const typename WgType<SPLIT>::T* __restrict__ dout,
             typename WgType<SPLIT>::T* __restrict__ o1,
             typename WgType<SPLIT>::T* __restrict__ o2, const Params p) {
  using W = WgTiles<D, DV, SPLIT>;
  using T = typename WgType<SPLIT>::T;
  constexpr int BQ = W::BQ, RS = W::RS, S = W::kStages, NW = W::NW;
  constexpr int AX = W::kAtomX, AY = W::kAtomY;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // planes: X1 hi, X1 lo, X2 hi, X2 lo (lo only where split), then the
  // stages, each Y1 hi, Y1 lo, Y2 hi, Y2 lo
  const uint32_t sx1h = base, sx1l = sx1h + (SPLIT ? W::kX1 : 0);
  const uint32_t sx2h = base + W::NP * W::kX1;
  const uint32_t sx2l = sx2h + (SPLIT ? W::kX2 : 0);
  auto sy1h = [&](int st) { return base + W::kYOff + st * W::kYBytes; };
  auto sy1l = [&](int st) { return sy1h(st) + (SPLIT ? W::kY1 : 0); };
  auto sy2h = [&](int st) { return sy1h(st) + W::NP * W::kY1; };
  auto sy2l = [&](int st) { return sy2h(st) + (SPLIT ? W::kY2 : 0); };
  const uint32_t bars = base + W::kBarOff;
  const uint32_t x_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + S + st); };

  const int tid = threadIdx.x, b = blockIdx.z, G = p.H / p.Kh;
  // the stationary rows [r_lo, r_lo + RS) and their head; the streamed
  // tiles: n of them, tile it at rows y_lo(it) of head y_head(it)
  int r_lo, x_head, t_begin, t_end;
  if (DQ) {
    const int nqt = (p.Sq + RS - 1) / RS;
    r_lo = (nqt - 1 - blockIdx.x) * RS;
    x_head = blockIdx.y;
    key_tiles(p, r_lo, RS, BQ, t_begin, t_end);
  } else {
    r_lo = blockIdx.x * RS;
    x_head = blockIdx.y;
    query_tiles(p, r_lo, RS, BQ, t_begin, t_end);
  }
  const int per = t_end - t_begin;
  const int n = DQ ? per : per * G;
  auto y_lo = [&](int it) {
    return (t_begin + (DQ ? it : it % max(per, 1))) * BQ;
  };
  auto y_head = [&](int it) {
    return DQ ? x_head / G : x_head * G + it / max(per, 1);
  };

  if (tid == 0) {
    mbar_init(x_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * NW);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the stage's (lse log2(e), D) of the streamed rows (dK/dV), generic
  const auto ld_of = [&](int st) {
    return reinterpret_cast<float2*>(smem_raw + (base - smem_u32(smem_raw)) +
                                     W::kLdOff + st * BQ * 8);
  };

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load; for
    // dK/dV its warp stages the streamed rows' lse and D ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(W::kProducerRegs) : "memory");
    if (tid == 0) {
      mbar_expect_tx(x_full, W::kXBytes);
#pragma unroll
      for (int a = 0; a < W::DA; ++a) {
        tma_load(sx1h + a * AX, &x1h, a * 64, r_lo, x_head, b, x_full);
        if (SPLIT)
          tma_load(sx1l + a * AX, &x1l, a * 64, r_lo, x_head, b, x_full);
      }
#pragma unroll
      for (int a = 0; a < W::VA; ++a) {
        tma_load(sx2h + a * AX, &x2h, a * 64, r_lo, x_head, b, x_full);
        if (SPLIT)
          tma_load(sx2l + a * AX, &x2l, a * 64, r_lo, x_head, b, x_full);
      }
    }
    if (tid < 32) {
      for (int it = 0; it < n; ++it) {
        const int st = it % S, yl = y_lo(it), yh = y_head(it);
        mbar_wait(empty(st), ((it / S) & 1) ^ 1);
        if (!DQ) {
          const long long row0 = ((long long)b * p.H + yh) * p.Sq;
          for (int c = tid; c < BQ; c += 32) {
            const bool in = yl + c < p.Sq;
            ld_of(st)[c] = make_float2(
                in ? lse[row0 + yl + c] * kLog2e : 0.0f,
                in ? delta[row0 + yl + c] : 0.0f);
          }
          __syncwarp();            // the rows are written before the arrive
        }
        if (tid == 0) {
          mbar_expect_tx(full(st), W::kYBytes);
#pragma unroll
          for (int a = 0; a < W::DA; ++a) {
            tma_load(sy1h(st) + a * AY, &y1h, a * 64, yl, yh, b, full(st));
            if (SPLIT)
              tma_load(sy1l(st) + a * AY, &y1l, a * 64, yl, yh, b, full(st));
          }
#pragma unroll
          for (int a = 0; a < W::VA; ++a) {
            tma_load(sy2h(st) + a * AY, &y2h, a * 64, yl, yh, b, full(st));
            if (SPLIT)
              tma_load(sy2l(st) + a * AY, &y2l, a * 64, yl, yh, b, full(st));
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 stationary rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(W::kConsumerRegs) : "memory");
  const int wg = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31;
  const int r0 = r_lo + wg * 64 + warp * 16 + lane / 4;   // rows r0, r0 + 8
  const int cq = (lane & 3) * 2;
  const uint32_t xo = wg * 64 * 128;           // this warpgroup's rows
  const float sl2 = p.scale * kLog2e;
  // dQ: lse (base 2) and D of the thread's two query rows
  float lr[2] = {0.0f, 0.0f}, dr[2] = {0.0f, 0.0f};
  if constexpr (DQ) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + 8 * r;
      const long long at = ((long long)b * p.H + x_head) * p.Sq + qi;
      lr[r] = qi < p.Sq ? lse[at] * kLog2e : 0.0f;
      dr[r] = qi < p.Sq ? delta[at] : 0.0f;
    }
  }
  float acc1[D / 2], acc2[DV / 2];     // dK and dV, or dQ (acc2 unused)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc2[i] = 0.0f;

  // Tile it + 1's S and dP are issued before tile it's updates, and its
  // P and dS formed while those run on the tensor cores (the forward's
  // QK / PV overlap).  Tile it's P and dS go into the A fragments before
  // tile it + 1's scores overwrite s and dp, and after tile it - 1's
  // updates, which read the fragments, are done.
  float s[BQ / 2], dp[BQ / 2];
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dl[BQ / 16][4];
  auto scores = [&](int it) {        // S and dP of tile it: one group
    const int st = it % S;
    mbar_wait(full(st), (it / S) & 1);
    pin(s);
    pin(dp);
    wgmma_fence();
    wg_scores<D, BQ, AX, AY, SPLIT>(s, sx1h + xo, sx1l + xo, sy1h(st),
                                    sy1l(st));
    wg_scores<DV, BQ, AX, AY, SPLIT>(dp, sx2h + xo, sx2l + xo, sy2h(st),
                                     sy2l(st));
    wgmma_commit();
  };
  // P = exp(S scale - lse) where the masks keep (query, key), else 0;
  // dS = P o (dP - D)
  auto softmax = [&](int it) {
    pin(s);
    pin(dp);
    const int yl = y_lo(it);
    const float2* ld = ld_of(it % S);
#pragma unroll
    for (int c8 = 0; c8 < BQ / 8; ++c8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = yl + 8 * c8 + cq + e;
        const float2 lc = DQ ? make_float2(0.0f, 0.0f) : ld[8 * c8 + cq + e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * c8 + 2 * r + e, row = r0 + 8 * r;
          const int qi = DQ ? row : col, kj = DQ ? col : row;
          const float l2 = DQ ? lr[r] : lc.x, d = DQ ? dr[r] : lc.y;
          const float pv = key_ok(p, qi, kj)
                               ? exp2f(fmaf(s[i], sl2, -l2)) : 0.0f;
          s[i] = pv;
          dp[i] = pv * (dp[i] - d);
        }
      }
  };
  auto pack = [&]() {                // P and dS into the A fragments
    if constexpr (!DQ) wg_frags<BQ, SPLIT>(s, ph, pl);
    wg_frags<BQ, SPLIT>(dp, dh, dl);
  };
  auto update = [&](int it) {        // dV, dK or dQ of tile it: one group
    const int st = it % S;
    pin(acc1);
    pin(dh);
    if constexpr (SPLIT) pin(dl);
    if constexpr (!DQ) {
      pin(acc2);
      pin(ph);
      if constexpr (SPLIT) pin(pl);
    }
    wgmma_fence();
    if constexpr (!DQ)
      wg_update<DV, BQ, AY, SPLIT>(acc2, ph, pl, sy2h(st), sy2l(st));
    wg_update<D, BQ, AY, SPLIT>(acc1, dh, dl, sy1h(st), sy1l(st));
    wgmma_commit();
  };
  auto done = [&](int it) {          // tile it's updates are done
    pin(acc1);
    if constexpr (!DQ) pin(acc2);
    __syncwarp();
    mbar_arrive_if(empty(it % S), lane == 0);
  };
  // The outputs: dK times scale and dV, or dQ times scale.  `first` writes
  // them; else (fp32 dK/dV) adds to what an earlier flush wrote.  The fp32
  // dK/dV are flushed there after each query head of the group, so that
  // no accumulator sums more than one head's rows: the tensor cores' fp32
  // sums lose more the longer they run (on an H100, dK/dV summed over a
  // GQA group of 8 heads of 2048 rows were 8.5e-5 from the plain backward's
  // against a bound of 1e-4), and a flush is one fp32 add an element.
  const long long ob1 = DQ ? b * p.sdq[0] + x_head * p.sdq[1]
                           : b * p.sdk[0] + x_head * p.sdk[1];
  const long long os1 = DQ ? p.sdq[2] : p.sdk[2];
  const long long ob2 = b * p.sdv[0] + x_head * p.sdv[1];
  const int rows = DQ ? p.Sq : p.Sk;
  auto emit = [&](bool first) {
#pragma unroll
    for (int g8 = 0; g8 < D / 8; ++g8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= rows) continue;
        T* at = o1 + ob1 + row * os1 + 8 * g8 + cq;
        float u = acc1[4 * g8 + 2 * r] * p.scale;
        float w = acc1[4 * g8 + 2 * r + 1] * p.scale;
        if constexpr (SPLIT) {
          if (!first) {
            const float2 old = *reinterpret_cast<const float2*>(at);
            u += old.x;
            w += old.y;
          }
        }
        store2(at, u, w);
      }
    if constexpr (!DQ) {
#pragma unroll
      for (int g8 = 0; g8 < DV / 8; ++g8)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row >= p.Sk) continue;
          T* at = o2 + ob2 + row * p.sdv[2] + 8 * g8 + cq;
          float u = acc2[4 * g8 + 2 * r], w = acc2[4 * g8 + 2 * r + 1];
          if constexpr (SPLIT) {
            if (!first) {
              const float2 old = *reinterpret_cast<const float2*>(at);
              u += old.x;
              w += old.y;
            }
          }
          store2(at, u, w);
        }
    }
  };
  int flushed = 0;
  mbar_wait(x_full, 0);
  if (n > 0) {
    scores(0);
    wgmma_wait<0>();
    softmax(0);
    for (int it = 0; it < n - 1; ++it) {
      pack();                      // before tile it + 1's scores overwrite s
      scores(it + 1);
      update(it);
      wgmma_wait<1>();             // tile it + 1's scores are done
      softmax(it + 1);
      wgmma_wait<0>();
      done(it);
      if constexpr (SPLIT && !DQ) {
        if ((it + 1) % per == 0) {   // a query head of the group is done
          emit(flushed++ == 0);
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc1[i] = 0.0f;
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) acc2[i] = 0.0f;
        }
      }
    }
    pack();
    update(n - 1);
    wgmma_wait<0>();
    done(n - 1);
  }

  // the rows no key is visible to: pinv dO_i into every key's dV
  if constexpr (!DQ) {
    const int blind = first_blind_row(p);
#pragma unroll
    for (int g8 = 0; g8 < DV / 8; ++g8) {
      if (blind >= p.Sq) break;
      const int col = 8 * g8 + cq;
      float add[2] = {0.0f, 0.0f};
      for (int hg = 0; hg < G; ++hg) {
        const T* src = dout + b * p.sdo[0] + (x_head * G + hg) * p.sdo[1] + col;
        for (int i = blind; i < p.Sq; ++i) {
          add[0] += to_f(src[i * p.sdo[2]]);
          add[1] += to_f(src[i * p.sdo[2] + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc2[4 * g8 + e] = fmaf(p.pinv, add[e & 1], acc2[4 * g8 + e]);
    }
  }
  emit(flushed == 0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void* split;         // the wgmma path's fp32 hi and lo planes (scratch)
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


template <int D, int DV, bool SPLIT>
int launch_wgmma(const Ptrs& a, const Params& p, cudaStream_t st) {
  using W = WgTiles<D, DV, SPLIT>;
  using T = typename WgType<SPLIT>::T;
  static_assert(W::kSmem <= kMaxSmem, "the wgmma backward tiles exceed 227 KB");
  int err = launch_delta<T>(a, p, st);
  if (err) return err;
  // what TMA reads of q, k, v and dO: the bf16 tensors as they are, the
  // fp32 ones as bf16 hi and lo planes written here, contiguous
  struct Src {
    const void *hi, *lo;
    int heads, rows, width;
    long long ss, sh, sb;
  };
  auto as_is = [&](const void* t, const long long* s, int heads, int rows,
                   int width) {
    return Src{t, t, heads, rows, width, s[2], s[1], s[0]};
  };
  Src srcs[4] = {as_is(a.q, p.sq, p.H, p.Sq, D),
                 as_is(a.k, p.sk, p.Kh, p.Sk, D),
                 as_is(a.v, p.sv, p.Kh, p.Sk, DV),
                 as_is(a.dout, p.sdo, p.H, p.Sq, DV)};
  if (SPLIT) {
    bf16* plane = static_cast<bf16*>(a.split);
    for (Src& t : srcs) {
      const long long n = (long long)p.B * t.heads * t.rows * t.width;
      bf16 *hi = plane, *lo = plane + n;
      plane += 2 * n;
      fa_bwd_split<<<(unsigned)((n / 4 + kSplitThreads - 1) / kSplitThreads),
                     kSplitThreads, 0, st>>>(
          static_cast<const float*>(t.hi), t.sb, t.sh, t.ss, t.heads, t.rows,
          t.width, n, hi, lo);
      if ((err = (int)cudaGetLastError())) return err;
      t = Src{hi, lo, t.heads, t.rows, t.width, t.width,
              (long long)t.rows * t.width,
              (long long)t.heads * t.rows * t.width};
    }
  }
  // maps of each plane in boxes of the stationary (RS) and the streamed
  // (BQ) rows: [tensor][box][plane]
  CUtensorMap maps[4][2][2];
  for (int i = 0; i < 4; ++i)
    for (int box = 0; box < 2; ++box)
      for (int pl = 0; pl < 2; ++pl) {
        const Src& t = srcs[i];
        if ((err = make_map(&maps[i][box][pl], pl ? t.lo : t.hi, t.width,
                            t.rows, t.heads, p.B, t.ss, t.sh, t.sb,
                            box ? W::BQ : W::RS)))
          return err;
      }
  enum { Q, K, V, DO };
  auto kdkdv = &fa_bwd_wgmma<D, DV, false, SPLIT>;
  if ((err = set_smem(kdkdv, W::kSmem))) return err;
  kdkdv<<<dim3((p.Sk + W::RS - 1) / W::RS, p.Kh, p.B), W::kThreads, W::kSmem,
          st>>>(maps[K][0][0], maps[K][0][1], maps[V][0][0], maps[V][0][1],
                maps[Q][1][0], maps[Q][1][1], maps[DO][1][0], maps[DO][1][1],
                a.lse, a.delta, static_cast<const T*>(a.dout),
                static_cast<T*>(a.dk), static_cast<T*>(a.dv), p);
  if ((err = (int)cudaGetLastError())) return err;
  auto kdq = &fa_bwd_wgmma<D, DV, true, SPLIT>;
  if ((err = set_smem(kdq, W::kSmem))) return err;
  kdq<<<dim3((p.Sq + W::RS - 1) / W::RS, p.H, p.B), W::kThreads, W::kSmem,
        st>>>(maps[Q][0][0], maps[Q][0][1], maps[DO][0][0], maps[DO][0][1],
              maps[K][1][0], maps[K][1][1], maps[V][1][0], maps[V][1][1],
              a.lse, a.delta, static_cast<const T*>(a.dout),
              static_cast<T*>(a.dq), static_cast<T*>(a.dq), p);
  return (int)cudaGetLastError();
}

// path 0 ("wgmma"): the pairs of FA_BWD_WGMMA_DIMS; path 1 ("general"):
// every pair of FA_HEAD_DIMS
int launch(int dtype, int path, const Ptrs& a, const Params& p,
           cudaStream_t st) {
  if (path == 0) {
#define FA_WG(D_)                                                 \
    if (p.D == D_ && p.Dv == D_)                                  \
      return dtype ? launch_wgmma<D_, D_, false>(a, p, st)        \
                   : launch_wgmma<D_, D_, true>(a, p, st);
    FA_BWD_WGMMA_DIMS(FA_WG)
#undef FA_WG
    return (int)cudaErrorInvalidValue;
  }
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

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, do, dq, dk and dv alike).  path:
// 0 = wgmma (D = Dv in FA_BWD_WGMMA_DIMS), 1 = general (any pair of
// FA_HEAD_DIMS).  lse is the forward's fp32 (B, H, Sq) log-sum-exp
// (fa_forward_lse), delta an fp32 (B, H, Sq) scratch, split (the wgmma
// path in fp32; else not read) a bf16 scratch of twice the elements of q,
// k, v and do together.  strides holds 24 element strides, over (b, h, s)
// of q, k, v, o, do, dq, dk and dv in that order (0 where a dimension has
// size 1); the feature dimension of each is contiguous, and the base
// addresses and strides of q, k, v and do are multiples of 16 bytes.  pinv
// is the weight that a row no key is visible to gives each key (1 / Sk in
// v's type).  Three launches on `stream` (seven on the fp32 wgmma path);
// returns the first error code that is not 0 (a cudaError_t, or from
// kErrTensorMap on a tensor map that could not be made), else 0.
int fa_backward(int dtype, int path, const void* q, const void* k,
                const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* split, void* dq,
                void* dk, void* dv, int B, int H, int Kh, int Sq, int Sk,
                int D, int Dv, const long long* strides, float scale,
                int causal, int window, float pinv, void* stream) {
  if (B < 1 || H < 1 || Kh < 1 || H % Kh != 0 || Sq < 1 || Sk < 1 ||
      window < 0 || (dtype != 0 && dtype != 1) || (path != 0 && path != 1) ||
      B > 65535 || (long long)H * 2 > 65535 ||
      (path == 0 && dtype == 0 && !split))
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
  Ptrs a{q, k, v, o, dout, lse, delta, split, dq, dk, dv};
  return launch(dtype, path, a, p, static_cast<cudaStream_t>(stream));
}

const char* fa_backward_error_string(int code) {
  static char msg[96];
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled is not available";
  if (code > kErrTensorMap) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused a map "
             "(CUresult %d)", code - kErrTensorMap);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
