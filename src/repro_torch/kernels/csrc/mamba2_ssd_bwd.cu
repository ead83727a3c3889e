// The backward of the chunked Mamba-2 SSD scan, for Hopper (sm_90a): dx,
// ddt, dA, dB and dC of mamba2_ssd.cu's y for the gradient dy (the final
// state takes none).
//
// Replaces no TPU kernel: the reference differentiates its jnp
// `ssd_chunked` with XLA and has no backward kernel.  It stands in for the
// plain backward (autograd through `mamba2_ssd_plain`) on the card, whose
// gradient it reproduces.
//
// Per (b, h) and chunk j, with xdt = x dt, cum the chunk's cumulative sum of
// dt A, total = cum_last, L[t, s] = exp(cum_t - cum_s) for t >= s (taken only
// there), In_j the state entering chunk j and Out_j the one leaving it:
//   y_t   = sum_{s <= t} (C_t . B_s) L[t, s] xdt_s + exp(cum_t) In_j C_t
//   Out_j = exp(total) In_j + sum_t exp(total - cum_t) xdt_t B_t^T.
// The reverse of the forward's stages (Dao & Gu 2024; the chunk-state,
// state-passing and chunk-scan backwards of mamba_ssm's ssd_combined):
//   (a) ssd_bwd_states: per (b, chunk, head), the chunk's own state
//       S_j = sum_t w_t xdt_t B_t^T (w = exp(total - cum)) and
//       Q_j = sum_t exp(cum_t) dy_t C_t^T, chunk-parallel;
//   (b) ssd_bwd_pass: per (b, h) and state entry, in place: the forward
//       pass In_j = exp(total_{j-1}) In_{j-1} + S_{j-1} (In_0 = 0) over S,
//       and the reverse pass dOut_{j-1} = exp(total_j) dOut_j + Q_j
//       (dOut_last = 0) over Q;
//   (c) ssd_bwd_chunk: per (b, chunk, head), everything else: with
//       G = C B^T, R[t, s] = dy_t . xdt_s and M = G o L o R,
//         dxdt_s = sum_{t >= s} G L dy_t + w_s dOut B_s,
//         dB_s   = sum_{t >= s} L R C_t + w_s dOut^T xdt_s,
//         dC_t   = sum_{s <= t} L R B_s + exp(cum_t) In^T dy_t,
//         dcum_t = rowsum_t M - colsum_t M + C_t . (exp(cum_t) In^T dy_t)
//                  - xdt_t . (w_t dOut B_t)  [+ dtotal at the last row],
//         dtotal = exp(total) <dOut, In> + sum_t xdt_t . (w_t dOut B_t),
//       then d(dt A) = the reverse cumsum of dcum, ddt = d(dt A) A +
//       x . dxdt, dx = dxdt dt; dB and dC per head, and dA per
//       (b, chunk), into fp32 scratch;
//   (d) ssd_bwd_reduce: dB and dC summed over the heads (all H heads share
//       B and C), dA over the sequences and chunks.
// No float atomics: every sum runs in a fixed order, so two calls give the
// same bits.
//
// Precision: the general path does everything in fp32 on the FMA units
// (bf16 inputs are exact in fp32), as the reference's backward; the tensor
// path splits each fp32 factor into bf16 hi and lo (hi.hi + hi.lo + lo.hi),
// which holds the same tolerances, where a single bf16 or TF32 rounding of
// the factors would miss them (the forward's header).
//
// What bounds it on an H100: (c) does six products of c^2 / 2 pairs a
// (chunk, head) against P or N (G, R twice, dxdt, dB, dC) and four of
// c P N (the state terms), about 3x the forward's products, on the FMA
// units.  Thread layout: 256 threads as 16 x 16 (ty, tx); a thread owns
// rows ty + 16 i of a row tile and columns tx + 16 c, and reads its
// operands from shared memory as float4 along the reduced dimension
// (rows padded by 4 floats: distinct banks for each 8-lane phase).  The
// chunk's (c, c) matrices are formed one (RT, RT) tile at a time and only
// on or below the diagonal.  This is the "general" path
// (mamba2_ssd.plan_backward): P or N up to 128, 32-row tiles, In and dOut
// read from L2 and the per-row arrays in global scratch, so only cum
// (c floats) holds shared memory that grows with the chunk: it takes every
// chunk the forward takes.  The "tensor" path (below) runs (a) and (c) on
// the tensor cores at the training shapes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "split_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory a block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  int Bt, L, H, P, N, chunk, nc;
  int N4;                      // N rounded up to 4: the scratch states' row
  long long sxb, sxt, sdb, sdt, sbb, sbt, scb, sct;   // element strides
};

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// block-wide helpers (fixed order: the same bits every run)
// ---------------------------------------------------------------------------

// the sum of every thread's v (the result to every thread); red holds
// kWarps + 1 floats
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

// a[i] <- sum of a[u] over u <= i (or u >= i, `reverse`), for i < c, in
// place; red holds kWarps + 2 floats
__device__ void block_scan(float* a, int c, bool reverse, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.0f;
  for (int base = 0; base < c; base += kThreads) {
    const int i = base + tid, at = reverse ? c - 1 - i : i;
    float v = i < c ? a[at] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) red[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += red[w];
    v += before;
    if (i < c) a[at] = v;
    if (tid == kThreads - 1) red[kWarps] = v;
    __syncthreads();
    carry = red[kWarps];
    __syncthreads();
  }
}

// acc[i][c] = sum_d a[ty + 16 i][d] b[tx + 16 c][d] over d < n (a multiple
// of 4, float4 reads); b's rows at or past `nb` give 0
template <int RI, int NC>
__device__ __forceinline__ void dot_rows(float (&acc)[RI][NC], const float* a,
                                         int lda, const float* b, int ldb,
                                         int n, int nb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < n; d += 4) {
    float4 x[RI], y[NC];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * lda + d);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      y[c] = tx + 16 * c < nb
                 ? *reinterpret_cast<const float4*>(b + (tx + 16 * c) * ldb + d)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c] = fmaf(x[i].x, y[c].x, acc[i][c]);
        acc[i][c] = fmaf(x[i].y, y[c].y, acc[i][c]);
        acc[i][c] = fmaf(x[i].z, y[c].z, acc[i][c]);
        acc[i][c] = fmaf(x[i].w, y[c].w, acc[i][c]);
      }
  }
}

// acc[i][c] += sum_r w[ty + 16 i][r] m[r][tx + 16 c] over r < n (a multiple
// of 4, float4 reads of w; w is 0 past m's `rows`, which are not read); m's
// columns at or past `cols` skipped
template <int RI, int NC>
__device__ __forceinline__ void mul_rows(float (&acc)[RI][NC], const float* w,
                                         int ldw, const float* m, int ldm,
                                         int n, int rows, int cols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int r = 0; r < n; r += 4) {
    float4 wr[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      wr[i] = *reinterpret_cast<const float4*>(w + (ty + 16 * i) * ldw + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float mv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        mv[c] = col < cols && r + rr < rows ? m[(r + rr) * ldm + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float wv = rr == 0 ? wr[i].x : rr == 1 ? wr[i].y
                       : rr == 2 ? wr[i].z : wr[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(wv, mv[c], acc[i][c]);
      }
    }
  }
}

// the sum of v over the 16 threads of a row (tx), to each of them
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + rt) of a (b, time)-strided (., W) input into a shared
// (rt, up4(W) + 4) fp32 tile, each row times scale(row); zero past the
// chunk's c rows and in the padding columns.  Each thread has kBatch loads
// in flight before it stores the first (the tiles come from L2, and a
// load at a time left the block waiting on each)
template <typename T, typename Scale>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long st, int r0, int rt, int c,
                                          int W, Scale scale) {
  constexpr int kBatch = 8;
  const int w4 = up4(W), n = rt * w4;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, r = e / w4, col = e - r * w4;
      v[u] = e < n && r0 + r < c && col < W
                 ? to_f(src[(r0 + r) * st + col]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads, r = e / w4, col = e - r * w4;
      if (e < n)
        dst[r * ld + col] = r0 + r < c && col < W ? v[u] * scale(r0 + r)
                                                  : 0.0f;
    }
  }
}

// dt of the chunk's rows (into dts, unless null) and cum = their
// cumulative sum of dt A; zeros the per-row arrays `zero` (n of them, c
// floats each, from zero[0] on)
__device__ __forceinline__ void chunk_setup(const float* dtb, long long sdt,
                                            float Ah, int c, float* dts,
                                            float* cum, float* zero, int n,
                                            float* red) {
  for (int t = threadIdx.x; t < c; t += kThreads) {
    const float d = dtb[t * sdt];
    if (dts) dts[t] = d;
    cum[t] = d * Ah;
  }
  for (int e = threadIdx.x; e < n * c; e += kThreads) zero[e] = 0.0f;
  __syncthreads();
  block_scan(cum, c, false, red);
}

// ---------------------------------------------------------------------------
// (a) the chunk's own state S and the dy side Q: a block per (h, chunk, b)
// ---------------------------------------------------------------------------

template <typename T, int RT, int NR>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ dy,
               float* __restrict__ S, float* __restrict__ Q,
               float* __restrict__ total, const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N, c = p.chunk;
  const int ldp = up4(P) + 4, ldn = up4(N) + 4;
  float* xs = smem;                 // (RT, ldp)
  float* bs = xs + RT * ldp;        // (RT, ldn)
  float* cum = bs + RT * ldn;       // (c,)
  float* red = cum + c;             // kWarps + 2
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long t0 = (long long)j * c;
  const float* dtb = dt + b * p.sdb + t0 * p.sdt + h;
  chunk_setup(dtb, p.sdt, A[h], c, nullptr, cum, nullptr, 0, red);
  const float tot = cum[c - 1];
  const long long out = (((long long)b * p.nc + j) * p.H + h) * P * p.N4;
  if (tid == 0) total[((long long)b * p.nc + j) * p.H + h] = tot;

  // pass 0: S = sum_t (w_t xdt_t) B_t^T; pass 1: Q = sum_t (e_t dy_t) C_t^T
  for (int pass = 0; pass < 2; ++pass) {
    float acc[NR][NR];
#pragma unroll
    for (int a = 0; a < NR; ++a)
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) acc[a][cc] = 0.0f;
    for (int r0 = 0; r0 < c; r0 += RT) {
      __syncthreads();
      if (pass == 0) {
        load_tile(xs, ldp, x + b * p.sxb + t0 * p.sxt + h * P, p.sxt, r0, RT,
                  c, P,
                  [&](int t) { return dtb[t * p.sdt] * expf(tot - cum[t]); });
        load_tile(bs, ldn, Bm + b * p.sbb + t0 * p.sbt, p.sbt, r0, RT, c, N,
                  [](int) { return 1.0f; });
      } else {
        load_tile(xs, ldp, dy + ((long long)b * p.L + t0) * p.H * P + h * P,
                  (long long)p.H * P, r0, RT, c, P,
                  [&](int t) { return expf(cum[t]); });
        load_tile(bs, ldn, Cm + b * p.scb + t0 * p.sct, p.sct, r0, RT, c, N,
                  [](int) { return 1.0f; });
      }
      __syncthreads();
      const int rows = min(RT, c - r0);
      // columns past the tiles' widths read 0: NR covers the widest P and
      // N, and a narrow tile's last row would otherwise reach past the end
      // of shared memory
      for (int r = 0; r < rows; ++r) {
        float xv[NR], bv[NR];
#pragma unroll
        for (int a = 0; a < NR; ++a)
          xv[a] = ty + 16 * a < P ? xs[r * ldp + ty + 16 * a] : 0.0f;
#pragma unroll
        for (int cc = 0; cc < NR; ++cc)
          bv[cc] = tx + 16 * cc < p.N4 ? bs[r * ldn + tx + 16 * cc] : 0.0f;
#pragma unroll
        for (int a = 0; a < NR; ++a)
#pragma unroll
          for (int cc = 0; cc < NR; ++cc) acc[a][cc] = fmaf(xv[a], bv[cc], acc[a][cc]);
      }
    }
    float* dst = (pass == 0 ? S : Q) + out;
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const int pr = ty + 16 * a;
      if (pr >= P) continue;
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) {
        const int n = tx + 16 * cc;
        if (n < p.N4) dst[pr * p.N4 + n] = acc[a][cc];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the state passes, in place: S -> In (forward), Q -> dOut (reverse)
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;

__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass(float* __restrict__ S, float* __restrict__ Q,
             const float* __restrict__ total, const Params p) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, pn = p.P * p.N4;
  if (e >= pn) return;
  const long long stride = (long long)p.H * pn;
  const long long base = ((long long)b * p.nc * p.H + h) * pn + e;
  const float* tot = total + (long long)b * p.nc * p.H + h;
  float in = 0.0f;
  for (int j = 0; j < p.nc; ++j) {
    const float s = S[base + j * stride];
    S[base + j * stride] = in;
    in = expf(tot[j * p.H]) * in + s;
  }
  float dout = 0.0f;
  for (int j = p.nc - 1; j >= 0; --j) {
    const float q = Q[base + j * stride];
    Q[base + j * stride] = dout;
    dout = expf(tot[j * p.H]) * dout + q;
  }
}

// ---------------------------------------------------------------------------
// (c) the chunk's gradients: a block per (h, chunk, b)
// ---------------------------------------------------------------------------

// per-row arrays of ssd_bwd_chunk besides cum: dt, two parts of dcum, the
// state terms' r and x . dxdt; in a global scratch of kRowArrays c floats a
// block (so that it takes every chunk the forward takes)
constexpr int kRowArrays = 5;

// shared memory of ssd_bwd_chunk, in floats: x dt and dy tiles (RT, ldp), B
// and C tiles (RT, ldn), two (RT, RT + 4) score tiles, the row sums' 16
// partials of RT, cum (c) and the reductions'
__host__ __device__ constexpr size_t chunk_smem_floats(int RT, int P, int N,
                                                       int c) {
  return (size_t)2 * RT * (up4(P) + 4) + (size_t)2 * RT * (up4(N) + 4) +
         (size_t)2 * RT * (RT + 4) + (size_t)16 * RT + (size_t)c + 16;
}

template <typename T, int RT, int NR>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ In, const float* __restrict__ dOut,
              const float* __restrict__ total, T* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dBp,
              float* __restrict__ dCp, float* __restrict__ dAp,
              float* __restrict__ row_scratch, const Params p) {
  constexpr int RI = RT / 16, ldw = RT + 4;
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N, c = p.chunk, H = p.H;
  const int P4 = up4(P), N4 = up4(N), ldp = P4 + 4, ldn = N4 + 4;
  float* xs = smem;                 // x dt of a source tile
  float* ys = xs + RT * ldp;        // dy of a query tile
  float* bs = ys + RT * ldp;        // B of a source tile
  float* cs = bs + RT * ldn;        // C of a query tile
  float* glt = cs + RT * ldn;       // (s, t): G L; in pass B (t, s): L R
  float* dgt = glt + RT * ldw;      // (s, t): L R
  float* msum = dgt + RT * ldw;     // (16, RT): G L R summed over 16 s a ty
  float* cum = msum + 16 * RT;
  float* red = cum + c;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  float* rows = row_scratch + (((long long)b * p.nc + j) * p.H + h) *
                                  kRowArrays * c;
  float* dts = rows;
  float* dcr = dts + c;             // dcum: row sums of M and C . dC_state
  float* dcc = dcr + c;             // dcum: minus column sums of M
  float* rr = dcc + c;              // xdt_t . (w_t dOut B_t)
  float* xdx = rr + c;              // x_t . dxdt_t

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long t0 = (long long)j * c;
  const long long st = (((long long)b * p.nc + j) * H + h) * P * p.N4;
  const float* gin = In + st;
  const float* gout = dOut + st;
  chunk_setup(dt + b * p.sdb + t0 * p.sdt + h, p.sdt, A[h], c, dts, cum, dcr,
              4, red);
  const float tot = cum[c - 1];
  const float* ins = gin;           // In and dOut, from L2
  const float* outs = gout;
  const int lds = p.N4;
  // <dOut, In>, a term of dtotal
  float part = 0.0f;
  for (int e = tid; e < P * p.N4; e += kThreads) part += gin[e] * gout[e];
  const float dot_state = block_sum(part, red);

  const T* xb = x + b * p.sxb + t0 * p.sxt + h * P;
  const T* bb = Bm + b * p.sbb + t0 * p.sbt;
  const T* cb = Cm + b * p.scb + t0 * p.sct;
  const float* yb = dy + ((long long)b * p.L + t0) * H * P + h * P;
  const long long syt = (long long)H * P;
  auto one = [](int) { return 1.0f; };
  auto xdt_of = [&](int t) { return dts[t]; };
  // L[t, s] for absolute rows of the chunk
  auto decay = [&](int t, int s) {
    return (t >= s && t < c) ? expf(cum[t] - cum[s]) : 0.0f;
  };

  // ---- pass A: a source tile s at a time: dxdt, dB, column sums of M ----
  for (int s0 = 0; s0 < c; s0 += RT) {
    __syncthreads();
    load_tile(xs, ldp, xb, p.sxt, s0, RT, c, P, xdt_of);
    load_tile(bs, ldn, bb, p.sbt, s0, RT, c, N, one);
    __syncthreads();
    float ax[RI][NR], ab[RI][NR];
    // the state terms: w_s dOut B_s and w_s dOut^T xdt_s
    dot_rows<RI, NR>(ax, bs, ldn, outs, lds, N4, P);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) ab[i][cc] = 0.0f;
    mul_rows<RI, NR>(ab, xs, ldp, outs, lds, P4, P, N);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int s = s0 + ty + 16 * i;
      const float w = s < c ? expf(tot - cum[s]) : 0.0f;
      float r = 0.0f;
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) {
        ax[i][cc] *= w;
        ab[i][cc] *= w;
        const int pc = tx + 16 * cc;
        if (pc < P) r = fmaf(xs[(ty + 16 * i) * ldp + pc], ax[i][cc], r);
      }
      r = row_sum(r);
      if (tx == 0 && s < c) rr[s] = r;
    }
    for (int q0 = s0; q0 < c; q0 += RT) {
      __syncthreads();
      load_tile(ys, ldp, yb, syt, q0, RT, c, P, one);
      load_tile(cs, ldn, cb, p.sct, q0, RT, c, N, one);
      __syncthreads();
      float g[RI][RI], rv[RI][RI];
      dot_rows<RI, RI>(g, bs, ldn, cs, ldn, N4, RT);    // (s, t): B_s . C_t
      dot_rows<RI, RI>(rv, xs, ldp, ys, ldp, P4, RT);   // (s, t): xdt_s . dy_t
      // M = G L R: its sum over t of row s (- into dcum_s) here, over the
      // 16 threads of the row; its sum over s of column t (+ into dcum_t)
      // a ty's 16 rows here, the 16 ty after the barrier
      float ms[RI], mc[RI] = {};
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        ms[i] = 0.0f;
#pragma unroll
        for (int jj = 0; jj < RI; ++jj) {
          const int sl = ty + 16 * i, tl = tx + 16 * jj;
          const float l = decay(q0 + tl, s0 + sl);
          const float gl = g[i][jj] * l, m = gl * rv[i][jj];
          glt[sl * ldw + tl] = gl;
          dgt[sl * ldw + tl] = rv[i][jj] * l;
          ms[i] += m;
          mc[jj] += m;
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float v = row_sum(ms[i]);
        const int s = s0 + ty + 16 * i;
        if (tx == 0 && s < c) dcc[s] -= v;
      }
#pragma unroll
      for (int jj = 0; jj < RI; ++jj) msum[ty * RT + tx + 16 * jj] = mc[jj];
      __syncthreads();
      if (tid < RT && q0 + tid < c) {
        float v = 0.0f;
        for (int y = 0; y < 16; ++y) v += msum[y * RT + tid];
        dcr[q0 + tid] += v;
      }
      mul_rows<RI, NR>(ax, glt, ldw, ys, ldp, RT, RT, P);
      mul_rows<RI, NR>(ab, dgt, ldw, cs, ldn, RT, RT, N);
    }
    // dx = dxdt dt, x . dxdt for ddt, and this head's dB
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int s = s0 + ty + 16 * i;
      float xd = 0.0f;
      if (s < c) {
        const long long l = t0 + s;
#pragma unroll
        for (int cc = 0; cc < NR; ++cc) {
          const int pc = tx + 16 * cc;
          if (pc < P) {
            xd = fmaf(to_f(xb[s * p.sxt + pc]), ax[i][cc], xd);
            dx[((b * (long long)p.L + l) * H + h) * P + pc] =
                from_f<T>(ax[i][cc] * dts[s]);
          }
          const int n = tx + 16 * cc;
          if (n < N) dBp[((b * (long long)p.L + l) * H + h) * N + n] = ab[i][cc];
        }
      }
      xd = row_sum(xd);
      if (tx == 0 && s < c) xdx[s] = xd;
    }
  }

  // ---- pass B: a query tile t at a time: dC, C . dC_state ----
  for (int q0 = 0; q0 < c; q0 += RT) {
    __syncthreads();
    load_tile(ys, ldp, yb, syt, q0, RT, c, P, one);
    load_tile(cs, ldn, cb, p.sct, q0, RT, c, N, one);
    __syncthreads();
    float ac[RI][NR];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) ac[i][cc] = 0.0f;
    mul_rows<RI, NR>(ac, ys, ldp, ins, lds, P4, P, N);    // In^T dy_t
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int t = q0 + ty + 16 * i;
      const float e = t < c ? expf(cum[t]) : 0.0f;
      float v = 0.0f;
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) {
        ac[i][cc] *= e;
        const int n = tx + 16 * cc;
        if (n < N) v = fmaf(cs[(ty + 16 * i) * ldn + n], ac[i][cc], v);
      }
      v = row_sum(v);
      if (tx == 0 && t < c) dcr[t] += v;
    }
    for (int s0 = 0; s0 <= q0; s0 += RT) {
      __syncthreads();
      load_tile(xs, ldp, xb, p.sxt, s0, RT, c, P, xdt_of);
      load_tile(bs, ldn, bb, p.sbt, s0, RT, c, N, one);
      __syncthreads();
      float rv[RI][RI];
      dot_rows<RI, RI>(rv, ys, ldp, xs, ldp, P4, RT);   // (t, s)
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jj = 0; jj < RI; ++jj) {
          const int tl = ty + 16 * i, sl = tx + 16 * jj;
          glt[tl * ldw + sl] = rv[i][jj] * decay(q0 + tl, s0 + sl);
        }
      __syncthreads();
      mul_rows<RI, NR>(ac, glt, ldw, bs, ldn, RT, RT, N);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int t = q0 + ty + 16 * i;
      if (t >= c) continue;
#pragma unroll
      for (int cc = 0; cc < NR; ++cc) {
        const int n = tx + 16 * cc;
        if (n < N)
          dCp[((b * (long long)p.L + t0 + t) * H + h) * N + n] = ac[i][cc];
      }
    }
  }

  // ---- finish: dcum, d(dt A) by a reverse cumsum, ddt, this chunk's dA ----
  __syncthreads();
  float rs = 0.0f;
  for (int t = tid; t < c; t += kThreads) {
    rs += rr[t];
    dcr[t] += dcc[t] - rr[t];
  }
  const float sum_r = block_sum(rs, red);
  if (tid == 0) dcr[c - 1] += expf(tot) * dot_state + sum_r;
  __syncthreads();
  block_scan(dcr, c, true, red);
  const float Ah = A[h];
  float da = 0.0f;
  for (int t = tid; t < c; t += kThreads) {
    ddt[(b * (long long)p.L + t0 + t) * H + h] = fmaf(dcr[t], Ah, xdx[t]);
    da = fmaf(dcr[t], dts[t], da);
  }
  da = block_sum(da, red);
  if (tid == 0) dAp[((long long)b * p.nc + j) * H + h] = da;
}

// ---------------------------------------------------------------------------
// (c) on the tensor path: the chunk's gradients by mma.sync
// ---------------------------------------------------------------------------

// The P and N of the tensor path, its largest chunk, and the per-row arrays
// ssd_bwd_src hands ssd_bwd_dst (a global scratch of kTcRows c floats a
// block): dcum's part -colsum M - xdt . (w dOut B), xdt . (w dOut B), and
// x . dxdt
#define SSD_BWD_TC_DIMS(X) X(16) X(32) X(64)
constexpr int kTcMaxChunk = 256;
constexpr int kPad = 8;                     // bf16 elements of row padding
constexpr int kTcRows = 3;
static_assert(kThreads >= kTcMaxChunk, "one thread a row of the scan");

template <typename T>
constexpr bool kSplitIn = std::is_same<T, float>::value;   // fp32 inputs

// shared memory of ssd_bwd_src and of ssd_bwd_dst, in bytes: two (c, W)
// tiles (W = P, then N) and a (P, N) state, each as bf16 hi and lo with
// rows padded by kPad; four per-row float arrays (c) and the reductions'
__host__ __device__ constexpr size_t tc_smem_bytes(int P, int N, int c) {
  return 2 * 2 * ((size_t)c * (P + kPad) + (size_t)c * (N + kPad) +
                  (size_t)P * (N + kPad)) +
         4 * (4 * (size_t)c + 16);
}

// Rows [0, c) of a (c, W) tile at src (row stride ld elements, 16-byte
// aligned) into shared bf16 tiles hi and lo (row pitch W + kPad), each row
// times scale[row] where scale is given: bf16 rows not scaled are copied as
// they are (lo not written), all others split into hi and lo.  16-byte
// loads, kBatch of a thread's in flight before it stores the first.
template <typename T, int W>
__device__ __forceinline__ void tc_load(const T* src, long long ld, int c,
                                        const float* scale, bf16* hi,
                                        bf16* lo) {
  constexpr int V = 16 / sizeof(T), PER = W / V, kBatch = 4;
  const int n = c * PER;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(
            src + (e / PER) * ld + (e % PER) * V));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= n) continue;
      const int r = e / PER, o = r * (W + kPad) + (e % PER) * V;
      if constexpr (!kSplitIn<T>) {
        if (!scale) {
          *reinterpret_cast<uint4*>(hi + o) = raw[u];
          continue;
        }
      }
      const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      float f[V];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kSplitIn<T>) {
          f[i] = __uint_as_float(w[i]);
        } else {
          const float2 v = unpack(w[i]);
          f[2 * i] = v.x;
          f[2 * i + 1] = v.y;
        }
      }
      const float sc = scale ? scale[r] : 1.0f;
      uint32_t h[V / 2], l[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i)
        split2(f[2 * i] * sc, f[2 * i + 1] * sc, h[i], l[i]);
      if constexpr (V == 8) {
        *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
        *reinterpret_cast<uint2*>(hi + o) = make_uint2(h[0], h[1]);
        *reinterpret_cast<uint2*>(lo + o) = make_uint2(l[0], l[1]);
      }
    }
  }
}

// the element pair at g as floats
__device__ __forceinline__ float2 load_pair(const float* g) {
  return __ldg(reinterpret_cast<const float2*>(g));
}
__device__ __forceinline__ float2 load_pair(const bf16* g) {
  return unpack(__ldg(reinterpret_cast<const unsigned int*>(g)));
}

// an A fragment pair of an input (B or C) at g: a bf16 pair as it is (lo
// 0), an fp32 pair split into hi and lo
__device__ __forceinline__ void input_pair(const bf16* g, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __ldg(reinterpret_cast<const unsigned int*>(g));
  lo = 0u;
}
__device__ __forceinline__ void input_pair(const float* g, uint32_t& hi,
                                           uint32_t& lo) {
  const float2 v = load_pair(g);
  split2(v.x, v.y, hi, lo);
}

__device__ __forceinline__ void store_pair(float* g, float a, float b) {
  *reinterpret_cast<float2*>(g) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* g, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(g) = __floats2bfloat162_rn(a, b);
}

// the float pair that A fragment register (hi, lo) holds
__device__ __forceinline__ float2 frag_value(uint32_t hi, uint32_t lo) {
  const float2 h = unpack(hi), l = unpack(lo);
  return make_float2(h.x + l.x, h.y + l.y);
}

// the sum of v over the 4 lanes of an accumulator row (lane & 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (a) on the tensor path: S_j = sum_s (w_s xdt_s)^T B_s and Q_j = sum_t
// (exp(cum_t) dy_t)^T C_t, a block per (h, chunk, b), as the forward's
// ssd_chunk_state: the chunk's (c, P) factor, scaled by its row weight and
// split into hi and lo, and its (c, N) partner in shared memory; warp w
// takes the 16 rows p of tile w % (P / 16) and every kWarps / (P / 16)-th
// k16 step of the chunk's rows, A fragments from the factor transposed, B
// from the partner transposed; the partial sums meet in shared memory in a
// fixed order.
// its shared memory in bytes: the two tiles as bf16 hi and lo with rows
// padded by kPad, the warps' partial sums, three per-row float arrays (c)
// and the scan's
__host__ __device__ constexpr size_t states_tc_smem(int P, int N, int c) {
  return 2 * 2 * ((size_t)c * (P + kPad) + (size_t)c * (N + kPad)) +
         4 * ((size_t)(kWarps / (P / 16)) * P * N + 3 * (size_t)c + 16);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_states_tc(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ dy,
                  float* __restrict__ S, float* __restrict__ Q,
                  float* __restrict__ total, const Params p) {
  constexpr int LP = P + kPad, LN = N + kPad;
  constexpr int MT = P / 16, KG = kWarps / MT;
  constexpr bool SP = kSplitIn<T>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const int c = p.chunk, H = p.H;
  bf16* xh = reinterpret_cast<bf16*>(tc_smem);   // the factor
  bf16* xl = xh + c * LP;
  bf16* bh = xl + c * LP;                          // its partner
  bf16* bl = bh + c * LN;
  float* red = reinterpret_cast<float*>(bl + c * LN);
  float* cum = red + KG * P * N;
  float* dts = cum + c;
  float* fs = dts + c;                             // the row weights
  float* scan = fs + c;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)j * c;
  const long long blk = ((long long)b * p.nc + j) * H + h;
  chunk_setup(dt + b * p.sdb + t0 * p.sdt + h, p.sdt, A[h], c, dts, cum,
              nullptr, 0, scan);
  __syncthreads();
  const float tot = cum[c - 1];
  if (tid == 0) total[blk] = tot;
  const int mt = warp % MT, kg = warp / MT;
  for (int pass = 0; pass < 2; ++pass) {
    for (int s = tid; s < c; s += kThreads)
      fs[s] = pass ? expf(cum[s]) : dts[s] * expf(tot - cum[s]);
    __syncthreads();
    if (pass == 0) {
      tc_load<T, P>(x + b * p.sxb + t0 * p.sxt + (long long)h * P, p.sxt, c,
                    fs, xh, xl);
      tc_load<T, N>(Bm + b * p.sbb + t0 * p.sbt, p.sbt, c, nullptr, bh, bl);
    } else {
      tc_load<float, P>(dy + ((long long)b * p.L + t0) * H * P + h * P,
                        (long long)H * P, c, fs, xh, xl);
      tc_load<T, N>(Cm + b * p.scb + t0 * p.sct, p.sct, c, nullptr, bh, bl);
    }
    __syncthreads();
    float acc[N / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    for (int ks = kg; ks < c / 16; ks += KG) {
      const int s0 = 16 * ks;
      // A = the factor^T: rows p, columns s, from the (s, p) tile
      // transposed
      const int ar = s0 + (lane & 7) + 8 * (lane >> 4);
      const int ac = 16 * mt + 8 * ((lane >> 3) & 1);
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, xh + ar * LP + ac);
      ldsm_x4_t(al, xl + ar * LP + ac);
      const int br = s0 + (lane & 15);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        const int bc = 16 * np + 8 * (lane >> 4);
        uint32_t bv[4], bw[4] = {0u, 0u, 0u, 0u};
        ldsm_x4_t(bv, bh + br * LN + bc);
        if constexpr (SP) ldsm_x4_t(bw, bl + br * LN + bc);
        mma_split<true, SP>(acc[2 * np], ah, al, bv[0], bv[1], bw[0], bw[1]);
        mma_split<true, SP>(acc[2 * np + 1], ah, al, bv[2], bv[3], bw[2],
                            bw[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = 16 * mt + g + 8 * hf, col = 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(red + ((size_t)kg * P + row) * N + col) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
      }
    __syncthreads();
    float* out = (pass ? Q : S) + blk * P * p.N4;
    for (int e = tid; e < P * N; e += kThreads) {
      float v = red[e];
      for (int k = 1; k < KG; ++k) v += red[k * P * N + e];
      out[(e / N) * p.N4 + e % N] = v;
    }
    __syncthreads();                 // the tiles and red are free again
  }
}

// (c1) the source side: a block per (h, chunk, b), warp w taking 16-row
// strips of s (i and n - 1 - i, so every warp does the same work).  dy and
// C of the whole chunk and dOut are in shared memory (hi and lo); the
// strip's B_s and x_s dt_s rows are A fragments in registers.  Per strip:
// dxdt_s = w_s dOut B_s + sum_{t >= s} G L dy_t, dB_s = w_s dOut^T xdt_s +
// sum_{t >= s} L R C_t, with G^T = B_s C_t^T and R^T = xdt_s dy_t^T formed
// 16 x 16 at a time and made the next products' A fragments (split) in
// registers; the column sums of M = G o L o R, xdt . (w dOut B) and
// x . dxdt go to the per-row scratch, dx and this head's dB out.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_src(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ dy,
            const float* __restrict__ dOut, T* __restrict__ dx,
            float* __restrict__ dBp, float* __restrict__ row_out,
            const Params p) {
  constexpr int LP = P + kPad, LN = N + kPad;
  constexpr bool SP = kSplitIn<T>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const int c = p.chunk, H = p.H;
  bf16* yh = reinterpret_cast<bf16*>(tc_smem);   // dy
  bf16* yl = yh + c * LP;
  bf16* ch = yl + c * LP;                          // C
  bf16* cl = ch + c * LN;
  bf16* oh = cl + c * LN;                          // dOut
  bf16* ol = oh + P * LN;
  float* cum = reinterpret_cast<float*>(ol + P * LN);
  float* dts = cum + c;
  float* red = dts + c;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)j * c;
  const long long blk = ((long long)b * p.nc + j) * H + h;
  tc_load<float, P>(dy + ((long long)b * p.L + t0) * H * P + h * P,
                    (long long)H * P, c, nullptr, yh, yl);
  tc_load<T, N>(Cm + b * p.scb + t0 * p.sct, p.sct, c, nullptr, ch, cl);
  tc_load<float, N>(dOut + blk * P * p.N4, p.N4, P, nullptr, oh, ol);
  chunk_setup(dt + b * p.sdb + t0 * p.sdt + h, p.sdt, A[h], c, dts, cum,
              nullptr, 0, red);
  __syncthreads();
  const float tot = cum[c - 1];
  const T* xb = x + b * p.sxb + t0 * p.sxt + (long long)h * P;
  const T* bb = Bm + b * p.sbb + t0 * p.sbt;
  float* rows = row_out + blk * kTcRows * c;
  // B operands: rows of a (rows, k) tile as col-major k x n (ldmatrix), and
  // of a (k, cols) tile transposed
  const int nrow = (lane & 7) + 8 * (lane >> 4), ncol = 8 * ((lane >> 3) & 1);
  const int trow = lane & 15, tcol = 8 * (lane >> 4);

  auto strip = [&](int r) {
    const int s0 = 16 * r, sa = s0 + g, sb = sa + 8;
    const float dta = dts[sa], dtb = dts[sb];
    // A fragments: (g, 2tq), (g + 8, 2tq), (g, 2tq + 8), (g + 8, 2tq + 8)
    // of each k16 step; B_s (k = n) and xdt_s (k = p)
    uint32_t bh[N / 16][4], bl[N / 16][4], xh[P / 16][4], xl[P / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        input_pair(bb + (sa + 8 * (q & 1)) * p.sbt + 16 * kk + 2 * tq +
                       8 * (q >> 1),
                   bh[kk][q], bl[kk][q]);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = load_pair(xb + (sa + 8 * (q & 1)) * p.sxt +
                                   16 * kk + 2 * tq + 8 * (q >> 1));
        const float d = q & 1 ? dtb : dta;
        split2(v.x * d, v.y * d, xh[kk][q], xl[kk][q]);
      }
    float ax[P / 8][4], ab[N / 8][4];
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ax[i][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ab[i][e] = 0.0f;
    // the state terms: dOut B_s (B operand dOut^T: k = n, n = p, from
    // (p, n)) and dOut^T xdt_s (B operand dOut: k = p, n = n, transposed)
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t vh[4], vl[4];
        const int off = (16 * pp + nrow) * LN + 16 * kk + ncol;
        ldsm_x4(vh, oh + off);
        ldsm_x4(vl, ol + off);
        mma_split<SP, true>(ax[2 * pp], bh[kk], bl[kk], vh[0], vh[1], vl[0],
                            vl[1]);
        mma_split<SP, true>(ax[2 * pp + 1], bh[kk], bl[kk], vh[2], vh[3],
                            vl[2], vl[3]);
      }
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn) {
        uint32_t vh[4], vl[4];
        const int off = (16 * kk + trow) * LN + 16 * nn + tcol;
        ldsm_x4_t(vh, oh + off);
        ldsm_x4_t(vl, ol + off);
        mma_split<true, true>(ab[2 * nn], xh[kk], xl[kk], vh[0], vh[1],
                              vl[0], vl[1]);
        mma_split<true, true>(ab[2 * nn + 1], xh[kk], xl[kk], vh[2], vh[3],
                              vl[2], vl[3]);
      }
    // times w_s = exp(total - cum_s); rr_s = xdt_s . (w_s dOut B_s)
    const float wa = expf(tot - cum[sa]), wb = expf(tot - cum[sb]);
    float rra = 0.0f, rrb = 0.0f;
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      ax[pt][0] *= wa; ax[pt][1] *= wa; ax[pt][2] *= wb; ax[pt][3] *= wb;
      const int kk = pt >> 1, u = 2 * (pt & 1);
      const float2 va = frag_value(xh[kk][u], xl[kk][u]);
      const float2 vb = frag_value(xh[kk][u + 1], xl[kk][u + 1]);
      rra = fmaf(va.x, ax[pt][0], fmaf(va.y, ax[pt][1], rra));
      rrb = fmaf(vb.x, ax[pt][2], fmaf(vb.y, ax[pt][3], rrb));
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      ab[nt][0] *= wa; ab[nt][1] *= wa; ab[nt][2] *= wb; ab[nt][3] *= wb;
    }
    // the source tile's own factors of the decay below the diagonal:
    // exp(cum_t - cum_s) = exp(cum_t - cum_e) exp(cum_e - cum_s), e = s0 + 15
    // between s and t, both exponents <= 0
    const float ce = cum[s0 + 15];
    const float fa = expf(ce - cum[sa]), fb = expf(ce - cum[sb]);
    float msa = 0.0f, msb = 0.0f;         // sum over t of M[t, s]
    for (int tb = r; tb < c / 16; ++tb) {
      const int u0 = 16 * tb;
      float gs[2][4], rs[2][4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int e = 0; e < 4; ++e) gs[i2][e] = rs[i2][e] = 0.0f;
      // G^T = B_s C_t^T and R^T = xdt_s dy_t^T, (s, t)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
        const int off = (u0 + nrow) * LN + 16 * kk + ncol;
        ldsm_x4(vh, ch + off);
        if constexpr (SP) ldsm_x4(vl, cl + off);
        mma_split<SP, SP>(gs[0], bh[kk], bl[kk], vh[0], vh[1], vl[0], vl[1]);
        mma_split<SP, SP>(gs[1], bh[kk], bl[kk], vh[2], vh[3], vl[2], vl[3]);
      }
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t vh[4], vl[4];
        const int off = (u0 + nrow) * LP + 16 * kk + ncol;
        ldsm_x4(vh, yh + off);
        ldsm_x4(vl, yl + off);
        mma_split<true, true>(rs[0], xh[kk], xl[kk], vh[0], vh[1], vl[0],
                              vl[1]);
        mma_split<true, true>(rs[1], xh[kk], xl[kk], vh[2], vh[3], vl[2],
                              vl[3]);
      }
      // element (i2, e) is s = sa (+ 8 for e >= 2), t = u0 + 8 i2 + 2tq +
      // (e & 1); G L and L R become the A fragments of the k16 step u0
      uint32_t gh[4], gl[4], lh[4], ll[4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        float gv[4], lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e < 2 ? sa : sb, t = u0 + 8 * i2 + 2 * tq + (e & 1);
          const float L = tb > r ? expf(cum[t] - ce) * (e < 2 ? fa : fb)
                          : t >= s ? expf(cum[t] - cum[s]) : 0.0f;
          gv[e] = gs[i2][e] * L;
          lv[e] = rs[i2][e] * L;
          if (e < 2) msa = fmaf(gv[e], rs[i2][e], msa);
          else msb = fmaf(gv[e], rs[i2][e], msb);
        }
        split2(gv[0], gv[1], gh[2 * i2], gl[2 * i2]);
        split2(gv[2], gv[3], gh[2 * i2 + 1], gl[2 * i2 + 1]);
        split2(lv[0], lv[1], lh[2 * i2], ll[2 * i2]);
        split2(lv[2], lv[3], lh[2 * i2 + 1], ll[2 * i2 + 1]);
      }
      // dxdt_s += (G L)^T dy_t, dB_s += (L R)^T C_t: B operands dy and C
      // (k = t), transposed
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t vh[4], vl[4];
        const int off = (u0 + trow) * LP + 16 * pp + tcol;
        ldsm_x4_t(vh, yh + off);
        ldsm_x4_t(vl, yl + off);
        mma_split<true, true>(ax[2 * pp], gh, gl, vh[0], vh[1], vl[0], vl[1]);
        mma_split<true, true>(ax[2 * pp + 1], gh, gl, vh[2], vh[3], vl[2],
                              vl[3]);
      }
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn) {
        uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
        const int off = (u0 + trow) * LN + 16 * nn + tcol;
        ldsm_x4_t(vh, ch + off);
        if constexpr (SP) ldsm_x4_t(vl, cl + off);
        mma_split<true, SP>(ab[2 * nn], lh, ll, vh[0], vh[1], vl[0], vl[1]);
        mma_split<true, SP>(ab[2 * nn + 1], lh, ll, vh[2], vh[3], vl[2],
                            vl[3]);
      }
    }
    // dx = dxdt dt, x . dxdt, this head's dB
    float xda = 0.0f, xdb = 0.0f;
    const long long ra = ((b * (long long)p.L + t0 + sa) * H + h),
                    rb = ((b * (long long)p.L + t0 + sb) * H + h);
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      const int col = 8 * pt + 2 * tq;
      const float2 va = load_pair(xb + sa * p.sxt + col);
      const float2 vb = load_pair(xb + sb * p.sxt + col);
      xda = fmaf(va.x, ax[pt][0], fmaf(va.y, ax[pt][1], xda));
      xdb = fmaf(vb.x, ax[pt][2], fmaf(vb.y, ax[pt][3], xdb));
      store_pair(dx + ra * P + col, ax[pt][0] * dta, ax[pt][1] * dta);
      store_pair(dx + rb * P + col, ax[pt][2] * dtb, ax[pt][3] * dtb);
    }
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const int col = 8 * nt + 2 * tq;
      store_pair(dBp + ra * N + col, ab[nt][0], ab[nt][1]);
      store_pair(dBp + rb * N + col, ab[nt][2], ab[nt][3]);
    }
    msa = quad_sum(msa); msb = quad_sum(msb);
    rra = quad_sum(rra); rrb = quad_sum(rrb);
    xda = quad_sum(xda); xdb = quad_sum(xdb);
    if (tq == 0) {
      rows[sa] = -msa - rra;
      rows[sb] = -msb - rrb;
      rows[c + sa] = rra;
      rows[c + sb] = rrb;
      rows[2 * c + sa] = xda;
      rows[2 * c + sb] = xdb;
    }
  };
  const int n_strips = c / 16;
  for (int i = warp; i < (n_strips + 1) / 2; i += kWarps) {
    strip(i);
    if (n_strips - 1 - i != i) strip(n_strips - 1 - i);
  }
}

// (c2) the target side and the chunk's finish: a block per (h, chunk, b),
// warp w taking 16-row strips of t as ssd_bwd_src takes s.  x dt and B of
// the whole chunk and In are in shared memory; the strip's C_t and dy_t
// rows are A fragments in registers.  Per strip: dC_t = exp(cum_t) In^T
// dy_t + sum_{s <= t} L R B_s with G = C_t B_s^T and R = dy_t xdt_s^T formed
// 16 x 16 at a time, and dcum_t's row sum of M and C_t . dC_state.  Then,
// with ssd_bwd_src's per-row arrays, dcum, d(dt A) by a reverse cumsum,
// ddt and this chunk's dA, as ssd_bwd_chunk finishes.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dst(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, const float* __restrict__ dy,
            const float* __restrict__ In, const float* __restrict__ dOut,
            const float* __restrict__ row_in, float* __restrict__ ddt,
            float* __restrict__ dCp, float* __restrict__ dAp,
            const Params p) {
  constexpr int LP = P + kPad, LN = N + kPad;
  constexpr bool SP = kSplitIn<T>;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const int c = p.chunk, H = p.H;
  bf16* xh_s = reinterpret_cast<bf16*>(tc_smem);   // x dt
  bf16* xl_s = xh_s + c * LP;
  bf16* bh_s = xl_s + c * LP;                        // B
  bf16* bl_s = bh_s + c * LN;
  bf16* ih = bl_s + c * LN;                          // In
  bf16* il = ih + P * LN;
  float* cum = reinterpret_cast<float*>(il + P * LN);
  float* dts = cum + c;
  float* colf = dts + c;       // exp(cum_e - cum_s), e the last row of s's tile
  float* dcr = colf + c;       // dcum
  float* red = dcr + c;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)j * c;
  const long long blk = ((long long)b * p.nc + j) * H + h;
  chunk_setup(dt + b * p.sdb + t0 * p.sdt + h, p.sdt, A[h], c, dts, cum,
              nullptr, 0, red);
  __syncthreads();
  tc_load<T, P>(x + b * p.sxb + t0 * p.sxt + (long long)h * P, p.sxt, c, dts,
                xh_s, xl_s);
  tc_load<T, N>(Bm + b * p.sbb + t0 * p.sbt, p.sbt, c, nullptr, bh_s, bl_s);
  tc_load<float, N>(In + blk * P * p.N4, p.N4, P, nullptr, ih, il);
  for (int s = tid; s < c; s += kThreads)
    colf[s] = expf(cum[s | 15] - cum[s]);
  __syncthreads();
  const float tot = cum[c - 1];
  const T* cb = Cm + b * p.scb + t0 * p.sct;
  const float* yb = dy + ((long long)b * p.L + t0) * H * P + h * P;
  const long long syt = (long long)H * P;
  const int nrow = (lane & 7) + 8 * (lane >> 4), ncol = 8 * ((lane >> 3) & 1);
  const int trow = lane & 15, tcol = 8 * (lane >> 4);

  auto strip = [&](int r) {
    const int u0 = 16 * r, ta = u0 + g, tb = ta + 8;
    uint32_t cfh[N / 16][4], cfl[N / 16][4], dyh[P / 16][4], dyl[P / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        input_pair(cb + (ta + 8 * (q & 1)) * p.sct + 16 * kk + 2 * tq +
                       8 * (q >> 1),
                   cfh[kk][q], cfl[kk][q]);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        input_pair(yb + (ta + 8 * (q & 1)) * syt + 16 * kk + 2 * tq +
                       8 * (q >> 1),
                   dyh[kk][q], dyl[kk][q]);
    float acc[N / 8][4];
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    // the state term exp(cum_t) In^T dy_t: B operand In (k = p, n = n),
    // transposed
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn) {
        uint32_t vh[4], vl[4];
        const int off = (16 * kk + trow) * LN + 16 * nn + tcol;
        ldsm_x4_t(vh, ih + off);
        ldsm_x4_t(vl, il + off);
        mma_split<true, true>(acc[2 * nn], dyh[kk], dyl[kk], vh[0], vh[1],
                              vl[0], vl[1]);
        mma_split<true, true>(acc[2 * nn + 1], dyh[kk], dyl[kk], vh[2],
                              vh[3], vl[2], vl[3]);
      }
    const float ea = expf(cum[ta]), eb = expf(cum[tb]);
    float csa = 0.0f, csb = 0.0f;          // C_t . dC_state
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      acc[nt][0] *= ea; acc[nt][1] *= ea; acc[nt][2] *= eb; acc[nt][3] *= eb;
      const int kk = nt >> 1, u = 2 * (nt & 1);
      const float2 va = frag_value(cfh[kk][u], cfl[kk][u]);
      const float2 vb = frag_value(cfh[kk][u + 1], cfl[kk][u + 1]);
      csa = fmaf(va.x, acc[nt][0], fmaf(va.y, acc[nt][1], csa));
      csb = fmaf(vb.x, acc[nt][2], fmaf(vb.y, acc[nt][3], csb));
    }
    float msa = 0.0f, msb = 0.0f;          // sum over s of M[t, s]
    for (int sb = 0; sb <= r; ++sb) {
      const int s0 = 16 * sb;
      float gs[2][4], rs[2][4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int e = 0; e < 4; ++e) gs[i2][e] = rs[i2][e] = 0.0f;
      // G = C_t B_s^T and R = dy_t xdt_s^T, (t, s)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
        const int off = (s0 + nrow) * LN + 16 * kk + ncol;
        ldsm_x4(vh, bh_s + off);
        if constexpr (SP) ldsm_x4(vl, bl_s + off);
        mma_split<SP, SP>(gs[0], cfh[kk], cfl[kk], vh[0], vh[1], vl[0],
                          vl[1]);
        mma_split<SP, SP>(gs[1], cfh[kk], cfl[kk], vh[2], vh[3], vl[2],
                          vl[3]);
      }
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk) {
        uint32_t vh[4], vl[4];
        const int off = (s0 + nrow) * LP + 16 * kk + ncol;
        ldsm_x4(vh, xh_s + off);
        ldsm_x4(vl, xl_s + off);
        mma_split<true, true>(rs[0], dyh[kk], dyl[kk], vh[0], vh[1], vl[0],
                              vl[1]);
        mma_split<true, true>(rs[1], dyh[kk], dyl[kk], vh[2], vh[3], vl[2],
                              vl[3]);
      }
      // element (i2, e) is t = ta (+ 8 for e >= 2), s = s0 + 8 i2 + 2tq +
      // (e & 1); L R becomes the A fragment of the k16 step s0
      const float ce = cum[s0 + 15];
      const float fa = expf(cum[ta] - ce), fb = expf(cum[tb] - ce);
      uint32_t lh[4], ll[4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        float lv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? ta : tb, s = s0 + 8 * i2 + 2 * tq + (e & 1);
          const float L = sb < r ? (e < 2 ? fa : fb) * colf[s]
                          : t >= s ? expf(cum[t] - cum[s]) : 0.0f;
          lv[e] = rs[i2][e] * L;
          if (e < 2) msa = fmaf(gs[i2][e], lv[e], msa);
          else msb = fmaf(gs[i2][e], lv[e], msb);
        }
        split2(lv[0], lv[1], lh[2 * i2], ll[2 * i2]);
        split2(lv[2], lv[3], lh[2 * i2 + 1], ll[2 * i2 + 1]);
      }
      // dC_t += (L R) B_s: B operand B (k = s, n = n), transposed
#pragma unroll
      for (int nn = 0; nn < N / 16; ++nn) {
        uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
        const int off = (s0 + trow) * LN + 16 * nn + tcol;
        ldsm_x4_t(vh, bh_s + off);
        if constexpr (SP) ldsm_x4_t(vl, bl_s + off);
        mma_split<true, SP>(acc[2 * nn], lh, ll, vh[0], vh[1], vl[0], vl[1]);
        mma_split<true, SP>(acc[2 * nn + 1], lh, ll, vh[2], vh[3], vl[2],
                            vl[3]);
      }
    }
    const long long ra = ((b * (long long)p.L + t0 + ta) * H + h),
                    rb = ((b * (long long)p.L + t0 + tb) * H + h);
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const int col = 8 * nt + 2 * tq;
      store_pair(dCp + ra * N + col, acc[nt][0], acc[nt][1]);
      store_pair(dCp + rb * N + col, acc[nt][2], acc[nt][3]);
    }
    msa = quad_sum(msa); msb = quad_sum(msb);
    csa = quad_sum(csa); csb = quad_sum(csb);
    if (tq == 0) {
      dcr[ta] = msa + csa;
      dcr[tb] = msb + csb;
    }
  };
  const int n_strips = c / 16;
  for (int i = warp; i < (n_strips + 1) / 2; i += kWarps) {
    strip(i);
    if (n_strips - 1 - i != i) strip(n_strips - 1 - i);
  }
  __syncthreads();

  // ---- finish: dcum, d(dt A) by a reverse cumsum, ddt, this chunk's dA ----
  const float* rows = row_in + blk * kTcRows * c;
  float part = 0.0f;
  const float* gin = In + blk * P * p.N4;
  const float* gout = dOut + blk * P * p.N4;
  for (int e = tid; e < P * p.N4; e += kThreads) part += gin[e] * gout[e];
  const float dot_state = block_sum(part, red);   // <dOut, In>
  float rs = 0.0f;
  for (int t = tid; t < c; t += kThreads) {
    rs += rows[c + t];
    dcr[t] += rows[t];
  }
  const float sum_r = block_sum(rs, red);
  if (tid == 0) dcr[c - 1] += expf(tot) * dot_state + sum_r;
  __syncthreads();
  block_scan(dcr, c, true, red);
  const float Ah = A[h];
  float da = 0.0f;
  for (int t = tid; t < c; t += kThreads) {
    ddt[(b * (long long)p.L + t0 + t) * H + h] =
        fmaf(dcr[t], Ah, rows[2 * c + t]);
    da = fmaf(dcr[t], dts[t], da);
  }
  da = block_sum(da, red);
  if (tid == 0) dAp[blk] = da;
}

// ---------------------------------------------------------------------------
// (d) sums over the heads (dB, dC) and over the sequences and chunks (dA)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128)
ssd_bwd_reduce(const float* __restrict__ dBp, const float* __restrict__ dCp,
               const float* __restrict__ dAp, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, const Params p) {
  const long long row = blockIdx.x;          // (b, l)
  if (row < (long long)p.Bt * p.L) {
    for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
      float sb = 0.0f, sc = 0.0f;
      for (int h = 0; h < p.H; ++h) {
        sb += dBp[(row * p.H + h) * p.N + n];
        sc += dCp[(row * p.H + h) * p.N + n];
      }
      dB[row * p.N + n] = from_f<T>(sb);
      dC[row * p.N + n] = from_f<T>(sc);
    }
  } else {
    const long long first = (row - (long long)p.Bt * p.L) * blockDim.x;
    const long long h = first + threadIdx.x;
    if (h < p.H) {
      float s = 0.0f;
      for (long long e = 0; e < (long long)p.Bt * p.nc; ++e) s += dAp[e * p.H + h];
      dA[h] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Ptrs {
  const void *x, *B, *C;
  const float *dt, *A, *dy;
  void *dx, *dB, *dC;
  float *ddt, *dA;
  float *S, *Q, *total, *dBp, *dCp, *dAp;   // scratch
  float* rows;           // the per-row arrays (ssd_bwd_chunk, ssd_bwd_src)
};

template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (b), in place
int launch_pass(const Ptrs& a, const Params& p, cudaStream_t st) {
  ssd_bwd_pass<<<dim3((p.P * p.N4 + kPassThreads - 1) / kPassThreads, p.H,
                      p.Bt), kPassThreads, 0, st>>>(a.S, a.Q, a.total, p);
  return (int)cudaGetLastError();
}

// (d)
template <typename T>
int launch_reduce(const Ptrs& a, const Params& p, cudaStream_t st) {
  const long long rows = (long long)p.Bt * p.L + (p.H + 127) / 128;
  ssd_bwd_reduce<T><<<(unsigned)rows, 128, 0, st>>>(
      a.dBp, a.dCp, a.dAp, static_cast<T*>(a.dB), static_cast<T*>(a.dC),
      a.dA, p);
  return (int)cudaGetLastError();
}

template <typename T, int RT, int NR>
int launch_nr(const Ptrs& a, const Params& p, cudaStream_t st) {
  const dim3 grid(p.H, p.nc, p.Bt);
  const T* x = static_cast<const T*>(a.x);
  const T* B = static_cast<const T*>(a.B);
  const T* C = static_cast<const T*>(a.C);
  auto ka = &ssd_bwd_states<T, RT, NR>;
  const size_t sa = sizeof(float) * ((size_t)RT * (up4(p.P) + 4) +
                                     (size_t)RT * (up4(p.N) + 4) +
                                     (size_t)p.chunk + 16);
  int err = set_smem(ka, sa);
  if (err) return err;
  ka<<<grid, kThreads, sa, st>>>(x, a.dt, a.A, B, C, a.dy, a.S, a.Q, a.total,
                                 p);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_pass(a, p, st))) return err;
  auto kc = &ssd_bwd_chunk<T, RT, NR>;
  const size_t sc = sizeof(float) * chunk_smem_floats(RT, p.P, p.N, p.chunk);
  if ((err = set_smem(kc, sc))) return err;
  kc<<<grid, kThreads, sc, st>>>(x, a.dt, a.A, B, C, a.dy, a.S, a.Q, a.total,
                                 static_cast<T*>(a.dx), a.ddt, a.dBp, a.dCp,
                                 a.dAp, a.rows, p);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_reduce<T>(a, p, st);
}

// the tensor path: ssd_bwd_states_tc, (b), ssd_bwd_src and ssd_bwd_dst,
// then (d)
template <typename T, int P, int N>
int launch_tc(const Ptrs& a, const Params& p, cudaStream_t st) {
  static_assert(states_tc_smem(P, N, kTcMaxChunk) <= (size_t)kMaxSmem &&
                    tc_smem_bytes(P, N, kTcMaxChunk) <= (size_t)kMaxSmem,
                "the tensor path's tiles exceed 227 KB at kTcMaxChunk");
  const dim3 grid(p.H, p.nc, p.Bt);
  const T* x = static_cast<const T*>(a.x);
  const T* B = static_cast<const T*>(a.B);
  const T* C = static_cast<const T*>(a.C);
  auto ka = &ssd_bwd_states_tc<T, P, N>;
  const size_t sa = states_tc_smem(P, N, p.chunk);
  int err = set_smem(ka, sa);
  if (err) return err;
  ka<<<grid, kThreads, sa, st>>>(x, a.dt, a.A, B, C, a.dy, a.S, a.Q, a.total,
                                 p);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_pass(a, p, st))) return err;
  const size_t smem = tc_smem_bytes(P, N, p.chunk);
  auto ks = &ssd_bwd_src<T, P, N>;
  if ((err = set_smem(ks, smem))) return err;
  ks<<<grid, kThreads, smem, st>>>(x, a.dt, a.A, B, C, a.dy, a.Q,
                                   static_cast<T*>(a.dx), a.dBp, a.rows, p);
  if ((err = (int)cudaGetLastError())) return err;
  auto kd = &ssd_bwd_dst<T, P, N>;
  if ((err = set_smem(kd, smem))) return err;
  kd<<<grid, kThreads, smem, st>>>(x, a.dt, a.A, B, C, a.dy, a.S, a.Q,
                                   a.rows, a.ddt, a.dCp, a.dAp, p);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_reduce<T>(a, p, st);
}

// path 0 ("general"): P and N up to 128, 32-row tiles, the state from L2;
// path 1 ("tensor"): P and N in SSD_BWD_TC_DIMS, a chunk a multiple of 16
// up to kTcMaxChunk
template <typename T>
int launch(int path, const Ptrs& a, const Params& p, cudaStream_t st) {
  if (path == 1) {
    if (p.chunk % 16 || p.chunk > kTcMaxChunk)
      return (int)cudaErrorInvalidValue;
#define SSD_TC_N(N_, P_) \
    if (p.N == N_) return launch_tc<T, P_, N_>(a, p, st);
#define SSD_TC_P(P_) \
    if (p.P == P_) { SSD_TC_N(16, P_) SSD_TC_N(32, P_) SSD_TC_N(64, P_) }
    SSD_BWD_TC_DIMS(SSD_TC_P)
#undef SSD_TC_P
#undef SSD_TC_N
    return (int)cudaErrorInvalidValue;
  }
  const int nr = ((p.P > p.N ? p.P : p.N) + 15) / 16;
  if (nr <= 8) return launch_nr<T, 32, 8>(a, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, B, C, dx, dB and dC alike; dt, A, dy, ddt
// and dA are fp32).  x, dt, A, B, C and strides as ssd_forward's; dy a
// contiguous (Bt, L, H, P); dx, ddt, dB, dC, dA contiguous like x, dt, B, C
// and A.  Scratch, fp32: S and Q (Bt, L / chunk, H, P, up4(N)), total and
// dAp (Bt, L / chunk, H), dBp and dCp (Bt, L, H, N), rows (Bt, L / chunk, H,
// kRowArrays (5), chunk).  path: 0 = general (P and N up to 128), 1 =
// tensor (P and N in SSD_BWD_TC_DIMS, the chunk a multiple of 16 up to
// kTcMaxChunk, x, B and C rows 16-byte aligned).  Four launches on
// `stream` (five on the tensor path); returns the first cudaError_t code
// that is not 0, else 0.
int ssd_backward(int dtype, int path, const void* x, const void* dt,
                 const void* A, const void* B, const void* C, const void* dy,
                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* S,
                 void* Q, void* total, void* dBp, void* dCp, void* dAp,
                 void* rows, int Bt, int L, int H, int P, int N, int chunk,
                 const long long* strides, void* stream) {
  if (Bt < 1 || L < 1 || H < 1 || P < 1 || N < 1 || chunk < 1 ||
      L % chunk != 0 || P > 128 || N > 128 || H > 65535 || Bt > 65535 ||
      L / chunk > 65535 || path < 0 || path > 1)
    return (int)cudaErrorInvalidValue;
  Params p{Bt, L, H, P, N, chunk, L / chunk, up4(N), strides[0], strides[1],
           strides[2], strides[3], strides[4], strides[5], strides[6],
           strides[7]};
  Ptrs a{x, B, C, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(dy), dx, dB, dC, static_cast<float*>(ddt),
         static_cast<float*>(dA), static_cast<float*>(S),
         static_cast<float*>(Q), static_cast<float*>(total),
         static_cast<float*>(dBp), static_cast<float*>(dCp),
         static_cast<float*>(dAp), static_cast<float*>(rows)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(path, a, p, st);
    case 1: return launch<bf16>(path, a, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
