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
// Precision: everything in fp32 on the FMA units (bf16 inputs are exact in
// fp32), as the reference's backward; a single bf16 or TF32 rounding of the
// products' fp32 factors would miss its tolerances (the forward's header).
//
// What bounds it on an H100: (c) does six products of c^2 / 2 pairs a
// (chunk, head) against P or N (G, R twice, dxdt, dB, dC) and four of
// c P N (the state terms), about 3x the forward's products, on the FMA
// units.  Thread layout: 256 threads as 16 x 16 (ty, tx); a thread owns
// rows ty + 16 i of a row tile and columns tx + 16 c, and reads its
// operands from shared memory as float4 along the reduced dimension
// (rows padded by 4 floats: distinct banks for each 8-lane phase).  The
// chunk's (c, c) matrices are formed one (RT, RT) tile at a time and only
// on or below the diagonal.  Two paths (mamba2_ssd.plan_backward): "fast",
// P and N up to 64, 64-row tiles, In and dOut in shared memory; "general",
// P or N up to 128, 32-row tiles, In and dOut read from L2 and the
// per-row arrays in global scratch, so only cum (c floats) holds shared
// memory that grows with the chunk: it takes every chunk the forward takes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
      for (int r = 0; r < rows; ++r) {
        float xv[NR], bv[NR];
#pragma unroll
        for (int a = 0; a < NR; ++a) xv[a] = xs[r * ldp + ty + 16 * a];
#pragma unroll
        for (int cc = 0; cc < NR; ++cc) bv[cc] = bs[r * ldn + tx + 16 * cc];
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
// state terms' r and x . dxdt; in shared memory on the fast path, in a
// global scratch of kRowArrays c floats a block on the general path (so
// that it takes every chunk the forward takes)
constexpr int kRowArrays = 5;

// shared memory of ssd_bwd_chunk, in floats: x dt and dy tiles (RT, ldp), B
// and C tiles (RT, ldn), two (RT, RT + 4) score tiles, the row sums' 16
// partials of RT, where `state` (the fast path) In and dOut (P, ldn each)
// and the per-row arrays, cum (c) and the reductions'
__host__ __device__ constexpr size_t chunk_smem_floats(int RT, int P, int N,
                                                       int c, bool state) {
  return (size_t)2 * RT * (up4(P) + 4) + (size_t)2 * RT * (up4(N) + 4) +
         (size_t)2 * RT * (RT + 4) + (size_t)16 * RT +
         (state ? (size_t)2 * P * (up4(N) + 4) + (size_t)kRowArrays * c : 0) +
         (size_t)c + 16;
}

template <typename T, int RT, int NR, bool STATE>
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
  float* in_s = msum + 16 * RT;     // In (P, ldn), where STATE
  float* out_s = in_s + (STATE ? P * ldn : 0);
  float* cum = out_s + (STATE ? P * ldn : 0);
  float* red = cum + c;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  float* rows = STATE ? red + 16
                      : row_scratch + (((long long)b * p.nc + j) * p.H + h) *
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
  const float* ins = gin;           // In and dOut: shared or global
  const float* outs = gout;
  int lds = p.N4;
  if (STATE) {
    for (int e = tid; e < P * N4; e += kThreads) {
      const int r = e / N4, col = e - r * N4;
      in_s[r * ldn + col] = gin[r * p.N4 + col];
      out_s[r * ldn + col] = gout[r * p.N4 + col];
    }
    ins = in_s;
    outs = out_s;
    lds = ldn;
  }
  // <dOut, In>, a term of dtotal
  float part = 0.0f;
  for (int e = tid; e < P * p.N4; e += kThreads) part += gin[e] * gout[e];
  const float dot_state = block_sum(part, red);   // (syncs: the state is in)

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
  float* rows;           // the general path's per-row arrays (else unused)
};

template <typename K>
int set_smem(K kern, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int RT, int NR, bool STATE>
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
  ssd_bwd_pass<<<dim3((p.P * p.N4 + kPassThreads - 1) / kPassThreads, p.H,
                      p.Bt), kPassThreads, 0, st>>>(a.S, a.Q, a.total, p);
  if ((err = (int)cudaGetLastError())) return err;
  auto kc = &ssd_bwd_chunk<T, RT, NR, STATE>;
  const size_t sc = sizeof(float) *
                    chunk_smem_floats(RT, p.P, p.N, p.chunk, STATE);
  if ((err = set_smem(kc, sc))) return err;
  kc<<<grid, kThreads, sc, st>>>(x, a.dt, a.A, B, C, a.dy, a.S, a.Q, a.total,
                                 static_cast<T*>(a.dx), a.ddt, a.dBp, a.dCp,
                                 a.dAp, a.rows, p);
  if ((err = (int)cudaGetLastError())) return err;
  const long long rows = (long long)p.Bt * p.L + (p.H + 127) / 128;
  ssd_bwd_reduce<T><<<(unsigned)rows, 128, 0, st>>>(
      a.dBp, a.dCp, a.dAp, static_cast<T*>(a.dB), static_cast<T*>(a.dC),
      a.dA, p);
  return (int)cudaGetLastError();
}

// path 0 ("fast"): P and N up to 64, 64-row tiles, the state in shared
// memory; path 1 ("general"): up to 128, 32-row tiles, the state from L2
template <typename T>
int launch(int path, const Ptrs& a, const Params& p, cudaStream_t st) {
  const int nr = ((p.P > p.N ? p.P : p.N) + 15) / 16;
  if (path == 0) {
    if (nr <= 1) return launch_nr<T, 64, 1, true>(a, p, st);
    if (nr <= 2) return launch_nr<T, 64, 2, true>(a, p, st);
    if (nr <= 4) return launch_nr<T, 64, 4, true>(a, p, st);
    return (int)cudaErrorInvalidValue;
  }
  if (nr <= 8) return launch_nr<T, 32, 8, false>(a, p, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The shared memory (bytes) that ssd_bwd_chunk needs on `path` (0 fast,
// 1 general) for (P, N, chunk); the wrapper's plan_backward keeps it within
// a block's 227 KB.
long long ssd_backward_smem(int path, int P, int N, int chunk) {
  return (long long)sizeof(float) *
         (long long)chunk_smem_floats(path == 0 ? 64 : 32, P, N, chunk,
                                      path == 0);
}

// dtype: 0 = fp32, 1 = bf16 (x, B, C, dx, dB and dC alike; dt, A, dy, ddt
// and dA are fp32).  x, dt, A, B, C and strides as ssd_forward's; dy a
// contiguous (Bt, L, H, P); dx, ddt, dB, dC, dA contiguous like x, dt, B, C
// and A.  Scratch, fp32: S and Q (Bt, L / chunk, H, P, up4(N)), total and
// dAp (Bt, L / chunk, H), dBp and dCp (Bt, L, H, N), rows (Bt, L / chunk, H,
// kRowArrays (5), chunk) on the general path (not read on the fast one).
// path: 0 = fast (P and N up to 64), 1 = general (up to 128).  Four
// launches on `stream`; returns the first cudaError_t code that is not 0,
// else 0.
int ssd_backward(int dtype, int path, const void* x, const void* dt,
                 const void* A, const void* B, const void* C, const void* dy,
                 void* dx, void* ddt, void* dA, void* dB, void* dC, void* S,
                 void* Q, void* total, void* dBp, void* dCp, void* dAp,
                 void* rows, int Bt, int L, int H, int P, int N, int chunk,
                 const long long* strides, void* stream) {
  if (Bt < 1 || L < 1 || H < 1 || P < 1 || N < 1 || chunk < 1 ||
      L % chunk != 0 || P > 128 || N > 128 || H > 65535 || Bt > 65535 ||
      L / chunk > 65535 || (path != 0 && path != 1))
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
