// Chunked Mamba-2 SSD (state-space dual) scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` in src/repro/kernels/mamba2_ssd.py
// (launched by `mamba2_ssd_pallas` through `pl.pallas_call`).
//
// Contract kept from the TPU kernel, all in fp32 (inputs are widened):
//   x (Bt, L, H, P), dt (Bt, L, H), A (H,), B and C (Bt, L, N); L is a
//   multiple of the chunk c.  Per (b, h) and chunk, with xdt = x * dt:
//     a = dt * A;  cum = cumsum(a) within the chunk;
//     L[t, s] = exp(cum_t - cum_s) for t >= s, else 0 (the exponential is
//       taken only where t >= s: elsewhere cum_t - cum_s > 0 may overflow);
//     y = (C B^T o L) xdt + exp(cum) * (C state^T);
//     state <- exp(cum_last) state + sum_t exp(cum_last - cum_t) xdt_t B_t^T;
//   y goes out as fp32 (Bt, L, H, P), the final state as fp32 (Bt, H, P, N).
//   No D skip and no initial state (the reference adds the skip outside).
//
// Two paths, both launched by the wrapper (mamba2_ssd.py, whose pure
// `plan()` chooses one per call):
//
// The staged path (`ssd_staged`), for P and N in SSD_STAGED_DIMS, a chunk
// that is a multiple of 16 up to kMaxChunk, and 16-byte aligned x, B, C.
// What bounds it on an H100: at zamba2's shape (Bt 8, L 2048, H 80,
// P = N = 64, chunk 256) the scan needs 43.3 GFLOP against 523 MB, of
// which y, written in fp32, is 64 %; on tensor cores the bytes bound it
// (0.156 ms at 3.35 TB/s against 0.088 ms for the products at the TF32
// peak), on the FMA units the products (0.646 ms).  Its design:
//   * Three kernels, so that every (sequence, chunk, head) is a block of
//     its own (5120 blocks at zamba2's shape) instead of one block walking
//     a (sequence, head)'s chunks in order (Dao & Gu 2024, the chunked SSD
//     algorithm):
//       (a) ssd_chunk_state: S_j = (x dt w)^T B over the chunk's rows, with
//           w = exp(total_j - cum), and total_j = cum_last;
//       (b) ssd_state_pass: per (b, h), st_j = exp(total_j) st_{j-1} + S_j
//           over the chunks in order; it writes the state entering each
//           chunk and the final state;
//       (c) ssd_chunk_scan: y = (C B^T o L) dt x + exp(cum) C st_{j-1}^T,
//           each warp taking two 16-row strips of the chunk (i and
//           n - 1 - i, so every warp does the same work) and only the
//           16 x 16 score tiles on or below the diagonal.
//     The staged scratch (chunk states and passed states, fp32) is written
//     once and read once: 4 x 84 MB at zamba2's shape.
//   * Every product on tensor cores (mma.sync m16n8k16, bf16 operands,
//     fp32 sums), with operands that keep the fp32 result: a bf16 input is
//     exact as a bf16 operand; an fp32 factor v (the scores times decay and
//     dt, the carried state, x dt w) is split into hi = bf16(v) and
//     lo = bf16(v - hi), which hold v to 2^-17 of itself, and multiplied
//     twice (hi and lo).  With fp32 inputs every operand is split so and
//     each product is hi.hi + hi.lo + lo.hi.  A single bf16 (or TF32)
//     rounding of those factors would miss the reference's tolerances
//     (tests/test_torch_ssd.py emulates both).
//   * Fragments come from shared memory by ldmatrix (transposed where the
//     product needs it: x^T in (a), x in (c)); shared rows are padded by
//     16 bytes so the 8 rows of a matrix fall in distinct banks.  The
//     scores' accumulator fragment is the next product's A fragment as it
//     stands (the columns of two n8 tiles are the k16 of the next product).
//   * bf16 tiles come in by cp.async, 16 bytes a thread, while the block
//     scans cum with all its warps; fp32 tiles are loaded 16 bytes a thread
//     and split on the way into shared memory.  C is read by each warp
//     straight into its strip's A fragments.  Strides over (batch, time)
//     stay arguments, so the model's column slices go in without a copy.
//   * The decay never overflows: every exponent is <= 0.  On a diagonal
//     tile it is cum_t - cum_s with t >= s; below it, exp(cum_t - cum_s)
//     is exp(cum_t - cum_e) exp(cum_e - cum_s) with e the source tile's
//     last row, between s and t, so one exponential a row and one a column
//     (precomputed per block) serve the whole tile, and never
//     exp(cum_t) exp(-cum_s).  The scan is bound by the instructions it
//     issues per score, so an exponential a score was its largest cost.
//   * Every sum runs in a fixed order: two runs give the same bits.
//
// The general path (`ssd_forward`), for every other shape: one block per
// (b, h) walks its chunks in order, the (P, N) state in shared memory, on
// the fp32 FMA units.  A chunk's (c, c) matrix would not fit shared memory
// at c = 256 (256 KB in fp32), so the chunk is cut into 64-row tiles: for
// each tile of query rows t the block forms C B^T o L against each 64-row
// tile of source rows s <= t, one 64 x 64 tile at a time, and accumulates
// y in registers; tiles above the diagonal are never computed.  The state
// update walks the chunk's rows once more.  Thread layout: 256 threads as a
// 16 x 16 grid (ty, tx).  A thread owns rows ty + 16 i (i < 4) of a tile,
// columns tx + 16 j of a 64 x 64 score tile, output features tx + 16 c
// (c < NR), and state entries (p = ty + 16 a, n = tx + 16 c);
// NR = max(ceil(P/16), ceil(N/16)) rounded up to an instantiated width.
// Shared rows are padded by one float so the 16 lanes of a row group read
// distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "split_mma.cuh"

namespace {

constexpr int kT = 64;         // rows of a tile
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
  int Bt, L, H, P, N, chunk;
  long long sxb, sxt, sdb, sdt, sbb, sbt, scb, sct;   // element strides
};

template <typename T, int NR>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, float* __restrict__ y,
           float* __restrict__ state_out, Params p) {
  extern __shared__ float smem[];
  const int P = p.P, N = p.N, c = p.chunk;
  const int ldn = N + 1, ldp = P + 1, ldg = kT + 1;
  float* cs = smem;                  // (kT, N + 1) C rows of the query tile
  float* bs = cs + kT * ldn;         // (kT, N + 1) B rows of the source tile
  float* xs = bs + kT * ldn;         // (kT, P + 1) xdt rows of the source tile
  float* gs = xs + kT * ldp;         // (kT, kT + 1) (C B^T o L) tile
  float* st = gs + kT * ldg;         // (P, N + 1) the carried state
  float* cum = st + P * ldn;         // (c,) cumulative log-decay

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const T* xb = x + b * p.sxb + (long long)h * P;
  const float* dtb = dt + b * p.sdb + h;
  const T* Bb = Bm + b * p.sbb;
  const T* Cb = Cm + b * p.scb;

  for (int e = tid; e < P * ldn; e += kThreads) st[e] = 0.0f;

  // source rows s0.. of the chunk at c0: B into bs, xdt (times w_s when
  // `weighted`: exp(cum_last - cum_s)) into xs; zero past the chunk
  auto load_source = [&](int c0, int s0, bool weighted) {
    for (int e = tid; e < kT * N; e += kThreads) {
      const int r = e / N, n = e - r * N;
      const int s = s0 + r;
      bs[r * ldn + n] = s < c ? to_f32(Bb[(c0 + s) * p.sbt + n]) : 0.0f;
    }
    for (int e = tid; e < kT * P; e += kThreads) {
      const int r = e / P, q = e - r * P;
      const int s = s0 + r;
      float v = 0.0f;
      if (s < c) {
        v = to_f32(xb[(c0 + s) * p.sxt + q]) * dtb[(c0 + s) * p.sdt];
        if (weighted) v *= expf(cum[c - 1] - cum[s]);
      }
      xs[r * ldp + q] = v;
    }
  };

  for (int c0 = 0; c0 < p.L; c0 += c) {
    __syncthreads();                 // the last chunk's state update is done
    for (int t = tid; t < c; t += kThreads) cum[t] = dtb[(c0 + t) * p.sdt] * Ah;
    __syncthreads();
    if (tid < 32) {                  // inclusive scan of cum: one warp
      const int per = (c + 31) / 32;
      const int t0 = tid * per, t1 = min(c, t0 + per);
      float run = 0.0f;
      for (int t = t0; t < t1; ++t) { run += cum[t]; cum[t] = run; }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - run;
      for (int t = t0; t < t1; ++t) cum[t] += excl;
    }

    for (int t0 = 0; t0 < c; t0 += kT) {
      __syncthreads();               // cum is ready; cs, bs, xs, gs are free
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        const int t = t0 + r;
        cs[r * ldn + n] = t < c ? to_f32(Cb[(c0 + t) * p.sct + n]) : 0.0f;
      }
      __syncthreads();

      // the carried state's part: exp(cum_t) * (C_t . state[q, :])
      float acc[4][NR];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < NR; ++k) acc[i][k] = 0.0f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          const int q = tx + 16 * k;
          const float sv = q < P ? st[q * ldn + n] : 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][k] = fmaf(cv[i], sv, acc[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float e = t < c ? expf(cum[t]) : 0.0f;
#pragma unroll
        for (int k = 0; k < NR; ++k) acc[i][k] *= e;
      }

      // the chunk's own part: sum over s <= t of (C_t . B_s) L[t, s] xdt_s
      for (int s0 = 0; s0 <= t0; s0 += kT) {
        __syncthreads();             // the last source tile is used
        load_source(c0, s0, false);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            gs[(ty + 16 * i) * ldg + tx + 16 * j] =
                (t < c && s <= t) ? g[i][j] * expf(cum[t] - cum[s]) : 0.0f;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          float gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = gs[(ty + 16 * i) * ldg + j];
#pragma unroll
          for (int k = 0; k < NR; ++k) {
            const int q = tx + 16 * k;
            const float xv = q < P ? xs[j * ldp + q] : 0.0f;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][k] = fmaf(gv[i], xv, acc[i][k]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= c) continue;
        float* yrow = y + (((long long)b * p.L + c0 + t) * p.H + h) * P;
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          const int q = tx + 16 * k;
          if (q < P) yrow[q] = acc[i][k];
        }
      }
    }

    // state <- exp(cum_last) state + sum_s exp(cum_last - cum_s) xdt_s B_s^T
    float ds[NR][NR];
#pragma unroll
    for (int a = 0; a < NR; ++a)
#pragma unroll
      for (int k = 0; k < NR; ++k) ds[a][k] = 0.0f;
    for (int s0 = 0; s0 < c; s0 += kT) {
      __syncthreads();               // every y tile has read the old state
      load_source(c0, s0, true);
      __syncthreads();
      for (int j = 0; j < kT; ++j) {
        float xv[NR], bv[NR];
#pragma unroll
        for (int a = 0; a < NR; ++a) {
          const int q = ty + 16 * a;
          xv[a] = q < P ? xs[j * ldp + q] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          const int n = tx + 16 * k;
          bv[k] = n < N ? bs[j * ldn + n] : 0.0f;
        }
#pragma unroll
        for (int a = 0; a < NR; ++a)
#pragma unroll
          for (int k = 0; k < NR; ++k) ds[a][k] = fmaf(xv[a], bv[k], ds[a][k]);
      }
    }
    const float decay = expf(cum[c - 1]);
#pragma unroll
    for (int a = 0; a < NR; ++a) {
      const int q = ty + 16 * a;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int n = tx + 16 * k;
        if (q < P && n < N) st[q * ldn + n] = decay * st[q * ldn + n] + ds[a][k];
      }
    }
  }

  __syncthreads();
  float* so = state_out + ((long long)b * p.H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int q = e / N, n = e - q * N;
    so[e] = st[q * ldn + n];
  }
}

size_t smem_bytes(int P, int N, int chunk) {
  return sizeof(float) * ((size_t)kT * (2 * (N + 1) + (P + 1) + kT + 1) +
                          (size_t)P * (N + 1) + (size_t)chunk);
}

template <typename T, int NR>
int launch_nr(const void* x, const float* dt, const float* A, const void* B,
              const void* C, float* y, float* state, const Params& p,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(p.P, p.N, p.chunk);
  auto kern = &ssd_kernel<T, NR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, p.Bt);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), y, state, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, float* y, float* state, const Params& p,
           cudaStream_t stream) {
  const int need = max((p.P + 15) / 16, (p.N + 15) / 16);
  if (need <= 1) return launch_nr<T, 1>(x, dt, A, B, C, y, state, p, stream);
  if (need <= 2) return launch_nr<T, 2>(x, dt, A, B, C, y, state, p, stream);
  if (need <= 4) return launch_nr<T, 4>(x, dt, A, B, C, y, state, p, stream);
  if (need <= 8) return launch_nr<T, 8>(x, dt, A, B, C, y, state, p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// The staged path
// ---------------------------------------------------------------------------

namespace {

using bf16 = __nv_bfloat16;

// The P and N the staged path is instantiated for, and its largest chunk.
#define SSD_STAGED_DIMS(X) X(16) X(32) X(64)
constexpr int kMaxChunk = 256;
constexpr int kWarps = 8;
constexpr int kStageThreads = 32 * kWarps;   // >= kMaxChunk: a row each for cum
constexpr int kPad = 8;                      // bf16 elements of row padding
constexpr int kPassThreads = 128;
static_assert(kStageThreads >= kMaxChunk, "one thread a row of the scan");

template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;   // fp32 inputs

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// wait for every cp.async this thread issued
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 floats into shared memory as their hi and lo bf16 parts
__device__ __forceinline__ void store_split(const float4& v, bf16* hi,
                                            bf16* lo) {
  uint32_t h0, l0, h1, l1;
  split2(v.x, v.y, h0, l0);
  split2(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hi) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

// fn(e, v) for e in [0, n), kStageThreads apart, with v the float4 at
// src(e): each thread's 8 loads are all in flight before the first is used
template <typename Src, typename Fn>
__device__ __forceinline__ void for_each16(int n, Src src, Fn fn) {
  constexpr int kBatch = 8;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kStageThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kStageThreads;
      if (e < n) v[u] = __ldg(reinterpret_cast<const float4*>(src(e)));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kStageThreads;
      if (e < n) fn(e, v[u]);
    }
  }
}

// Rows [0, c) of a (c, W) tile at src (row stride ld elements) into the
// bf16 tile hi (row pitch W + kPad): bf16 rows are copied as they are by
// cp.async (the caller waits), fp32 rows split into hi and lo.
template <typename T, int W>
__device__ __forceinline__ void load_rows(const T* src, long long ld, int c,
                                          bf16* hi, bf16* lo) {
  constexpr int V = 16 / sizeof(T), PER = W / V;
  const int n = c * PER;
  auto at = [](int e) { return e / PER; };
  auto col = [](int e) { return (e % PER) * V; };
  if constexpr (kSplit<T>) {
    for_each16(
        n, [&](int e) { return src + at(e) * ld + col(e); },
        [&](int e, const float4& v) {
          const int o = at(e) * (W + kPad) + col(e);
          store_split(v, hi + o, lo + o);
        });
  } else {
    for (int e = threadIdx.x; e < n; e += kStageThreads)
      cp_async16(hi + at(e) * (W + kPad) + col(e), src + at(e) * ld + col(e));
  }
}

// cum[s] = sum over u <= s of dt_u A and dts[s] = dt_s, for s < c: an
// inclusive scan in every warp, then each warp adds the totals of the
// warps before it (wtot).  The caller syncs before reading cum.
__device__ __forceinline__ void chunk_cumsum(const float* dtb, long long sdt,
                                             float Ah, int c, float* cum,
                                             float* dts, float* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float d = tid < c ? dtb[tid * sdt] : 0.0f;
  float v = d * Ah;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  float before = 0.0f;
  for (int w = 0; w < warp; ++w) before += wtot[w];
  if (tid < c) {
    cum[tid] = v + before;
    dts[tid] = d;
  }
}

// Shared memory of (a): x (c, P) and B (c, N) (and their lo with fp32
// inputs), reused for the warps' partial sums (kWarps / (P / 16) of (P, N)
// fp32); then cum, dt w and the scan's warp totals.
template <typename T, int P, int N>
struct StateSmem {
  static constexpr int LP = P + kPad, LN = N + kPad;
  __host__ __device__ static size_t tiles(int c) {
    return sizeof(bf16) * (size_t)c * (LP + LN) * (kSplit<T> ? 2 : 1);
  }
  __host__ __device__ static size_t base(int c) {
    const size_t red = sizeof(float) * (size_t)kWarps * 16 * N;
    return tiles(c) > red ? tiles(c) : red;
  }
  __host__ __device__ static size_t bytes(int c) {
    return base(c) + sizeof(float) * (2 * (size_t)c + kWarps);
  }
};

// (a) S_j = sum over the chunk's rows s of (x_s dt_s w_s)^T B_s, with
// w_s = exp(total - cum_s): a (P, N) product over c rows.  x and B come in
// as (c)'s do; x's A fragments are scaled by dt w and split into hi and lo
// in registers.  Warp w takes the 16 rows p of tile w % (P / 16) and every
// kWarps / (P / 16)-th k16 step of s; the partial sums meet in shared
// memory, in a fixed order.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kStageThreads, kSplit<T> ? 1 : 3)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                float* __restrict__ chunk_state,
                float* __restrict__ chunk_total, Params p) {
  using S = StateSmem<T, P, N>;
  constexpr int LP = S::LP, LN = S::LN;
  constexpr int MT = P / 16, KG = kWarps / MT;
  extern __shared__ __align__(16) unsigned char stage_smem[];
  const int c = p.chunk, nc = p.L / c;
  constexpr bool SP = kSplit<T>;
  bf16* xh = reinterpret_cast<bf16*>(stage_smem);
  bf16* xl = xh + c * LP;              // fp32 inputs only
  bf16* bh = xh + c * LP * (SP ? 2 : 1);
  bf16* bl = bh + c * LN;              // fp32 inputs only
  float* red = reinterpret_cast<float*>(stage_smem);
  float* cum = reinterpret_cast<float*>(stage_smem + S::base(c));
  float* fs = cum + c;                 // dt, then dt w
  float* wtot = fs + c;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)j * c;
  load_rows<T, P>(x + b * p.sxb + t0 * p.sxt + (long long)h * P, p.sxt, c,
                  xh, xl);
  load_rows<T, N>(Bm + b * p.sbb + t0 * p.sbt, p.sbt, c, bh, bl);
  chunk_cumsum(dt + b * p.sdb + t0 * p.sdt + h, p.sdt, A[h], c, cum, fs,
               wtot);
  __syncthreads();
  const float total = cum[c - 1];
  if (tid < c) fs[tid] *= expf(total - cum[tid]);
  cp_async_wait_all();
  __syncthreads();

  const int mt = warp % MT, kg = warp / MT;
  float acc[N / 8][4];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int ks = kg; ks < c / 16; ks += KG) {
    const int s0 = 16 * ks;
    // A = (x dt w)^T: rows p, columns s, from the (s, p) tile transposed;
    // its registers 0 and 1 hold columns s0 + 2tq and s0 + 2tq + 1, 2 and
    // 3 the same + 8
    const int ar = s0 + (lane & 7) + 8 * (lane >> 4);
    const int ac = 16 * mt + 8 * ((lane >> 3) & 1);
    uint32_t xv[4], xw[4] = {0u, 0u, 0u, 0u}, ah[4], al[4];
    ldsm_x4_t(xv, xh + ar * LP + ac);
    if constexpr (SP) ldsm_x4_t(xw, xl + ar * LP + ac);
    const int fc = s0 + 2 * (lane & 3);
    const float2 f[2] = {*reinterpret_cast<const float2*>(fs + fc),
                         *reinterpret_cast<const float2*>(fs + fc + 8)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 v = unpack(xv[q]);
      if constexpr (SP) {
        const float2 u = unpack(xw[q]);
        v.x += u.x;
        v.y += u.y;
      }
      split2(v.x * f[q >> 1].x, v.y * f[q >> 1].y, ah[q], al[q]);
    }
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
  __syncthreads();                   // every warp is done with the tiles

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 16 * mt + g + 8 * hf, col = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(red + ((size_t)kg * P + row) * N + col) =
          make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  __syncthreads();
  const size_t blk = ((size_t)b * nc + j) * p.H + h;
  float4* out = reinterpret_cast<float4*>(chunk_state + blk * P * N);
  const float4* r4 = reinterpret_cast<const float4*>(red);
  for (int e = tid; e < P * N / 4; e += kStageThreads) {
    float4 s = r4[e];
#pragma unroll
    for (int k = 1; k < KG; ++k) {
      const float4 u = r4[k * (P * N / 4) + e];
      s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
    }
    out[e] = s;
  }
  if (tid == 0) chunk_total[blk] = total;
}

// (b) per (b, h) and 4 state entries a thread, over the chunks in order:
// passed_j = st (the state entering chunk j), st = exp(total_j) st + S_j;
// the last st is the final state.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float4* __restrict__ chunk_state,
               const float* __restrict__ chunk_total,
               float4* __restrict__ passed, float4* __restrict__ state,
               int nc, int H, int pn4) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= pn4) return;
  float4 st = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < nc; ++j) {
    const size_t blk = ((size_t)b * nc + j) * H + h;
    passed[blk * pn4 + e] = st;
    const float d = expf(chunk_total[blk]);
    const float4 s = chunk_state[blk * pn4 + e];
    st.x = d * st.x + s.x;
    st.y = d * st.y + s.y;
    st.z = d * st.z + s.z;
    st.w = d * st.w + s.w;
  }
  state[((size_t)b * H + h) * pn4 + e] = st;
}

// Shared memory of (c): x (c, P) and B (c, N) (and their lo with fp32
// inputs), the passed state as hi and lo (P, N); then cum, dt, the column
// factors of the decay and the scan's warp totals.
template <typename T, int P, int N>
struct ScanSmem {
  static constexpr int LP = P + kPad, LN = N + kPad;
  __host__ __device__ static size_t base(int c) {
    return sizeof(bf16) * ((size_t)c * (LP + LN) * (kSplit<T> ? 2 : 1) +
                           2 * (size_t)P * LN);
  }
  __host__ __device__ static size_t bytes(int c) {
    return base(c) + sizeof(float) * (3 * (size_t)c + kWarps);
  }
};

// The A fragment pair of C at g (row stride ld): as it is in bf16, split
// into hi and lo in fp32
__device__ __forceinline__ void c_pair(const bf16* g, uint32_t& hi,
                                       uint32_t& lo) {
  hi = __ldg(reinterpret_cast<const unsigned int*>(g));
  lo = 0u;
}

__device__ __forceinline__ void c_pair(const float* g, uint32_t& hi,
                                       uint32_t& lo) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(g));
  split2(v.x, v.y, hi, lo);
}

// (C B^T o L)[t, s] dt_s for one score: exp(cum_t - cum_s) only where
// t >= s
__device__ __forceinline__ float decayed(float gv, int t, int s, float ct,
                                         const float* cum, const float* dts) {
  return t >= s ? gv * expf(ct - cum[s]) * dts[s] : 0.0f;
}

// (c) y of one chunk and head.  Warp w takes strip pairs (i, n - 1 - i),
// i = w, w + kWarps, ...: per 16-row strip r its C rows as A fragments
// (registers), the carried state's part exp(cum_t) C_t st^T, then for each
// 16-row source tile s0 <= 16 r the scores G = C B^T (two n8 tiles), made
// (G o L) dt and split into hi and lo as the next product's A fragment,
// times x.  Every tile of x and B is in shared memory before the first
// strip: waiting for half of them lets the warps of short strips start,
// but the barrier between the halves then holds every warp to the longest
// short strip, which cost more than it saved (PERF.md).
template <typename T, int P, int N>
__global__ void __launch_bounds__(kStageThreads, kSplit<T> ? 1 : 2)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ passed,
               float* __restrict__ y, Params p) {
  using S = ScanSmem<T, P, N>;
  constexpr int LP = S::LP, LN = S::LN;
  constexpr bool SP = kSplit<T>;
  extern __shared__ __align__(16) unsigned char stage_smem[];
  const int c = p.chunk, nc = p.L / c;
  bf16* xh = reinterpret_cast<bf16*>(stage_smem);
  bf16* xl = xh + c * LP;              // fp32 inputs only
  bf16* bh = xh + c * LP * (SP ? 2 : 1);
  bf16* bl = bh + c * LN;              // fp32 inputs only
  bf16* sh = bh + c * LN * (SP ? 2 : 1);
  bf16* sl = sh + P * LN;
  float* cum = reinterpret_cast<float*>(stage_smem + S::base(c));
  float* dts = cum + c;
  float* colf = dts + c;
  float* wtot = colf + c;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const long long t0 = (long long)j * c;
  const bool carry = j > 0;          // the state entering chunk 0 is 0

  load_rows<T, P>(x + b * p.sxb + t0 * p.sxt + (long long)h * P, p.sxt, c,
                  xh, xl);
  load_rows<T, N>(Bm + b * p.sbb + t0 * p.sbt, p.sbt, c, bh, bl);
  chunk_cumsum(dt + b * p.sdb + t0 * p.sdt + h, p.sdt, A[h], c, cum, dts,
               wtot);
  __syncthreads();
  // colf[s] = exp(cum_e - cum_s) dt_s, e the last row of s's 16-row tile
  if (tid < c) colf[tid] = expf(cum[tid | 15] - cum[tid]) * dts[tid];
  if (carry) {
    const float* st = passed + (((size_t)b * nc + j) * p.H + h) * P * N;
    for_each16(
        P * N / 4, [&](int e) { return st + 4 * e; },
        [&](int e, const float4& v) {
          const int o = (e / (N / 4)) * LN + (e % (N / 4)) * 4;
          store_split(v, sh + o, sl + o);
        });
  }

  const T* Cb = Cm + b * p.scb + t0 * p.sct;
  const long long hp = (long long)p.H * P;
  auto strip = [&](int r) {
    const int tr = 16 * r;
    // C rows tr.. as A fragments: (g, 2tq), (g + 8, 2tq), (g, 2tq + 8),
    // (g + 8, 2tq + 8) of each k16 step
    uint32_t ch[N / 16][4], cl[N / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        c_pair(Cb + (tr + g + 8 * (q & 1)) * p.sct + 16 * kk + 2 * tq +
                   8 * (q >> 1),
               ch[kk][q], cl[kk][q]);
    const float cum0 = cum[tr + g], cum1 = cum[tr + g + 8];

    float acc[P / 8][4];
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pt][e] = 0.0f;
    if (carry) {
      // exp(cum_t) C_t st^T: B operand st^T (k = n, n = p) from (p, n)
      const int sr = (lane & 7) + 8 * (lane >> 4);
      const int sc = 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t vh[4], vl[4];
          const int off = (16 * pp + sr) * LN + 16 * kk + sc;
          ldsm_x4(vh, sh + off);
          ldsm_x4(vl, sl + off);
          mma_split<SP, true>(acc[2 * pp], ch[kk], cl[kk], vh[0], vh[1],
                              vl[0], vl[1]);
          mma_split<SP, true>(acc[2 * pp + 1], ch[kk], cl[kk], vh[2],
                              vh[3], vl[2], vl[3]);
        }
      const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        acc[pt][0] *= e0; acc[pt][1] *= e0;
        acc[pt][2] *= e1; acc[pt][3] *= e1;
      }
    }

    for (int sb = 0; sb <= r; ++sb) {
      const int s0 = 16 * sb;
      // G = C B^T for source rows s0..s0+15: B operand B^T (k = n,
      // n = s) from (s, n), two n8 tiles
      float gs[2][4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int e = 0; e < 4; ++e) gs[i2][e] = 0.0f;
      const int brow = s0 + (lane & 7) + 8 * (lane >> 4);
      const int bcol = 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
        const int off = brow * LN + 16 * kk + bcol;
        ldsm_x4(vh, bh + off);
        if constexpr (SP) ldsm_x4(vl, bl + off);
        mma_split<SP, SP>(gs[0], ch[kk], cl[kk], vh[0], vh[1], vl[0],
                          vl[1]);
        mma_split<SP, SP>(gs[1], ch[kk], cl[kk], vh[2], vh[3], vl[2],
                          vl[3]);
      }
      // (G o L) dt, split: the accumulator of the two n8 tiles is the A
      // fragment of the k16 step s0.. of the next product
      uint32_t ah[4], al[4];
      if (sb < r) {
        // below the diagonal every s < t: exp(cum_t - cum_s) dt_s is
        // exp(cum_t - cum_e) colf[s], e = s0 + 15 between s and t, so both
        // exponents are <= 0
        const float ce = cum[s0 + 15];
        const float f0 = expf(cum0 - ce), f1 = expf(cum1 - ce);
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int s = s0 + 8 * i2 + 2 * tq;
          const float w0 = colf[s], w1 = colf[s + 1];
          split2(gs[i2][0] * f0 * w0, gs[i2][1] * f0 * w1, ah[2 * i2],
                 al[2 * i2]);
          split2(gs[i2][2] * f1 * w0, gs[i2][3] * f1 * w1, ah[2 * i2 + 1],
                 al[2 * i2 + 1]);
        }
      } else {
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int s = s0 + 8 * i2 + 2 * tq, t = tr + g;
          split2(decayed(gs[i2][0], t, s, cum0, cum, dts),
                 decayed(gs[i2][1], t, s + 1, cum0, cum, dts), ah[2 * i2],
                 al[2 * i2]);
          split2(decayed(gs[i2][2], t + 8, s, cum1, cum, dts),
                 decayed(gs[i2][3], t + 8, s + 1, cum1, cum, dts),
                 ah[2 * i2 + 1], al[2 * i2 + 1]);
        }
      }
      // y += ((G o L) dt) x: B operand x (k = s, n = p) from (s, p),
      // transposed
      const int xrow = s0 + (lane & 15), xcol = 8 * (lane >> 4);
#pragma unroll
      for (int pp = 0; pp < P / 16; ++pp) {
        uint32_t vh[4], vl[4] = {0u, 0u, 0u, 0u};
        const int off = xrow * LP + 16 * pp + xcol;
        ldsm_x4_t(vh, xh + off);
        if constexpr (SP) ldsm_x4_t(vl, xl + off);
        mma_split<true, SP>(acc[2 * pp], ah, al, vh[0], vh[1], vl[0],
                            vl[1]);
        mma_split<true, SP>(acc[2 * pp + 1], ah, al, vh[2], vh[3], vl[2],
                            vl[3]);
      }
    }

    float* yr = y + ((size_t)b * p.L + t0 + tr + g) * hp + (size_t)h * P;
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      const int col = 8 * pt + 2 * tq;
      *reinterpret_cast<float2*>(yr + col) =
          make_float2(acc[pt][0], acc[pt][1]);
      *reinterpret_cast<float2*>(yr + 8 * hp + col) =
          make_float2(acc[pt][2], acc[pt][3]);
    }
  };
  cp_async_wait_all();
  __syncthreads();
  // warp w takes strips i and n - 1 - i for i = w, w + kWarps, ...
  const int n_strips = c / 16;
  for (int i = warp; i < (n_strips + 1) / 2; i += kWarps) {
    strip(i);
    if (n_strips - 1 - i != i) strip(n_strips - 1 - i);
  }
}

struct Staged {
  const void *x, *B, *C;
  const float *dt, *A;
  float *y, *state, *chunk_state, *passed, *chunk_total;
};

template <typename T, int P, int N>
int launch_staged_pn(const Staged& a, const Params& p, cudaStream_t stream) {
  const int nc = p.L / p.chunk;
  const dim3 grid(p.H, nc, p.Bt);
  const T* x = static_cast<const T*>(a.x);
  const T* B = static_cast<const T*>(a.B);
  const T* C = static_cast<const T*>(a.C);

  auto ka = &ssd_chunk_state<T, P, N>;
  const size_t sa = StateSmem<T, P, N>::bytes(p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err != cudaSuccess) return (int)err;
  ka<<<grid, kStageThreads, sa, stream>>>(x, a.dt, a.A, B, a.chunk_state,
                                          a.chunk_total, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int pn4 = P * N / 4;
  ssd_state_pass<<<dim3((pn4 + kPassThreads - 1) / kPassThreads, p.H, p.Bt),
                   kPassThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(a.chunk_state), a.chunk_total,
      reinterpret_cast<float4*>(a.passed), reinterpret_cast<float4*>(a.state),
      nc, p.H, pn4);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto kc = &ssd_chunk_scan<T, P, N>;
  const size_t sc = ScanSmem<T, P, N>::bytes(p.chunk);
  err = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sc);
  if (err != cudaSuccess) return (int)err;
  kc<<<grid, kStageThreads, sc, stream>>>(x, a.dt, a.A, B, C, a.passed, a.y,
                                          p);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_staged_p(const Staged& a, const Params& p, cudaStream_t stream) {
  switch (p.N) {
#define SSD_CASE(n) case n: return launch_staged_pn<T, P, n>(a, p, stream);
    SSD_STAGED_DIMS(SSD_CASE)
#undef SSD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_staged(const Staged& a, const Params& p, cudaStream_t stream) {
  switch (p.P) {
#define SSD_CASE(n) case n: return launch_staged_p<T, n>(a, p, stream);
    SSD_STAGED_DIMS(SSD_CASE)
#undef SSD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (x, B and C alike; dt and A are fp32).
// strides holds 8 element strides: x's, dt's, B's and C's over (batch,
// time); the (H, P) of x, the H of dt and the N of B and C are contiguous.
// y is a contiguous fp32 (Bt, L, H, P), state a contiguous fp32
// (Bt, H, P, N).  Returns a cudaError_t code: 0 when the launch was accepted.
int ssd_forward(int dtype, const void* x, const void* dt, const void* A,
                const void* B, const void* C, void* y, void* state, int Bt,
                int L, int H, int P, int N, int chunk,
                const long long* strides, void* stream) {
  if (Bt < 1 || L < 1 || H < 1 || P < 1 || N < 1 || chunk < 1 ||
      L % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Params p{Bt, L, H, P, N, chunk, strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5], strides[6], strides[7]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  switch (dtype) {
    case 0: return launch<float>(x, dtf, Af, B, C, yf, sf, p, st);
    case 1: return launch<__nv_bfloat16>(x, dtf, Af, B, C, yf, sf, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The staged path: dtype, x, dt, A, B, C, y, state and strides as
// ssd_forward's; chunk_state and passed are fp32 (Bt, L / chunk, H, P, N)
// scratch, chunk_total fp32 (Bt, L / chunk, H).  P and N in
// SSD_STAGED_DIMS, the chunk a multiple of 16 up to kMaxChunk; x, B and C
// 16-byte aligned, with strides that keep every row so.  Three launches on
// `stream`; returns the first cudaError_t code that is not 0, else 0.
int ssd_staged(int dtype, const void* x, const void* dt, const void* A,
               const void* B, const void* C, void* y, void* state,
               void* chunk_state, void* passed, void* chunk_total, int Bt,
               int L, int H, int P, int N, int chunk,
               const long long* strides, void* stream) {
  if (Bt < 1 || L < 1 || H < 1 || chunk < 16 || chunk > kMaxChunk ||
      chunk % 16 != 0 || L % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Params p{Bt, L, H, P, N, chunk, strides[0], strides[1], strides[2],
           strides[3], strides[4], strides[5], strides[6], strides[7]};
  Staged a{x, B, C, static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<float*>(y),
           static_cast<float*>(state), static_cast<float*>(chunk_state),
           static_cast<float*>(passed), static_cast<float*>(chunk_total)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_staged<float>(a, p, st);
    case 1: return launch_staged<bf16>(a, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
