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
// What bounds it on an H100: per (b, h, chunk) it does ~2 c^2 N + 2 c^2 P
// flops for the quadratic form (half of it under the causal mask) and
// 4 c P N for the state, against ~c (P + 2 N) input values, so at
// c = 256, P = N = 64 it is bound by arithmetic, not bytes.  It computes
// exactly in fp32 on the FMA units (67 TFLOP/s peak); tensor cores in TF32
// or bf16 would be faster and less exact, and are later work, as is
// sharing C B^T (which does not depend on the head) across the heads.
// What the design does: the chunks of one (b, h) depend on each other
// through the state and blocks run in no order, so one block owns one
// (b, h) and walks its chunks in order, the (P, N) state in shared memory.
// A chunk's (c, c) matrix would not fit shared memory at c = 256 (256 KB in
// fp32), so the chunk is cut into 64-row tiles: for each tile of query rows
// t the block forms C B^T o L against each 64-row tile of source rows
// s <= t, one 64 x 64 tile at a time, and accumulates y in registers; tiles
// above the diagonal are never computed.  The state update walks the
// chunk's rows once more.
//
// Thread layout: 256 threads as a 16 x 16 grid (ty, tx).  A thread owns rows
// ty + 16 i (i < 4) of a tile, columns tx + 16 j of a 64 x 64 score tile,
// output features tx + 16 c (c < NR), and state entries
// (p = ty + 16 a, n = tx + 16 c); NR = max(ceil(P/16), ceil(N/16)) rounded up
// to an instantiated width.  Shared rows are padded by one float so the 16
// lanes of a row group read distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
