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
//     gives corr = exp(NEG - m) = 0, which wipes them, as on the TPU.  The
//     bf16 kernel works in base 2 (scores times scale * log2(e), exp2): NEG
//     stays NEG in those units, so the same two identities hold.
//
// What bounds it on an H100: at the serving shapes (S = 2048, D = 64 or 80)
// it does ~4 S D flops per byte of q, k, v and o, far above the card's
// ridge, so the bound is arithmetic: the bf16 tensor cores (989 TFLOP/s) for
// bf16 inputs, the fp32 FMA units (67 TFLOP/s) for exact fp32 inputs.
//
// bf16: tensor cores fed by TMA, warp-specialised.  A block owns one
// (b, h, query tile) and loops over its key tiles (no accumulator can carry
// across blocks on Hopper).  Warpgroup 0 is the producer: one thread loads
// the Q tile once with TMA, then streams K and V tiles into a two-stage
// ring in shared memory, each stage with a full barrier (TMA transaction
// bytes) and an empty barrier (one arrival per consumer warp).  The other
// warpgroups are consumers of 64 query rows each (two, or three where
// D, Dv <= 64 and the registers allow: 128 or 192 rows a block).  For key
// tile j a consumer issues S_j = Q K_j^T by `wgmma` (both operands K-major
// in shared memory, fp32 accumulator in registers), then O += P_{j-1} V_{j-1}
// by `wgmma` with P from registers (the S accumulator converted to bf16 in
// the A-fragment layout) and V read with its Dv dimension contiguous (the
// transposed-B descriptor, N = Dv in one instruction); it runs tile j's
// online softmax while that PV is on the tensor cores.  The consumers take
// turns to issue (named barriers), so one's softmax also overlaps the
// others' products.  `setmaxnreg` moves registers from the producer to the
// consumers.  The element mask runs only on the tiles that cut the causal
// diagonal, the window edge or Sk; elsewhere the scale folds into the exp2's
// FMA.  Blocks run head by head in groups of 8 heads (block_tile), so a
// head's K and V are read from device memory about once.
//
// Shared-memory layout (bf16): every tile is stored as 64-column atoms of
// rows x 128 bytes with the 128-byte swizzle, one TMA box {64, rows} each,
// so any D or Dv that is a multiple of 16 up to 256 is ceil(D / 64) atoms
// whose unused columns TMA zero-fills (D = 80: two atoms, columns 80..127
// zero; 60 % more shared memory for Q, K and V than D needs, and no wasted
// MMA work: S takes D / 16 = 5 k-steps of 16, PV one N = 80 wgmma whose B
// descriptor steps from the first atom to the second by its leading byte
// offset).  PV is one wgmma of N = Dv for Dv = 16 ... 80, 128 and 240; the
// other widths issue one per 64-column atom of V (wgmma_rs).  Key tiles are
// 128 keys for D, Dv <= 128 and 64 above; the ring with Q then takes 160 KB
// at D = 80 or 128, 88 KB at D = 64 (192 rows), 128 KB at 192 / 128 and
// 192 KB at 240 or 256.  FA_HEAD_DIMS (host side) lists the (D, Dv) pairs
// that both dtypes are instantiated for.

// fp32: exact IEEE fp32 on the FMA units (no TF32), register-tiled.  A block
// of 256 threads (16 x 16) owns 128 query rows (64 when D is large); thread
// (ty, tx) owns the scores of rows ty + 16 i (i < 8, or 4) against keys
// tx + 16 j (j < 4) of a 64-key tile, and the outputs of those rows in
// columns tx + 16 c, so each float4 read from shared memory feeds 8 to 32
// FMAs.  K and V tiles are double-buffered with `cp.async` (single-buffered
// when two stages do not fit 227 KB), so the next tile loads under the
// FMAs.  Rows of the shared tiles are padded by 4 floats: the 8 lanes of a
// 16-byte read phase hit distinct banks for every D that is a multiple of 16.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

#include "flash_head_dims.cuh"
#include "hopper_wgmma.cuh"

namespace {

constexpr float kNeg = -2.0e38f;
constexpr int kMaxSmem = 232448;      // 227 KB of dynamic shared memory a block

struct Params {
  int B, H, Kh, Sq, Sk, D, Dv;
  long long sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  float scale;
  int causal, window;
};

// heads (b, h) whose query tiles the bf16 kernel runs together (see
// block_tile): their K and V (8 x 655 KB at zamba2's S = 2048, D = 80) stay
// in L2 while the tiles that read them run
constexpr int kHeadGroup = 8;

// The block's (b, h) and first query row, from a one-dimensional grid in
// which the latest query tiles (which see the most keys) come first.
// grouped: the heads go in groups of kHeadGroup, each group's tiles
// consecutive (latest first across the group), so the blocks that share a
// head's K and V run close together and find them in L2 (the bf16 kernel;
// with every head's latest tile first it read each head's K and V again
// from device memory for each query tile, and took a third longer at
// zamba2's shape); else every head's latest tile first (the fp32 kernel,
// bound by its FMAs, where that order balanced the SMs better)
__device__ __forceinline__ void block_tile(const Params& p, int bq,
                                           bool grouped, int& b, int& h,
                                           int& q_lo) {
  const int nqt = (p.Sq + bq - 1) / bq, nbh = p.B * p.H;
  const int g = grouped ? kHeadGroup : nbh;          // heads a group
  const int first = blockIdx.x / (g * nqt) * g;      // the group's first head
  const int r = blockIdx.x - first * nqt;
  const int size = min(g, nbh - first);
  const int bh = first + r % size, t = r / size;
  b = bh / p.H;
  h = bh % p.H;
  q_lo = (nqt - 1 - t) * bq;
}

// the key tiles [begin, end) that a query tile [q_lo, q_lo + bq) visits
// (whole-tile skipping, left-aligned causal mask, window)
__device__ __forceinline__ void tile_range(const Params& p, int q_lo, int bq,
                                           int bk, int& begin, int& end) {
  const int nkt = (p.Sk + bk - 1) / bk;
  end = p.causal ? min(nkt, (q_lo + bq - 1) / bk + 1) : nkt;
  const int lo = q_lo - p.window + 1;     // the earliest key a row may see
  begin = (p.window && lo > 0) ? lo / bk : 0;
}

// whether any (row, key) of rows [r_lo, r_hi] x keys [k_lo, k_hi] is masked
__device__ __forceinline__ bool tile_cut(const Params& p, int r_lo, int r_hi,
                                         int k_lo, int k_hi) {
  return k_hi >= p.Sk || (p.causal && k_hi > r_lo) ||
         (p.window && r_hi - k_lo >= p.window);
}

__device__ __forceinline__ bool key_ok(const Params& p, int qi, int kj) {
  return kj < p.Sk && (!p.causal || qi >= kj) &&
         (!p.window || qi - kj < p.window);
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma
// ---------------------------------------------------------------------------

// named barrier `id` of 256 threads, one consumer warpgroup's turn: that
// warpgroup syncs on it, and the one before it in the ring arrives (when
// `pred`) to hand the turn on
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, bool pred) {
  asm volatile("{\n.reg .pred p;\n"
               "setp.ne.b32 p, %1, 0;\n"
               "@p bar.arrive %0, 256;\n}\n"
               :: "r"(id), "r"((int)pred) : "memory");
}

// One key tile of the online softmax, base 2, on a consumer thread's part of
// S: s[i] is row (i >> 1) & 1 ? row1 : row0 and key k0 + 8 (i >> 2) + (i & 1).
// In place, s becomes the probabilities exp2(s sl2 - m); m, l move to the
// tile and corr is the factor that rescales the output accumulated so far.
// CUT: the tile holds masked (row, key) pairs, which become NEG (in units
// of s sl2); else every score is valid and the scale folds into one FMA.
template <int BK, bool CUT>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float sl2, const Params& p,
                                             int row0, int row1, int k0) {
  // a row's valid keys, relative to k0: [lo, hi)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row1 : row0;
    hi[r] = (p.causal ? min(p.Sk, qi + 1) : p.Sk) - k0;
    lo[r] = p.window ? qi - p.window + 1 - k0 : -BK;
  }
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1, c = 8 * (i >> 2) + (i & 1);
    if (CUT) s[i] = c >= lo[r] && c < hi[r] ? s[i] * sl2 : kNeg;
    mx[r] = fmaxf(mx[r], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // sl2 > 0, so the max of the rounded s sl2 is the rounded max s sl2
    const float m_new = fmaxf(m[r], CUT ? mx[r] : mx[r] * sl2);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    // an uncut tile holds a valid key for every row, so m is finite here
    s[i] = CUT ? ex2(s[i] - m[r]) : ex2(fmaf(s[i], sl2, -m[r]));
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
}



// the tiles of head dims (D, DV): DA 64-column atoms of q and k, VA of v
// and o
template <int D, int DV>
struct Tiles {
  static constexpr int DA = (D + 63) / 64, VA = (DV + 63) / 64;
  static constexpr int BK = (DA <= 2 && VA <= 2) ? 128 : 64;
  // consumer warpgroups of 64 query rows: three where their registers fit
  // (S, P and O of 64 columns), else two; and the registers they take
  // from the producer warpgroup with setmaxnreg (the SM's 64K in all)
  static constexpr int NW = (D <= 64 && DV <= 64) ? 3 : 2;
  static constexpr int BQ = 64 * NW;             // query rows a block
  static constexpr int kThreads = 128 * (NW + 1);
  static constexpr int kProducerRegs = NW == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = NW == 3 ? 160 : 232;
  static constexpr int kAtomQ = BQ * 128;        // bytes of one atom
  static constexpr int kAtomK = BK * 128;
  static constexpr int kQBytes = DA * kAtomQ;
  static constexpr int kKBytes = DA * kAtomK;
  static constexpr int kVBytes = VA * kAtomK;
  // the ring of K and V stages (three measured no faster on the H100)
  static constexpr int kStages = 2;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  // + the barriers, + 1024 to align the base to the swizzle's 1024 bytes
  static constexpr int kSmem = kBarOff + 128 + 1024;
};

// The consumer's steps on one key tile, whose stage's barrier completes
// with `parity`.  Each wgmma batch is bracketed by pins, a fence and a
// commit, and no branch holds a wgmma, so ptxas keeps the batches
// asynchronous.

// S = Q K^T for this warpgroup's 64 rows: D / 16 k-steps of 16 columns,
// 4 to an atom
template <int D, int DV>
__device__ __forceinline__ void issue_qk(float (&s)[Tiles<D, DV>::BK / 2],
                                         uint32_t sq, uint32_t sk,
                                         uint32_t full, uint32_t parity) {
  using T = Tiles<D, DV>;
  mbar_wait(full, parity);
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = gmma_desc(sq + (kk / 4) * T::kAtomQ + (kk % 4) * 32,
                                  16);
    const uint64_t db = gmma_desc(sk + (kk / 4) * T::kAtomK + (kk % 4) * 32,
                                  16);
    wgmma_ss<T::BK>(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// O = O corr + P V: one wgmma of N = DV for each 16 keys, its B descriptor
// stepping across V's 64-column atoms (LBO)
template <int D, int DV>
__device__ __forceinline__ void issue_pv(
    float (&acc)[DV / 2], uint32_t (&pa)[Tiles<D, DV>::BK / 16][4],
    const float (&corr)[2], uint32_t sv, uint32_t full, uint32_t parity) {
  using T = Tiles<D, DV>;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
  mbar_wait(full, parity);
  pin(acc);
  pin(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
    wgmma_rs<DV>(acc, pa[kk], gmma_desc(sv + kk * 16 * 128, T::kAtomK));
  wgmma_commit();
}

// P rounded to bf16 in the A-fragment layout: the accumulator's 8 values of
// 16 keys are the 4 registers of one k-step
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// LSE: also write each row's natural log-sum-exp of its masked scores to
// lse (B, H, Sq) fp32 (training's forward, read by the backward kernels);
// NEG for a row that no key is visible to, as the plain logsumexp gives
// (log Sk is absorbed).  Serving instantiates LSE = false.
template <int D, int DV, bool LSE>
__global__ void __launch_bounds__(Tiles<D, DV>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  const Params p) {
  using T = Tiles<D, DV>;
  constexpr int BK = T::BK, DA = T::DA, VA = T::VA, S = T::kStages;
  constexpr int BQ = T::BQ, NW = T::NW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + T::kKOff, sv = base + T::kVOff;
  const uint32_t bars = base + T::kBarOff;
  // barriers: q full; k full, v full, k empty, v empty per stage.  Key
  // tile it uses stage it % S, whose barriers complete their phase of
  // parity (it / S) & 1 for it
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + S + st); };
  auto k_empty = [&](int st) { return bars + 8 * (1 + 2 * S + st); };
  auto v_empty = [&](int st) { return bars + 8 * (1 + 3 * S + st); };

  const int tid = threadIdx.x;
  int b, h, q_lo;
  block_tile(p, BQ, true, b, h, q_lo);
  const int kh = h / (p.H / p.Kh);
  int kt_begin, kt_end;
  tile_range(p, q_lo, BQ, BK, kt_begin, kt_end);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4 * NW);  // one arrival per consumer warp
      mbar_init(v_empty(st), 4 * NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(T::kProducerRegs) : "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int a = 0; a < DA; ++a)
        tma_load(sq + a * T::kAtomQ, &tq, a * 64, q_lo, h, b, q_full);
      for (int kt = kt_begin, it = 0; kt < kt_end; ++kt, ++it) {
        const int st = it % S;
        const uint32_t free_parity = ((it / S) & 1) ^ 1;
        mbar_wait(k_empty(st), free_parity);
        mbar_expect_tx(k_full(st), T::kKBytes);
#pragma unroll
        for (int a = 0; a < DA; ++a)
          tma_load(sk + st * T::kKBytes + a * T::kAtomK, &tk, a * 64, kt * BK,
                   kh, b, k_full(st));
        mbar_wait(v_empty(st), free_parity);
        mbar_expect_tx(v_full(st), T::kVBytes);
#pragma unroll
        for (int a = 0; a < VA; ++a)
          tma_load(sv + st * T::kVBytes + a * T::kAtomK, &tv, a * 64, kt * BK,
                   kh, b, v_full(st));
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(T::kConsumerRegs) : "memory");
    const int wg = tid / 128 - 1, warp = (tid / 32) & 3, lane = tid & 31;
    const int row0 = q_lo + wg * 64 + warp * 16 + lane / 4;  // its rows
    const int row1 = row0 + 8;
    const int cq = (lane & 3) * 2;                   // its first column in 8
    const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)

    float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
    float acc[DV / 2];           // O: rows row0 / row1, 8-column groups
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;

    // Tile it's S = Q K^T is issued before tile it - 1's O += P V, and
    // tile it's softmax runs while that PV is on the tensor cores.
    const int n = kt_end - kt_begin;
    const uint32_t sq_wg = sq + wg * 64 * 128;       // this warpgroup's Q
    float s[BK / 2];             // S of tile it, then its probabilities
    uint32_t pa[BK / 16][4] = {};  // P of tile it - 1 in bf16
    float corr[2] = {1.0f, 1.0f};
    auto softmax = [&](int it) {
      pin(s);
      __syncwarp();
      mbar_arrive_if(k_empty(it % S), lane == 0);
      const int k_lo = (kt_begin + it) * BK;
      // (decided for the block's rows, not the warpgroup's: uniform)
      if (tile_cut(p, q_lo, q_lo + BQ - 1, k_lo, k_lo + BK - 1))
        softmax_tile<BK, true>(s, m, l, corr, sl2, p, row0, row1, k_lo + cq);
      else
        softmax_tile<BK, false>(s, m, l, corr, sl2, p, row0, row1,
                                k_lo + cq);
    };
    auto pv_done = [&](int it) {
      pin(acc);
      __syncwarp();
      mbar_arrive_if(v_empty(it % S), lane == 0);
    };
    // The warpgroups take turns, in a ring, to issue their wgmmas (named
    // barrier 1 + w is warpgroup w's turn), so one's softmax runs while
    // another's products hold the tensor cores.  Each issues n + 1 times;
    // warpgroup 0 goes first, and the last passes the turn on after all
    // but its last issue.
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % NW;
    named_arrive(1, wg == NW - 1 && n > 0);
    mbar_wait(q_full, 0);
    if (n > 0) {
      named_sync(my_turn);
      issue_qk<D, DV>(s, sq_wg, sk, k_full(0), 0u);
      named_arrive(next_turn, true);
      wgmma_wait<0>();
      softmax(0);
      pack_p<BK>(s, pa);
      for (int it = 1; it < n; ++it) {
        const int st = it % S, pst = (it - 1) % S;
        named_sync(my_turn);
        issue_qk<D, DV>(s, sq_wg, sk + st * T::kKBytes, k_full(st),
                        (it / S) & 1);
        issue_pv<D, DV>(acc, pa, corr, sv + pst * T::kVBytes, v_full(pst),
                        ((it - 1) / S) & 1);
        named_arrive(next_turn, true);
        wgmma_wait<1>();         // S is done, the PV may not be
        softmax(it);
        wgmma_wait<0>();
        pv_done(it - 1);
        pack_p<BK>(s, pa);
      }
      const int pst = (n - 1) % S;
      named_sync(my_turn);
      issue_pv<D, DV>(acc, pa, corr, sv + pst * T::kVBytes, v_full(pst),
                      ((n - 1) / S) & 1);
      named_arrive(next_turn, wg != NW - 1);
      wgmma_wait<0>();
      pv_done(n - 1);
    }

    // out = acc / max(l, 1e-20): l summed over the row's 4 lanes
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = l[r];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      den[r] = fmaxf(t, 1e-20f);
      // m is in units of s sl2: lse = ln 2 (m + log2 l)
      const int qi = r ? row1 : row0;
      if (LSE && (lane & 3) == 0 && qi < p.Sq)
        lse[((long long)b * p.H + h) * p.Sq + qi] =
            m[r] <= kNeg ? kNeg : (m[r] + log2f(t)) * 0.6931471805599453f;
    }
    __nv_bfloat16* ob = o + b * p.sob + h * p.soh;
#pragma unroll
    for (int g = 0; g < DV / 8; ++g)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r ? row1 : row0;
        if (qi < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + qi * p.sos + 8 * g + cq) =
              __floats2bfloat162_rn(acc[4 * g + 2 * r] / den[r],
                                    acc[4 * g + 2 * r + 1] / den[r]);
      }
  }
}

// ---------------------------------------------------------------------------
// fp32: register-tiled FMAs, cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;       // 16 x 16
constexpr int kBK32 = 64;              // keys a tile

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (src is then not read)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// shared memory of the fp32 kernel: q (BQ, D + 4), `stages` k (64, D + 4)
// and v (64, Dv + 4) tiles, p (BQ, 64 + 4)
__host__ __device__ constexpr size_t f32_smem(int ri, int stages, int D,
                                           int Dv) {
  return sizeof(float) * ((size_t)16 * ri * (D + 4) +
                          (size_t)stages * kBK32 * (D + 4) +
                          (size_t)stages * kBK32 * (Dv + 4) +
                          (size_t)16 * ri * (kBK32 + 4));
}

// RI query rows and NC output columns a thread; BQ = 16 RI rows a block;
// LSE as the bf16 kernel's
template <int RI, int NC, bool LSE>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, const Params p, const int stages) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BQ = 16 * RI;
  const int D = p.D, Dv = p.Dv;
  const int ldq = D + 4, ldv = Dv + 4, ldp = kBK32 + 4;
  float* qs = smem;
  float* ks = qs + BQ * ldq;
  float* vs = ks + stages * kBK32 * ldq;
  float* ps = vs + stages * kBK32 * ldv;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  int b, h, q_lo;
  block_tile(p, BQ, false, b, h, q_lo);
  const int kh = h / (p.H / p.Kh);
  const float* qb = q + b * p.sqb + h * p.sqh;
  const float* kb = k + b * p.skb + kh * p.skh;
  const float* vb = v + b * p.svb + kh * p.svh;
  const int d4 = D / 4, v4 = Dv / 4;
  int kt_begin, kt_end;
  tile_range(p, q_lo, BQ, kBK32, kt_begin, kt_end);
  const int n = kt_end - kt_begin;

  auto load_kv = [&](int kt, int buf) {
    float* kd = ks + buf * kBK32 * ldq;
    float* vd = vs + buf * kBK32 * ldv;
    for (int e = tid; e < kBK32 * d4; e += kF32Threads) {
      const int r = e / d4, c = (e - r * d4) * 4, kj = kt * kBK32 + r;
      cp_async16(kd + r * ldq + c, kb + min(kj, p.Sk - 1) * p.sks + c,
                 kj < p.Sk);
    }
    for (int e = tid; e < kBK32 * v4; e += kF32Threads) {
      const int r = e / v4, c = (e - r * v4) * 4, kj = kt * kBK32 + r;
      cp_async16(vd + r * ldv + c, vb + min(kj, p.Sk - 1) * p.svs + c,
                 kj < p.Sk);
    }
  };

  for (int e = tid; e < BQ * d4; e += kF32Threads) {
    const int r = e / d4, c = (e - r * d4) * 4, qi = q_lo + r;
    cp_async16(qs + r * ldq + c, qb + min(qi, p.Sq - 1) * p.sqs + c,
               qi < p.Sq);
  }
  if (n > 0) load_kv(kt_begin, 0);
  cp_commit();

  float m[RI], l[RI], acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int it = 0; it < n; ++it) {
    const int kt = kt_begin + it, k_lo = kt * kBK32;
    const int buf = stages == 2 ? (it & 1) : 0;
    if (stages == 1 && it > 0) {
      load_kv(kt, 0);
      cp_commit();
    }
    if (stages == 2 && it + 1 < n) {   // the next tile loads under this one
      load_kv(kt + 1, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const float* kt_s = ks + buf * kBK32 * ldq;
    float s[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[RI], bk[4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(kt_s + (tx + 16 * j) * ldq + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }

    const bool cut = tile_cut(p, q_lo, q_lo + BQ - 1, k_lo, k_lo + kBK32 - 1);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q_lo + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = !cut || key_ok(p, qi, k_lo + tx + 16 * j);
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
        ps[(ty + 16 * i) * ldp + tx + 16 * j] = pv;
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

    const float* vt = vs + buf * kBK32 * ldv;
#pragma unroll 2
    for (int j = 0; j < kBK32; j += 4) {
      float4 pr[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pr[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * ldp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          vv[c] = col < Dv ? vt[(j + jj) * ldv + col] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pij = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y
                          : jj == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
        }
      }
    }
    __syncthreads();                   // this tile's k, v and p are used
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q_lo + ty + 16 * i;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
    if (LSE && tx == 0)
      lse[((long long)b * p.H + h) * p.Sq + qi] =
          m[i] <= kNeg ? kNeg : m[i] + logf(l[i]);
    float* orow = o + b * p.sob + h * p.soh + qi * p.sos;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv) orow[col] = acc[i][c] / den;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

namespace {

template <int D, int DV, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, const Params& p, cudaStream_t stream) {
  using T = Tiles<D, DV>;
  static_assert(T::kSmem <= kMaxSmem, "the bf16 tiles exceed 227 KB");
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, p.Sq, p.H, p.B, p.sqs, p.sqh, p.sqb, T::BQ);
  if (!err) err = make_map(&tk, k, D, p.Sk, p.Kh, p.B, p.sks, p.skh, p.skb,
                           T::BK);
  if (!err) err = make_map(&tv, v, DV, p.Sk, p.Kh, p.B, p.svs, p.svh, p.svb,
                           T::BK);
  if (err) return err;
  auto kern = &flash_bf16_kernel<D, DV, LSE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.B * p.H * ((p.Sq + T::BQ - 1) / T::BQ));
  kern<<<grid, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, p);
  return (int)cudaGetLastError();
}

// double-buffered where two stages fit 227 KB, else single-buffered
template <int RI, int NC, bool LSE>
int launch_f32_nc(const void* q, const void* k, const void* v, void* o,
                  float* lse, const Params& p, cudaStream_t stream) {
  const int stages = f32_smem(RI, 2, p.D, p.Dv) <= (size_t)kMaxSmem ? 2 : 1;
  const size_t smem = f32_smem(RI, stages, p.D, p.Dv);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = &flash_f32_kernel<RI, NC, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H * ((p.Sq + 16 * RI - 1) / (16 * RI)));
  kern<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p, stages);
  return (int)cudaGetLastError();
}

// the fp32 register tile of head dims (D, DV): Dv / 16 output columns a
// thread, and 8 query rows where one stage of 8-row tiles fits 227 KB,
// else 4 (D = Dv = 192 and above)
template <int D, int DV, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Params& p, cudaStream_t st) {
  constexpr int RI = f32_smem(8, 1, D, DV) <= (size_t)kMaxSmem ? 8 : 4;
  return launch_f32_nc<RI, DV / 16, LSE>(q, k, v, o, lse, p, st);
}

// any other pair is refused; LSE: the instances that also write lse
template <bool LSE>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, const Params& p, cudaStream_t st) {
#define FA_CASE(D_, DV_)                                                  \
  if (p.D == D_ && p.Dv == DV_)                                           \
    return dtype ? launch_bf16<D_, DV_, LSE>(q, k, v, o, lse, p, st)      \
                 : launch_f32<D_, DV_, LSE>(q, k, v, o, lse, p, st);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

Params make_params(int B, int H, int Kh, int Sq, int Sk, int D, int Dv,
                   const long long* s, float scale, int causal, int window) {
  return Params{B, H, Kh, Sq, Sk, D, Dv, s[0], s[1], s[2], s[3], s[4], s[5],
                s[6], s[7], s[8], s[9], s[10], s[11], scale, causal, window};
}

bool bad_args(int dtype, int B, int H, int Kh, int Sq, int Sk, int window) {
  return B < 1 || H < 1 || Kh < 1 || H % Kh != 0 || Sq < 1 || Sk < 1 ||
         window < 0 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// Serving's instances (LSE = false) in this library; training's (LSE =
// true) in flash_attention_lse.cu's, which includes this file with
// FA_TRAINING defined: two libraries that nvcc builds in parallel.
#ifndef FA_TRAINING

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o alike).  strides holds 12 element
// strides: q's, k's, v's and o's over (b, h, s), in that order; the feature
// dimension of each is contiguous, (D, Dv) is a pair of FA_HEAD_DIMS, and
// base addresses and strides are multiples of 16 bytes (TMA, cp.async).
// Returns 0 when the launch was accepted, else a cudaError_t code or, from
// kErrTensorMap on, a tensor map that could not be made.
int fa_forward(int dtype, const void* q, const void* k, const void* v,
               void* o, int B, int H, int Kh, int Sq, int Sk, int D, int Dv,
               const long long* strides, float scale, int causal, int window,
               void* stream) {
  if (bad_args(dtype, B, H, Kh, Sq, Sk, window))
    return (int)cudaErrorInvalidValue;
  return launch<false>(dtype, q, k, v, o, nullptr,
                       make_params(B, H, Kh, Sq, Sk, D, Dv, strides, scale,
                                   causal, window),
                       static_cast<cudaStream_t>(stream));
}

#else

// fa_forward that also writes lse, a contiguous fp32 (B, H, Sq): each row's
// natural log-sum-exp of its masked scores (NEG where no key is visible)
int fa_forward_lse(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int H, int Kh, int Sq, int Sk,
                   int D, int Dv, const long long* strides, float scale,
                   int causal, int window, void* stream) {
  if (bad_args(dtype, B, H, Kh, Sq, Sk, window) || !lse)
    return (int)cudaErrorInvalidValue;
  return launch<true>(dtype, q, k, v, o, lse,
                      make_params(B, H, Kh, Sq, Sk, D, Dv, strides, scale,
                                  causal, window),
                      static_cast<cudaStream_t>(stream));
}

#endif  // FA_TRAINING

const char* fa_error_string(int code) {
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
