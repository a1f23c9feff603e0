// Prefill attention for Hopper (sm_90a) on the tensor cores: one pass over
// the keys with an online softmax, so the (S, T) score matrix never
// reaches device memory.
//
// Replaces the TPU kernel `_flash_kernel` launched by `flash_attention` in
// src/repro/kernels/flash_attention.py.  Same function: scores q . k
// scaled by hd^-0.5 in float32; with `causal`, key positions past the
// query's (both from 0) score -1e30 and key tiles wholly above the
// diagonal are skipped; GQA reads kv head h / (H / KV); the running
// (max, sum, accumulator) are float32, and so is the softmax weight p in
// the PV product (the Pallas kernel casts v to float32 first, so
// `p.astype(v.dtype)` keeps p float32 for bfloat16 inputs too); the output
// is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on an H100.  The work is 4 * hd operations per (query,
// key) pair the mask leaves, on the tensor cores: bfloat16 at 989 TFLOP/s,
// float32 as three TF32 products each (below) at 495 / 3 = 165 TFLOP/s.
// At the benchmark's causal shape (B = 1, H = 8, S = T = 1024, hd = 64,
// float32) 1.07 GFLOP take 6.5 us against 1.6 us to move 5.2 MB:
// operations.  At yi-6b's width (H = 32, KV = 4, hd = 128, S = T = 4096,
// causal) 137 GFLOP take 0.83 ms in float32 and 0.139 ms in bfloat16; the
// softmax's exps, 268 M at 16 a clock per SM, take about 0.07 ms, half
// the bfloat16 bound, so the exps are computed once per score (exp2 of
// scores prescaled by log2(e)) and never recomputed.
//
// Design.  A block owns `rows` = 64 or 128 query rows of one (b, h) and
// loops over the keys itself (the Pallas grid's sequential kv axis), `bk`
// keys a tile, K and V tiles staged by cp.async into a ring of `stages`
// buffers in shared memory while earlier tiles are consumed, one barrier
// a tile; the plan (rows, bk, splits, stages) is `flash_plan` of
// kernels/flash_attention.py, mirrored by `plan_*` below and checked at
// launch.  hd is padded to a multiple of 16 (`HDP`) with zeros in shared
// memory; HDP is a template parameter, so any hd that is a multiple of 8
// up to 256 runs.  Causal blocks are launched heaviest first, tiles past
// the block's last row are not loaded, and only tiles that cross the
// diagonal or the end of T are masked.  A score row is held by the four
// lanes of a quad: its max and sum are four partial chains a lane, then
// two xor shuffles.
//
//   bfloat16: wgmma.  One warpgroup (four warps) per 64 query rows.
//   S = Q K^T is wgmma m64n{bk}k16 with Q (A) and K (B) from shared
//   memory, both K-major as they lie in memory, in the no-swizzle layout of
//   8 x 16-byte core matrices (a tile's 16-byte chunk e lands at byte 16 e,
//   so the cp.async writes are contiguous).  O += P V is wgmma with P in
//   registers (the S accumulator's fragment is the A fragment's layout)
//   and V from shared memory as an MN-major B (the transpose bit), so V
//   needs no transpose.  p stays float32 by splitting it into two bfloat16
//   pieces, p_hi = bf16(p) and p_lo = bf16(p - p_hi), two wgmmas against
//   the same V tile: 1.5x the product work of a bfloat16 p, and the
//   output's bfloat16 rounding then differs from float32 p's on about
//   0.2 % of elements instead of about 40 %.  The products are pipelined
//   one tile deep: S of tile i and P V of tile i - 1 are issued together
//   and the softmax of tile i runs while P V of tile i - 1 does, so the
//   ring holds three tiles (scored, in P V, loading).  Both warpgroups of
//   a block run every tile, a causal tile above the first one's rows
//   giving p = 0: a wgmma under a branch on the thread index makes ptxas
//   serialise every wgmma of the kernel.
//
//   float32: 3xTF32 with mma.sync.m16n8k8 (one warp per 16 rows).  Each
//   operand is split at fragment-load time, hi = x rounded to TF32 (to
//   nearest, ties away, by an add and a mask, shorter than
//   cvt.rna.tf32.f32) and lo = x - hi (the tensor core reads lo's top 11
//   bits), and each product is lo*hi + hi*lo + hi*hi accumulated in
//   float32, which keeps the 2e-5 contract where one TF32 product misses
//   it by 50x.  mma.sync rather than wgmma: wgmma's TF32 form takes its B
//   operand from shared memory K-major, so P V would need V transposed,
//   and hi and lo copies of K and V staged; mma.sync loads its fragments
//   from any layout, so the staging holds one float32 copy.  P's
//   accumulator fragment becomes P V's A fragment without shuffles by
//   reading V's rows in the matching order (a quad's columns 2t and
//   2t + 1 are the A fragment's t and t + 4).  Rows are padded to HDP + 4
//   floats, so the fragment loads hit 32 distinct banks.  Up to hdp = 64
//   a block is two sets of four warps over the same 64 rows, each set
//   scoring every other tile of keys, their (m, l, O) merged through
//   shared memory at the end: the benchmark's causal shape has 8 heads x
//   16 such blocks, and the longest row's chain of tiles is halved.
//
// Under grad the launch also writes each row's logsumexp (natural log)
// into a float32 (B, H, S) output, which the backward
// (flash_attention_bwd.cu) reads instead of recomputing the scores; a
// null pointer writes nothing, and the output is the same bits either
// way.  The staging and the products are flash_common.cuh's, shared with
// the backward.

#include <climits>
#include <cstdint>

#include "attention.cuh"
#include "flash_common.cuh"

namespace {

using namespace attn;
using namespace flash;

constexpr int SMEM_MAX = 232448;         // a block's shared memory, 227 KB
constexpr int SMEM_PAIR = 116 * 1024;    // within this, two blocks an SM
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The plan, as `flash_plan` computes it (kernels/flash_attention.py).
#define HD __host__ __device__ constexpr
HD int plan_rows(int hdp, bool is_bf16) {
  return hdp > 128 || (!is_bf16 && hdp <= 64) ? 64 : 128;
}
HD int plan_bk(int hdp) { return hdp <= 128 ? 64 : 32; }
// warp sets that split a block's keys (float32): two where 64 rows a
// block leave a warp per scheduler
HD int plan_splits(int hdp, bool is_bf16) {
  return !is_bf16 && hdp <= 64 ? 2 : 1;
}
HD int row_len(int hdp, bool is_bf16) {  // a staged row, elements
  return is_bf16 ? hdp : hdp + 4;
}
HD int smem_bytes(int hdp, bool is_bf16, int rows, int bk, int splits,
                  int stages) {
  return (is_bf16 ? 2 : 4) * row_len(hdp, is_bf16) *
         (rows + 2 * stages * splits * bk);
}
HD int plan_stages(int hdp, bool is_bf16) {
  return is_bf16 || smem_bytes(hdp, false, plan_rows(hdp, false),
                               plan_bk(hdp), plan_splits(hdp, false),
                               3) <= SMEM_PAIR
             ? 3
             : 2;
}
#undef HD

// -- the online softmax of one tile, shared by both paths ----------------
//
// s holds NJ 8-column blocks of a quad's two rows in the mma accumulator
// layout: s[4j + e] is row r + 8 (e >> 1), column 8j + 2t + (e & 1).  The
// scores are scaled into log2 units and masked where `edge`; m and l are
// the two rows' running max (log2 units) and this lane's part of the sum;
// returns the two rows' corrections and leaves p in s.
template <int NJ>
__device__ __forceinline__ float2 softmax_tile(float* s, float (&m)[2],
                                               float (&l)[2], float scale2,
                                               bool edge, bool causal,
                                               int row, int key, int Tn) {
  // a row's max and sum in four independent parts, short chains
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = NEG_INF;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale2;
      if (edge) {
        const int kj = key + 8 * j + (e & 1);
        if (kj >= Tn || (causal && kj > row + 8 * (e >> 1))) x = NEG_INF;
      }
      s[4 * j + e] = x;
      float& part = mx[e >> 1][(j & 1) * 2 + (e & 1)];
      part = fmaxf(part, x);
    }
  }
  float corr[2], top[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    top[i] = fmaxf(fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3])),
                   m[i]);
    top[i] = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 1));
    top[i] = fmaxf(top[i], __shfl_xor_sync(0xffffffffu, top[i], 2));
    // key 0 is in the first tile and every row sees it, so top is a real
    // score from the first tile on and the first correction is exp(-1e30)
    corr[i] = exp2_ftz(m[i] - top[i]);
    m[i] = top[i];
#pragma unroll
    for (int k = 0; k < 4; ++k) sum[i][k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(s[4 * j + e] - top[e >> 1]);
      s[4 * j + e] = p;
      sum[e >> 1][(j & 1) * 2 + (e & 1)] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] = l[i] * corr[i] + ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
  return make_float2(corr[0], corr[1]);
}

// acc (NJ 8-column blocks in the accumulator layout) / max(l, 1e-30) ->
// rows r and r + 8 of o, columns below hd; where `lse` is not null, the
// two rows' logsumexp of the scaled scores, natural log, ln 2 (m +
// log2 l) with m in log2 units (-inf for a row that saw no key)
template <int NJ, typename T>
__device__ __forceinline__ void store_rows(T* o, float* lse,
                                           const float* acc,
                                           const float (&m)[2],
                                           float (&l)[2], int row, int S,
                                           int hd, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (lse != nullptr && t == 0 && row + 8 * i < S)
      lse[row + 8 * i] = (m[i] + log2f(l[i])) * LN2;
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r >= S) continue;
      const float a = acc[4 * j + 2 * i] / l[i];
      const float b = acc[4 * j + 2 * i + 1] / l[i];
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * hd + col) =
            __floats2bfloat162_rn(a, b);
      } else {
        *reinterpret_cast<float2*>(o + (size_t)r * hd + col) =
            make_float2(a, b);
      }
    }
  }
}

// -- float32: 3xTF32 on mma.sync.m16n8k8 ---------------------------------

// KS sets of ROWS / 16 warps split the keys: a stage holds KS tiles of
// BK keys, set p scores the p-th, and the sets' (m, l, O) are merged at
// the end.
template <int HDP, int BK, int ROWS, int KS, int STAGES>
__global__ void __launch_bounds__(ROWS * 2 * KS, 1)
flash_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int S, int Tn,
                 int hd, float scale2, int causal) {
  constexpr int THREADS = ROWS * 2 * KS;  // a warp per 16 rows and set
  constexpr int LD = HDP + 4;
  constexpr int NJ = BK / 8;           // 8-key blocks of a tile
  constexpr int ND = HDP / 8;          // 8-column blocks of a row
  constexpr int STEP = KS * BK;        // keys a stage
  extern __shared__ __align__(128) float smem_f[];
  float* q_s = smem_f;
  float* k_s = q_s + ROWS * LD;
  float* v_s = k_s + STAGES * STEP * LD;

  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = tid / 32 % (ROWS / 16), part = tid / 32 / (ROWS / 16);
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const float* qb = q + ((size_t)b * H + h) * S * hd;
  const float* kb = k + ((size_t)b * KV + kvh) * Tn * hd;
  const float* vb = v + ((size_t)b * KV + kvh) * Tn * hd;
  const int kend = causal ? min(Tn, q0 + ROWS) : Tn;
  const int nsteps = (kend + STEP - 1) / STEP;

  if (hd != HDP) {
    zero_smem<smem_bytes(HDP, false, ROWS, BK, KS, STAGES), THREADS>(smem_f);
    __syncthreads();
  }
  if (nsteps > 0) stage_tile<HDP, ROWS, THREADS>(q_s, qb, q0, S, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) {
      stage_tile<HDP, STEP, THREADS>(k_s + st * STEP * LD, kb, st * STEP, Tn,
                                     hd);
      stage_tile<HDP, STEP, THREADS>(v_s + st * STEP * LD, vb, st * STEP, Tn,
                                     hd);
    }
    cp_commit();
  }

  const int wrow = warp * 16;              // the warp's first row in q_s
  const int row = q0 + wrow + g;           // this lane's rows: row, row + 8
  float acc[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < nsteps; ++it) {
    cp_wait<STAGES - 2>();  // stage it has landed, the newest may not have
    __syncthreads();  // ... for every thread, and stage it - 1 is consumed
    const int nxt = it + STAGES - 1;
    if (nxt < nsteps) {
      const int st = nxt % STAGES;
      stage_tile<HDP, STEP, THREADS>(k_s + st * STEP * LD, kb, nxt * STEP,
                                     Tn, hd);
      stage_tile<HDP, STEP, THREADS>(v_s + st * STEP * LD, vb, nxt * STEP,
                                     Tn, hd);
    }
    cp_commit();

    const int k0 = it * STEP + part * BK;
    if (k0 < kend && !(causal && k0 > q0 + wrow + 15)) {
      const float* ks = k_s + ((it % STAGES) * STEP + part * BK) * LD;
      const float* vs = v_s + ((it % STAGES) * STEP + part * BK) * LD;
      float s[4 * NJ];
#pragma unroll
      for (int i = 0; i < 4 * NJ; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const float* qa = q_s + (wrow + g) * LD + 8 * kk + t;
        const float x[4] = {qa[0], qa[8 * LD], qa[4], qa[8 * LD + 4]};
        uint32_t ah[4], al[4];
        split4(x, ah, al);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* kr = ks + (8 * j + g) * LD + 8 * kk + t;
          mma_3xtf32(s + 4 * j, ah, al, split_tf32(kr[0]),
                     split_tf32(kr[4]));
        }
      }
      const bool edge =
          (causal && k0 + BK - 1 > q0 + wrow) || k0 + BK > Tn;
      const float2 corr = softmax_tile<NJ>(s, m, l, scale2, edge, causal,
                                           row, k0 + 2 * t, Tn);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[4 * d] *= corr.x;
        acc[4 * d + 1] *= corr.x;
        acc[4 * d + 2] *= corr.y;
        acc[4 * d + 3] *= corr.y;
      }
      // O += P V: P's columns 2t and 2t + 1 of block j are the A
      // fragment's columns t and t + 4, so B's rows are keys 8j + 2t and
      // 8j + 2t + 1
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float x[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1],
                            s[4 * j + 3]};
        uint32_t ph[4], pl[4];
        split4(x, ph, pl);
        const float* vr = vs + (8 * j + 2 * t) * LD + g;
#pragma unroll
        for (int d = 0; d < ND; ++d)
          mma_3xtf32(acc + 4 * d, ph, pl, split_tf32(vr[8 * d]),
                     split_tf32(vr[LD + 8 * d]));
      }
    }
  }
  cp_wait<0>();
  if constexpr (KS > 1) {
    // the sets past the first hand (m, l, O) over through shared memory,
    // element i of lane L of warp w at [i][w * 32 + L], and the first
    // merges them
    constexpr int LANES = ROWS / 16 * 32;
    float* x = k_s;
    __syncthreads();  // every set is done with the last stage
#pragma unroll
    for (int p = 1; p < KS; ++p) {
      if (part == p) {
        float* y = x + warp * 32 + lane;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          y[i * LANES] = m[i];
          y[(2 + i) * LANES] = l[i];
        }
#pragma unroll
        for (int i = 0; i < 4 * ND; ++i) y[(4 + i) * LANES] = acc[i];
      }
      __syncthreads();
      if (part == 0) {
        const float* y = x + warp * 32 + lane;
        float c0[2], c1[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mo = y[i * LANES], top = fmaxf(m[i], mo);
          c0[i] = exp2_ftz(m[i] - top);
          c1[i] = exp2_ftz(mo - top);
          m[i] = top;
          l[i] = l[i] * c0[i] + y[(2 + i) * LANES] * c1[i];
        }
#pragma unroll
        for (int i = 0; i < 4 * ND; ++i)
          acc[i] = acc[i] * c0[(i >> 1) & 1] +
                   y[(4 + i) * LANES] * c1[(i >> 1) & 1];
      }
      __syncthreads();
    }
    if (part != 0) return;
  }
  store_rows<ND>(o + ((size_t)b * H + h) * S * hd,
                 lse ? lse + ((size_t)b * H + h) * S : nullptr, acc, m, l,
                 row, S, hd, t);
}

// -- bfloat16: wgmma -------------------------------------------------------

// O += (P_hi + P_lo) V over a tile's BK keys, issued, not committed
template <int HDP, int BK>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t* ph,
                                         const uint32_t* pl,
                                         const bf16_t* vs) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    mn_step<HDP, HDP>(acc, pl + 4 * kk, vs, kk);
    mn_step<HDP, HDP>(acc, ph + 4 * kk, vs, kk);
  }
}

template <int HDP, int BK, int ROWS, int STAGES>
__global__ void __launch_bounds__(ROWS * 2, 1)
flash_wgmma_kernel(const bf16_t* __restrict__ q,
                   const bf16_t* __restrict__ k,
                   const bf16_t* __restrict__ v, bf16_t* __restrict__ o,
                   float* __restrict__ lse, int H, int KV, int S, int Tn,
                   int hd, float scale2, int causal) {
  constexpr int THREADS = ROWS * 2;       // a warpgroup per 64 rows
  constexpr int NJ = BK / 8;
  constexpr int ND = HDP / 8;
  constexpr int AHEAD = STAGES - 2;       // tiles loading past the two in use
  constexpr uint32_t KM_LBO = 128;        // K-major: next 8 columns
  constexpr uint32_t KM_SBO = HDP * 16;   // K-major: next 8 rows
  static_assert(AHEAD >= 1, "the pipeline needs three stages");
  extern __shared__ __align__(128) bf16_t smem_h[];
  bf16_t* q_s = smem_h;
  bf16_t* k_s = q_s + ROWS * HDP;
  bf16_t* v_s = k_s + STAGES * BK * HDP;

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const bf16_t* qb = q + ((size_t)b * H + h) * S * hd;
  const bf16_t* kb = k + ((size_t)b * KV + kvh) * Tn * hd;
  const bf16_t* vb = v + ((size_t)b * KV + kvh) * Tn * hd;
  const int kend = causal ? min(Tn, q0 + ROWS) : Tn;
  const int ntiles = (kend + BK - 1) / BK;

  if (hd != HDP) {
    zero_smem<smem_bytes(HDP, true, ROWS, BK, 1, STAGES), THREADS>(smem_h);
    __syncthreads();
  }
  if (ntiles > 0) stage_tile<HDP, ROWS, THREADS>(q_s, qb, q0, S, hd);
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) {
    if (st < ntiles) {
      stage_tile<HDP, BK, THREADS>(k_s + st * BK * HDP, kb, st * BK, Tn, hd);
      stage_tile<HDP, BK, THREADS>(v_s + st * BK * HDP, vb, st * BK, Tn, hd);
    }
    cp_commit();
  }

  const int wrow = wg * 64;                     // the warpgroup's rows
  const int row = q0 + wrow + (tid % 128) / 32 * 16 + g;  // row, row + 8
  const bf16_t* qw = q_s + wrow * HDP;
  float acc[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t ph[2 * NJ], pl[2 * NJ];              // P of the previous tile

  // Tile `it` is scored while tile it - 1's P V runs: S_it and PV_{it-1}
  // are issued together, the softmax of S_it overlaps PV_{it-1}, and O is
  // rescaled once PV_{it-1} is done.  Tile it - 1's V is still read while
  // tile it + AHEAD loads, so the ring holds AHEAD + 2 tiles.  Both
  // warpgroups run every tile of the block (a tile above the first one's
  // rows gives p = 0): a product under a branch that depends on the
  // thread would make ptxas serialise every wgmma.
  for (int it = 0; it < ntiles; ++it) {
    cp_wait<AHEAD - 1>();  // tile it has landed, the newest may not have
    fence_async_smem();  // cp.async's and the zeros' writes before wgmma
    __syncthreads();  // ... for every thread; tile it - 2 is consumed
    const int nxt = it + AHEAD;
    if (nxt < ntiles) {
      const int st = nxt % STAGES;
      stage_tile<HDP, BK, THREADS>(k_s + st * BK * HDP, kb, nxt * BK, Tn, hd);
      stage_tile<HDP, BK, THREADS>(v_s + st * BK * HDP, vb, nxt * BK, Tn, hd);
    }
    cp_commit();

    const int k0 = it * BK;
    const bf16_t* ks = k_s + (it % STAGES) * BK * HDP;
    float s[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) s[i] = 0.f;
    pin<4 * NJ>(s);
    pin<4 * ND>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss<BK>(s, smem_desc(qw + kk * 16 * 8, KM_LBO, KM_SBO),
                   smem_desc(ks + kk * 16 * 8, KM_LBO, KM_SBO));
    wgmma_commit();
    if (it > 0)
      issue_pv<HDP, BK>(acc, ph, pl, v_s + ((it - 1) % STAGES) * BK * HDP);
    wgmma_commit();
    wgmma_wait<1>();  // S_it is done; PV_{it-1} may run on
    pin<4 * NJ>(s);

    const bool edge = (causal && k0 + BK - 1 > q0 + wrow) || k0 + BK > Tn;
    const float2 corr = softmax_tile<NJ>(s, m, l, scale2, edge, causal, row,
                                         k0 + 2 * t, Tn);
    uint32_t nh[2 * NJ], nl[2 * NJ];
    split_p<NJ>(s, nh, nl);
    wgmma_wait<0>();
    pin<4 * ND>(acc);         // PV_{it-1} has written O ...
    pin<2 * NJ>(ph);          // ... and read P_{it-1}
    pin<2 * NJ>(pl);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      acc[4 * d] *= corr.x;
      acc[4 * d + 1] *= corr.x;
      acc[4 * d + 2] *= corr.y;
      acc[4 * d + 3] *= corr.y;
    }
#pragma unroll
    for (int i = 0; i < 2 * NJ; ++i) {
      ph[i] = nh[i];
      pl[i] = nl[i];
    }
  }
  if (ntiles > 0) {           // the last tile's P V
    pin<4 * ND>(acc);
    pin<2 * NJ>(ph);
    pin<2 * NJ>(pl);
    wgmma_fence();
    issue_pv<HDP, BK>(acc, ph, pl, v_s + ((ntiles - 1) % STAGES) * BK * HDP);
    wgmma_commit();
    wgmma_wait<0>();
    pin<4 * ND>(acc);
    pin<2 * NJ>(ph);
    pin<2 * NJ>(pl);
  }
  cp_wait<0>();
  store_rows<ND>(o + ((size_t)b * H + h) * S * hd,
                 lse ? lse + ((size_t)b * H + h) * S : nullptr, acc, m, l,
                 row, S, hd, t);
}

template <int HDP, bool BF16>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KV, int S, int Tn, int hd,
                   int causal, cudaStream_t stream) {
  constexpr int ROWS = plan_rows(HDP, BF16), BK = plan_bk(HDP);
  constexpr int KS = plan_splits(HDP, BF16);
  constexpr int STAGES = plan_stages(HDP, BF16);
  constexpr int SMEM = smem_bytes(HDP, BF16, ROWS, BK, KS, STAGES);
  static_assert(SMEM <= SMEM_MAX, "the plan overflows shared memory");
  const dim3 grid((S + ROWS - 1) / ROWS, H, B);
  const float scale2 = LOG2E / sqrtf((float)hd);
  if constexpr (BF16) {
    const auto kern = flash_wgmma_kernel<HDP, BK, ROWS, STAGES>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    kern<<<grid, ROWS * 2, SMEM, stream>>>(
        static_cast<const bf16_t*>(q), static_cast<const bf16_t*>(k),
        static_cast<const bf16_t*>(v), static_cast<bf16_t*>(o), lse, H, KV,
        S, Tn, hd, scale2, causal);
  } else {
    const auto kern = flash_mma_kernel<HDP, BK, ROWS, KS, STAGES>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    kern<<<grid, ROWS * 2 * KS, SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, S,
        Tn, hd, scale2, causal);
  }
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_hd(int hdp, const void* q, const void* k, const void* v,
                      void* o, float* lse, int B, int H, int KV, int S,
                      int Tn, int hd, int causal, cudaStream_t s) {
  switch (hdp) {
#define FLASH_HDP(N) \
  case N:            \
    return launch<N, BF16>(q, k, v, o, lse, B, H, KV, S, Tn, hd, causal, \
                           s);
    FLASH_HDP(16) FLASH_HDP(32) FLASH_HDP(48) FLASH_HDP(64)
    FLASH_HDP(80) FLASH_HDP(96) FLASH_HDP(112) FLASH_HDP(128)
    FLASH_HDP(144) FLASH_HDP(160) FLASH_HDP(176) FLASH_HDP(192)
    FLASH_HDP(208) FLASH_HDP(224) FLASH_HDP(240) FLASH_HDP(256)
#undef FLASH_HDP
  }
  return cudaErrorInvalidValue;
}

// The launcher's guard: the sizes it takes (the grid's y and z within
// 65,535; S and T at most 127 short of INT_MAX, since q0 + ROWS and
// kend + STEP - 1 are int), the plan it is built with for (hd, dtype),
// and 16-byte aligned operands (the lse output null, or aligned too).
bool plan_ok(const void* q, const void* k, const void* v, const void* o,
             const void* lse, int B, int H, int KV, int S, int T, int hd,
             int bf16, int rows, int bk, int splits, int stages) {
  const int hdp = (hd + 15) / 16 * 16;
  return B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 && T >= 0 &&
         S <= INT_MAX - 127 && T <= INT_MAX - 127 && hd >= 8 && hd <= 256 &&
         hd % 8 == 0 && H <= 65535 && B <= 65535 &&
         rows == plan_rows(hdp, bf16 != 0) && bk == plan_bk(hdp) &&
         splits == plan_splits(hdp, bf16 != 0) &&
         stages == plan_stages(hdp, bf16 != 0) &&
         ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
            (uintptr_t)lse) &
           15) == 0);
}

}  // namespace

// All pointers are device pointers to contiguous, 16-byte aligned arrays on
// card `device`, float32 (bf16 == 0) or bfloat16 (bf16 == 1): q and o
// (B, H, S, hd), k and v (B, KV, T, hd); lse, null or float32 (B, H, S),
// receives each row's logsumexp of its scaled scores (natural log) for
// the backward, and null writes nothing (o is the same bits either way).
// hd is a multiple of 8 from 8 to 256 and H a multiple of KV; (rows, bk,
// splits, stages) must be the plan the kernel is built with for (hd,
// dtype), `flash_plan`'s.  The launch goes on `stream` and does not
// synchronise.  Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int KV,
                               int S, int T, int hd, int bf16, int causal,
                               int rows, int bk, int splits, int stages,
                               int device, void* stream) {
  if (!plan_ok(q, k, v, o, lse, B, H, KV, S, T, hd, bf16, rows, bk, splits,
               stages))
    return (int)cudaErrorInvalidValue;
  const int hdp = (hd + 15) / 16 * 16;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  if (bf16)
    return (int)launch_hd<true>(hdp, q, k, v, o, L, B, H, KV, S, T, hd,
                                causal, s);
  return (int)launch_hd<false>(hdp, q, k, v, o, L, B, H, KV, S, T, hd,
                               causal, s);
}

// The launcher's guard alone (plan_ok), on the launcher's own arguments
// but the device and the stream: 1 where flash_attention would launch, 0
// where it would return cudaErrorInvalidValue.  `causal` takes no part
// in it.  Launches nothing and touches no device.
extern "C" int flash_attention_plan_ok(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int H, int KV, int S, int T,
                                       int hd, int bf16, int causal,
                                       int rows, int bk, int splits,
                                       int stages) {
  (void)causal;
  return plan_ok(q, k, v, o, lse, B, H, KV, S, T, hd, bf16, rows, bk,
                 splits, stages);
}
