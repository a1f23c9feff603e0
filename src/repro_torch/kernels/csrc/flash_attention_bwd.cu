// The gradient of prefill attention for Hopper (sm_90a), on the tensor
// cores: dq, dk and dv of flash_attention.cu's output against its
// gradient do, so the (S, T) probability matrix never reaches device
// memory.
//
// Replaces no Pallas kernel one for one: the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py) has no backward, and the reference
// trains through XLA's autodiff of jnp attention
// (src/repro/models/attention.py, `blockwise_attention`).  The port's
// forward is a hand-written kernel, so its gradient is one too.  Same
// function as autodiff of the forward: with s = q . k * scale (scale =
// hd^-0.5), P = softmax(s) over the keys the mask leaves (`causal`: row i
// sees keys j <= i, both from 0, S may differ from T), o = P v,
//
//   lse_i = log sum_j exp(s_ij)               (the forward's, natural log)
//   P_ij  = exp(s_ij - lse_i)
//   D_i   = sum_d do_id o_id                  (= sum_j P_ij dP_ij)
//   dP_ij = do_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_i dS_ij q_i,   dv_j = sum_i P_ij do_i,
//
// dk and dv summed over the H / KV query heads that read kv head j.
// Everything is float32 inside: the scores, P and dS (never rounded to
// bfloat16, as in the forward), the sums; the outputs are cast to the
// inputs' dtype.  The forward writes lse under grad, so no pass recomputes
// it.
//
// What bounds it on an H100.  The gradient needs 5 products of 2 hd
// operations per (query, key) pair the mask leaves (S, dP, dv, dk, dq;
// `bwd_cost` in chip_smoke.py).  Without atomics, dq and dk / dv are
// formed in two passes that each recompute S and dP, so the kernel
// performs 7; in bfloat16 the products that read P or dS take it in two
// bfloat16 pieces (below), so 10 wgmma products a pair.  At the tensor
// cores' rates (989 TFLOP/s bfloat16, 165 as 3xTF32) whisper's 1,500
// frames are bound by the operations; the short causal training shapes in
// bfloat16 by their bytes (q, k, v, o, do read, dq, dk, dv written once).
//
// Design.  Four kernels on the caller's stream, the plan (`flash_bwd_plan`
// of kernels/flash_attention.py, mirrored by `plan_*` below and checked at
// launch) fixed by hd and the dtype:
//   1. bwd_delta: D = rowsum(do * o) into a float32 workspace (B, H, S),
//      a warp a row, 16-byte loads; bytes-bound.
//   2. bwd_dkdv_*: a block per (64-key tile, query head h, b).  K and V
//      stay in shared memory; the query tiles that see the key tile
//      (`rows` rows each, from the key tile's first key on when causal)
//      stream through a cp.async ring of `stages` buffers holding Q, dO
//      and their lse and D rows; S^T = K Q^T and dP^T = V dO^T, then
//      dv += P^T dO and dk += dS^T Q into register accumulators.  A block
//      per query head, not per kv head, so that the scaled yi-6b's 16 x 1
//      kv heads x 4 key tiles still make 256 blocks for 132 SMs: with
//      H / KV > 1 each block writes float32 partials of its head, and
//   3. bwd_sum adds the H / KV partials of each kv head in head order
//      into dk and dv (bytes-bound, a few percent of the pass above).
//      The partials are taken wherever H > KV, also where a block per kv
//      head would fill the card: such a block, walking its kv head's
//      query heads, was slower on an H100 at most GQA shapes (causal key
//      tiles differ in work, and fewer, longer blocks balance worse), and
//      its one float32 chain over the heads lost accuracy.
//   4. bwd_dq_*: a block per (64-row query tile, h, b), heaviest causal
//      tile first.  Q and dO stay in shared memory, the key tiles (`q_keys`
//      keys) stream through the ring; S = Q K^T, dP = dO V^T, then
//      dq += dS K.
// Every output element is written by one block, in a fixed order: no
// atomics, and the gradient is the same bits on every run.
//
//   bfloat16: wgmma, one warpgroup per 64 keys (dk / dv) or 64 rows (dq).
//   Operands lie in shared memory in the forward's no-swizzle core-matrix
//   layout, rows of HDP elements; S^T and dP^T are wgmma_ss with K, V (A)
//   and Q, dO (B) all K-major, as they lie in memory.  P^T and dS^T are
//   split into hi and lo bfloat16 pieces (p stays float32 to 2^-16, as in
//   the forward's P V) and go in as register A fragments (the accumulator
//   layout is the A fragment's, pair by pair) against dO and Q read as
//   MN-major B operands (the transpose bit), so nothing is transposed in
//   memory; dq += dS K likewise against K.  Past hdp = 128 the dk / dv
//   accumulators (2 x hdp / 2 registers a thread) do not fit one
//   warpgroup, so two warpgroups share the 64 keys, both forming S^T and
//   dP^T, each accumulating half of dk's and dv's columns.
//
//   float32: 3xTF32 mma.sync.m16n8k8, a warp per 16 keys or rows, as the
//   forward's float32 path: operands split to hi and lo TF32 at fragment
//   load, rows padded to HDP + 4 floats so fragment loads hit distinct
//   banks, an accumulator fragment reused as the next product's A
//   fragment by reading the B rows in the matching order.  Past hdp = 128
//   two sets of four warps split dk's and dv's columns as above.
//
// Each instantiation's shared-memory attribute is set once a device, on
// its first launch there.

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention.cuh"
#include "flash_common.cuh"

namespace {

using namespace attn;
using namespace flash;

constexpr int SMEM_MAX = 232448;         // a block's shared memory, 227 KB
constexpr int SMEM_PAIR = 116 * 1024;    // within this, two blocks an SM
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KEYS = 64;                 // keys a dk / dv block
constexpr int QROWS = 64;                // rows a dq block
constexpr int DELTA_ROWS = 8;            // rows (warps) a bwd_delta block
constexpr int SUM_THREADS = 256;
constexpr int SUM_BLOCKS = 132 * 8;      // bwd_sum's grid at most

// The plan, as `flash_bwd_plan` computes it (kernels/flash_attention.py).
#define HD __host__ __device__ constexpr
HD int plan_hdp(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}
// query rows a tile of the dk / dv pass
HD int plan_rows(int hdp, bool is_bf16) {
  return hdp <= 64 ? 64 : is_bf16 || hdp <= 128 ? 32 : 16;
}
// keys a tile of the dq pass
HD int plan_qkeys(int hdp, bool is_bf16) {
  return hdp <= 64 || (is_bf16 && hdp <= 128) ? 64
         : is_bf16 || hdp <= 128             ? 32
                                             : 16;
}
// warpgroups (sets of four warps) that split dk's and dv's columns
HD int plan_cols(int hdp) { return hdp > 128 ? 2 : 1; }
HD int row_len(int hdp, bool is_bf16) {  // a staged row, elements
  return is_bf16 ? hdp : hdp + 4;
}
HD int dkdv_smem(int hdp, bool is_bf16, int rows, int stages) {
  return (is_bf16 ? 2 : 4) * row_len(hdp, is_bf16) *
             (2 * KEYS + 2 * stages * rows) +
         4 * 2 * stages * rows;
}
HD int dq_smem(int hdp, bool is_bf16, int qkeys, int stages) {
  return (is_bf16 ? 2 : 4) * row_len(hdp, is_bf16) *
         (2 * QROWS + 2 * stages * qkeys);
}
// three stages where both passes' blocks still fit twice an SM
HD int plan_stages(int hdp, bool is_bf16) {
  return dkdv_smem(hdp, is_bf16, plan_rows(hdp, is_bf16), 3) <= SMEM_PAIR &&
                 dq_smem(hdp, is_bf16, plan_qkeys(hdp, is_bf16), 3) <=
                     SMEM_PAIR
             ? 3
             : 2;
}
#undef HD

// -- pass 1: D ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(32 * DELTA_ROWS)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, size_t rows, int hd) {
  constexpr int EPC = 16 / sizeof(T);
  const size_t row = (size_t)blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* ob = o + row * hd;
  const T* db = dout + row * hd;
  float sum = 0.f;
  for (int c = lane; c < hd / EPC; c += 32) {
    const int4 x = reinterpret_cast<const int4*>(ob)[c];
    const int4 y = reinterpret_cast<const int4*>(db)[c];
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int e = 0; e < EPC; ++e) sum = fmaf(to_f32(xs[e]), to_f32(ys[e]), sum);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) sum += __shfl_xor_sync(~0u, sum, m);
  if (lane == 0) delta[row] = sum;
}

// -- the shared steps of the dk / dv and dq passes ----------------------

// Stage query rows [q0, q0 + ROWS) of Q and dO, and their lse and D, into
// ring slot `slot`
template <int HDP, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void stage_queries(T* q_s, T* do_s, float* lse_s,
                                              float* dl_s, const T* qb,
                                              const T* dob, const float* lb,
                                              const float* db, int q0, int S,
                                              int hd) {
  stage_tile<HDP, ROWS, THREADS>(q_s, qb, q0, S, hd);
  stage_tile<HDP, ROWS, THREADS>(do_s, dob, q0, S, hd);
  for (int i = threadIdx.x; i < 2 * ROWS; i += THREADS) {
    const int r = i % ROWS;
    const bool in = q0 + r < S;
    const size_t at = in ? q0 + r : 0;
    if (i < ROWS)
      cp_async4(lse_s + r, lb + at, in);
    else
      cp_async4(dl_s + r, db + at, in);
  }
}

// -- pass 2: dk and dv ---------------------------------------------------

// Writes a lane's rows (key, key + 8) and column pairs of dk and dv: into
// dk and dv in the dtype where the block's head is the kv head's only
// query head, else float32 partials of the head (ws, (B, H, T, hd)).
template <int ND, typename T>
__device__ __forceinline__ void store_dkdv(const float* acc_k,
                                           const float* acc_v, T* dk, T* dv,
                                           float* ws_k, float* ws_v,
                                           size_t base, int key, int Tn,
                                           int col0, int hd, int t,
                                           float scale, bool partial) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = key + 8 * i;
    if (kr >= Tn) continue;
    const size_t at = (base + kr) * hd;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = col0 + 8 * d + 2 * t;
      if (col >= hd) continue;
      const float k0 = acc_k[4 * d + 2 * i] * scale;
      const float k1 = acc_k[4 * d + 2 * i + 1] * scale;
      const float v0 = acc_v[4 * d + 2 * i], v1 = acc_v[4 * d + 2 * i + 1];
      if (partial) {
        *reinterpret_cast<float2*>(ws_k + at + col) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(ws_v + at + col) = make_float2(v0, v1);
      } else if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(dk + at + col) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(dv + at + col) = make_float2(v0, v1);
      }
    }
  }
}

// The block's place: keys [k0, k0 + KEYS) of kv head kvh, query head h,
// batch row b; its query tiles start at the key tile's first key when
// causal (BQ divides KEYS), and there are none where that is past S (the
// block then writes zeros).  It writes the rows from `orow` on of dk and
// dv, or of the partials where the kv head has more than one query head.
struct KeyBlock {
  int k0, h, b, kvh, qstart, ntiles;
  size_t qrow, kvrow, orow;
  bool partial;
};

template <int BQ>
__device__ __forceinline__ KeyBlock key_block(int H, int KV, int S, int Tn,
                                              int causal) {
  KeyBlock kb;
  kb.k0 = blockIdx.x * KEYS;
  kb.h = blockIdx.y;
  kb.b = blockIdx.z;
  kb.kvh = kb.h / (H / KV);
  kb.qstart = causal ? kb.k0 : 0;
  kb.ntiles = kb.qstart < S ? (S - kb.qstart + BQ - 1) / BQ : 0;
  kb.qrow = ((size_t)kb.b * H + kb.h) * S;
  kb.kvrow = ((size_t)kb.b * KV + kb.kvh) * Tn;
  kb.partial = H != KV;
  kb.orow = kb.partial ? ((size_t)kb.b * H + kb.h) * Tn : kb.kvrow;
  return kb;
}

template <int HDP, int BQ, int CS, int STAGES>
__global__ void __launch_bounds__(128 * CS, 1)
    bwd_dkdv_wgmma(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                   const bf16_t* __restrict__ v,
                   const bf16_t* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16_t* __restrict__ dk,
                   bf16_t* __restrict__ dv, float* __restrict__ ws_k,
                   float* __restrict__ ws_v, int H, int KV, int S, int Tn,
                   int hd, float scale, float scale2, int causal) {
  constexpr int THREADS = 128 * CS;
  constexpr int NJ = BQ / 8;             // 8-row blocks of a query tile
  constexpr int NC = HDP / CS;           // dk / dv columns a warpgroup
  constexpr int ND = NC / 8;
  constexpr uint32_t KM_LBO = 128;       // K-major: next 8 columns
  constexpr uint32_t KM_SBO = HDP * 16;  // K-major: next 8 rows
  constexpr int SMEM = dkdv_smem(HDP, true, BQ, STAGES);
  extern __shared__ __align__(128) unsigned char smem_kv_h[];
  bf16_t* k_s = reinterpret_cast<bf16_t*>(smem_kv_h);
  bf16_t* v_s = k_s + KEYS * HDP;
  bf16_t* q_s = v_s + KEYS * HDP;        // STAGES tiles of BQ rows
  bf16_t* do_s = q_s + STAGES * BQ * HDP;
  float* lse_s = reinterpret_cast<float*>(do_s + STAGES * BQ * HDP);
  float* dl_s = lse_s + STAGES * BQ;

  const KeyBlock kb = key_block<BQ>(H, KV, S, Tn, causal);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = (tid % 128) / 32 * 16 + g;   // keys wkey, wkey + 8
  const int col0 = wg * NC;
  const bf16_t* qb = q + kb.qrow * hd;
  const bf16_t* dob = dout + kb.qrow * hd;
  const float* lb = lse + kb.qrow;
  const float* db = delta + kb.qrow;

  if (hd != HDP) {
    zero_smem<SMEM, THREADS>(smem_kv_h);
    __syncthreads();
  }
  stage_tile<HDP, KEYS, THREADS>(k_s, k + kb.kvrow * hd, kb.k0, Tn, hd);
  stage_tile<HDP, KEYS, THREADS>(v_s, v + kb.kvrow * hd, kb.k0, Tn, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kb.ntiles)
      stage_queries<HDP, BQ, THREADS>(
          q_s + st * BQ * HDP, do_s + st * BQ * HDP, lse_s + st * BQ,
          dl_s + st * BQ, qb, dob, lb, db, kb.qstart + st * BQ, S, hd);
    cp_commit();
  }

  float acc_k[4 * ND], acc_v[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < kb.ntiles; ++it) {
    cp_wait<STAGES - 2>();   // tile it has landed, the newer may not have
    fence_async_smem();
    __syncthreads();         // ... for every thread; tile it - 1 is done
    const int nxt = it + STAGES - 1;
    if (nxt < kb.ntiles) {
      const int sl = nxt % STAGES;
      stage_queries<HDP, BQ, THREADS>(
          q_s + sl * BQ * HDP, do_s + sl * BQ * HDP, lse_s + sl * BQ,
          dl_s + sl * BQ, qb, dob, lb, db, kb.qstart + nxt * BQ, S, hd);
    }
    cp_commit();

    const int slot = it % STAGES;
    const int q0 = kb.qstart + it * BQ;
    const bf16_t* qs = q_s + slot * BQ * HDP;
    const bf16_t* ds = do_s + slot * BQ * HDP;
    float st[4 * NJ], dpt[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) st[i] = dpt[i] = 0.f;
    pin<4 * NJ>(st);
    pin<4 * NJ>(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss<BQ>(st, smem_desc(k_s + kk * 128, KM_LBO, KM_SBO),
                   smem_desc(qs + kk * 128, KM_LBO, KM_SBO));
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss<BQ>(dpt, smem_desc(v_s + kk * 128, KM_LBO, KM_SBO),
                   smem_desc(ds + kk * 128, KM_LBO, KM_SBO));
    wgmma_commit();
    wgmma_wait<0>();
    pin<4 * NJ>(st);
    pin<4 * NJ>(dpt);

    // P^T and dS^T: rows are keys k0 + wkey (+ 8), columns query rows
    // q0 + 8j + 2t (+ 1)
    const bool edge = q0 + BQ > S || kb.k0 + KEYS > Tn ||
                      (causal && q0 < kb.k0 + KEYS - 1);
    const float* ls = lse_s + slot * BQ;
    const float* dls = dl_s + slot * BQ;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lsum = (e & 1) ? l2.y : l2.x;
        const float dlt = (e & 1) ? d2.y : d2.x;
        float p = exp2_ftz(st[4 * j + e] * scale2 - lsum * LOG2E);
        if (edge) {
          const int key = kb.k0 + wkey + 8 * (e >> 1);
          const int row = q0 + 8 * j + 2 * t + (e & 1);
          if (row >= S || key >= Tn || (causal && key > row)) p = 0.f;
        }
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt);
      }
    }
    uint32_t ph[2 * NJ], pl[2 * NJ], sh[2 * NJ], sl[2 * NJ];
    split_p<NJ>(st, ph, pl);
    split_p<NJ>(dpt, sh, sl);
    pin<4 * ND>(acc_v);
    pin<4 * ND>(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mn_step<HDP, NC>(acc_v, pl + 4 * kk, ds + col0 * 8, kk);
      mn_step<HDP, NC>(acc_v, ph + 4 * kk, ds + col0 * 8, kk);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mn_step<HDP, NC>(acc_k, sl + 4 * kk, qs + col0 * 8, kk);
      mn_step<HDP, NC>(acc_k, sh + 4 * kk, qs + col0 * 8, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<4 * ND>(acc_v);
    pin<4 * ND>(acc_k);
    pin<2 * NJ>(ph);
    pin<2 * NJ>(pl);
    pin<2 * NJ>(sh);
    pin<2 * NJ>(sl);
  }
  cp_wait<0>();
  store_dkdv<ND>(acc_k, acc_v, dk, dv, ws_k, ws_v,
                 kb.orow, kb.k0 + wkey, Tn, col0, hd, t, scale, kb.partial);
}

template <int HDP, int BQ, int CS, int STAGES>
__global__ void __launch_bounds__(128 * CS, 1)
    bwd_dkdv_mma(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ ws_k,
                 float* __restrict__ ws_v, int H, int KV, int S, int Tn,
                 int hd, float scale, float scale2, int causal) {
  constexpr int THREADS = 128 * CS;
  constexpr int LD = HDP + 4;
  constexpr int NJ = BQ / 8;
  constexpr int NC = HDP / CS;
  constexpr int ND = NC / 8;
  constexpr int SMEM = dkdv_smem(HDP, false, BQ, STAGES);
  extern __shared__ __align__(128) float smem_kv_f[];
  float* k_s = smem_kv_f;
  float* v_s = k_s + KEYS * LD;
  float* q_s = v_s + KEYS * LD;
  float* do_s = q_s + STAGES * BQ * LD;
  float* lse_s = do_s + STAGES * BQ * LD;
  float* dl_s = lse_s + STAGES * BQ;

  const KeyBlock kb = key_block<BQ>(H, KV, S, Tn, causal);
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk = (tid % 128) / 32 * 16;        // the warp's first key
  const int col0 = tid / 128 * NC;
  const float* qb = q + kb.qrow * hd;
  const float* dob = dout + kb.qrow * hd;
  const float* lb = lse + kb.qrow;
  const float* db = delta + kb.qrow;

  if (hd != HDP) {
    zero_smem<SMEM, THREADS>(smem_kv_f);
    __syncthreads();
  }
  stage_tile<HDP, KEYS, THREADS>(k_s, k + kb.kvrow * hd, kb.k0, Tn, hd);
  stage_tile<HDP, KEYS, THREADS>(v_s, v + kb.kvrow * hd, kb.k0, Tn, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < kb.ntiles)
      stage_queries<HDP, BQ, THREADS>(
          q_s + st * BQ * LD, do_s + st * BQ * LD, lse_s + st * BQ,
          dl_s + st * BQ, qb, dob, lb, db, kb.qstart + st * BQ, S, hd);
    cp_commit();
  }

  float acc_k[4 * ND], acc_v[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < kb.ntiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < kb.ntiles) {
      const int sl = nxt % STAGES;
      stage_queries<HDP, BQ, THREADS>(
          q_s + sl * BQ * LD, do_s + sl * BQ * LD, lse_s + sl * BQ,
          dl_s + sl * BQ, qb, dob, lb, db, kb.qstart + nxt * BQ, S, hd);
    }
    cp_commit();

    const int slot = it % STAGES;
    const int q0 = kb.qstart + it * BQ;
    const float* qs = q_s + slot * BQ * LD;
    const float* ds = do_s + slot * BQ * LD;
    float st[4 * NJ], dpt[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 8; ++kk) {
      const float* ka = k_s + (wk + g) * LD + 8 * kk + t;
      const float* va = v_s + (wk + g) * LD + 8 * kk + t;
      const float xk[4] = {ka[0], ka[8 * LD], ka[4], ka[8 * LD + 4]};
      const float xv[4] = {va[0], va[8 * LD], va[4], va[8 * LD + 4]};
      uint32_t kh[4], kl[4], vh[4], vl[4];
      split4(xk, kh, kl);
      split4(xv, vh, vl);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* qr = qs + (8 * j + g) * LD + 8 * kk + t;
        const float* dr = ds + (8 * j + g) * LD + 8 * kk + t;
        mma_3xtf32(st + 4 * j, kh, kl, split_tf32(qr[0]), split_tf32(qr[4]));
        mma_3xtf32(dpt + 4 * j, vh, vl, split_tf32(dr[0]),
                   split_tf32(dr[4]));
      }
    }
    const bool edge = q0 + BQ > S || kb.k0 + KEYS > Tn ||
                      (causal && q0 < kb.k0 + KEYS - 1);
    const float* ls = lse_s + slot * BQ;
    const float* dls = dl_s + slot * BQ;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lsum = (e & 1) ? l2.y : l2.x;
        const float dlt = (e & 1) ? d2.y : d2.x;
        float p = exp2_ftz(st[4 * j + e] * scale2 - lsum * LOG2E);
        if (edge) {
          const int key = kb.k0 + wk + g + 8 * (e >> 1);
          const int row = q0 + 8 * j + 2 * t + (e & 1);
          if (row >= S || key >= Tn || (causal && key > row)) p = 0.f;
        }
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - dlt);
      }
    }
    // dv += P^T dO, dk += dS^T Q: the accumulator's columns 2t and 2t + 1
    // of block j are the A fragment's t and t + 4, so B's rows are query
    // rows 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float xp[4] = {st[4 * j], st[4 * j + 2], st[4 * j + 1],
                           st[4 * j + 3]};
      const float xs[4] = {dpt[4 * j], dpt[4 * j + 2], dpt[4 * j + 1],
                           dpt[4 * j + 3]};
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split4(xp, ph, pl);
      split4(xs, sh, sl);
      const float* dr = ds + (8 * j + 2 * t) * LD + col0 + g;
      const float* qr = qs + (8 * j + 2 * t) * LD + col0 + g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        mma_3xtf32(acc_v + 4 * d, ph, pl, split_tf32(dr[8 * d]),
                   split_tf32(dr[LD + 8 * d]));
        mma_3xtf32(acc_k + 4 * d, sh, sl, split_tf32(qr[8 * d]),
                   split_tf32(qr[LD + 8 * d]));
      }
    }
  }
  cp_wait<0>();
  store_dkdv<ND>(acc_k, acc_v, dk, dv, ws_k, ws_v,
                 kb.orow, kb.k0 + wk + g, Tn, col0, hd, t, scale,
                 kb.partial);
}

// -- pass 3: dk and dv from the heads' partials --------------------------

// dk[b, kvh] = sum over g < G of ws_k[b, kvh G + g], in that order; dv the
// same.  `per` = T hd elements a head, `n` = B KV T hd; four elements a
// thread (hd is a multiple of 8).
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
    bwd_sum(const float* __restrict__ ws_k, const float* __restrict__ ws_v,
            T* __restrict__ dk, T* __restrict__ dv, int G, size_t per,
            size_t n) {
  for (size_t e = ((size_t)blockIdx.x * SUM_THREADS + threadIdx.x) * 4;
       e < n; e += (size_t)gridDim.x * SUM_THREADS * 4) {
    const size_t u = e / per, r = e - u * per;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < G; ++g) {
      const size_t at = (u * G + g) * per + r;
      const float4 a = *reinterpret_cast<const float4*>(ws_k + at);
      const float4 c = *reinterpret_cast<const float4*>(ws_v + at);
      sk = make_float4(sk.x + a.x, sk.y + a.y, sk.z + a.z, sk.w + a.w);
      sv = make_float4(sv.x + c.x, sv.y + c.y, sv.z + c.z, sv.w + c.w);
    }
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk + e);
      __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv + e);
      ok[0] = __floats2bfloat162_rn(sk.x, sk.y);
      ok[1] = __floats2bfloat162_rn(sk.z, sk.w);
      ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
      ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
    } else {
      *reinterpret_cast<float4*>(dk + e) = sk;
      *reinterpret_cast<float4*>(dv + e) = sv;
    }
  }
}

// -- pass 4: dq ----------------------------------------------------------

// A lane's rows (row, row + 8) of dq, scaled, columns below hd
template <int ND, typename T>
__device__ __forceinline__ void store_dq(const float* acc, T* dq, int row,
                                         int S, int hd, int t, float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int col = 8 * d + 2 * t;
      if (col >= hd) continue;
      const float a = acc[4 * d + 2 * i] * scale;
      const float b = acc[4 * d + 2 * i + 1] * scale;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (size_t)r * hd + col) =
            __floats2bfloat162_rn(a, b);
      } else {
        *reinterpret_cast<float2*>(dq + (size_t)r * hd + col) =
            make_float2(a, b);
      }
    }
  }
}

// The block's place: rows [q0, q0 + QROWS) of head h, batch row b,
// heaviest causal tile first; its key tiles end at kend.
struct RowBlock {
  int q0, h, b, kend;
  size_t qrow, kvrow;
};

__device__ __forceinline__ RowBlock row_block(int H, int KV, int S, int Tn,
                                              int causal) {
  RowBlock rb;
  rb.q0 = (gridDim.x - 1 - blockIdx.x) * QROWS;
  rb.h = blockIdx.y;
  rb.b = blockIdx.z;
  rb.kend = causal ? min(Tn, rb.q0 + QROWS) : Tn;
  rb.qrow = ((size_t)rb.b * H + rb.h) * S;
  rb.kvrow = ((size_t)rb.b * KV + rb.h / (H / KV)) * Tn;
  return rb;
}

template <int HDP, int BK, int STAGES>
__global__ void __launch_bounds__(128, 1)
    bwd_dq_wgmma(const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                 const bf16_t* __restrict__ v,
                 const bf16_t* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16_t* __restrict__ dq,
                 int H, int KV, int S, int Tn, int hd, float scale,
                 float scale2, int causal) {
  constexpr int THREADS = 128;
  constexpr int NJ = BK / 8;
  constexpr int ND = HDP / 8;
  constexpr uint32_t KM_LBO = 128;
  constexpr uint32_t KM_SBO = HDP * 16;
  constexpr int SMEM = dq_smem(HDP, true, BK, STAGES);
  extern __shared__ __align__(128) bf16_t smem_q_h[];
  bf16_t* q_s = smem_q_h;
  bf16_t* do_s = q_s + QROWS * HDP;
  bf16_t* k_s = do_s + QROWS * HDP;        // STAGES tiles of BK keys
  bf16_t* v_s = k_s + STAGES * BK * HDP;

  const RowBlock rb = row_block(H, KV, S, Tn, causal);
  const int ntiles = (rb.kend + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row = rb.q0 + tid / 32 * 16 + g;   // this lane's rows: row, +8
  const bf16_t* kb = k + rb.kvrow * hd;
  const bf16_t* vb = v + rb.kvrow * hd;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row + 8 * i < S;
    lse2[i] = in ? lse[rb.qrow + row + 8 * i] * LOG2E : 0.f;
    dlt[i] = in ? delta[rb.qrow + row + 8 * i] : 0.f;
  }

  if (hd != HDP) {
    zero_smem<SMEM, THREADS>(smem_q_h);
    __syncthreads();
  }
  stage_tile<HDP, QROWS, THREADS>(q_s, q + rb.qrow * hd, rb.q0, S, hd);
  stage_tile<HDP, QROWS, THREADS>(do_s, dout + rb.qrow * hd, rb.q0, S, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) {
      stage_tile<HDP, BK, THREADS>(k_s + st * BK * HDP, kb, st * BK, Tn, hd);
      stage_tile<HDP, BK, THREADS>(v_s + st * BK * HDP, vb, st * BK, Tn, hd);
    }
    cp_commit();
  }

  float acc[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) acc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < ntiles) {
      const int sl = nxt % STAGES;
      stage_tile<HDP, BK, THREADS>(k_s + sl * BK * HDP, kb, nxt * BK, Tn, hd);
      stage_tile<HDP, BK, THREADS>(v_s + sl * BK * HDP, vb, nxt * BK, Tn, hd);
    }
    cp_commit();

    const int k0 = it * BK;
    const bf16_t* ks = k_s + (it % STAGES) * BK * HDP;
    const bf16_t* vs = v_s + (it % STAGES) * BK * HDP;
    float s[4 * NJ], dp[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) s[i] = dp[i] = 0.f;
    pin<4 * NJ>(s);
    pin<4 * NJ>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss<BK>(s, smem_desc(q_s + kk * 128, KM_LBO, KM_SBO),
                   smem_desc(ks + kk * 128, KM_LBO, KM_SBO));
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
      wgmma_ss<BK>(dp, smem_desc(do_s + kk * 128, KM_LBO, KM_SBO),
                   smem_desc(vs + kk * 128, KM_LBO, KM_SBO));
    wgmma_commit();
    wgmma_wait<0>();
    pin<4 * NJ>(s);
    pin<4 * NJ>(dp);

    // rows row (+ 8), columns keys k0 + 8j + 2t (+ 1)
    const bool edge = (causal && k0 + BK - 1 > rb.q0) || k0 + BK > Tn;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(s[4 * j + e] * scale2 - lse2[e >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= Tn || (causal && key > row + 8 * (e >> 1))) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dlt[e >> 1]);
      }
    }
    uint32_t sh[2 * NJ], sl[2 * NJ];
    split_p<NJ>(dp, sh, sl);
    pin<4 * ND>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      mn_step<HDP, HDP>(acc, sl + 4 * kk, ks, kk);
      mn_step<HDP, HDP>(acc, sh + 4 * kk, ks, kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<4 * ND>(acc);
    pin<2 * NJ>(sh);
    pin<2 * NJ>(sl);
  }
  cp_wait<0>();
  store_dq<ND>(acc, dq + rb.qrow * hd, row, S, hd, t, scale);
}

template <int HDP, int BK, int STAGES>
__global__ void __launch_bounds__(128, 1)
    bwd_dq_mma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq, int H,
               int KV, int S, int Tn, int hd, float scale, float scale2,
               int causal) {
  constexpr int THREADS = 128;
  constexpr int LD = HDP + 4;
  constexpr int NJ = BK / 8;
  constexpr int ND = HDP / 8;
  constexpr int SMEM = dq_smem(HDP, false, BK, STAGES);
  extern __shared__ __align__(128) float smem_q_f[];
  float* q_s = smem_q_f;
  float* do_s = q_s + QROWS * LD;
  float* k_s = do_s + QROWS * LD;
  float* v_s = k_s + STAGES * BK * LD;

  const RowBlock rb = row_block(H, KV, S, Tn, causal);
  const int ntiles = (rb.kend + BK - 1) / BK;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = tid / 32 * 16;              // the warp's first row
  const int row = rb.q0 + wrow + g;
  const float* kb = k + rb.kvrow * hd;
  const float* vb = v + rb.kvrow * hd;
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row + 8 * i < S;
    lse2[i] = in ? lse[rb.qrow + row + 8 * i] * LOG2E : 0.f;
    dlt[i] = in ? delta[rb.qrow + row + 8 * i] : 0.f;
  }

  if (hd != HDP) {
    zero_smem<SMEM, THREADS>(smem_q_f);
    __syncthreads();
  }
  stage_tile<HDP, QROWS, THREADS>(q_s, q + rb.qrow * hd, rb.q0, S, hd);
  stage_tile<HDP, QROWS, THREADS>(do_s, dout + rb.qrow * hd, rb.q0, S, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) {
      stage_tile<HDP, BK, THREADS>(k_s + st * BK * LD, kb, st * BK, Tn, hd);
      stage_tile<HDP, BK, THREADS>(v_s + st * BK * LD, vb, st * BK, Tn, hd);
    }
    cp_commit();
  }

  float acc[4 * ND];
#pragma unroll
  for (int i = 0; i < 4 * ND; ++i) acc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < ntiles) {
      const int sl = nxt % STAGES;
      stage_tile<HDP, BK, THREADS>(k_s + sl * BK * LD, kb, nxt * BK, Tn, hd);
      stage_tile<HDP, BK, THREADS>(v_s + sl * BK * LD, vb, nxt * BK, Tn, hd);
    }
    cp_commit();

    const int k0 = it * BK;
    const float* ks = k_s + (it % STAGES) * BK * LD;
    const float* vs = v_s + (it % STAGES) * BK * LD;
    float s[4 * NJ], dp[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4 * NJ; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 8; ++kk) {
      const float* qa = q_s + (wrow + g) * LD + 8 * kk + t;
      const float* da = do_s + (wrow + g) * LD + 8 * kk + t;
      const float xq[4] = {qa[0], qa[8 * LD], qa[4], qa[8 * LD + 4]};
      const float xd[4] = {da[0], da[8 * LD], da[4], da[8 * LD + 4]};
      uint32_t qh[4], ql[4], dh[4], dl[4];
      split4(xq, qh, ql);
      split4(xd, dh, dl);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* kr = ks + (8 * j + g) * LD + 8 * kk + t;
        const float* vr = vs + (8 * j + g) * LD + 8 * kk + t;
        mma_3xtf32(s + 4 * j, qh, ql, split_tf32(kr[0]), split_tf32(kr[4]));
        mma_3xtf32(dp + 4 * j, dh, dl, split_tf32(vr[0]), split_tf32(vr[4]));
      }
    }
    const bool edge = (causal && k0 + BK - 1 > rb.q0 + wrow) || k0 + BK > Tn;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(s[4 * j + e] * scale2 - lse2[e >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= Tn || (causal && key > row + 8 * (e >> 1))) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dlt[e >> 1]);
      }
    }
    // dq += dS K: B's rows are keys 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float x[4] = {dp[4 * j], dp[4 * j + 2], dp[4 * j + 1],
                          dp[4 * j + 3]};
      uint32_t sh[4], sl[4];
      split4(x, sh, sl);
      const float* kr = ks + (8 * j + 2 * t) * LD + g;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        mma_3xtf32(acc + 4 * d, sh, sl, split_tf32(kr[8 * d]),
                   split_tf32(kr[LD + 8 * d]));
    }
  }
  cp_wait<0>();
  store_dq<ND>(acc, dq + rb.qrow * hd, row, S, hd, t, scale);
}

// -- the launch --------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float *delta, *ws_k, *ws_v;
  int B, H, KV, S, Tn, hd, causal, device;
  cudaStream_t st;
};

template <int HDP, bool BF16>
cudaError_t launch(const Args& a) {
  using T = typename std::conditional<BF16, bf16_t, float>::type;
  constexpr int BQ = plan_rows(HDP, BF16), BK = plan_qkeys(HDP, BF16);
  constexpr int CS = plan_cols(HDP), STAGES = plan_stages(HDP, BF16);
  constexpr int SM_KV = dkdv_smem(HDP, BF16, BQ, STAGES);
  constexpr int SM_Q = dq_smem(HDP, BF16, BK, STAGES);
  static_assert(SM_KV <= SMEM_MAX && SM_Q <= SMEM_MAX,
                "the plan overflows shared memory");
  const auto kv_kern = [] {
    if constexpr (BF16) return bwd_dkdv_wgmma<HDP, BQ, CS, STAGES>;
    else return bwd_dkdv_mma<HDP, BQ, CS, STAGES>;
  }();
  const auto q_kern = [] {
    if constexpr (BF16) return bwd_dq_wgmma<HDP, BK, STAGES>;
    else return bwd_dq_mma<HDP, BK, STAGES>;
  }();
  // the shared-memory attribute, once a device
  static std::atomic<uint64_t> ready{0};
  const uint64_t bit = 1ull << (a.device & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    cudaError_t e = cudaFuncSetAttribute(
        kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_KV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SM_Q);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const float scale = (float)(1.0 / sqrt((double)a.hd));
  const float scale2 = LOG2E * scale;
  const T* Q = static_cast<const T*>(a.q);
  const T* K = static_cast<const T*>(a.k);
  const T* V = static_cast<const T*>(a.v);
  const T* DO = static_cast<const T*>(a.dout);
  const size_t rows = (size_t)a.B * a.H * a.S;
  bwd_delta<T><<<(unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS),
                 32 * DELTA_ROWS, 0, a.st>>>(static_cast<const T*>(a.o), DO,
                                             a.delta, rows, a.hd);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 kv_grid((a.Tn + KEYS - 1) / KEYS, a.H, a.B);
  kv_kern<<<kv_grid, 128 * CS, SM_KV, a.st>>>(
      Q, K, V, DO, a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.ws_k, a.ws_v, a.H, a.KV, a.S, a.Tn, a.hd,
      scale, scale2, a.causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.H != a.KV) {
    const size_t per = (size_t)a.Tn * a.hd;
    const size_t n = (size_t)a.B * a.KV * per;
    const size_t want = (n / 4 + SUM_THREADS - 1) / SUM_THREADS;
    bwd_sum<T><<<(unsigned)(want < SUM_BLOCKS ? want : SUM_BLOCKS),
                 SUM_THREADS, 0, a.st>>>(a.ws_k, a.ws_v,
                                         static_cast<T*>(a.dk),
                                         static_cast<T*>(a.dv), a.H / a.KV,
                                         per, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const dim3 q_grid((a.S + QROWS - 1) / QROWS, a.H, a.B);
  q_kern<<<q_grid, 128, SM_Q, a.st>>>(Q, K, V, DO, a.lse, a.delta,
                                      static_cast<T*>(a.dq), a.H, a.KV, a.S,
                                      a.Tn, a.hd, scale, scale2, a.causal);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_hd(int hdp, const Args& a) {
  switch (hdp) {
    case 32: return launch<32, BF16>(a);
    case 64: return launch<64, BF16>(a);
    case 128: return launch<128, BF16>(a);
    case 256: return launch<256, BF16>(a);
  }
  return cudaErrorInvalidValue;
}

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

// The launcher's guard: the sizes it takes (the grids' y and z within
// 65,535, bwd_delta's grid of B H S / 8 blocks within INT_MAX; S and T at
// least 1 and at most 127 short of INT_MAX, since a block's row and key
// bounds q0 + 64 and k0 + 64 and its loops' last q0 + rows and
// k0 + q_keys are int), the plan it is built with for (hd, dtype), and
// 16-byte aligned, non-null operands and workspaces (ws_k and ws_v, the
// heads' partials, only where H > KV).
bool plan_ok(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, const void* dq,
             const void* dk, const void* dv, const void* delta,
             const void* ws_k, const void* ws_v, int B, int H, int KV, int S,
             int T, int hd, int bf16, int rows, int keys, int q_keys,
             int stages) {
  const void* need[] = {q, k, v, o, lse, dout, dq, dk, dv, delta};
  for (const void* p : need)
    if (p == nullptr || (addr(p) & 15) != 0) return false;
  const void* work[] = {ws_k, ws_v};
  for (const void* p : work)
    if ((addr(p) & 15) != 0 || (p == nullptr && H != KV)) return false;
  if (!(B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 && T >= 1 &&
        S <= INT_MAX - 127 && T <= INT_MAX - 127 && hd >= 8 && hd <= 256 &&
        hd % 8 == 0 && H <= 65535 && B <= 65535))
    return false;
  const int hdp = plan_hdp(hd);
  const bool is_bf16 = bf16 != 0;
  return ((long long)B * H * S + DELTA_ROWS - 1) / DELTA_ROWS <= INT_MAX &&
         rows == plan_rows(hdp, is_bf16) && keys == KEYS &&
         q_keys == plan_qkeys(hdp, is_bf16) &&
         stages == plan_stages(hdp, is_bf16);
}

}  // namespace

// All pointers are device pointers to contiguous, 16-byte aligned arrays on
// card `device`, float32 (bf16 == 0) or bfloat16 (bf16 == 1): q, o, dout
// and dq (B, H, S, hd), k, v, dk and dv (B, KV, T, hd); lse is the
// forward's float32 (B, H, S) logsumexp of each row's scaled scores
// (natural log); delta a float32 workspace (B, H, S); ws_k and ws_v
// float32 workspaces (B, H, T, hd) where H > KV, else may be null.  hd is
// a multiple of 8 from 8 to 256 and H a multiple of KV; (rows, keys,
// q_keys, stages) must be the plan the kernel is built with for (hd,
// dtype), `flash_bwd_plan`'s.  The passes go on `stream`; returns the
// CUDA error code (cudaErrorInvalidValue where the guard refuses,
// launching nothing).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   void* ws_k, void* ws_v, int B, int H,
                                   int KV, int S, int T, int hd, int bf16,
                                   int causal, int rows, int keys,
                                   int q_keys, int stages, int device,
                                   void* stream) {
  if (!plan_ok(q, k, v, o, lse, dout, dq, dk, dv, delta, ws_k, ws_v, B, H,
               KV, S, T, hd, bf16, rows, keys, q_keys, stages))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), static_cast<float*>(ws_k),
               static_cast<float*>(ws_v), B, H, KV, S, T, hd, causal, device,
               static_cast<cudaStream_t>(stream)};
  if (bf16) return (int)launch_hd<true>(plan_hdp(hd), a);
  return (int)launch_hd<false>(plan_hdp(hd), a);
}

// The launcher's guard alone (plan_ok), on the launcher's own arguments
// but the device and the stream: 1 where flash_attention_bwd would launch,
// 0 where it would return cudaErrorInvalidValue.  `causal` takes no part
// in it.  Launches nothing and touches no device.
extern "C" int flash_attention_bwd_plan_ok(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* ws_k, void* ws_v, int B, int H, int KV, int S, int T,
    int hd, int bf16, int causal, int rows, int keys, int q_keys,
    int stages) {
  (void)causal;
  return plan_ok(q, k, v, o, lse, dout, dq, dk, dv, delta, ws_k, ws_v, B, H,
                 KV, S, T, hd, bf16, rows, keys, q_keys, stages);
}
