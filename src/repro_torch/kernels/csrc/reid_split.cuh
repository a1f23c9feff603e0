// The gallery-split design shared by the re-id top-k kernels for Hopper
// (sm_90a): unmasked (reid_topk_plain.cu), camera-masked (reid_topk.cu)
// and tile-masked over fused (camera x tile) cells (reid_topk_tiles.cu).
// Each fuses the similarity GEMM with a masked top-k, the (Q, G) score
// matrix never in device memory.
//
// What bounds these kernels on an H100.  At the benchmark and stress
// shapes (Q = 256, G = 8,192) the fp32 product, 2 Q G D operations, is the
// work: 0.27 GFLOP at D = 64 and 8.6 GFLOP at D = 2,048, about 4 us and
// 0.13 ms at the 67 TFLOP/s CUDA-core peak, against 2.2 MB and 67 MB to
// read.  A block per 32 query rows over the whole gallery would leave most
// of the 132 SMs idle (8 blocks at Q = 256).  This design answers with
// four pieces.
//
//  1. The split.  A block owns BQ = 64 query rows and one slice of the
//     gallery, a whole number of BG = 64-row tiles; the grid is q-blocks x
//     S slices, q-block fastest, so the blocks that read one gallery slice
//     run together and share it through the 50 MB L2.  S comes from the
//     host (kernels/reid_topk.py::split_plan); slice s holds tiles
//     [s ng / S, (s + 1) ng / S).  With S = 1 the block writes the k
//     results itself; with S > 1 it writes its slice's top-K per query row
//     (raw, sentinels as (-inf, INT_MAX)) to a workspace the wrapper
//     allocates, and merge_slices picks the k best of the S K candidates
//     of each row.  The merge is exact: a slice's top-K holds every member
//     of the global top-k that lies in the slice, and every comparison is
//     the total order (score descending, index ascending).
//  2. The product.  64 threads in an 8 x 8 grid, each owning an 8 x 8
//     micro-tile: rows tq + 8 i, columns tg + 8 j.  Per two depth steps a
//     thread reads 8 + 8 float2 from shared memory for 128 FMAs, 4 FMAs per
//     word (a block of at most 16 or 32 query rows runs only the first 2
//     or 4 row groups).  Operands are staged row-major ([row][depth],
//     DCH = 32 deep) by cp.async, double-buffered: chunk c + 1 is in
//     flight while chunk c multiplies, and the next tile's first chunk and
//     gallery columns while a tile's scores fold.  The row stride is
//     padded to OS = 36 words, which makes both sides free of bank
//     conflicts: a quarter-warp's 16-byte copies fill one row's 32
//     contiguous words, and the 8 consecutive rows a warp reads at one
//     depth start 4 banks apart, so their 8-byte reads cover all 32 banks
//     once (the 4 query rows broadcast).  Each score is one fmaf chain in
//     depth order from 0, the zero-padded depth adding exact zeros, so the
//     three kernels give the same bits wherever their eligibility agrees.
//  3. The top-K, out of the product's registers.  After a tile's product
//     every thread stores its 64 scores to a score tile in shared memory
//     (over the first operand stage, stride SS = 72 words, conflict-free).
//     A half-warp then takes a row, 4 entries a lane, and keeps an entry
//     only if it is eligible and beats the row's threshold, the K-th best
//     so far (a shared array: one compare in the common case).  A row with
//     no candidate is skipped; otherwise the half-warp selects the row's
//     best K by xor shuffles of 64-bit keys (score and index in one
//     unsigned order) — a bitonic network for K = 16, K rounds of a
//     half-warp maximum for K <= 8 — and merges them into the row's list
//     in shared memory.  On the card a warp shuffle is the scarce unit (one
//     a clock per SM), so the selection counts shuffles: 114 a row for
//     K = 16, 8 K and the merge's for K <= 8.  No list lives in the
//     product's registers.
//  4. Dead tiles.  An admission may decide, per tile, before any operand
//     is copied, whether the (64-row, 64-row) tile holds an eligible pair
//     (Admission::SKIPS, the tile kernel's): the tile's gallery columns
//     land first, the admission gathers its masks, and __syncthreads_or
//     skips a tile with none, which would push nothing.  Admissions that
//     do not skip run the loop without that step.
#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace reid {

constexpr int MAX_K = 16;
constexpr float NEG_INF = -1e30f;              // the sentinel score
constexpr size_t DEFAULT_SMEM = 48 * 1024;     // without the opt-in attribute

namespace split {

constexpr int BQ = 64;            // query rows per block
constexpr int BG = 64;            // gallery rows per tile
constexpr int DCH = 32;           // depth per staged chunk
constexpr int NT = 64;            // threads: 8 x 8, each an 8 x 8 micro-tile
constexpr int OS = DCH + 4;       // operand row stride, words
constexpr int SS = BG + 8;        // score row stride, words
constexpr int MERGE_THREADS = 128;  // merge_slices: 8 half-warps per row
constexpr unsigned FULL = 0xffffffffu;
constexpr float NONE = -INFINITY;   // "no candidate" inside the kernels

static_assert(BQ == BG, "the operand stages share one row count");

struct Smem {
  union {
    float op[2][2][BQ][OS];  // [stage][query or gallery][row][depth]
    float score[BQ][SS];     // a tile's filtered scores, over stage 0
  };
  float lv[BQ][MAX_K];       // each row's running top-K, best first
  int li[BQ][MAX_K];
  float thr[BQ];             // lv[r][K - 1]: the row's K-th best
  int qtag[BQ];
  int gcam[2][BG];           // a tile's gallery cameras and tags, by
  int gtag[2][BG];           // tile parity
};

static_assert(sizeof(float) * BQ * SS <= sizeof(float) * 2 * BQ * OS,
              "the score tile fits in stage 0");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [row0, row0 + BQ) x depth [d0, d0 + DCH) of x (rows x D) into
// dst; what lies past the rows or the depth is zero-filled.  `vec`: D is a
// multiple of 4 and x 16-byte aligned, so 16-byte copies; else 4-byte ones.
__device__ __forceinline__ void load_stage(float (*dst)[OS],
                                           const float* __restrict__ x,
                                           int rows, int row0, int D, int d0,
                                           bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int m = 0; m < BQ * DCH / 4 / NT; ++m) {
      const int p = tid + NT * m, r = p >> 3, c = (p & 7) * 4;
      const bool ok = row0 + r < rows && d0 + c < D;
      cp_async16(&dst[r][c], ok ? x + (size_t)(row0 + r) * D + d0 + c : x,
                 ok);
    }
  } else {
    for (int m = 0; m < BQ * DCH / NT; ++m) {
      const int p = tid + NT * m, r = p >> 5, c = p & 31;
      const bool ok = row0 + r < rows && d0 + c < D;
      cp_async4(&dst[r][c], ok ? x + (size_t)(row0 + r) * D + d0 + c : x,
                ok);
    }
  }
}

// acc[i][j] += q[tq + 8 i] . g[tg + 8 j] over one staged chunk, in depth
// order, for the first NI row groups (a block with at most 8 NI query
// rows leaves the others alone).
template <int NI>
__device__ __forceinline__ void product(const float (*qs)[OS],
                                        const float (*gs)[OS], int tq, int tg,
                                        float (&acc)[8][8]) {
#pragma unroll 4
  for (int dd = 0; dd < DCH; dd += 2) {
    float2 a[NI], b[8];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a[i] = *reinterpret_cast<const float2*>(&qs[tq + 8 * i][dd]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float2*>(&gs[tg + 8 * j][dd]);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
    }
  }
}

// An entry (score v, gallery index i) as one 64-bit key whose unsigned
// order is the total order: the score's bits made monotonic above, the
// complemented index below, so a larger key is a higher score or, on
// equal scores, a lower index.  v + 0.f folds -0 into +0, which compare
// equal as floats.
using Key = unsigned long long;

__device__ __forceinline__ Key key_of(float v, int i) {
  unsigned u = __float_as_uint(v + 0.f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) | static_cast<unsigned>(~i);
}

__device__ __forceinline__ float key_score(Key k) {
  const unsigned u = static_cast<unsigned>(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_index(Key k) {
  return static_cast<int>(~static_cast<unsigned>(k));
}

__device__ __forceinline__ Key kmax(Key a, Key b) { return a > b ? a : b; }
__device__ __forceinline__ Key kmin(Key a, Key b) { return a > b ? b : a; }

// One compare-exchange across lanes `lane ^ j` (j < 16, so inside a
// half-warp).  `desc`: the pair's lower position takes the larger key.
__device__ __forceinline__ void cas_lanes(Key& k, int j, bool desc,
                                          bool lower) {
  const Key p = __shfl_xor_sync(FULL, k, j);
  k = (lower == desc) ? kmax(k, p) : kmin(k, p);
}

// The best 16 of a row of 64 keys, best first over a half-warp's lanes;
// key e = 16 t + (lane & 15) lies in register t.  Each register (a column
// of 16) is sorted across lanes, best first in even columns and last in
// odd ones; the lane-wise larger of columns 0 and 1 (and of 2 and 3) is
// then a bitonic 16 holding the pair's best 16; cleaned to opposite
// orders, their lane-wise larger holds the row's best 16, and a last clean
// sorts it: 18 exchange stages.  Every lane of the warp must call it.
__device__ __forceinline__ Key best16(Key (&k)[4], int hl) {
#pragma unroll
  for (int s = 2; s <= 16; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      const bool lower = (hl & j) == 0;
      const bool up = (hl & s) == 0;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        cas_lanes(k[t], j, up == ((t & 1) == 0), lower);
    }
  }
  Key a = kmax(k[0], k[1]), b = kmax(k[2], k[3]);
#pragma unroll
  for (int j = 8; j > 0; j >>= 1) {
    const bool lower = (hl & j) == 0;
    cas_lanes(a, j, true, lower);
    cas_lanes(b, j, false, lower);
  }
  a = kmax(a, b);
#pragma unroll
  for (int j = 8; j > 0; j >>= 1) cas_lanes(a, j, true, (hl & j) == 0);
  return a;
}

// The best K (K <= 8) of a row of 64 keys, best first over lanes 0..K-1 of
// a half-warp: each lane sorts its 4 keys, then K rounds each take the
// largest head (a 4-stage max over the half-warp) and pop it from its
// lane; 4 K stages of one 64-bit shuffle.  An exhausted slot holds
// `floor`, the key of "no candidate".  Every lane of the warp must call it.
template <int K>
__device__ __forceinline__ Key best_few(Key (&k)[4], int hl, Key floor) {
  const auto order = [](Key& x, Key& y) {
    const Key hi = kmax(x, y);
    y = kmin(x, y);
    x = hi;
  };
  order(k[0], k[1]);
  order(k[2], k[3]);
  order(k[0], k[2]);
  order(k[1], k[3]);
  order(k[1], k[2]);
  Key out = floor;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    Key m = k[0];
#pragma unroll
    for (int j = 8; j > 0; j >>= 1) m = kmax(m, __shfl_xor_sync(FULL, m, j));
    if (k[0] == m) {
      k[0] = k[1];
      k[1] = k[2];
      k[2] = k[3];
      k[3] = floor;
    }
    if (hl == r) out = m;
  }
  return out;
}

// c, a sorted list of K keys in lanes 0..K-1 of each half-warp, becomes
// the best K of itself and of x, another such list: the list against the
// other reversed keeps the best K as a bitonic sequence, and log2(K)
// stages sort it.  Every lane of the warp must call it.
template <int K>
__device__ __forceinline__ Key merge_lists(Key c, Key x, int lane) {
  const int hl = lane & 15;
  c = kmax(c, __shfl_sync(FULL, x, (lane & 16) | ((K - 1 - hl) & 15)));
#pragma unroll
  for (int j = K >> 1; j > 0; j >>= 1) cas_lanes(c, j, true, (hl & j) == 0);
  return c;
}

// Fold a tile's scores (sm.score) into the rows' lists.  Half-warp h of
// warp w takes row 4 m + w + 2 h, so the two halves of a warp read rows 2
// apart, 16 banks apart.  An entry is a candidate when its row holds a
// query, its column a gallery row, it is eligible (adm.ok) and it beats
// the row's threshold, the K-th best so far: the common case, once the
// list is full, fails the compare.  A row with no candidate is skipped;
// the others select their best K (best16 for K = 16, else best_few) and
// merge them into the list.
template <int K, class Admission>
__device__ __forceinline__ void fold_tile(Smem& sm, const Admission& adm,
                                          int tb, int nrows, int g0, int G,
                                          int tid) {
  const Key none = key_of(NONE, INT_MAX);
  const int lane = tid & 31, w = tid >> 5, hl = lane & 15;
  for (int m = 0; 4 * m + w < nrows; ++m) {
    const int row = 4 * m + w + 2 * (lane >> 4);
    const float th = sm.thr[row];
    Key k[4];
    bool any = false;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = t * 16 + hl;
      const float v = sm.score[row][c];
      const bool keep = row < nrows && g0 + c < G && v > th &&
                        adm.ok(sm, tb, row, c);
      k[t] = keep ? key_of(v, g0 + c) : none;
      any |= keep;
    }
    if (!__any_sync(FULL, any)) continue;
    Key best;
    if constexpr (K == 16)
      best = best16(k, hl);
    else
      best = best_few<K>(k, hl, none);
    // a row's first candidates need no merge: its list is empty
    Key c = best;
    if (!__all_sync(FULL, sm.lv[row][0] == NONE))
      c = merge_lists<K>(hl < K ? key_of(sm.lv[row][hl], sm.li[row][hl])
                                : none,
                         best, lane);
    if (hl < K) {
      sm.lv[row][hl] = key_score(c);
      sm.li[row][hl] = key_index(c);
    }
    if (hl == K - 1) sm.thr[row] = key_score(c);
  }
}

// Stage a tile's gallery columns, a camera or cell and a tag per row, into
// column buffer tb by cp.async; past G they read 0, but the caller tests
// g < G before ok().
__device__ __forceinline__ void stage_columns(Smem& sm, int tb,
                                              const int* __restrict__ cam,
                                              const int* __restrict__ tag,
                                              int g0, int G, int tid) {
  for (int r = tid; r < BG; r += NT) {
    const bool in = g0 + r < G;
    cp_async4(&sm.gcam[tb][r], in ? cam + g0 + r : cam, in);
    cp_async4(&sm.gtag[tb][r], in ? tag + g0 + r : tag, in);
  }
}

// Stage tile t's first depth chunk into stage 1 (the score tile lies over
// stage 0); the caller commits the cp.async group.
__device__ __forceinline__ void first_chunk(Smem& sm,
                                            const float* __restrict__ q,
                                            const float* __restrict__ g,
                                            int Q, int G, int D, int q0,
                                            int t, bool vec, int tid) {
  load_stage(sm.op[1][0], q, Q, q0, D, 0, vec, tid);
  load_stage(sm.op[1][1], g, G, t * BG, D, 0, vec, tid);
}

// A tile's product over the whole depth, into the score tile.  Its first
// chunk is in flight in stage 1; chunk c lies in stage (c + 1) % 2, and
// chunk c + 1 is issued while chunk c multiplies.  Every cp.async group is
// complete on return.
__device__ __forceinline__ void score_tile(Smem& sm,
                                           const float* __restrict__ q,
                                           const float* __restrict__ g,
                                           int Q, int G, int D, int q0,
                                           int g0, int ni, bool vec,
                                           int tid) {
  const int tq = tid >> 3, tg = tid & 7;
  const int nch = (D + DCH - 1) / DCH;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      const int b = ch & 1, d0 = (ch + 1) * DCH;
      load_stage(sm.op[b][0], q, Q, q0, D, d0, vec, tid);
      load_stage(sm.op[b][1], g, G, g0, D, d0, vec, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // chunk ch is in place for every thread
    const int b = (ch + 1) & 1;
    if (ni <= 2)
      product<2>(sm.op[b][0], sm.op[b][1], tq, tg, acc);
    else if (ni <= 4)
      product<4>(sm.op[b][0], sm.op[b][1], tq, tg, acc);
    else
      product<8>(sm.op[b][0], sm.op[b][1], tq, tg, acc);
    __syncthreads();  // chunk ch is consumed: its stage may refill
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sm.score[tq + 8 * i][tg + 8 * j] = acc[i][j];
  }
  __syncthreads();  // the score tile is complete; stage 1 is free
}

// The first live tile of [t, t1) for an admission that skips dead tiles.
// On entry tile t's columns are in flight into column buffer tb, the only
// pending cp.async group.  For each candidate the columns land, and
// adm.gather(sm, tb, q0, g0, nrows, tid) builds its masks (buffer tb) and
// says whether the thread's column holds an eligible pair; a tile with
// none in the block is skipped before any of its operands is copied, and
// the next candidate's columns come into the same buffer.  The live tile
// found has its first chunk and the next tile's columns (into buffer
// tb ^ 1, whose masks the caller may still be folding: ok() reads only the
// masks) issued as one group.  Returns the tile, or t1 if none is live.
template <class Admission>
__device__ __forceinline__ int next_live(Smem& sm, const Admission& adm,
                                         const float* __restrict__ q,
                                         const float* __restrict__ g,
                                         int Q, int G, int D, int q0,
                                         int nrows, int t, int t1, int tb,
                                         bool vec, int tid) {
  for (; t < t1; ++t) {
    cp_wait<0>();
    __syncthreads();  // tile t's columns are in place for every thread
    if (__syncthreads_or(adm.gather(sm, tb, q0, t * BG, nrows, tid))) break;
    if (t + 1 < t1) {
      adm.tile(sm, tb, (t + 1) * BG, tid);
      cp_commit();
    }
  }
  if (t < t1) {
    if (t + 1 < t1) adm.tile(sm, tb ^ 1, (t + 1) * BG, tid);
    first_chunk(sm, q, g, Q, G, D, q0, t, vec, tid);
    cp_commit();
  }
  return t;
}

// The block's work: q-block blockIdx.x % nq, slice blockIdx.x / nq.
// `adm` decides eligibility beyond the ranges: adm.setup(sm, q0, nrows,
// tid) stages the block's query rows (overlapping the first tile's
// copies), adm.tile(sm, tb, g0, tid) issues the copies of a tile's gallery
// columns into column buffer tb, and adm.ok(sm, tb, r, c) tests one pair.
// While a tile's scores fold, the next tile's first chunk and columns are
// in flight.  An admission with SKIPS also gathers each tile's masks
// (next_live) and runs the product of live tiles only.
template <int K, class Admission>
__device__ __forceinline__ void slice_topk(
    Smem& sm, const Admission& adm, const float* __restrict__ q,
    const float* __restrict__ g, int Q, int G, int D, int k, int S, bool vec,
    float* __restrict__ out_v, int* __restrict__ out_i,
    float* __restrict__ ws_v, int* __restrict__ ws_i) {
  const int tid = threadIdx.x;
  const int nq = (Q + BQ - 1) / BQ;
  const int s = blockIdx.x / nq;
  const int q0 = (blockIdx.x - s * nq) * BQ;
  const int nrows = min(BQ, Q - q0);
  const int ni = (nrows + 7) / 8;       // row groups holding a query
  const int ng = (G + BG - 1) / BG;
  const int t0 = (int)((long long)s * ng / S);
  const int t1 = (int)((long long)(s + 1) * ng / S);

  adm.tile(sm, 0, t0 * BG, tid);
  if constexpr (!Admission::SKIPS)
    first_chunk(sm, q, g, Q, G, D, q0, t0, vec, tid);
  cp_commit();
  adm.setup(sm, q0, nrows, tid);
  for (int e = tid; e < BQ * MAX_K; e += NT) {
    (&sm.lv[0][0])[e] = NONE;
    (&sm.li[0][0])[e] = INT_MAX;
  }
  for (int r = tid; r < BQ; r += NT) sm.thr[r] = NONE;

  if constexpr (Admission::SKIPS) {
    int tb = 0;
    int t = next_live(sm, adm, q, g, Q, G, D, q0, nrows, t0, t1, tb, vec,
                      tid);
    while (t < t1) {
      score_tile(sm, q, g, Q, G, D, q0, t * BG, ni, vec, tid);
      const int next = next_live(sm, adm, q, g, Q, G, D, q0, nrows, t + 1,
                                 t1, tb ^ 1, vec, tid);
      fold_tile<K>(sm, adm, tb, nrows, t * BG, G, tid);
      __syncthreads();  // lists updated, the score tile (stage 0) free
      t = next;
      tb ^= 1;
    }
  } else {
    for (int t = t0; t < t1; ++t) {
      const int tb = (t - t0) & 1;
      score_tile(sm, q, g, Q, G, D, q0, t * BG, ni, vec, tid);
      if (t + 1 < t1) {
        adm.tile(sm, tb ^ 1, (t + 1) * BG, tid);
        first_chunk(sm, q, g, Q, G, D, q0, t + 1, vec, tid);
        cp_commit();
      }
      fold_tile<K>(sm, adm, tb, nrows, t * BG, G, tid);
      __syncthreads();  // lists updated, the score tile (stage 0) free
    }
  }

  if (S == 1) {
    for (int e = tid; e < nrows * k; e += NT) {
      const int r = e / k, l = e - r * k;
      const float v = sm.lv[r][l];
      const bool real = v > NEG_INF / 2;
      out_v[(size_t)(q0 + r) * k + l] = real ? v : NEG_INF;
      out_i[(size_t)(q0 + r) * k + l] = real ? sm.li[r][l] : -1;
    }
  } else {
    for (int e = tid; e < nrows * K; e += NT) {
      const int r = e / K, l = e - r * K;
      const size_t o = ((size_t)(q0 + r) * S + s) * K + l;
      ws_v[o] = sm.lv[r][l];
      ws_i[o] = sm.li[r][l];
    }
  }
}

// The k best of each query row's S slice lists (workspace (Q, S, K), each
// list best first): one block of 8 half-warps per row, half-warp h folding
// slices h, h + 8, ...; then half-warp 0 folds the other seven.
template <int K>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_slices(const float* __restrict__ ws_v, const int* __restrict__ ws_i,
             float* __restrict__ out_v, int* __restrict__ out_i, int S,
             int k) {
  static_assert(K <= 16, "a list fits in a half-warp");
  constexpr int HALVES = MERGE_THREADS / 16, BATCH = 4;
  __shared__ Key hk[HALVES][MAX_K];
  const Key none = key_of(NONE, INT_MAX);
  const int tid = threadIdx.x, lane = tid & 31, hw = tid >> 4,
            hl = tid & 15;
  const size_t row = (size_t)blockIdx.x * S * K;
  Key c = none;
  for (int b0 = 0; b0 < S; b0 += HALVES * BATCH) {  // bound uniform
    Key x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int s = b0 + hw + HALVES * u;
      const size_t o = row + (size_t)s * K + hl;
      x[u] = s < S && hl < K ? key_of(ws_v[o], ws_i[o]) : none;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) c = merge_lists<K>(c, x[u], lane);
  }
  if (hl < K) hk[hw][hl] = c;
  __syncthreads();
  if (tid >= 32) return;  // warp 0 folds; its half 1 repeats half 0's work
  c = hl < K ? hk[0][hl] : none;
#pragma unroll
  for (int h = 1; h < HALVES; ++h)
    c = merge_lists<K>(c, hl < K ? hk[h][hl] : none, lane);
  if (lane < k) {
    const float v = key_score(c);
    const bool real = v > NEG_INF / 2;
    out_v[(size_t)blockIdx.x * k + lane] = real ? v : NEG_INF;
    out_i[(size_t)blockIdx.x * k + lane] = real ? key_index(c) : -1;
  }
}

// The launchers' shared pieces.  A plan is S slices of a gallery of
// ceil(G / BG) tiles, each slice at least one tile; S > 1 needs both
// workspace arrays.
inline bool plan_ok(int Q, int G, int S, const void* ws_v,
                    const void* ws_i) {
  const long long nq = (Q + BQ - 1) / BQ, ng = (G + BG - 1) / BG;
  return S >= 1 && S <= ng && nq * S <= INT_MAX &&
         (S == 1 || (ws_v != nullptr && ws_i != nullptr));
}

// 16-byte copies need every row start 16-byte aligned.
inline bool vec_ok(const float* q, const float* g, int D) {
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

// After a split launch (S > 1): the merge, on the same stream.
template <int K>
cudaError_t merge(int Q, int S, int k, const float* ws_v, const int* ws_i,
                  float* out_v, int* out_i, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  merge_slices<K><<<Q, MERGE_THREADS, 0, stream>>>(ws_v, ws_i, out_v, out_i,
                                                   S, k);
  return cudaGetLastError();
}

}  // namespace split
}  // namespace reid
