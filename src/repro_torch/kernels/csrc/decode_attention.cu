// Decode attention for Hopper (sm_90a): one query token of every head
// against a long key/value cache, split along the cache (flash-decoding).
//
// Replaces the TPU kernel `_decode_kernel` launched by `decode_attention`
// in src/repro/kernels/decode_attention.py.  Same function: for row b, the
// keys t < length[b] (length past T means T) are scored q . k * hd^-0.5 in
// float32, softmaxed with a float32 running (max, sum, accumulator), p
// stays float32 in the PV product (the Pallas kernel casts v to float32
// first), and the output is acc / max(l, 1e-30) in q's dtype; a row with
// length <= 0 is zeros, since every tile is skipped.
//
// What bounds it on an H100.  Each cached key and value must leave device
// memory once: 2 hd bytes a key and kv head per byte of the dtype, against
// 4 G hd flops (G = H / KV q heads share a kv head): 2 G / itemsize flops a
// byte, 4 at yi-6b's G = 8 in float32 and 8 in bfloat16.  Bytes, if the
// instructions around the flops fit under the byte time.
//
// Design (`decode_plan` in kernels/decode_attention.py, mirrored by
// `plan_ok`):
// - A block takes up to 8 q heads of one kv head (all G of them; larger
//   G in groups) against one split of the cache, so each K and V element
//   leaves device memory once a group and shared memory once a block.
//   The grid is (row, kv head, group, split), split fastest; the split
//   length follows the shape, so small batches still fill the card, and a
//   split at or past a row's length returns at once.
// - Its 4 or 8 warps take the split's tiles in turn, each through its own
//   ring of STAGES = 3 tiles: 16-byte cp.async copies of K and V rows
//   in the cache's dtype (bfloat16 stays bfloat16 in shared memory), two
//   tiles in flight while one is computed, one __syncwarp a tile and no
//   block barrier in the loop.
// - float32 (`decode_fma_kernel`, CUDA-core FMA, rows of hdp = hd rounded
//   up to 32): the lanes of a warp form KQ groups of DL lanes, each group
//   scoring NKB keys at a time with q's HEADS rows in registers (at most 8
//   dims a lane, for every head); a reduce-scatter over the group's lanes
//   (shuffles, halving the values each step) turns the partial sums into
//   whole scores, which go through the warp's shared score tile for each
//   head's max and sum (shuffles) and come back as p; each lane holds
//   hdp / 32 dims x HEADS heads of the accumulator and reads each staged V
//   row once for all heads.
// - bfloat16 (`decode_mma_kernel`, mma.sync.m16n8k16 on the tensor cores,
//   rows of hdp = hd rounded up to 16, padded 16 bytes so that ldmatrix's
//   eight rows fall on eight bank groups): the block's 8 heads are the
//   product's N.  S (16 keys x 8 heads) = K (ldmatrix) . q (B fragments in
//   registers, bfloat16 products exact in the float32 sum); each thread's
//   two heads keep their (m, l) in registers, the max over the 16 keys by
//   three shuffles; O^T (hdp x 8 heads) += V^T (ldmatrix.trans) . P^T, p
//   split into bfloat16 pieces p_hi + p_lo as flash does (so p stays
//   float32 to 2^-16), each piece's 8 x 8 blocks turned from the score
//   accumulator's layout into B fragments by movmatrix.trans.
// - At the end the warps' (m, l, acc) merge through shared memory.  With
//   one split (or a row that reaches only its first split) the block
//   writes the output; otherwise it writes a float32 partial, and the last
//   block of its (row, kv head, group), found by an atomic ticket on a
//   zeroed counter (which it zeroes again, so the next launch needs no
//   memset), combines the row's partials: lanes over the splits for
//   the max and the sum, threads over (head, 4 dims) with the splits dealt
//   among them for the accumulator.  With `combine` == 0 the partials are
//   left uncombined (to time the two parts).

#include <cstddef>
#include <cstdint>
#include <utility>

#include "attention.cuh"

namespace {

using namespace attn;
using bf16_t = __nv_bfloat16;

constexpr int MAX_THREADS = 256;   // warps a block: 4 or 8 (the plan's)
// one block an SM is enough: the plan's blocks hold up to 227 KB of ring,
// and without it ptxas traded a few bytes of spill for a second block
constexpr int MIN_BLOCKS = 1;
constexpr int STAGES = 3;         // tiles in a warp's ring
constexpr int MAX_HEADS = 8;      // q heads a block; mma's N
constexpr int MAX_SPLITS = 256;   // weights the combine keeps a head
constexpr int MAX_SMEM = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// -- geometry shared by the host check and the kernels ----------------------

// float32: keys a warp scores side by side (lane groups of 32 / KQ lanes),
// so that a lane holds at most 8 of a key's hdp = 32 dpl dims.
__host__ __device__ constexpr int key_groups(int dpl) {
  return dpl == 1 ? 8 : dpl == 2 ? 4 : dpl <= 4 ? 2 : 1;
}
__host__ __device__ constexpr int pow2_floor(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}
// float32: keys a lane group scores before reducing, 8 / heads, at most
// 4 KB of K in the score block.
__host__ __device__ constexpr int group_keys(int dpl, int heads) {
  const int cap = pow2_floor(4096 / (key_groups(dpl) * 32 * dpl * 4));
  return 8 / heads < cap ? 8 / heads : cap;
}
__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}
// The widest vector (elements, at most 16 bytes) that divides n floats.
__host__ __device__ constexpr int vec_width(int n) {
  int w = 4;
  while (n % w) w /= 2;
  return w;
}
__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Elements of a staged row: float32 hdp (a multiple of 32); bfloat16 hdp
// (a multiple of 16) + 8.
__host__ __device__ constexpr int row_elems(int hdp, bool bf16) {
  return bf16 ? hdp + 8 : hdp;
}

// A warp's share: its ring and, in float32, its score tile and its heads'
// rescales.
__host__ __device__ size_t warp_bytes(int hdp, bool bf16, int heads,
                                      int tile) {
  const size_t ring =
      (size_t)STAGES * 2 * tile * row_elems(hdp, bf16) * (bf16 ? 2 : 4);
  return bf16 ? ring : ring + round16((size_t)tile * heads * 4) + 32;
}

size_t smem_bytes(int hdp, bool bf16, int heads, int tile, int warps) {
  const size_t ring = warps * warp_bytes(hdp, bf16, heads, tile);
  const size_t merge = 4 * ((size_t)warps * heads * (hdp + 3) + 2 * heads);
  const size_t combine =
      4 * ((size_t)heads * MAX_SPLITS + 8) + 16 * 32 * (size_t)warps;
  const size_t m = ring > merge ? ring : merge;
  return m > combine ? m : combine;
}

// -- copies -----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most STAGES - 2 groups of this lane are pending: the
// oldest tile of the ring has landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A lane's share of a tile's copy: the 16-byte chunks lane, lane + 32,
// ... of the tile's rows of hd elements, walked as (row, element) with the
// step of 32 chunks, so no division is left in the loop.
struct Chunks {
  int r, e;       // the lane's first chunk
  int dr, de;     // 32 chunks on
  __device__ Chunks(int lane, int hd, int epc) {
    const int cpr = hd / epc;
    r = lane / cpr;
    e = (lane - r * cpr) * epc;
    dr = 32 / cpr;
    de = (32 - dr * cpr) * epc;
  }
};

// A warp's copy of `rows` K and V rows of hd elements from kg and vg into
// rows of ROW elements at ks and vs.
template <int ROW, typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kg,
                                          const T* vg, int rows, int hd,
                                          const Chunks& c) {
  int r = c.r, e = c.e;
  while (r < rows) {
    cp_async16(ks + r * ROW + e, kg + (size_t)r * hd + e);
    cp_async16(vs + r * ROW + e, vg + (size_t)r * hd + e);
    r += c.dr;
    e += c.de;
    if (e >= hd) {
      e -= hd;
      ++r;
    }
  }
}

// -- where a block works, and its end ---------------------------------------

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const int* length;
  T* o;
  float* ws_acc;    // (B, H, splits, hd)
  float2* ws_ml;    // (B, H, splits): (max in log2 units, sum)
  int* counters;    // (B, KV, groups), zero before the launch and after
  int H, KV, Tn, hd, G, groups, tile, split, splits, combine;
  int warps;        // warps a block (blockDim.x / 32)
  float scale;      // hd^-0.5 log2(e): scores in log2 units
};

// blockIdx.x read as (row b, kv head, group, split s), split fastest, and
// what follows from it.
struct Where {
  int s, unit, b, kvh, h0, gv, len, n_valid;
  size_t orow;    // the output row (and q row) of the block's first head
};

template <int HEADS, typename T>
__device__ __forceinline__ Where locate(const Args<T>& a, int blk) {
  Where at;
  at.s = blk % a.splits;
  at.unit = blk / a.splits;
  const int grp = at.unit % a.groups, u = at.unit / a.groups;
  at.kvh = u % a.KV;
  at.b = u / a.KV;
  at.h0 = at.kvh * a.G + grp * HEADS;
  at.gv = min(HEADS, a.G - grp * HEADS);
  at.len = min(max(a.length[at.b], 0), a.Tn);
  at.n_valid = (int)(((long long)at.len + a.split - 1) / a.split);
  at.orow = ((size_t)at.b * a.H + at.h0) * a.hd;
  return at;
}

// blockIdx.x and threadIdx.x read anew, so that the end of a kernel
// recomputes where the block works instead of keeping the prologue's
// values live across the loop (ptxas spilled some of them in a few
// templates).
__device__ __forceinline__ int block_index() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return x;
}
__device__ __forceinline__ int thread_index() {
  int x;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(x));
  return x;
}

// A block that does no scoring: past its row's length, or split 0 of a row
// of length 0, which writes the zeros the Pallas kernel gives.  True when
// the block is done.
template <typename T>
__device__ __forceinline__ bool idle(const Args<T>& a, const Where& at,
                                     int tid) {
  if (at.s > 0 && at.s >= at.n_valid) return true;
  if (at.len > 0) return false;
  for (int i = tid; i < at.gv * a.hd; i += 32 * a.warps)
    a.o[at.orow + i] = from_f32<T>(0.f);
  return true;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ void fma4(float4& a, float w, const float4& x) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}

// Four outputs acc / l in the output's dtype.
template <typename T>
__device__ __forceinline__ void store4(T* out, const float4& x, float l) {
  out[0] = from_f32<T>(x.x / l);
  out[1] = from_f32<T>(x.y / l);
  out[2] = from_f32<T>(x.z / l);
  out[3] = from_f32<T>(x.w / l);
}

// The end of both kernels, from the warps' states in shared memory
// (m [warps][HEADS] in log2 units, l [warps][HEADS], then acc
// [warps][HEADS][HDP] after one more [warps][HEADS] and two [HEADS]
// arrays, `state_acc`): merge the warps, then write the output, or the
// block's partial and, for the last block of the unit, the combine of the
// unit's partials.
template <int HEADS, int HDP, typename T>
__device__ __forceinline__ void finish(const Args<T>& a,
                                       unsigned char* smem) {
  __shared__ int s_last;
  const int tid = thread_index(), w = tid >> 5, lane = tid & 31;
  const int warps = a.warps, nthreads = 32 * warps;
  float* mw = reinterpret_cast<float*>(smem);   // [warps][HEADS]
  float* lw = mw + warps * HEADS;               // [warps][HEADS]
  float* wt = lw + warps * HEADS;               // [warps][HEADS]
  float* bm = wt + warps * HEADS;               // [HEADS]
  float* bl = bm + HEADS;                       // [HEADS]
  float* aw = bl + HEADS;                       // [warps][HEADS][HDP]
  if (tid < HEADS) {                            // weights 2^(m_w - M)
    float M = NEG_INF, L = 0.f;
    for (int x = 0; x < warps; ++x) M = fmaxf(M, mw[x * HEADS + tid]);
    for (int x = 0; x < warps; ++x) {
      const float y = exp2f(mw[x * HEADS + tid] - M);
      wt[x * HEADS + tid] = y;
      L = fmaf(lw[x * HEADS + tid], y, L);
    }
    bm[tid] = M;
    bl[tid] = L;
  }
  __syncthreads();
  const Where fin = locate<HEADS>(a, block_index());
  const int gv = fin.gv, n_valid = fin.n_valid;
  const size_t orow = fin.orow;
  const bool direct = n_valid == 1;     // the row's only split
  const size_t hrow = ((size_t)fin.b * a.H + fin.h0) * a.splits;  // ws, split 0
  const size_t wrow = hrow + fin.s;                               // split s
  for (int i = tid; i < gv * a.hd; i += nthreads) {
    const int g = i / a.hd, d = i - g * a.hd;
    float A = 0.f;
    for (int x = 0; x < warps; ++x)
      A = fmaf(aw[(x * HEADS + g) * HDP + d], wt[x * HEADS + g], A);
    if (direct)
      a.o[orow + i] = from_f32<T>(A / fmaxf(bl[g], 1e-30f));
    else
      a.ws_acc[(wrow + (size_t)g * a.splits) * a.hd + d] = A;
  }
  if (direct) return;
  if (tid < gv)
    a.ws_ml[wrow + (size_t)tid * a.splits] = make_float2(bm[tid], bl[tid]);
  if (!a.combine) return;

  // the last block of the unit to get here combines its partials
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + fin.unit, 1) == n_valid - 1;
  __syncthreads();
  if (!s_last) return;
  if (tid == 0) a.counters[fin.unit] = 0;  // every block of the unit counted
  __threadfence();
  float* wj = reinterpret_cast<float*>(smem);   // [HEADS][MAX_SPLITS]
  float* Ls = wj + HEADS * MAX_SPLITS;          // [HEADS]
  float4* red = reinterpret_cast<float4*>(Ls + 8);  // [nthreads]
  for (int g = w; g < gv; g += warps) {         // lanes over the splits
    const float2* ml = a.ws_ml + hrow + (size_t)g * a.splits;
    float M = NEG_INF;
    for (int j = lane; j < n_valid; j += 32) M = fmaxf(M, __ldcg(&ml[j].x));
    M = warp_max(M);
    float L = 0.f;
    for (int j = lane; j < n_valid; j += 32) {
      const float2 x = __ldcg(ml + j);
      const float y = exp2f(x.x - M);
      wj[g * MAX_SPLITS + j] = y;
      L = fmaf(x.y, y, L);
    }
    L = warp_sum(L);
    if (lane == 0) Ls[g] = L;
  }
  __syncthreads();
  // threads over (head, 4 dims), the splits dealt among `parts` of them
  const int q4 = a.hd / 4, slots = gv * q4;
  const int parts = max(1, nthreads / slots);
  for (int i = tid; i < slots * parts; i += nthreads) {
    const int slot = i % slots, part = i / slots;
    const int g = slot / q4;
    const float4* src = reinterpret_cast<const float4*>(
                            a.ws_acc + (hrow + (size_t)g * a.splits) * a.hd) +
                        (slot - g * q4);
    const float* y = wj + g * MAX_SPLITS;
    // eight loads in flight, into eight sums
    float4 x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    int j = part;
    for (; j + 7 * parts < n_valid; j += 8 * parts) {
      float4 z[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) z[u] = __ldcg(src + (size_t)(j + u * parts) * q4);
#pragma unroll
      for (int u = 0; u < 8; ++u) fma4(x[u], y[j + u * parts], z[u]);
    }
    for (; j < n_valid; j += parts) fma4(x[0], y[j], __ldcg(src + (size_t)j * q4));
#pragma unroll
    for (int u = 1; u < 8; ++u) {
      x[0].x += x[u].x;
      x[0].y += x[u].y;
      x[0].z += x[u].z;
      x[0].w += x[u].w;
    }
    const float4 x0 = x[0];
    if (parts == 1)
      store4(a.o + orow + (size_t)g * a.hd + (slot - g * q4) * 4, x0,
             fmaxf(Ls[g], 1e-30f));
    else
      red[i] = x0;
  }
  if (parts > 1) {
    __syncthreads();
    for (int i = tid; i < slots; i += nthreads) {
      float4 x = red[i];
      for (int p = 1; p < parts; ++p) {
        const float4 z = red[p * slots + i];
        x.x += z.x;
        x.y += z.y;
        x.z += z.z;
        x.w += z.w;
      }
      const int g = i / q4;
      store4(a.o + orow + (size_t)g * a.hd + (i - g * q4) * 4, x,
             fmaxf(Ls[g], 1e-30f));
    }
  }
}

// Where the warps' accumulators go in shared memory for `finish` (their m
// and l at its start).
template <int HEADS>
__device__ __forceinline__ float* state_acc(unsigned char* smem, int warps) {
  return reinterpret_cast<float*>(smem) + 3 * warps * HEADS + 2 * HEADS;
}

// -- float32: CUDA-core FMA -------------------------------------------------

// N consecutive floats of shared memory (N * 4 bytes aligned).
template <int N>
__device__ __forceinline__ void load_vec(const float* s, float* o) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    o[0] = x.x; o[1] = x.y;
  } else {
    o[0] = s[0];
  }
}

template <int DPL, int HEADS>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    decode_fma_kernel(const Args<float> a) {
  constexpr int HDP = 32 * DPL;
  constexpr int KQ = key_groups(DPL);
  constexpr int DL = 32 / KQ;                   // lanes splitting a key
  constexpr int LOG_DL = ilog2(DL);
  constexpr int DPLQ = DPL * KQ;                // a lane's dims of a key
  constexpr int NKB = group_keys(DPL, HEADS);
  constexpr int SK = KQ * NKB;                  // keys a score block
  constexpr int V = HEADS * NKB;                // partial scores a lane
  constexpr int S = ilog2(V) < LOG_DL ? ilog2(V) : LOG_DL;  // scatter steps
  constexpr int VPL = V >> S;                   // whole scores a lane
  constexpr int DUP = LOG_DL - S;               // lane bits holding copies
  constexpr int CWQ = vec_width(DPLQ);
  constexpr int CWV = vec_width(DPL);
  constexpr int HV = HEADS < 4 ? HEADS : 4;     // floats a p load

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const Where at = locate<HEADS>(a, blockIdx.x);
  if (idle(a, at, tid)) return;
  const int t_begin = at.s * a.split;
  const int t_end =
      (int)min((long long)t_begin + a.split, (long long)at.len);

  // this warp's ring, its score tile and its heads' rescales
  unsigned char* wbase =
      smem + w * warp_bytes(HDP, false, HEADS, a.tile);
  float* ring = reinterpret_cast<float*>(wbase);
  const size_t stage_elems = (size_t)2 * a.tile * HDP;
  float* sc = ring + STAGES * stage_elems;
  float* cr = sc + round16((size_t)a.tile * HEADS * 4) / 4;
  if (a.hd < HDP) {                             // zero the padding columns
    const int pad = HDP - a.hd, rows = STAGES * 2 * a.tile;
    for (int i = lane; i < rows * pad; i += 32)
      ring[(size_t)(i / pad) * HDP + a.hd + i % pad] = 0.f;
  }

  // the warp's tiles w, w + warps, ... of the split
  const size_t kv0 = ((size_t)at.b * a.KV + at.kvh) * a.Tn * a.hd;
  const float* kg = a.k + kv0 + (size_t)(t_begin + w * a.tile) * a.hd;
  const float* vg = a.v + kv0 + (size_t)(t_begin + w * a.tile) * a.hd;
  const int round = a.warps * a.tile;                  // a round of tiles
  const size_t step = (size_t)round * a.hd;
  const Chunks chunks(lane, a.hd, 4);

  // q in registers: lane dl of its key group holds dims
  // c DL CWQ + dl CWQ + [0, CWQ) of every head
  const int kq = lane / DL, dl = lane % DL;
  float qr[HEADS][DPLQ];
#pragma unroll
  for (int g = 0; g < HEADS; ++g)
#pragma unroll
    for (int e = 0; e < DPLQ; ++e) {
      const int d = (e / CWQ) * DL * CWQ + dl * CWQ + e % CWQ;
      qr[g][e] = g < at.gv && d < a.hd ? a.q[at.orow + (size_t)g * a.hd + d]
                                       : 0.f;
    }

  float m_own = NEG_INF, l_own = 0.f;   // of head lane % HEADS, log2 units
  float acc[HEADS][DPL];                // dims c 32 CWV + lane CWV + [0, CWV)
#pragma unroll
  for (int g = 0; g < HEADS; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;

  // the next tile to load (its first key, its stage) and the next to score
  int ld_t0 = t_begin + w * a.tile, ld_stage = 0, stage = 0;
  auto issue = [&]() {
    if (ld_t0 < t_end) {
      float* ks = ring + ld_stage * stage_elems;
      load_tile<HDP>(ks, ks + (size_t)a.tile * HDP, kg, vg,
                     min(a.tile, t_end - ld_t0), a.hd, chunks);
    }
    cp_async_commit();
    ld_t0 += round;
    kg += step;
    vg += step;
    ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
  };
  __syncwarp();                         // the padding is zero
  for (int st = 0; st < STAGES - 1; ++st) issue();
  for (int t0 = t_begin + w * a.tile; t0 < t_end; t0 += round) {
    cp_async_wait_ring();
    __syncwarp();                       // the tile landed; the last is read
    issue();
    const int rows = min(a.tile, t_end - t0);
    const float* ks = ring + stage * stage_elems;
    const float* vs = ks + (size_t)a.tile * HDP;
    stage = stage + 1 == STAGES ? 0 : stage + 1;

    // scores of the tile, a score block at a time
    for (int sb = 0; sb < a.tile; sb += SK) {
      float part[V];
#pragma unroll
      for (int i = 0; i < V; ++i) part[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NKB; ++kk) {
        const float* kr = ks + (size_t)(sb + kq * NKB + kk) * HDP + dl * CWQ;
        float kf[DPLQ];
#pragma unroll
        for (int c = 0; c < DPLQ / CWQ; ++c)
          load_vec<CWQ>(kr + c * DL * CWQ, kf + c * CWQ);
#pragma unroll
        for (int g = 0; g < HEADS; ++g)
#pragma unroll
          for (int e = 0; e < DPLQ; ++e)
            part[kk * HEADS + g] = fmaf(qr[g][e], kf[e], part[kk * HEADS + g]);
      }
      // reduce-scatter: the lane whose bit `off` is set keeps the upper half
#pragma unroll
      for (int st = 0; st < S; ++st) {
        const int half = (V >> st) / 2, off = DL >> (st + 1);
        const bool up = dl & off;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = up ? part[i] : part[i + half];
          const float keep = up ? part[i + half] : part[i];
          part[i] = keep + __shfl_xor_sync(FULL, send, off);
        }
      }
#pragma unroll
      for (int off = DL >> (S + 1); off >= 1; off >>= 1)
        part[0] += __shfl_xor_sync(FULL, part[0], off);
      if ((dl & ((1 << DUP) - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < VPL; ++r) {
          const int i = (dl >> DUP) * VPL + r;
          const int key = sb + kq * NKB + i / HEADS;
          sc[key * HEADS + i % HEADS] =
              key < rows ? part[r] * a.scale : NEG_INF;
        }
      }
    }
    __syncwarp();

    // each head's max over the tile, its rescale, p and the lane's sum;
    // entry e = key HEADS + head lies with lane e % 32, of head lane % HEADS
    const int n = a.tile * HEADS;
    float mx = NEG_INF;
    for (int e = lane; e < n; e += 32) mx = fmaxf(mx, sc[e]);
#pragma unroll
    for (int off = HEADS; off < 32; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_new = fmaxf(m_own, mx);   // a tile holds a valid key
    const float corr = exp2f(m_own - m_new);
    float ps = 0.f;
    for (int e = lane; e < n; e += 32) {
      const float p = exp2f(sc[e] - m_new);
      sc[e] = p;
      ps += p;
    }
    l_own = fmaf(l_own, corr, ps);
    m_own = m_new;
    if (lane < HEADS) cr[lane] = corr;
    __syncwarp();

    // P V: every staged V row once, for all heads
    float cg[HEADS];
#pragma unroll
    for (int g = 0; g < HEADS; g += HV) load_vec<HV>(cr + g, cg + g);
#pragma unroll
    for (int g = 0; g < HEADS; ++g)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] *= cg[g];
#pragma unroll 2
    for (int key = 0; key < rows; ++key) {
      float p[HEADS];
#pragma unroll
      for (int g = 0; g < HEADS; g += HV)
        load_vec<HV>(sc + key * HEADS + g, p + g);
      float vf[DPL];
      const float* vr = vs + (size_t)key * HDP + lane * CWV;
#pragma unroll
      for (int c = 0; c < DPL / CWV; ++c)
        load_vec<CWV>(vr + c * 32 * CWV, vf + c * CWV);
#pragma unroll
      for (int g = 0; g < HEADS; ++g)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p[g], vf[e], acc[g][e]);
    }
  }
  cp_async_wait_all();

  // the warp's state into shared memory, for `finish`
#pragma unroll
  for (int off = HEADS; off < 32; off <<= 1)
    l_own += __shfl_xor_sync(FULL, l_own, off);
  __syncthreads();                      // every ring is done: reuse it
  float* ml = reinterpret_cast<float*>(smem);
  float* aw = state_acc<HEADS>(smem, a.warps);
  if (lane < HEADS) {
    ml[w * HEADS + lane] = m_own;
    ml[(a.warps + w) * HEADS + lane] = l_own;
  }
#pragma unroll
  for (int g = 0; g < HEADS; ++g)
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      aw[(w * HEADS + g) * HDP + (e / CWV) * 32 * CWV + lane * CWV + e % CWV] =
          acc[g][e];
  __syncthreads();
  finish<HEADS, HDP>(a, smem);
}

// -- bfloat16: the tensor cores (mma.sync.m16n8k16) -------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d (16 x 8, float32) += a (16 x 16) b (16 x 8), bfloat16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// The low bfloat16 pieces of the float pair (lo, hi) whose high pieces are
// the pair `high`.
__device__ __forceinline__ uint32_t low_piece(float lo, float hi,
                                              uint32_t high) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&high);
  return pack_bf16(lo - __low2float(h), hi - __high2float(h));
}

template <int HDP>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
    decode_mma_kernel(const Args<bf16_t> a) {
  constexpr int ROW = HDP + 8;          // a staged row, 16 bytes of padding
  constexpr int KT = HDP / 16;          // k-steps of S, m-tiles of O^T

  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma's group and thread in group
  const Where at = locate<MAX_HEADS>(a, blockIdx.x);
  if (idle(a, at, tid)) return;
  const int t_begin = at.s * a.split;
  const int t_end =
      (int)min((long long)t_begin + a.split, (long long)at.len);

  // this warp's ring, zeroed once: the padding columns stay zero and rows
  // past a ragged tile's end hold finite values (they meet p = 0)
  const size_t stage_elems = (size_t)2 * a.tile * ROW;
  bf16_t* ring =
      reinterpret_cast<bf16_t*>(smem) + (size_t)w * STAGES * stage_elems;
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n = (int)(STAGES * stage_elems * 2 / 16);
    for (int i = lane; i < n; i += 32) z[i] = make_uint4(0, 0, 0, 0);
  }

  const size_t kv0 = ((size_t)at.b * a.KV + at.kvh) * a.Tn * a.hd;
  const bf16_t* kg = a.k + kv0 + (size_t)(t_begin + w * a.tile) * a.hd;
  const bf16_t* vg = a.v + kv0 + (size_t)(t_begin + w * a.tile) * a.hd;
  const int round = a.warps * a.tile;                  // a round of tiles
  const size_t step = (size_t)round * a.hd;
  const Chunks chunks(lane, a.hd, 8);

  // q as the B fragments of S = K q^T: head g, dims 16 kk + 2t (+ 8), + 1
  uint32_t qb[KT][2];
  {
    const bf16_t* qrow = a.q + at.orow + (size_t)g * a.hd;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = 16 * kk + 8 * j + 2 * t;
        qb[kk][j] = g < at.gv && d < a.hd
                        ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
      }
  }
  // each thread's two heads 2t, 2t + 1: (m, l) and O^T's dims 16 mt + g
  // (+ 8) of them
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[KT][4];
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j] = 0.f;

  int ld_t0 = t_begin + w * a.tile, ld_stage = 0, stage = 0;
  auto issue = [&]() {
    if (ld_t0 < t_end) {
      bf16_t* ks = ring + ld_stage * stage_elems;
      load_tile<ROW>(ks, ks + (size_t)a.tile * ROW, kg, vg,
                     min(a.tile, t_end - ld_t0), a.hd, chunks);
    }
    cp_async_commit();
    ld_t0 += round;
    kg += step;
    vg += step;
    ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
  };
  __syncwarp();                         // the ring is zero
  for (int st = 0; st < STAGES - 1; ++st) issue();
  for (int t0 = t_begin + w * a.tile; t0 < t_end; t0 += round) {
    cp_async_wait_ring();
    __syncwarp();                       // the tile landed; the last is read
    issue();
    const int rows = min(a.tile, t_end - t0);
    const bf16_t* ks = ring + stage * stage_elems;
    const bf16_t* vs = ks + (size_t)a.tile * ROW;
    stage = stage + 1 == STAGES ? 0 : stage + 1;

    for (int kb = 0; kb < rows; kb += 16) {     // 16 keys at a time
      // S: keys kb + g (+ 8) x heads 2t, 2t + 1
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16_t* ka =
          ks + (size_t)(kb + (lane & 15)) * ROW + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, ka + 16 * kk);
        mma_bf16(s, af, qb[kk][0], qb[kk][1]);
      }
      const bool v0 = kb + g < rows, v1 = kb + g + 8 < rows;
      s[0] = v0 ? s[0] * a.scale : NEG_INF;
      s[1] = v0 ? s[1] * a.scale : NEG_INF;
      s[2] = v1 ? s[2] * a.scale : NEG_INF;
      s[3] = v1 ? s[3] * a.scale : NEG_INF;
      // each head's max over the 16 keys: the 8 groups hold its 16 rows
      float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
      }
      const float n0 = fmaxf(m[0], mx0), n1 = fmaxf(m[1], mx1);
      const float c0 = exp2f(m[0] - n0), c1 = exp2f(m[1] - n1);
      m[0] = n0;
      m[1] = n1;
      const float p0 = exp2f(s[0] - n0), p1 = exp2f(s[1] - n1);
      const float p2 = exp2f(s[2] - n0), p3 = exp2f(s[3] - n1);
      l[0] = fmaf(l[0], c0, p0 + p2);
      l[1] = fmaf(l[1], c1, p1 + p3);
#pragma unroll
      for (int mt = 0; mt < KT; ++mt) {
        acc[mt][0] *= c0;
        acc[mt][1] *= c1;
        acc[mt][2] *= c0;
        acc[mt][3] *= c1;
      }
      // P^T as B fragments (keys 2t (+ 8), + 1 x head g), in two pieces
      const uint32_t h0 = pack_bf16(p0, p1), h1 = pack_bf16(p2, p3);
      const uint32_t bh0 = movmatrix_trans(h0), bh1 = movmatrix_trans(h1);
      const uint32_t bl0 = movmatrix_trans(low_piece(p0, p1, h0));
      const uint32_t bl1 = movmatrix_trans(low_piece(p2, p3, h1));
      // O^T += V^T P^T: V rows kb + (lane & 7) (+ 8), dims 16 mt (+ 8)
      const bf16_t* va =
          vs + (size_t)(kb + (lane & 7) + ((lane >> 4) << 3)) * ROW +
          ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int mt = 0; mt < KT; ++mt) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, va + 16 * mt);
        mma_bf16(acc[mt], vf, bl0, bl1);
        mma_bf16(acc[mt], vf, bh0, bh1);
      }
    }
  }
  cp_async_wait_all();

  // the warp's state into shared memory, for `finish`: l summed over the
  // eight groups; group 0 holds m and l of heads 2t, 2t + 1
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l[0] += __shfl_xor_sync(FULL, l[0], off);
    l[1] += __shfl_xor_sync(FULL, l[1], off);
  }
  __syncthreads();                      // every ring is done: reuse it
  float* ml = reinterpret_cast<float*>(smem);
  float* aw = state_acc<MAX_HEADS>(smem, a.warps);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      ml[w * MAX_HEADS + 2 * t + j] = m[j];
      ml[(a.warps + w) * MAX_HEADS + 2 * t + j] = l[j];
    }
  }
#pragma unroll
  for (int mt = 0; mt < KT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      aw[(w * MAX_HEADS + 2 * t + (j & 1)) * HDP + 16 * mt + g + 8 * (j >> 1)] =
          acc[mt][j];
  __syncthreads();
  finish<MAX_HEADS, HDP>(a, smem);
}

// -- launch -----------------------------------------------------------------

template <typename Kernel, typename T>
cudaError_t launch(Kernel kernel, const Args<T>& a, int blocks, int smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, 32 * a.warps, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DPL>
cudaError_t fma_by_heads(int heads, const Args<float>& a, int blocks,
                         int smem, cudaStream_t s) {
  switch (heads) {
    case 1: return launch(decode_fma_kernel<DPL, 1>, a, blocks, smem, s);
    case 2: return launch(decode_fma_kernel<DPL, 2>, a, blocks, smem, s);
    case 4: return launch(decode_fma_kernel<DPL, 4>, a, blocks, smem, s);
    default: return launch(decode_fma_kernel<DPL, 8>, a, blocks, smem, s);
  }
}

cudaError_t launch_fma(int dpl, int heads, const Args<float>& a, int blocks,
                       int smem, cudaStream_t s) {
  switch (dpl) {
    case 1: return fma_by_heads<1>(heads, a, blocks, smem, s);
    case 2: return fma_by_heads<2>(heads, a, blocks, smem, s);
    case 3: return fma_by_heads<3>(heads, a, blocks, smem, s);
    case 4: return fma_by_heads<4>(heads, a, blocks, smem, s);
    case 5: return fma_by_heads<5>(heads, a, blocks, smem, s);
    case 6: return fma_by_heads<6>(heads, a, blocks, smem, s);
    case 7: return fma_by_heads<7>(heads, a, blocks, smem, s);
    default: return fma_by_heads<8>(heads, a, blocks, smem, s);
  }
}

template <int HDP>
cudaError_t launch_mma_at(const Args<bf16_t>& a, int blocks, int smem,
                          cudaStream_t s) {
  return launch(decode_mma_kernel<HDP>, a, blocks, smem, s);
}

// one template per hdp = 16 (I + 1), indexed by hdp / 16 - 1
template <int... I>
cudaError_t launch_mma(int hdp, const Args<bf16_t>& a, int blocks, int smem,
                       cudaStream_t s, std::integer_sequence<int, I...>) {
  using Fn = cudaError_t (*)(const Args<bf16_t>&, int, int, cudaStream_t);
  constexpr Fn table[] = {launch_mma_at<16 * (I + 1)>...};
  return table[hdp / 16 - 1](a, blocks, smem, s);
}

// The plan `decode_plan` (kernels/decode_attention.py) may give: hd a
// multiple of 8 in [8, 256]; float32 with heads 1, 2, 4 or 8 and a tile of
// whole score blocks, bfloat16 with heads 8 and a tile of whole 16-key
// blocks; 4 or 8 warps; splits = ceil(T / split) (1 when T = 0) of at
// most MAX_SPLITS; the shared memory the layout takes; the grid, and the
// keys a warp steps through in int, within an int: its first key s split
// + w tile, the key it scores t0 (past a split's end by under a round of
// warps tiles) and the key it loads ld_t0 (STAGES - 1 rounds ahead of t0),
// so T - 1 + STAGES warps tile at most; and the workspace and counters
// where the plan needs them.
bool plan_ok(int B, int H, int KV, int T, int hd, bool bf16, int heads,
             int tile, int split, int splits, int warps, int smem,
             const float* ws, const int* counters, int combine) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || T < 0 || hd < 8 || hd > 256 ||
      (warps != 4 && warps != 8) ||
      hd % 8 || (heads != 1 && heads != 2 && heads != 4 && heads != 8) ||
      (bf16 && heads != MAX_HEADS) || split < 1 ||
      splits < 1 || splits > MAX_SPLITS)
    return false;
  const int hdp = bf16 ? (hd + 15) / 16 * 16 : (hd + 31) / 32 * 32;
  const int sk =
      bf16 ? 16 : key_groups(hdp / 32) * group_keys(hdp / 32, heads);
  if (tile < sk || tile % sk) return false;
  if (splits != (T > 0 ? (int)(((long long)T + split - 1) / split) : 1))
    return false;
  if ((size_t)smem != smem_bytes(hdp, bf16, heads, tile, warps) ||
      smem > MAX_SMEM)
    return false;
  const long long groups = (H / KV + heads - 1) / heads;
  if ((long long)B * KV * groups * splits > 0x7fffffffLL) return false;
  if ((long long)T - 1 + (long long)STAGES * warps * tile > 0x7fffffffLL)
    return false;
  return splits == 1 || (ws != nullptr && (!combine || counters != nullptr));
}

}  // namespace

// All pointers are device pointers to contiguous arrays on card `device`,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1), each starting on 16 bytes:
// q and o (B, H, hd), k and v (B, KV, T, hd); length (B,) int32; with
// splits > 1, ws a float32 workspace of B H splits (hd + 2) floats and,
// when `combine`, counters B KV ceil(H / KV / heads) int32 zeros, which the
// launch leaves zero (launches on one stream may share them).  The plan
// (heads, tile, split, splits, warps, smem) is `decode_plan`'s or
// `make_plan`'s; `plan_ok` refuses any other.  With combine == 0 and
// splits > 1 the partials are written and not combined.  One launch on
// `stream`; nothing synchronises.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* length, void* o, float* ws,
                                int* counters, int B, int H, int KV, int T,
                                int hd, int bf16, int heads, int tile,
                                int split, int splits, int warps, int smem,
                                int combine, int device, void* stream) {
  if (!plan_ok(B, H, KV, T, hd, bf16, heads, tile, split, splits, warps,
               smem, ws, counters, combine))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV, groups = (G + heads - 1) / heads;
  const int blocks = B * KV * groups * splits;
  float* ws_acc = ws;
  float2* ws_ml = ws == nullptr ? nullptr
                                : reinterpret_cast<float2*>(
                                      ws + (size_t)B * H * splits * hd);
  const float scale = LOG2E / sqrtf((float)hd);
  if (bf16) {
    const Args<bf16_t> a{static_cast<const bf16_t*>(q),
                         static_cast<const bf16_t*>(k),
                         static_cast<const bf16_t*>(v), length,
                         static_cast<bf16_t*>(o), ws_acc, ws_ml, counters, H,
                         KV, T, hd, G, groups, tile, split, splits, combine,
                         warps, scale};
    return (int)launch_mma((hd + 15) / 16 * 16, a, blocks, smem, s,
                           std::make_integer_sequence<int, 16>{});
  }
  const Args<float> a{static_cast<const float*>(q),
                      static_cast<const float*>(k),
                      static_cast<const float*>(v), length,
                      static_cast<float*>(o), ws_acc, ws_ml, counters, H, KV,
                      T, hd, G, groups, tile, split, splits, combine, warps,
                      scale};
  return (int)launch_fma((hd + 31) / 32, heads, a, blocks, smem, s);
}

// The launcher's guard alone (plan_ok), on the launcher's own arguments
// but the device and the stream: 1 where decode_attention would launch, 0
// where it would return cudaErrorInvalidValue.  Launches nothing and
// touches no device.
extern "C" int decode_attention_plan_ok(const void* q, const void* k,
                                        const void* v, const int* length,
                                        void* o, float* ws, int* counters,
                                        int B, int H, int KV, int T, int hd,
                                        int bf16, int heads, int tile,
                                        int split, int splits, int warps,
                                        int smem, int combine) {
  return plan_ok(B, H, KV, T, hd, bf16, heads, tile, split, splits, warps,
                 smem, ws, counters, combine);
}
