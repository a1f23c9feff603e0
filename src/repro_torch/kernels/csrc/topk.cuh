// Pieces shared by the re-id top-k kernels for Hopper (sm_90a):
// reid_topk.cu (camera-masked) and reid_topk_tiles.cu (camera x tile
// masked).  Both fuse the similarity GEMM with a masked running top-k, so
// the (Q, G) score matrix never reaches device memory.
//
// A block owns QB = 32 query rows and walks the gallery in tiles of
// GB = 64 rows; for each tile the feature axis is staged in chunks of
// DC = 32, both operands transposed into shared memory.  256 threads each
// own a 2 x 4 register micro-tile (2 query rows x 4 gallery rows): per
// depth step one float2 and one float4 shared load feed 8 fp32 FMAs.
// Scores are plain fp32 FMA in depth order (no TF32, no tensor cores),
// which keeps them within 1e-5 of an fp32 reference.  Each thread keeps a
// register top-K per query row in the total order (score descending, index
// ascending); at the end the 16 threads of a half-warp that share a query
// row merge their lists with xor shuffles.
#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace reid {

constexpr int QB = 32;            // query rows per block
constexpr int GB = 64;            // gallery rows per staged tile
constexpr int DC = 32;            // feature depth per staged chunk
constexpr int THREADS = 256;      // 16 query pairs x 16 gallery quads
constexpr int QS = QB + 2;        // padded transposed query row (float2-aligned)
constexpr int GS = GB + 4;        // padded transposed gallery row (float4-aligned)
constexpr int MAX_K = 16;
constexpr float NEG_INF = -1e30f;
// static shared memory of a kernel: the two staged operands plus the query
// tags and two int tags per gallery row of a tile
constexpr size_t STATIC_SMEM =
    sizeof(float) * DC * (QS + GS) + sizeof(int) * (QB + 2 * GB);
constexpr size_t DEFAULT_SMEM = 48 * 1024;   // without the opt-in attribute
constexpr size_t MAX_SMEM = 232448;          // per block on an H100, opted in

// (v, i) ranks before (w, j): higher score first, lower index on ties.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (v, i) into a list sorted by `better`, dropping the last entry.
template <int K>
__device__ __forceinline__ void push(float (&tv)[K], int (&ti)[K], float v,
                                     int i) {
  if (!better(v, i, tv[K - 1], ti[K - 1])) return;
  bool placed = false;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (!placed) {
      if (better(v, i, tv[s - 1], ti[s - 1])) {
        tv[s] = tv[s - 1];
        ti[s] = ti[s - 1];
      } else {
        tv[s] = v;
        ti[s] = i;
        placed = true;
      }
    }
  }
  if (!placed) {
    tv[0] = v;
    ti[0] = i;
  }
}

template <int K>
__device__ __forceinline__ void pop_front(float (&tv)[K], int (&ti)[K]) {
#pragma unroll
  for (int s = 0; s < K - 1; ++s) {
    tv[s] = tv[s + 1];
    ti[s] = ti[s + 1];
  }
  tv[K - 1] = NEG_INF;
  ti[K - 1] = INT_MAX;
}

template <int K>
__device__ __forceinline__ void init_topk(float (&tv)[2][K], int (&ti)[2][K]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      tv[a][s] = NEG_INF;
      ti[a][s] = INT_MAX;
    }
  }
}

// acc[a][j] = q[q0 + 2 tq + a] . g[g0 + 4 tg + j] over the whole depth D,
// in depth order; rows past Q or G and depth past D read as zero.  Every
// thread of the block must call it (it synchronises).
__device__ __forceinline__ void score_tile(const float* __restrict__ q,
                                           const float* __restrict__ g,
                                           float (&q_s)[DC][QS],
                                           float (&g_s)[DC][GS], int Q, int G,
                                           int D, int q0, int g0, int tid,
                                           int tq, int tg,
                                           float (&acc)[2][4]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += DC) {
    for (int e = tid; e < QB * DC; e += THREADS) {
      const int r = e / DC, dd = e - r * DC;
      const int row = q0 + r, col = d0 + dd;
      q_s[dd][r] = (row < Q && col < D) ? q[(size_t)row * D + col] : 0.f;
    }
    for (int e = tid; e < GB * DC; e += THREADS) {
      const int r = e / DC, dd = e - r * DC;
      const int row = g0 + r, col = d0 + dd;
      g_s[dd][r] = (row < G && col < D) ? g[(size_t)row * D + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < DC; ++dd) {
      const float2 a = *reinterpret_cast<const float2*>(&q_s[dd][tq * 2]);
      const float4 b = *reinterpret_cast<const float4*>(&g_s[dd][tg * 4]);
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[0][2] = fmaf(a.x, b.z, acc[0][2]);
      acc[0][3] = fmaf(a.x, b.w, acc[0][3]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
      acc[1][2] = fmaf(a.y, b.z, acc[1][2]);
      acc[1][3] = fmaf(a.y, b.w, acc[1][3]);
    }
    __syncthreads();
  }
}

// The 16 lanes of a half-warp share a query row: k rounds of "the best
// head wins", the winner pops it.  Sentinel heads tie across lanes; every
// lane holding one pops, which is harmless since all that is left is
// sentinels.  Slots with no eligible row come out as (NEG_INF, -1).
template <int K>
__device__ __forceinline__ void merge_and_store(float (&tv)[2][K],
                                                int (&ti)[2][K], int tq,
                                                int tg, int q0, int Q, int k,
                                                float* __restrict__ out_v,
                                                int* __restrict__ out_i) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qg = q0 + tq * 2 + a;
    for (int slot = 0; slot < k; ++slot) {
      float bv = tv[a][0];
      int bi = ti[a][0];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (tv[a][0] == bv && ti[a][0] == bi) pop_front<K>(tv[a], ti[a]);
      if (tg == 0 && qg < Q) {
        const bool real = bv > NEG_INF / 2;
        out_v[(size_t)qg * k + slot] = real ? bv : NEG_INF;
        out_i[(size_t)qg * k + slot] = real ? bi : -1;
      }
    }
  }
}

}  // namespace reid
