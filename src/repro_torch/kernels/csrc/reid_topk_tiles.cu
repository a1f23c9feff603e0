// Tile-masked re-id top-k for Hopper (sm_90a): the camera-masked kernel
// (reid_topk.cu) over the fused (camera x tile) cell axis, CT = C*T*T.
//
// Replaces the TPU kernel `_reid_tiles_kernel` launched by
// `reid_topk_tiles` in src/repro/kernels/reid_topk.py.  Query q may score
// gallery row g only when admit_ct[q, gal_ct[g]] holds (gal_ct outside
// [0, CT) — unlabeled or padded rows carry -1 — is never admitted, as the
// Pallas one-hot gives), gal_tag[g] == q_tag[q] and g < G.  The k best
// eligible rows come back in the total order (score descending, index
// ascending); slots with no eligible row are (-1e30, -1).
//
// What bounds it on an H100.  On duke (CT = 512, D = 64, G up to a few
// hundred rows) the work is tiny and launch latency bounds it.  At the
// stress shape (Q = 256, G = 8,192, D = 2,048, CT = 8,320) it is bound by
// the fp32 operations on the eligible pairs, 0.05 ms at the 67 TFLOP/s
// CUDA-core peak.
//
// Design: the gallery-split kernel of reid_split.cuh (q-blocks of 64 rows
// x S gallery slices, the camera kernel's plan, product and top-K, a merge
// launch when S > 1) with an admission that skips dead tiles.
//  - Admission per gallery tile.  The camera kernel packs its 64 admit rows
//    as bits once a block; here a row is CT bytes (8,320 at C = 130,
//    T = 8, any int here), and every slice would pack the same rows again.
//    Instead, once a tile's cells and tags land, thread c reads, for each
//    of the block's rows with an equal tag and a cell in [0, CT), the one
//    admit byte admit_ct[q0 + r, cell_c], all in flight together, and
//    keeps them as a 64-bit row mask of its column (1 KB of shared memory
//    for both column buffers).  A pair's admission is then one bit test,
//    and nothing the block stages grows with CT.
//  - Dead tiles.  A (64-row, 64-row) tile whose masks are all zero would
//    push nothing: __syncthreads_or skips it before its operands are
//    copied, as the Pallas kernel skips dead (q-block, g-block) pairs.
//  - With every cell of every admitted camera admitted, eligibility, plan
//    and FMA order equal the camera kernel's: the result is bit-identical
//    to reid_topk_segment_masked.
// K is a template (1, 2, 4, 8, 16): k rounds up to it, which changes
// nothing, since the top-k is a prefix of the top-K under a total order.

#include "reid_split.cuh"

namespace {

using namespace reid;
using namespace reid::split;

using Mask = unsigned long long;  // bit r: the pair (row r, a column)

static_assert(BQ <= 64, "a column's rows fit in one mask");
static_assert(NT == BG, "a thread per gallery column");
// The split kernels' shared memory and the column masks of both column
// buffers (bit r of elig[tb][c]: row r may score column c); the camera and
// unmasked kernels do without them.
struct TileSmem : Smem {
  Mask elig[2][BG];
};

static_assert(sizeof(TileSmem) <= DEFAULT_SMEM, "static shared memory");

struct Tiles {
  static constexpr bool SKIPS = true;
  const uint8_t* admit_ct;
  const int* q_tag;
  const int* gal_ct;
  const int* gal_tag;
  int CT, G;

  __device__ __forceinline__ void setup(Smem& sm, int q0, int nrows,
                                        int tid) const {
    for (int r = tid; r < nrows; r += NT) sm.qtag[r] = q_tag[q0 + r];
  }

  // cells in sm.gcam
  __device__ __forceinline__ void tile(Smem& sm, int tb, int g0,
                                       int tid) const {
    stage_columns(sm, tb, gal_ct, gal_tag, g0, G, tid);
  }

  // Column tid's mask of the tile at g0: one byte load per row whose tag
  // equals the column's, for a cell in range; rows past Q are never read.
  // The row stride passes through an empty asm, so the 64 row addresses
  // are computed here, per tile: hoisted out of the tile loop, they would
  // hold 128 registers across the product and the kernel would spill.
  __device__ __forceinline__ bool gather(Smem& sm, int tb, int q0, int g0,
                                         int nrows, int tid) const {
    const int cell = sm.gcam[tb][tid], tag = sm.gtag[tb][tid];
    const bool in = g0 + tid < G && cell >= 0 && cell < CT;
    size_t stride = (size_t)CT;
    asm volatile("" : "+l"(stride));
    const uint8_t* col = admit_ct + (size_t)q0 * stride + (in ? cell : 0);
    uint8_t a[BQ];
#pragma unroll
    for (int r = 0; r < BQ; ++r) {
      a[r] = in && r < nrows && sm.qtag[r] == tag ? __ldg(col) : 0;
      col += stride;
    }
    Mask m = 0;
#pragma unroll
    for (int r = 0; r < BQ; ++r) m |= static_cast<Mask>(a[r] != 0) << r;
    static_cast<TileSmem&>(sm).elig[tb][tid] = m;
    return m != 0;
  }

  __device__ __forceinline__ bool ok(const Smem& sm, int tb, int r,
                                     int c) const {
    return (static_cast<const TileSmem&>(sm).elig[tb][c] >> r) & 1u;
  }
};

template <int K>
__global__ void __launch_bounds__(NT)
reid_topk_tiles_kernel(const float* __restrict__ q,
                       const int* __restrict__ q_tag,
                       const uint8_t* __restrict__ admit_ct,
                       const float* __restrict__ g,
                       const int* __restrict__ gal_ct,
                       const int* __restrict__ gal_tag,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       float* __restrict__ ws_v, int* __restrict__ ws_i,
                       int Q, int G, int D, int CT, int k, int S, bool vec) {
  __shared__ __align__(16) TileSmem sm;
  slice_topk<K>(sm, Tiles{admit_ct, q_tag, gal_ct, gal_tag, CT, G}, q, g, Q,
                G, D, k, S, vec, out_v, out_i, ws_v, ws_i);
}

template <int K>
cudaError_t launch(const float* q, const int* q_tag, const uint8_t* admit_ct,
                   const float* g, const int* gal_ct, const int* gal_tag,
                   float* out_v, int* out_i, float* ws_v, int* ws_i, int Q,
                   int G, int D, int CT, int k, int S, cudaStream_t stream) {
  const int nq = (Q + BQ - 1) / BQ;
  reid_topk_tiles_kernel<K><<<nq * S, NT, 0, stream>>>(
      q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v, out_i, ws_v, ws_i, Q,
      G, D, CT, k, S, vec_ok(q, g, D));
  return merge<K>(Q, S, k, ws_v, ws_i, out_v, out_i, stream);
}

// The launcher's guard: the sizes it takes and a plan of S slices
// (split::plan_ok).
bool accepts(int Q, int G, int D, int CT, int k, int S, const void* ws_v,
             const void* ws_i) {
  return Q >= 1 && G >= 1 && D >= 1 && CT >= 1 && k >= 1 && k <= MAX_K &&
         plan_ok(Q, G, S, ws_v, ws_i);
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q (Q, D) float32,
// q_tag (Q,) int32, admit_ct (Q, CT) bool bytes, g (G, D) float32, gal_ct
// and gal_tag (G,) int32; out_v (Q, k) float32 and out_i (Q, k) int32, all
// on card `device`, whose stream `stream` is.  S is the number of gallery
// slices (1 <= S <= ceil(G / 64)); with S > 1, ws_v (float32) and ws_i
// (int32) are a (Q, S, K) workspace, K = k rounded up to a power of two,
// else they may be null.  This library's runtime keeps its own current
// device, so the launch first makes `device` current.  The launches do
// not synchronise.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int reid_topk_tiles(const float* q, const int* q_tag,
                               const uint8_t* admit_ct, const float* g,
                               const int* gal_ct, const int* gal_tag,
                               float* out_v, int* out_i, float* ws_v,
                               int* ws_i, int Q, int G, int D, int CT, int k,
                               int S, int device, void* stream) {
  if (!accepts(Q, G, D, CT, k, S, ws_v, ws_i))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return (int)launch<1>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, ws_v, ws_i, Q, G, D, CT, k, S, s);
  if (k <= 2)
    return (int)launch<2>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, ws_v, ws_i, Q, G, D, CT, k, S, s);
  if (k <= 4)
    return (int)launch<4>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, ws_v, ws_i, Q, G, D, CT, k, S, s);
  if (k <= 8)
    return (int)launch<8>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, ws_v, ws_i, Q, G, D, CT, k, S, s);
  return (int)launch<16>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                         out_i, ws_v, ws_i, Q, G, D, CT, k, S, s);
}

// The launcher's guard alone, on the launcher's own arguments: 1 where
// reid_topk_tiles would launch, 0 where it would return
// cudaErrorInvalidValue.  Launches nothing and touches no device.
extern "C" int reid_topk_tiles_plan_ok(const float* q, const int* q_tag,
                                       const uint8_t* admit_ct,
                                       const float* g, const int* gal_ct,
                                       const int* gal_tag, float* out_v,
                                       int* out_i, float* ws_v, int* ws_i,
                                       int Q, int G, int D, int CT, int k,
                                       int S) {
  return accepts(Q, G, D, CT, k, S, ws_v, ws_i);
}
