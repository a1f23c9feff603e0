// Segment-masked re-id top-k for Hopper (sm_90a): similarity GEMM fused
// with a masked top-k, so the (Q, G) score matrix never reaches device
// memory.
//
// Replaces the TPU kernel `_reid_masked_kernel` launched by
// `_segment_masked_call` in src/repro/kernels/reid_topk.py, which serves
// both `reid_topk_masked` (frame tags) and `reid_topk_segments`
// (round-scoped segment ids).  It computes the same function, not the
// Pallas grid: query q may score gallery row g only when
// admit[q, gal_cam[g]] holds (gal_cam outside [0, C) is "no camera"),
// gal_tag[g] == q_tag[q] and g < G; the k best eligible rows come back in
// the total order (score descending, index ascending) — the lower gallery
// index wins a tie, as the reference's merge and lax.top_k give.  Slots
// with no eligible row are (-1e30, -1).
//
// What bounds it on an H100.  At the serving path's shapes (Q <= 128, G a
// few hundred rows, D = 64) the work is a few MFLOP and about 0.1 MB, so
// launch latency bounds it: the host's plan keeps one block and no merge
// there (S = 1) while the gallery has fewer than four 64-row tiles, and
// splits larger rounds.  At the stress shape (Q = 256, G = 8,192,
// D = 2,048) the product is up to 8.6 GFLOP, about 0.13 ms at the
// 67 TFLOP/s fp32 CUDA-core peak against about 20 us to read 67 MB: bound
// by operations.
//
// Design: the gallery-split kernel of reid_split.cuh (q-blocks of 64 rows
// x S gallery slices, an 8 x 8 register micro-tile per thread over
// cp.async double-buffered operands, the top-K folded through shared
// memory, a merge launch when S > 1) with camera admission.  Each block
// packs its 64 admit rows as bits in dynamic shared memory (64 x
// ceil(C / 32) words, 32 KB at MAX_CAMS = 4,096: bytes would take 256 KB),
// one warp ballot per word, eight words' loads in flight at once; a pair's
// admission is then one shared-memory bit test.  K is a template (1, 2, 4,
// 8, 16): k rounds up to it, which changes nothing, since the top-k is a
// prefix of the top-K under a total order.

#include "reid_split.cuh"

namespace {

using namespace reid;
using namespace reid::split;

constexpr int MAX_CAMS = 4096;    // 64 x 128 packed words: 32 KB
constexpr int PACK = 16;          // admit words a warp packs per step

struct Cameras {
  static constexpr bool SKIPS = false;
  const uint8_t* admit;
  const int* q_tag;
  const int* gal_cam;
  const int* gal_tag;
  uint32_t* bits;                 // (BQ, W) in shared memory
  int W, C, G;

  // Pack the block's admit rows as bits, PACK words per warp at a time:
  // their loads are issued before the first ballot, so they are in flight
  // together.  The loop bound depends on the warp only, so every lane of a
  // warp takes part in each ballot.  Rows past Q are never read.
  __device__ __forceinline__ void setup(Smem& sm, int q0, int nrows,
                                        int tid) const {
    const int lane = tid & 31, warp = tid >> 5;
    for (int e0 = warp * PACK; e0 < nrows * W; e0 += (NT / 32) * PACK) {
      bool bit[PACK];
#pragma unroll
      for (int u = 0; u < PACK; ++u) {
        const int e = e0 + u;
        const int r = e / W, col = (e - r * W) * 32 + lane;
        bit[u] = e < nrows * W && col < C &&
                 admit[(size_t)(q0 + r) * C + col] != 0;
      }
#pragma unroll
      for (int u = 0; u < PACK; ++u) {
        const unsigned word = __ballot_sync(FULL, bit[u]);
        if (lane == 0 && e0 + u < nrows * W) bits[e0 + u] = word;
      }
    }
    for (int r = tid; r < nrows; r += NT) sm.qtag[r] = q_tag[q0 + r];
  }

  __device__ __forceinline__ void tile(Smem& sm, int tb, int g0,
                                       int tid) const {
    stage_columns(sm, tb, gal_cam, gal_tag, g0, G, tid);
  }

  __device__ __forceinline__ bool ok(const Smem& sm, int tb, int r,
                                     int c) const {
    const int cam = sm.gcam[tb][c];
    return cam >= 0 && cam < C &&
           ((bits[r * W + (cam >> 5)] >> (cam & 31)) & 1u) &&
           sm.gtag[tb][c] == sm.qtag[r];
  }
};

template <int K>
__global__ void __launch_bounds__(NT)
reid_topk_segment_masked_kernel(const float* __restrict__ q,
                                const int* __restrict__ q_tag,
                                const uint8_t* __restrict__ admit,
                                const float* __restrict__ g,
                                const int* __restrict__ gal_cam,
                                const int* __restrict__ gal_tag,
                                float* __restrict__ out_v,
                                int* __restrict__ out_i,
                                float* __restrict__ ws_v,
                                int* __restrict__ ws_i, int Q, int G, int D,
                                int C, int W, int k, int S, bool vec) {
  __shared__ __align__(16) Smem sm;
  extern __shared__ uint32_t admit_bits[];  // (BQ, W): bit c of row r
  slice_topk<K>(sm,
                Cameras{admit, q_tag, gal_cam, gal_tag, admit_bits, W, C, G},
                q, g, Q, G, D, k, S, vec, out_v, out_i, ws_v, ws_i);
}

template <int K>
cudaError_t launch(const float* q, const int* q_tag, const uint8_t* admit,
                   const float* g, const int* gal_cam, const int* gal_tag,
                   float* out_v, int* out_i, float* ws_v, int* ws_i, int Q,
                   int G, int D, int C, int k, int S, cudaStream_t stream) {
  const int W = (C + 31) / 32;
  const size_t dyn = sizeof(uint32_t) * BQ * W;
  if (dyn > DEFAULT_SMEM - sizeof(Smem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        reid_topk_segment_masked_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
  }
  const int nq = (Q + BQ - 1) / BQ;
  reid_topk_segment_masked_kernel<K><<<nq * S, NT, dyn, stream>>>(
      q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i, ws_v, ws_i, Q, G,
      D, C, W, k, S, vec_ok(q, g, D));
  return merge<K>(Q, S, k, ws_v, ws_i, out_v, out_i, stream);
}

// The launcher's guard: the sizes it takes and a plan of S slices
// (split::plan_ok).
bool accepts(int Q, int G, int D, int C, int k, int S, const void* ws_v,
             const void* ws_i) {
  return Q >= 1 && G >= 1 && D >= 1 && C >= 1 && C <= MAX_CAMS && k >= 1 &&
         k <= MAX_K && plan_ok(Q, G, S, ws_v, ws_i);
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q (Q, D) float32,
// q_tag (Q,) int32, admit (Q, C) bool bytes, g (G, D) float32, gal_cam and
// gal_tag (G,) int32; out_v (Q, k) float32 and out_i (Q, k) int32, all on
// card `device`, whose stream `stream` is.  S is the number of gallery
// slices (1 <= S <= ceil(G / 64)); with S > 1, ws_v (float32) and ws_i
// (int32) are a (Q, S, K) workspace, K = k rounded up to a power of two,
// else they may be null.  This library's runtime keeps its own current
// device, so the launch first makes `device` current.  The launches do
// not synchronise.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int reid_topk_segment_masked(const float* q, const int* q_tag,
                                        const uint8_t* admit, const float* g,
                                        const int* gal_cam, const int* gal_tag,
                                        float* out_v, int* out_i,
                                        float* ws_v, int* ws_i, int Q,
                                        int G, int D, int C, int k, int S,
                                        int device, void* stream) {
  if (!accepts(Q, G, D, C, k, S, ws_v, ws_i))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return (int)launch<1>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          ws_v, ws_i, Q, G, D, C, k, S, s);
  if (k <= 2)
    return (int)launch<2>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          ws_v, ws_i, Q, G, D, C, k, S, s);
  if (k <= 4)
    return (int)launch<4>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          ws_v, ws_i, Q, G, D, C, k, S, s);
  if (k <= 8)
    return (int)launch<8>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          ws_v, ws_i, Q, G, D, C, k, S, s);
  return (int)launch<16>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                         ws_v, ws_i, Q, G, D, C, k, S, s);
}

// The launcher's guard alone, on the launcher's own arguments: 1 where
// reid_topk_segment_masked would launch, 0 where it would return
// cudaErrorInvalidValue.  Launches nothing and touches no device.
extern "C" int reid_topk_segment_masked_plan_ok(
    const float* q, const int* q_tag, const uint8_t* admit, const float* g,
    const int* gal_cam, const int* gal_tag, float* out_v, int* out_i,
    float* ws_v, int* ws_i, int Q, int G, int D, int C, int k, int S) {
  return accepts(Q, G, D, C, k, S, ws_v, ws_i);
}
