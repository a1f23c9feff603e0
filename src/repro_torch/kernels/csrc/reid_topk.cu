// Segment-masked re-id top-k for Hopper (sm_90a): similarity GEMM fused
// with a masked running top-k, so the (Q, G) score matrix never reaches
// device memory.
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
// Design (the shared pieces are in topk.cuh).  A block owns QB = 32 query
// rows, their admit rows (QB x C bytes, dynamic shared memory) and tags.
// It walks the gallery in tiles of GB = 64 rows; after each tile's fp32
// FMA product (score_tile) each thread pushes its eligible scores into a
// register top-K, and at the end the half-warps merge (merge_and_store).
// K is a template (1, 2, 4, 8, 16): k is rounded up to the next one, which
// changes nothing, since the top-k is a prefix of the top-K under a total
// order.
//
// What bounds it on an H100.  At the serving path's shapes (Q <= 128
// padded, G a few hundred rows, D = 64) the work is a few MFLOP and about
// 0.1 MB, so launch latency bounds it.  At the stress shape (Q = 256,
// G = 8192, D = 2048) the GEMM is up to 8.6 GFLOP, about 0.13 ms at the
// 67 TFLOP/s fp32 CUDA-core peak against about 20 us to read 67 MB: it is
// bound by fp32 operations there.  This first version runs one block per
// 32 query rows (8 blocks at Q = 256), so it leaves most SMs idle at that
// shape; splitting the gallery axis across blocks, TMA staging and a
// tensor-core product are later work.

#include "topk.cuh"

namespace {

using namespace reid;

constexpr int MAX_CAMS = 4096;    // QB * MAX_CAMS bytes of dynamic shared memory

template <int K>
__global__ void __launch_bounds__(THREADS)
reid_topk_segment_masked_kernel(const float* __restrict__ q,
                                const int* __restrict__ q_tag,
                                const uint8_t* __restrict__ admit,
                                const float* __restrict__ g,
                                const int* __restrict__ gal_cam,
                                const int* __restrict__ gal_tag,
                                float* __restrict__ out_v,
                                int* __restrict__ out_i,
                                int Q, int G, int D, int C, int k) {
  __shared__ __align__(16) float q_s[DC][QS];
  __shared__ __align__(16) float g_s[DC][GS];
  __shared__ int qtag_s[QB];
  __shared__ int gcam_s[GB];
  __shared__ int gtag_s[GB];
  extern __shared__ uint8_t admit_s[];  // (QB, C)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tq = (tid >> 5) * 2 + (lane >> 4);  // query pair, 0..15
  const int tg = lane & 15;                     // gallery quad, 0..15
  const int q0 = blockIdx.x * QB;

  for (int e = tid; e < QB * C; e += THREADS) {
    const int r = e / C;
    admit_s[e] = (q0 + r < Q) ? admit[(size_t)q0 * C + e] : 0;
  }
  for (int r = tid; r < QB; r += THREADS)
    qtag_s[r] = (q0 + r < Q) ? q_tag[q0 + r] : -1;

  float tv[2][K];
  int ti[2][K];
  init_topk<K>(tv, ti);

  for (int g0 = 0; g0 < G; g0 += GB) {
    __syncthreads();  // the previous tile's tags and operands are consumed
    for (int r = tid; r < GB; r += THREADS) {
      const bool in = g0 + r < G;
      gcam_s[r] = in ? gal_cam[g0 + r] : -1;
      gtag_s[r] = in ? gal_tag[g0 + r] : 0;
    }
    float acc[2][4];
    score_tile(q, g, q_s, g_s, Q, G, D, q0, g0, tid, tq, tg, acc);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = tq * 2 + a;
      if (q0 + r >= Q) continue;
      const int tag = qtag_s[r];
      const uint8_t* adm = admit_s + r * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tg * 4 + j;
        const int cam = gcam_s[c];
        if (cam >= 0 && cam < C && adm[cam] && gtag_s[c] == tag)
          push<K>(tv[a], ti[a], acc[a][j], g0 + c);
      }
    }
  }

  merge_and_store<K>(tv, ti, tq, tg, q0, Q, k, out_v, out_i);
}

template <int K>
cudaError_t launch(const float* q, const int* q_tag, const uint8_t* admit,
                   const float* g, const int* gal_cam, const int* gal_tag,
                   float* out_v, int* out_i, int Q, int G, int D, int C,
                   int k, cudaStream_t stream) {
  const size_t dyn = (size_t)QB * C;
  if (dyn > DEFAULT_SMEM - STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        reid_topk_segment_masked_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + QB - 1) / QB);
  reid_topk_segment_masked_kernel<K><<<grid, THREADS, dyn, stream>>>(
      q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i, Q, G, D, C, k);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q (Q, D) float32,
// q_tag (Q,) int32, admit (Q, C) bool bytes, g (G, D) float32, gal_cam and
// gal_tag (G,) int32; out_v (Q, k) float32 and out_i (Q, k) int32, all on
// card `device`, whose stream `stream` is.  This library's runtime keeps its
// own current device, so the launch first makes `device` current.  The
// launch does not synchronise.  Returns the CUDA error code of the launch
// (0 on success).
extern "C" int reid_topk_segment_masked(const float* q, const int* q_tag,
                                        const uint8_t* admit, const float* g,
                                        const int* gal_cam, const int* gal_tag,
                                        float* out_v, int* out_i, int Q,
                                        int G, int D, int C, int k,
                                        int device, void* stream) {
  if (Q < 1 || G < 1 || D < 1 || C < 1 || C > MAX_CAMS || k < 1 ||
      k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return (int)launch<1>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          Q, G, D, C, k, s);
  if (k <= 2)
    return (int)launch<2>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          Q, G, D, C, k, s);
  if (k <= 4)
    return (int)launch<4>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          Q, G, D, C, k, s);
  if (k <= 8)
    return (int)launch<8>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                          Q, G, D, C, k, s);
  return (int)launch<16>(q, q_tag, admit, g, gal_cam, gal_tag, out_v, out_i,
                         Q, G, D, C, k, s);
}
