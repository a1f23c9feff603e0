// Unmasked re-id top-k for Hopper (sm_90a): the similarity GEMM fused with
// a running top-k, so the (Q, G) score matrix never reaches device memory.
//
// Replaces the TPU kernel `_reid_kernel` launched by `reid_topk` in
// src/repro/kernels/reid_topk.py: the k best rows of q . g for every
// query, with only the padding masked.  Slots past G come back as
// (-1e30, -1), and ties go to the lower gallery index, as the reference's
// merge and lax.top_k give.
//
// Design: the camera-masked kernel (reid_topk.cu) with admission and tags
// taken out; the shared pieces are in topk.cuh.  A block owns QB = 32
// query rows and walks the whole gallery in tiles of GB = 64 rows: an fp32
// FMA product per tile (score_tile), every in-range score pushed into a
// per-thread register top-K, and at the end a half-warp merge
// (merge_and_store).  K is a template (1, 2, 4, 8, 16); k rounds up to it.
//
// What bounds it on an H100.  At the benchmark's shape (Q = 256,
// G = 8192, D = 64) the product is 0.27 GFLOP, 4 us at the 67 TFLOP/s fp32
// peak, against about 0.7 us to read 2.2 MB: it is bound by operations.
// One block per 32 query rows is only 8 blocks on 132 SMs at Q = 256, so
// this first version leaves most of the card idle; splitting the gallery
// across blocks with a merge pass is later work.

#include "topk.cuh"

namespace {

using namespace reid;

template <int K>
__global__ void __launch_bounds__(THREADS)
reid_topk_unmasked_kernel(const float* __restrict__ q,
                          const float* __restrict__ g,
                          float* __restrict__ out_v, int* __restrict__ out_i,
                          int Q, int G, int D, int k) {
  __shared__ __align__(16) float q_s[DC][QS];
  __shared__ __align__(16) float g_s[DC][GS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tq = (tid >> 5) * 2 + (lane >> 4);  // query pair, 0..15
  const int tg = lane & 15;                     // gallery quad, 0..15
  const int q0 = blockIdx.x * QB;

  float tv[2][K];
  int ti[2][K];
  init_topk<K>(tv, ti);

  for (int g0 = 0; g0 < G; g0 += GB) {
    float acc[2][4];
    score_tile(q, g, q_s, g_s, Q, G, D, q0, g0, tid, tq, tg, acc);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (q0 + tq * 2 + a >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = g0 + tg * 4 + j;
        if (c < G) push<K>(tv[a], ti[a], acc[a][j], c);
      }
    }
  }

  merge_and_store<K>(tv, ti, tq, tg, q0, Q, k, out_v, out_i);
}

template <int K>
cudaError_t launch(const float* q, const float* g, float* out_v, int* out_i,
                   int Q, int G, int D, int k, cudaStream_t stream) {
  const dim3 grid((Q + QB - 1) / QB);
  reid_topk_unmasked_kernel<K><<<grid, THREADS, 0, stream>>>(
      q, g, out_v, out_i, Q, G, D, k);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers to contiguous arrays on card `device`:
// q (Q, D) float32, g (G, D) float32, out_v (Q, k) float32, out_i (Q, k)
// int32.  The launch goes on `stream` and does not synchronise.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int reid_topk_unmasked(const float* q, const float* g,
                                  float* out_v, int* out_i, int Q, int G,
                                  int D, int k, int device, void* stream) {
  if (Q < 1 || G < 1 || D < 1 || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return (int)launch<1>(q, g, out_v, out_i, Q, G, D, k, s);
  if (k <= 2) return (int)launch<2>(q, g, out_v, out_i, Q, G, D, k, s);
  if (k <= 4) return (int)launch<4>(q, g, out_v, out_i, Q, G, D, k, s);
  if (k <= 8) return (int)launch<8>(q, g, out_v, out_i, Q, G, D, k, s);
  return (int)launch<16>(q, g, out_v, out_i, Q, G, D, k, s);
}
