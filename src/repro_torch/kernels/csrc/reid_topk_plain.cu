// Unmasked re-id top-k for Hopper (sm_90a): the similarity GEMM fused with
// a running top-k, so the (Q, G) score matrix never reaches device memory.
//
// Replaces the TPU kernel `_reid_kernel` launched by `reid_topk` in
// src/repro/kernels/reid_topk.py: the k best rows of q . g for every
// query, with only the padding masked.  Slots past G come back as
// (-1e30, -1), and ties go to the lower gallery index, as the reference's
// merge and lax.top_k give.
//
// What bounds it on an H100.  At the benchmark's shape (Q = 256,
// G = 8,192, D = 64) the product is 0.27 GFLOP, 4 us at the 67 TFLOP/s
// fp32 peak, against 0.7 us to read 2.2 MB; at D = 2,048 it is 8.6 GFLOP,
// 0.13 ms against 20 us for 67 MB: bound by operations at both.
//
// Design: the gallery-split kernel of reid_split.cuh with every in-range
// pair eligible.  The grid is (q-blocks of 64 rows) x S gallery slices
// (512 blocks at the benchmark's shape), an 8 x 8 register micro-tile per
// thread over cp.async double-buffered operands, the top-K folded through
// shared memory, and a merge launch when S > 1.  K is a template (1, 2, 4,
// 8, 16): k rounds up to it, which changes nothing, since the top-k is a
// prefix of the top-K under a total order.

#include "reid_split.cuh"

namespace {

using namespace reid;
using namespace reid::split;

struct Everyone {
  static constexpr bool SKIPS = false;
  __device__ __forceinline__ void setup(Smem&, int, int, int) const {}
  __device__ __forceinline__ void tile(Smem&, int, int, int) const {}
  __device__ __forceinline__ bool ok(const Smem&, int, int, int) const {
    return true;
  }
};

template <int K>
__global__ void __launch_bounds__(NT)
reid_topk_unmasked_kernel(const float* __restrict__ q,
                          const float* __restrict__ g,
                          float* __restrict__ out_v, int* __restrict__ out_i,
                          float* __restrict__ ws_v, int* __restrict__ ws_i,
                          int Q, int G, int D, int k, int S, bool vec) {
  __shared__ __align__(16) Smem sm;
  slice_topk<K>(sm, Everyone{}, q, g, Q, G, D, k, S, vec, out_v, out_i, ws_v,
                ws_i);
}

template <int K>
cudaError_t launch(const float* q, const float* g, float* out_v, int* out_i,
                   float* ws_v, int* ws_i, int Q, int G, int D, int k, int S,
                   cudaStream_t stream) {
  const int nq = (Q + BQ - 1) / BQ;
  reid_topk_unmasked_kernel<K><<<nq * S, NT, 0, stream>>>(
      q, g, out_v, out_i, ws_v, ws_i, Q, G, D, k, S, vec_ok(q, g, D));
  return merge<K>(Q, S, k, ws_v, ws_i, out_v, out_i, stream);
}

// The launcher's guard: the sizes it takes and a plan of S slices
// (split::plan_ok).
bool accepts(int Q, int G, int D, int k, int S, const void* ws_v,
             const void* ws_i) {
  return Q >= 1 && G >= 1 && D >= 1 && k >= 1 && k <= MAX_K &&
         plan_ok(Q, G, S, ws_v, ws_i);
}

}  // namespace

// All pointers are device pointers to contiguous arrays on card `device`:
// q (Q, D) float32, g (G, D) float32, out_v (Q, k) float32, out_i (Q, k)
// int32.  S is the number of gallery slices (1 <= S <= ceil(G / 64));
// with S > 1, ws_v (float32) and ws_i (int32) are a (Q, S, K) workspace,
// K = k rounded up to a power of two, else they may be null.  The launches
// go on `stream` and do not synchronise.  Returns the CUDA error code of
// the launches (0 on success).
extern "C" int reid_topk_unmasked(const float* q, const float* g,
                                  float* out_v, int* out_i, float* ws_v,
                                  int* ws_i, int Q, int G, int D, int k,
                                  int S, int device, void* stream) {
  if (!accepts(Q, G, D, k, S, ws_v, ws_i))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return (int)launch<1>(q, g, out_v, out_i, ws_v, ws_i, Q, G, D, k, S, s);
  if (k <= 2)
    return (int)launch<2>(q, g, out_v, out_i, ws_v, ws_i, Q, G, D, k, S, s);
  if (k <= 4)
    return (int)launch<4>(q, g, out_v, out_i, ws_v, ws_i, Q, G, D, k, S, s);
  if (k <= 8)
    return (int)launch<8>(q, g, out_v, out_i, ws_v, ws_i, Q, G, D, k, S, s);
  return (int)launch<16>(q, g, out_v, out_i, ws_v, ws_i, Q, G, D, k, S, s);
}

// The launcher's guard alone, on the launcher's own arguments: 1 where
// reid_topk_unmasked would launch, 0 where it would return
// cudaErrorInvalidValue.  Launches nothing and touches no device.
extern "C" int reid_topk_unmasked_plan_ok(const float* q, const float* g,
                                          float* out_v, int* out_i,
                                          float* ws_v, int* ws_i, int Q,
                                          int G, int D, int k, int S) {
  return accepts(Q, G, D, k, S, ws_v, ws_i);
}
