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
// Design (the shared pieces are in topk.cuh; the product, the register
// top-K and the half-warp merge are the camera kernel's):
//  - Admission width.  CT is 512 on duke at T = 8 but 8,320 at C = 130,
//    T = 8, too wide for byte rows in shared memory.  Each block packs its
//    32 admit rows as bits at its start (32 x ceil(CT/32) uint32 words,
//    33 KB at CT = 8,320, dynamic shared memory): one warp per word, a
//    ballot over the 32 bytes its lanes read side by side, eight words'
//    loads in flight at once.
//  - Liveness.  The Pallas kernel skips (q-block, g-block) pairs that admit
//    no cell, from a table built outside its grid.  Here each staged
//    (32-row, 64-row) tile first tests its threads' 8 pairs for
//    eligibility (cell in range, admit bit, tag), and when
//    __syncthreads_or says no pair of the tile is eligible the block skips
//    the tile's operand staging and FMAs.  A skipped tile would push
//    nothing, so the skip is bit-identical.
//  - With every cell of every admitted camera admitted, eligibility equals
//    the camera kernel's and so does every score (same FMA order): the
//    result is bit-identical to reid_topk_segment_masked.
//
// What bounds it on an H100.  On duke (CT = 512, D = 64, G up to a few
// hundred rows) the work is tiny and launch latency bounds it.  At the
// stress shape (Q = 256, G = 8192, D = 2048, CT = 8,320) it is bound by
// the fp32 operations on eligible pairs; like the camera kernel it runs
// one block per 32 query rows and leaves most SMs idle there.  Splitting
// the gallery axis, TMA staging and a tensor-core product are later work.

#include "topk.cuh"

namespace {

using namespace reid;

constexpr int PACK = 8;           // admit words a warp packs per step

template <int K>
__global__ void __launch_bounds__(THREADS)
reid_topk_tiles_kernel(const float* __restrict__ q,
                       const int* __restrict__ q_tag,
                       const uint8_t* __restrict__ admit_ct,
                       const float* __restrict__ g,
                       const int* __restrict__ gal_ct,
                       const int* __restrict__ gal_tag,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int Q, int G, int D, int CT, int W, int k) {
  __shared__ __align__(16) float q_s[DC][QS];
  __shared__ __align__(16) float g_s[DC][GS];
  __shared__ int qtag_s[QB];
  __shared__ int gct_s[GB];
  __shared__ int gtag_s[GB];
  extern __shared__ uint32_t admit_bits[];  // (QB, W): bit c of row r

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tq = warp * 2 + (lane >> 4);        // query pair, 0..15
  const int tg = lane & 15;                     // gallery quad, 0..15
  const int q0 = blockIdx.x * QB;

  // pack the block's admit rows, PACK words per warp at a time: their
  // PACK byte loads are issued before the first ballot, so they are in
  // flight together.  The loop bound depends on the warp only, so every
  // lane of a warp takes part in each ballot.
  for (int e0 = warp * PACK; e0 < QB * W; e0 += (THREADS / 32) * PACK) {
    bool bit[PACK];
#pragma unroll
    for (int u = 0; u < PACK; ++u) {
      const int e = e0 + u;
      const int r = e / W, col = (e - r * W) * 32 + lane;
      bit[u] = e < QB * W && q0 + r < Q && col < CT &&
               admit_ct[(size_t)(q0 + r) * CT + col] != 0;
    }
#pragma unroll
    for (int u = 0; u < PACK; ++u) {
      const unsigned word = __ballot_sync(0xffffffffu, bit[u]);
      if (lane == 0 && e0 + u < QB * W) admit_bits[e0 + u] = word;
    }
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
      gct_s[r] = in ? gal_ct[g0 + r] : -1;
      gtag_s[r] = in ? gal_tag[g0 + r] : 0;
    }
    __syncthreads();  // the tile's tags (and the packed bits) are in place
    unsigned elig = 0;  // bit 4a + j: pair (2 tq + a, 4 tg + j) is eligible
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int r = tq * 2 + a;
      if (q0 + r >= Q) continue;
      const int tag = qtag_s[r];
      const uint32_t* bits = admit_bits + (size_t)r * W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tg * 4 + j;
        const int ct = gct_s[c];
        if (ct >= 0 && ct < CT && ((bits[ct >> 5] >> (ct & 31)) & 1u) &&
            gtag_s[c] == tag)
          elig |= 1u << (a * 4 + j);
      }
    }
    // the same answer for every thread: the skip is uniform over the block
    if (!__syncthreads_or(elig != 0)) continue;
    float acc[2][4];
    score_tile(q, g, q_s, g_s, Q, G, D, q0, g0, tid, tq, tg, acc);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (elig & (1u << (a * 4 + j)))
          push<K>(tv[a], ti[a], acc[a][j], g0 + tg * 4 + j);
      }
    }
  }

  merge_and_store<K>(tv, ti, tq, tg, q0, Q, k, out_v, out_i);
}

template <int K>
cudaError_t launch(const float* q, const int* q_tag, const uint8_t* admit_ct,
                   const float* g, const int* gal_ct, const int* gal_tag,
                   float* out_v, int* out_i, int Q, int G, int D, int CT,
                   int k, cudaStream_t stream) {
  const int W = (CT + 31) / 32;
  const size_t dyn = sizeof(uint32_t) * QB * W;
  if (dyn > DEFAULT_SMEM - STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        reid_topk_tiles_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Q + QB - 1) / QB);
  reid_topk_tiles_kernel<K><<<grid, THREADS, dyn, stream>>>(
      q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v, out_i, Q, G, D, CT, W,
      k);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers to contiguous arrays: q (Q, D) float32,
// q_tag (Q,) int32, admit_ct (Q, CT) bool bytes, g (G, D) float32, gal_ct
// and gal_tag (G,) int32; out_v (Q, k) float32 and out_i (Q, k) int32, all
// on card `device`, whose stream `stream` is.  The launch first makes
// `device` current (this library's runtime keeps its own current device)
// and does not synchronise.  Returns the CUDA error code of the launch
// (0 on success); cudaErrorInvalidValue for sizes it does not take,
// among them a CT whose packed admit rows do not fit in shared memory.
extern "C" int reid_topk_tiles(const float* q, const int* q_tag,
                               const uint8_t* admit_ct, const float* g,
                               const int* gal_ct, const int* gal_tag,
                               float* out_v, int* out_i, int Q, int G, int D,
                               int CT, int k, int device, void* stream) {
  if (Q < 1 || G < 1 || D < 1 || CT < 1 || k < 1 || k > MAX_K ||
      sizeof(uint32_t) * QB * ((CT + 31) / 32) > MAX_SMEM - STATIC_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1)
    return (int)launch<1>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, Q, G, D, CT, k, s);
  if (k <= 2)
    return (int)launch<2>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, Q, G, D, CT, k, s);
  if (k <= 4)
    return (int)launch<4>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, Q, G, D, CT, k, s);
  if (k <= 8)
    return (int)launch<8>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                          out_i, Q, G, D, CT, k, s);
  return (int)launch<16>(q, q_tag, admit_ct, g, gal_ct, gal_tag, out_v,
                         out_i, Q, G, D, CT, k, s);
}
