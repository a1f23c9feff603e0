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
// Design.  The Pallas grid walks the cache sequentially per (b, kv head)
// with all G = H / KV q heads in one (G, hd) x (hd, block_k) product.
// One block per (b, kv head) would be 8 blocks at the benchmark's shape, so
// here the cache is cut into chunks of `chunk` keys and the first pass
// runs a block per (chunk, kv head, b), skipping chunks at or past
// length[b].  A block holds one warp per q head of its kv head and stages
// 32 keys of K and V (as float32) in shared memory per step, K rows padded
// to hd + 1 floats; lane j scores key j against its warp's head, the warp
// takes its max and sum by shuffles, and each lane accumulates hd / 32
// dims of p V.  Each (b, head, chunk) writes a float32 partial
// (m, l, acc[hd]) to the workspace; the second pass, a block per (head, b)
// and a thread per dim, rescales the partials of the valid chunks to
// their common max and divides.
//
// What bounds it on an H100.  Each cached key and value is read once: at
// the benchmark's shape (B = 4, KV = 2, T = 8192, hd = 64, full length)
// 33.6 MB, 10 us at 3.35 TB/s, against 0.067 GFLOP: bytes.  The
// workspace adds (2 + hd) floats per (b, head, chunk) each way.

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int TK = 32;  // keys per staged step: one per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD, typename T>
__global__ void decode_partial(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const int* __restrict__ length,
                               float* __restrict__ ws, int H, int KV, int Tn,
                               int chunk, int n_chunks, float scale) {
  constexpr int DPL = HD / 32;  // dims per lane
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  float* q_s = smem;                  // (G, HD)
  float* k_s = q_s + G * HD;          // (TK, HD + 1)
  float* v_s = k_s + TK * (HD + 1);   // (TK, HD)

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(length[b], Tn);
  const int c0 = c * chunk;
  if (c0 >= len) return;  // the whole block: the combine never reads it
  const int cend = min(c0 + chunk, len);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int g = tid / 32, lane = tid % 32;

  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * HD;
  for (int e = tid; e < G * HD; e += nthreads) q_s[e] = to_f32(qb[e]);
  const T* kb = k + ((size_t)b * KV + kvh) * (size_t)Tn * HD;
  const T* vb = v + ((size_t)b * KV + kvh) * (size_t)Tn * HD;
  const float* qg = q_s + g * HD;

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int t0 = c0; t0 < cend; t0 += TK) {
    __syncthreads();  // q staged, or the previous step consumed
    for (int e = tid; e < TK * HD; e += nthreads) {
      const int j = e / HD, d = e - j * HD;
      const bool in = t0 + j < cend;
      k_s[j * (HD + 1) + d] = in ? to_f32(kb[(size_t)(t0 + j) * HD + d]) : 0.f;
      v_s[j * HD + d] = in ? to_f32(vb[(size_t)(t0 + j) * HD + d]) : 0.f;
    }
    __syncthreads();

    const bool valid = t0 + lane < cend;
    const float* kr = k_s + lane * (HD + 1);
    float sc = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d) sc = fmaf(qg[d], kr[d], sc);
    sc = valid ? sc * scale : NEG_INF;
    // lane 0's key (t0 < cend) is valid, so mt is a real score
    const float mt = warp_max(fmaxf(m, sc));
    const float corr = expf(m - mt);
    const float p = valid ? expf(sc - mt) : 0.f;
    l = l * corr + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
#pragma unroll 8
    for (int j = 0; j < TK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(pj, v_s[j * HD + lane + 32 * i], acc[i]);
    }
    m = mt;
  }

  float* w = ws + (((size_t)b * H + (size_t)kvh * G + g) * n_chunks + c) *
                      (2 + HD);
  if (lane == 0) {
    w[0] = m;
    w[1] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) w[2 + lane + 32 * i] = acc[i];
}

template <typename T>
__global__ void decode_combine(const float* __restrict__ ws,
                               const int* __restrict__ length,
                               T* __restrict__ o, int H, int Tn, int chunk,
                               int n_chunks, int HD) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(length[b], Tn);
  const int n_valid = len > 0 ? (len + chunk - 1) / chunk : 0;
  const float* w = ws + ((size_t)b * H + h) * n_chunks * (2 + HD);
  float mx = NEG_INF;
  for (int c = 0; c < n_valid; ++c) mx = fmaxf(mx, w[c * (2 + HD)]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < n_valid; ++c) {
    const float* wc = w + c * (2 + HD);
    const float scale = expf(wc[0] - mx);
    l = fmaf(wc[1], scale, l);
    acc = fmaf(wc[2 + d], scale, acc);
  }
  o[((size_t)b * H + h) * HD + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* length, void* o, float* ws, int B, int H,
                   int KV, int Tn, int chunk, cudaStream_t stream) {
  const int G = H / KV;
  const int n_chunks = (Tn + chunk - 1) / chunk;
  if (n_chunks > 0) {
    const size_t smem = sizeof(float) * ((size_t)G * HD + TK * (HD + 1) +
                                         TK * HD);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          decode_partial<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    decode_partial<HD, T><<<dim3(n_chunks, KV, B), 32 * G, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), length, ws, H, KV, Tn, chunk, n_chunks,
        1.0f / sqrtf((float)HD));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  decode_combine<T><<<dim3(H, B), HD, 0, stream>>>(
      ws, length, static_cast<T*>(o), H, Tn, chunk, n_chunks, HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const int* length, void* o, float* ws, int B, int H,
                      int KV, int Tn, int chunk, cudaStream_t stream) {
  if (hd == 32)
    return launch<32, T>(q, k, v, length, o, ws, B, H, KV, Tn, chunk, stream);
  if (hd == 64)
    return launch<64, T>(q, k, v, length, o, ws, B, H, KV, Tn, chunk, stream);
  return launch<128, T>(q, k, v, length, o, ws, B, H, KV, Tn, chunk, stream);
}

}  // namespace

// All pointers are device pointers to contiguous arrays on card `device`,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1): q and o (B, H, hd), k and v
// (B, KV, T, hd); length (B,) int32; ws a float32 workspace of
// B * H * ceil(T / chunk) * (2 + hd) floats.  hd is 32, 64 or 128, H a
// multiple of KV with at most 32 q heads per kv head, and chunk a
// positive multiple of 32.  Both passes go on `stream`; nothing
// synchronises.  Returns the CUDA error code of the launches (0 on
// success).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const int* length, void* o, float* ws, int B,
                                int H, int KV, int T, int hd, int bf16,
                                int chunk, int device, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || H / KV > 32 || T < 0 ||
      (hd != 32 && hd != 64 && hd != 128) || chunk < TK || chunk % TK ||
      B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, length, o, ws, B, H,
                                         KV, T, chunk, s);
  return (int)launch_hd<float>(hd, q, k, v, length, o, ws, B, H, KV, T,
                               chunk, s);
}
