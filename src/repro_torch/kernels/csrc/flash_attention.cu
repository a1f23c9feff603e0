// Prefill attention for Hopper (sm_90a): one pass over the keys with an
// online softmax, so the (S, T) score matrix never reaches device memory.
//
// Replaces the TPU kernel `_flash_kernel` launched by `flash_attention` in
// src/repro/kernels/flash_attention.py.  Same function: scores q . k
// scaled by hd^-0.5 in float32; with `causal`, key positions past the
// query's (both from 0) score -1e30 and key tiles wholly above the
// diagonal are skipped; GQA reads kv head h / (H / KV); the running
// (max, sum, accumulator) are float32, p is rounded to v's dtype before
// the PV product, and the output is acc / max(l, 1e-30) in q's dtype.
//
// Design.  The Pallas grid carries (m, l, acc) in VMEM across a sequential
// kv axis; here a block owns BQ = 64 query rows of one (b, h) and loops
// over the keys itself, staging BK = 32 keys of K and V (as float32) in
// shared memory per step.  Four threads share a query row, each holding
// hd / 4 of its q and accumulator in registers (8, 16 or 32 floats at
// hd = 32, 64, 128) as interleaved float4 chunks, so the four lanes read
// 64 contiguous bytes of a K or V row together without bank conflicts;
// a row's score is its four partial dot products summed by two xor
// shuffles.  hd is a template parameter.
//
// What bounds it on an H100.  The work is 4 * hd operations per (query,
// key) pair: at the benchmark's causal shape (B = 1, H = 8, S = T = 1024,
// hd = 64) 1.07 GFLOP, 16 us at the 67 TFLOP/s fp32 peak, against 1.6 us
// to move 5.2 MB: operations.  This kernel uses the CUDA cores' fp32 FMA,
// not the tensor cores, and every lane re-reads each staged K and V row;
// a wgmma product from TMA-staged tiles is later work.

#include "attention.cuh"

namespace {

using namespace attn;

constexpr int BQ = 64;                 // query rows per block
constexpr int LANES = 4;               // threads per query row
constexpr int THREADS = BQ * LANES;    // 256
constexpr int BK = 32;                 // keys per staged tile

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int KV, int S,
             int Tn, float scale, int causal) {
  constexpr int DPL = HD / LANES;      // dims per lane
  constexpr int CH4 = DPL / 4;         // float4 chunks per lane
  __shared__ __align__(16) float k_s[BK][HD];
  __shared__ __align__(16) float v_s[BK][HD];

  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int qpos = q0 + row;
  const bool live = qpos < S;
  const T* qrow = q + (((size_t)b * H + h) * S + (live ? qpos : 0)) * HD;
  const T* kb = k + ((size_t)b * KV + kvh) * (size_t)Tn * HD;
  const T* vb = v + ((size_t)b * KV + kvh) * (size_t)Tn * HD;

  // lane owns the float4 chunks LANES * i + lane, i < CH4
  float qr[DPL], acc[DPL];
#pragma unroll
  for (int i = 0; i < CH4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (LANES * i + lane) + e;
      qr[4 * i + e] = live ? to_f32(qrow[d]) : 0.f;
      acc[4 * i + e] = 0.f;
    }
  }
  float m = NEG_INF, l = 0.f;

  // causal: tiles starting past the block's last query row see nothing
  const int kend = causal ? min(Tn, q0 + BQ) : Tn;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    const int nk = min(BK, Tn - k0);
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int j = e / HD, d = e - j * HD;
      const bool in = j < nk;
      k_s[j][d] = in ? to_f32(kb[(size_t)(k0 + j) * HD + d]) : 0.f;
      v_s[j][d] = in ? to_f32(vb[(size_t)(k0 + j) * HD + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < CH4; ++i) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&k_s[j][4 * (LANES * i + lane)]);
        part = fmaf(qr[4 * i], kk.x, part);
        part = fmaf(qr[4 * i + 1], kk.y, part);
        part = fmaf(qr[4 * i + 2], kk.z, part);
        part = fmaf(qr[4 * i + 3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float sc = part * scale;
      if (causal && k0 + j > qpos) sc = NEG_INF;
      if (j >= nk) sc = NEG_INF;  // past T: no key (its p is set to 0 below)
      s[j] = sc;
      mt = fmaxf(mt, sc);
    }
    // key 0 is in the first tile and every row sees it, so mt is a real
    // score from the first tile on and the first correction is exp(-1e30)
    const float corr = expf(m - mt);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] *= corr;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = j < nk ? expf(s[j] - mt) : 0.f;
      psum += p;
      const float pv = as_v_dtype(p, T{});
#pragma unroll
      for (int i = 0; i < CH4; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&v_s[j][4 * (LANES * i + lane)]);
        acc[4 * i] = fmaf(pv, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(pv, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(pv, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(pv, vv.w, acc[4 * i + 3]);
      }
    }
    l += psum;
    m = mt;
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  T* orow = o + (((size_t)b * H + h) * S + qpos) * HD;
#pragma unroll
  for (int i = 0; i < CH4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      orow[4 * (LANES * i + lane) + e] = from_f32<T>(acc[4 * i + e] / denom);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int Tn, int causal,
                   cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<HD, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, Tn,
      1.0f / sqrtf((float)HD), causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int B, int H, int KV, int S, int Tn,
                      int causal, cudaStream_t stream) {
  if (hd == 32)
    return launch<32, T>(q, k, v, o, B, H, KV, S, Tn, causal, stream);
  if (hd == 64)
    return launch<64, T>(q, k, v, o, B, H, KV, S, Tn, causal, stream);
  return launch<128, T>(q, k, v, o, B, H, KV, S, Tn, causal, stream);
}

}  // namespace

// All pointers are device pointers to contiguous arrays on card `device`,
// float32 (bf16 == 0) or bfloat16 (bf16 == 1): q and o (B, H, S, hd), k and
// v (B, KV, T, hd).  hd is 32, 64 or 128 and H a multiple of KV.  The
// launch goes on `stream` and does not synchronise.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KV, int S, int T,
                               int hd, int bf16, int causal, int device,
                               void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || S < 1 || T < 0 ||
      (hd != 32 && hd != 64 && hd != 128) || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KV, S, T,
                                         causal, s);
  return (int)launch_hd<float>(hd, q, k, v, o, B, H, KV, S, T, causal, s);
}
