// The gradient of prefill attention for Hopper (sm_90a): dq, dk and dv of
// flash_attention.cu's output against its gradient do, in three passes
// over the same tiles, so the (S, T) probability matrix never reaches
// device memory.
//
// Replaces no Pallas kernel one for one: the TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py) has no backward, and the reference
// trains through XLA's autodiff of jnp attention
// (src/repro/models/attention.py, `blockwise_attention`).  The port's
// forward is a hand-written kernel, so its gradient is one too.  Same
// function as autodiff of the forward: with s = q . k * scale (scale =
// hd^-0.5), P = softmax(s) over the keys the mask leaves (`causal`: row i
// sees keys j <= i, both from 0, S may differ from T), o = P v,
//
//   D_i   = sum_d do_id o_id                  (= sum_j P_ij dP_ij)
//   dP_ij = do_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_i dS_ij q_i,   dv_j = sum_i P_ij do_i,
//
// dk and dv summed over the H / KV query heads that read kv head j's head.
// Everything is float32 inside: the scores, P (never rounded to bfloat16,
// as in the forward), the sums; the outputs are cast to the inputs' dtype.
//
// What bounds it on an H100.  The passes recompute the scores three times
// (statistics, dk / dv, dq) and dP twice, and form dv, dk and dq: 8
// products of 2 hd operations per (query, key) pair the mask leaves.  At
// the tensor cores' rates (989 TFLOP/s bfloat16, 165 as 3xTF32) that is
// the bound at whisper's 1,500 frames; the short causal training shapes
// in bfloat16 are bound by their bytes (q, k, v, o, do read, dq, dk, dv
// written once).  This first kernel runs on the CUDA cores (67 TFLOP/s
// float32), the simple, correct design; the tensor cores (wgmma, as the
// forward's bfloat16 path) are later work.
//
// Design.  Three kernels, each a block of 256 threads over 32-row query
// tiles and 32-key tiles staged into shared memory as float32 at rows of
// HDP + 1 floats (HDP the template's width, 32, 64, 128 or 256; hd any
// multiple of 8 up to it):
//   1. bwd_stats, one block per (query tile, h, b): each row's logsumexp
//      lse_i, an online (max, sum) over the key tiles it sees, and D_i,
//      into float32 workspaces (B, H, S).  The forward stays as it is.
//   2. bwd_dkdv, one block per (key tile, kv head, b): for each of the kv
//      head's query heads and each query tile that sees the key tile, P
//      and dS into shared memory, then dv += P^T do and dk += dS^T q in
//      registers (a thread owns one key and every eighth column).
//   3. bwd_dq, one block per (query tile, h, b): over the key tiles the
//      rows see, dS into shared memory, then dq += dS k in registers.
// A score tile entry (r, c) belongs to thread t with r = t / 8 and
// c = t % 8 + 8 j, j < 4; the 8 lanes of a row are the low 3 bits of the
// lane id, so a row's max and sum reduce with three xor shuffles.  Every
// output element is written by one block, in a fixed order: no atomics,
// and the gradient is the same bits on every run.

#include <climits>
#include <cmath>
#include <cstdint>

#include "attention.cuh"

namespace {

using attn::from_f32;
using attn::to_f32;

constexpr int ROWS = 32;      // query rows a tile
constexpr int KEYS = 32;      // keys a tile
constexpr int THREADS = 256;
constexpr int PER = ROWS * KEYS / THREADS;   // score entries a thread: 4

// Shared memory, float32: Q, dO (ROWS rows) and K, V (KEYS rows) at
// rows of HDP + 1; P and dS (ROWS x (KEYS + 1)); each row's lse and D.
__host__ __device__ constexpr int smem_floats(int hdp) {
  return (2 * ROWS + 2 * KEYS) * (hdp + 1) + 2 * ROWS * (KEYS + 1) +
         2 * ROWS;
}

struct Tiles {
  float* q;
  float* dout;
  float* k;
  float* v;
  float* p;
  float* ds;
  float* lse;
  float* delta;
};

template <int HDP>
__device__ Tiles carve(float* smem) {
  constexpr int LD = HDP + 1;
  Tiles t;
  t.q = smem;
  t.dout = t.q + ROWS * LD;
  t.k = t.dout + ROWS * LD;
  t.v = t.k + KEYS * LD;
  t.p = t.v + KEYS * LD;
  t.ds = t.p + ROWS * (KEYS + 1);
  t.lse = t.ds + ROWS * (KEYS + 1);
  t.delta = t.lse + ROWS;
  return t;
}

// Rows [r0, r0 + n) of a (rows_total, hd) slab at `base` (row-major) into
// a shared tile of rows LD floats, as float32; rows past rows_total are 0.
template <int HDP, typename T>
__device__ void stage(float* dst, const T* base, int r0, int n,
                      int rows_total, int hd) {
  constexpr int LD = HDP + 1;
  for (int i = threadIdx.x; i < n * hd; i += THREADS) {
    const int r = i / hd, d = i - r * hd;
    const int row = r0 + r;
    dst[r * LD + d] =
        row < rows_total ? to_f32(base[(size_t)row * hd + d]) : 0.f;
  }
}

template <int HDP>
__device__ __forceinline__ float dot(const float* a, const float* b,
                                     int hd) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < hd; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// The score tile entries (r, c_j) of this thread, j < PER: whether the mask
// leaves them, and their scores q_r . k_c * scale.
template <int HDP>
__device__ __forceinline__ void scores(const Tiles& t, int q0, int k0, int S,
                                       int Tn, int hd, bool causal,
                                       float scale, float (&s)[PER],
                                       bool (&ok)[PER]) {
  constexpr int LD = HDP + 1;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  const int row = q0 + r;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = c0 + 8 * j, key = k0 + c;
    ok[j] = row < S && key < Tn && (!causal || key <= row);
    s[j] = dot<HDP>(t.q + r * LD, t.k + c * LD, hd) * scale;
  }
}

// P and dS of this thread's entries into the shared tiles (0 where masked).
template <int HDP>
__device__ __forceinline__ void probs(const Tiles& t, int q0, int k0, int S,
                                      int Tn, int hd, bool causal,
                                      float scale, bool keep_p) {
  constexpr int LD = HDP + 1;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
  float s[PER];
  bool ok[PER];
  scores<HDP>(t, q0, k0, S, Tn, hd, causal, scale, s, ok);
  const float lse = t.lse[r], dlt = t.delta[r];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = c0 + 8 * j;
    const float p = ok[j] ? expf(s[j] - lse) : 0.f;
    const float dp = dot<HDP>(t.dout + r * LD, t.v + c * LD, hd);
    if (keep_p) t.p[r * (KEYS + 1) + c] = p;
    t.ds[r * (KEYS + 1) + c] = p * (dp - dlt);
  }
}

// Pass 1: each row's lse over the keys it sees, and D = rowsum(do * o).
template <int HDP, typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int H,
              int KV, int S, int Tn, int hd, int causal, float scale) {
  extern __shared__ float smem[];
  const Tiles t = carve<HDP>(smem);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t qrow = ((size_t)b * H + h) * S;
  const size_t kvrow = ((size_t)b * KV + kvh) * Tn;
  const int r = threadIdx.x >> 3, lane8 = threadIdx.x & 7;
  const int row = q0 + r;
  stage<HDP>(t.q, q + qrow * hd, q0, ROWS, S, hd);
  // D: 8 lanes a row, every eighth column each, then 3 xor shuffles
  float dsum = 0.f;
  if (row < S)
    for (int d = lane8; d < hd; d += 8)
      dsum = fmaf(to_f32(dout[(qrow + row) * hd + d]),
                  to_f32(o[(qrow + row) * hd + d]), dsum);
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) dsum += __shfl_xor_sync(~0u, dsum, m);
  const int kend = causal ? min(Tn, q0 + ROWS) : Tn;
  float mx = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < kend; k0 += KEYS) {
    __syncthreads();
    stage<HDP>(t.k, k + kvrow * hd, k0, KEYS, Tn, hd);
    __syncthreads();
    float s[PER];
    bool ok[PER];
    scores<HDP>(t, q0, k0, S, Tn, hd, causal != 0, scale, s, ok);
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (ok[j]) tmax = fmaxf(tmax, s[j]);
#pragma unroll
    for (int m = 1; m < 8; m <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(~0u, tmax, m));
    // every lane runs the shuffles; a row with no key yet keeps (-inf, 0)
    const float mnew = fmaxf(mx, tmax);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (ok[j]) psum += expf(s[j] - mnew);
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) psum += __shfl_xor_sync(~0u, psum, m);
    l = (mx == -INFINITY ? 0.f : l * expf(mx - mnew)) + psum;
    mx = mnew;
  }
  if (row < S && lane8 == 0) {
    lse[qrow + row] = mx + logf(l);
    delta[qrow + row] = dsum;
  }
}

// Pass 2: dk and dv of one key tile of one kv head.
template <int HDP, typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int S,
             int Tn, int hd, int causal, float scale) {
  constexpr int LD = HDP + 1, NC = HDP / 8;
  extern __shared__ float smem[];
  const Tiles t = carve<HDP>(smem);
  const int k0 = blockIdx.x * KEYS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const size_t kvrow = ((size_t)b * KV + kvh) * Tn;
  stage<HDP>(t.k, k + kvrow * hd, k0, KEYS, Tn, hd);
  stage<HDP>(t.v, v + kvrow * hd, k0, KEYS, Tn, hd);
  const int c = threadIdx.x >> 3, lane8 = threadIdx.x & 7;
  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc_k[m] = acc_v[m] = 0.f;
  // the first query tile that sees a key of this tile
  const int qstart = causal ? k0 / ROWS * ROWS : 0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t qrow = ((size_t)b * H + h) * S;
    for (int q0 = qstart; q0 < S; q0 += ROWS) {
      __syncthreads();
      stage<HDP>(t.q, q + qrow * hd, q0, ROWS, S, hd);
      stage<HDP>(t.dout, dout + qrow * hd, q0, ROWS, S, hd);
      if (threadIdx.x < ROWS) {
        const int row = q0 + threadIdx.x;
        t.lse[threadIdx.x] = row < S ? lse[qrow + row] : 0.f;
        t.delta[threadIdx.x] = row < S ? delta[qrow + row] : 0.f;
      }
      __syncthreads();
      probs<HDP>(t, q0, k0, S, Tn, hd, causal != 0, scale, true);
      __syncthreads();
      for (int r = 0; r < ROWS; ++r) {
        const float p = t.p[r * (KEYS + 1) + c];
        const float ds = t.ds[r * (KEYS + 1) + c];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int d = lane8 + 8 * m;
          if (d < hd) {
            acc_v[m] = fmaf(p, t.dout[r * LD + d], acc_v[m]);
            acc_k[m] = fmaf(ds, t.q[r * LD + d], acc_k[m]);
          }
        }
      }
    }
  }
  const int key = k0 + c;
  if (key < Tn) {
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = lane8 + 8 * m;
      if (d < hd) {
        dk[(kvrow + key) * hd + d] = from_f32<T>(acc_k[m] * scale);
        dv[(kvrow + key) * hd + d] = from_f32<T>(acc_v[m]);
      }
    }
  }
}

// Pass 3: dq of one query tile of one head.
template <int HDP, typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, int H, int KV, int S, int Tn, int hd,
           int causal, float scale) {
  constexpr int LD = HDP + 1, NC = HDP / 8;
  extern __shared__ float smem[];
  const Tiles t = carve<HDP>(smem);
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t qrow = ((size_t)b * H + h) * S;
  const size_t kvrow = ((size_t)b * KV + kvh) * Tn;
  stage<HDP>(t.q, q + qrow * hd, q0, ROWS, S, hd);
  stage<HDP>(t.dout, dout + qrow * hd, q0, ROWS, S, hd);
  if (threadIdx.x < ROWS) {
    const int row = q0 + threadIdx.x;
    t.lse[threadIdx.x] = row < S ? lse[qrow + row] : 0.f;
    t.delta[threadIdx.x] = row < S ? delta[qrow + row] : 0.f;
  }
  const int r = threadIdx.x >> 3, lane8 = threadIdx.x & 7;
  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.f;
  const int kend = causal ? min(Tn, q0 + ROWS) : Tn;
  for (int k0 = 0; k0 < kend; k0 += KEYS) {
    __syncthreads();
    stage<HDP>(t.k, k + kvrow * hd, k0, KEYS, Tn, hd);
    stage<HDP>(t.v, v + kvrow * hd, k0, KEYS, Tn, hd);
    __syncthreads();
    probs<HDP>(t, q0, k0, S, Tn, hd, causal != 0, scale, false);
    __syncthreads();
    for (int c = 0; c < KEYS; ++c) {
      const float ds = t.ds[r * (KEYS + 1) + c];
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const int d = lane8 + 8 * m;
        if (d < hd) acc[m] = fmaf(ds, t.k[c * LD + d], acc[m]);
      }
    }
  }
  const int row = q0 + r;
  if (row < S) {
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int d = lane8 + 8 * m;
      if (d < hd) dq[(qrow + row) * hd + d] = from_f32<T>(acc[m] * scale);
    }
  }
}

template <int HDP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int B, int H, int KV,
                   int S, int Tn, int hd, int causal, cudaStream_t st) {
  const int smem = smem_floats(HDP) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_stats<HDP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dkdv<HDP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bwd_dq<HDP, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  const float scale = (float)(1.0 / sqrt((double)hd));
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* O = static_cast<const T*>(o);
  const T* DO = static_cast<const T*>(dout);
  const dim3 rows_grid((S + ROWS - 1) / ROWS, H, B);
  const dim3 keys_grid((Tn + KEYS - 1) / KEYS, KV, B);
  bwd_stats<HDP, T><<<rows_grid, THREADS, smem, st>>>(
      Q, K, O, DO, lse, delta, H, KV, S, Tn, hd, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkdv<HDP, T><<<keys_grid, THREADS, smem, st>>>(
      Q, K, V, DO, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H,
      KV, S, Tn, hd, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dq<HDP, T><<<rows_grid, THREADS, smem, st>>>(
      Q, K, V, DO, lse, delta, static_cast<T*>(dq), H, KV, S, Tn, hd,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hdp, const void* q, const void* k, const void* v,
                      const void* o, const void* dout, void* dq, void* dk,
                      void* dv, float* lse, float* delta, int B, int H,
                      int KV, int S, int Tn, int hd, int causal,
                      cudaStream_t st) {
  switch (hdp) {
#define BWD_HDP(N)                                                         \
  case N:                                                                  \
    return launch<N, T>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, \
                        S, Tn, hd, causal, st);
    BWD_HDP(32) BWD_HDP(64) BWD_HDP(128) BWD_HDP(256)
#undef BWD_HDP
  }
  return cudaErrorInvalidValue;
}

int plan_hdp(int hd) {
  return hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// The launcher's guard: the sizes it takes (the grids' y and z within
// 65,535; S and T at least 1 and at most 127 short of INT_MAX, since a
// block's row and key bounds q0 + ROWS and k0 + KEYS and its loops' last
// q0 and k0 are int), the plan's tiles, and 16-byte aligned, non-null
// operands and workspaces.
bool plan_ok(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* dq, const void* dk,
             const void* dv, const void* lse, const void* delta, int B, int H,
             int KV, int S, int T, int hd, int rows, int keys) {
  const uintptr_t ptrs[] = {(uintptr_t)q,  (uintptr_t)k,   (uintptr_t)v,
                            (uintptr_t)o,  (uintptr_t)dout, (uintptr_t)dq,
                            (uintptr_t)dk, (uintptr_t)dv,  (uintptr_t)lse,
                            (uintptr_t)delta};
  for (uintptr_t p : ptrs)
    if (p == 0 || (p & 15) != 0) return false;
  return B >= 1 && H >= 1 && KV >= 1 && H % KV == 0 && S >= 1 && T >= 1 &&
         S <= INT_MAX - 127 && T <= INT_MAX - 127 && hd >= 8 && hd <= 256 &&
         hd % 8 == 0 && H <= 65535 && B <= 65535 && rows == ROWS &&
         keys == KEYS;
}

}  // namespace

// All pointers are device pointers to contiguous, 16-byte aligned arrays on
// card `device`, float32 (bf16 == 0) or bfloat16 (bf16 == 1): q, o, dout
// and dq (B, H, S, hd), k, v, dk and dv (B, KV, T, hd); lse and delta are
// float32 workspaces (B, H, S).  hd is a multiple of 8 from 8 to 256 and H
// a multiple of KV; (rows, keys) must be the kernel's tiles, 32 and 32
// (`flash_bwd_plan`).  The three passes go on `stream`; returns the CUDA
// error code (cudaErrorInvalidValue where the guard refuses, launching
// nothing).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int B,
                                   int H, int KV, int S, int T, int hd,
                                   int bf16, int causal, int rows, int keys,
                                   int device, void* stream) {
  if (!plan_ok(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, S, T, hd,
               rows, keys))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* L = static_cast<float*>(lse);
  float* Dl = static_cast<float*>(delta);
  if (bf16)
    return (int)launch_hd<__nv_bfloat16>(plan_hdp(hd), q, k, v, o, dout, dq,
                                         dk, dv, L, Dl, B, H, KV, S, T, hd,
                                         causal, st);
  return (int)launch_hd<float>(plan_hdp(hd), q, k, v, o, dout, dq, dk, dv, L,
                               Dl, B, H, KV, S, T, hd, causal, st);
}

// The launcher's guard alone (plan_ok), on the launcher's own arguments
// but the device and the stream: 1 where flash_attention_bwd would launch,
// 0 where it would return cudaErrorInvalidValue.  `bf16` and `causal` take
// no part in it.  Launches nothing and touches no device.
extern "C" int flash_attention_bwd_plan_ok(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int B, int H, int KV, int S, int T, int hd, int bf16, int causal,
    int rows, int keys) {
  (void)bf16;
  (void)causal;
  return plan_ok(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, S, T,
                 hd, rows, keys);
}
