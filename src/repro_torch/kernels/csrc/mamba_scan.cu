// Mamba1 selective scan for Hopper (sm_90a): the recurrence run in
// registers, so the (B, L, D, N) state tensor never reaches device memory.
//
// Replaces the TPU kernel `_scan_kernel` launched by `mamba_scan` in
// src/repro/kernels/mamba_scan.py.  Same function: from h_0 = 0,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,  y_t = h_t . C_t,
// in float32, y (B, L, D) float32.
//
// Design.  The Pallas kernel evaluates each chunk of steps with an
// associative doubling over VMEM tiles; on Hopper the natural form is one
// thread per (b, d) channel that holds its N states and A row in
// registers and steps through L in order.  B_t and C_t, which every
// channel of a row shares, and the chunk's u and dt (loaded coalesced
// across d) are staged in shared memory LC = 32 steps at a time.  N is a
// template parameter (4, 8, 16).  The sums run in step order, as the
// step-by-step reference, not in the doubling's order.
//
// What bounds it on an H100.  The bytes are u, dt and y (3 * B * L * D
// floats) plus B, C and A: 3.3 MB at the benchmark's shape (B = 1,
// L = 1024, D = 256, N = 16), 1 us at 3.35 TB/s.  But one thread per
// channel is 256 threads there, each a 1,024-step chain of N exps and
// FMAs: the kernel is bound by that chain's latency, far from the bytes.
// Splitting N across lanes, or a chunked scan over L, is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // channels per block
constexpr int LC = 32;       // steps per staged chunk

template <int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ A, float* __restrict__ y, int L,
                  int D) {
  __shared__ float b_s[LC][N];
  __shared__ float c_s[LC][N];
  __shared__ float u_s[LC][THREADS];
  __shared__ float dt_s[LC][THREADS];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid, b = blockIdx.y;
  const bool live = d < D;
  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(size_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const size_t row = (size_t)b * L;

  for (int t0 = 0; t0 < L; t0 += LC) {
    const int nt = min(LC, L - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < LC * N; e += THREADS) {
      const int j = e / N, n = e - j * N;
      const bool in = j < nt;
      b_s[j][n] = in ? Bm[(row + t0 + j) * N + n] : 0.f;
      c_s[j][n] = in ? Cm[(row + t0 + j) * N + n] : 0.f;
    }
#pragma unroll 8
    for (int j = 0; j < LC; ++j) {
      const bool in = live && j < nt;
      u_s[j][tid] = in ? u[(row + t0 + j) * D + d] : 0.f;
      dt_s[j][tid] = in ? dt[(row + t0 + j) * D + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const float dtv = dt_s[j][tid];
      const float x = dtv * u_s[j][tid];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + x * b_s[j][n];
        yv = fmaf(h[n], c_s[j][n], yv);
      }
      if (live) y[(row + t0 + j) * D + d] = yv;
    }
  }
}

template <int N>
cudaError_t launch(const float* u, const float* dt, const float* Bm,
                   const float* Cm, const float* A, float* y, int B, int L,
                   int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  mamba_scan_kernel<N><<<grid, THREADS, 0, stream>>>(u, dt, Bm, Cm, A, y, L,
                                                     D);
  return cudaGetLastError();
}

}  // namespace

// All pointers are device pointers to contiguous float32 arrays on card
// `device`: u, dt and y (B, L, D), Bm and Cm (B, L, N), A (D, N); N is 4, 8
// or 16.  The launch goes on `stream` and does not synchronise.  Returns
// the CUDA error code of the launch (0 on success).
extern "C" int mamba_scan(const float* u, const float* dt, const float* Bm,
                          const float* Cm, const float* A, float* y, int B,
                          int L, int D, int N, int device, void* stream) {
  if (B < 1 || L < 1 || D < 1 || B > 65535 || (N != 4 && N != 8 && N != 16))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 4) return (int)launch<4>(u, dt, Bm, Cm, A, y, B, L, D, s);
  if (N == 8) return (int)launch<8>(u, dt, Bm, Cm, A, y, B, L, D, s);
  return (int)launch<16>(u, dt, Bm, Cm, A, y, B, L, D, s);
}
