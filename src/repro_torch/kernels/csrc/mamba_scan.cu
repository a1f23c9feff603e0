// Mamba1 selective scan for Hopper (sm_90a): each thread scans a few
// state entries of one channel over its steps, in registers, so the
// (B, L, D, N) state tensor never reaches device memory; where the
// channels alone cannot fill the card, L is cut into segments across
// blocks and the segments are joined by the recurrence's associative form.
//
// Replaces the TPU kernel `_scan_kernel` launched by `mamba_scan` in
// src/repro/kernels/mamba_scan.py.  Same function: from h_0 = 0,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t,  y_t = h_t . C_t,
// in float32, y (B, L, D) float32.  Any B, L, D and any N.  Where the
// caller asks for it (a model's prefill keeps each layer's state), the
// pass that writes y also writes the end state h_L (B, D, N): from each
// lane's registers after its last step, in the last segment's blocks,
// each tile from its own stage; no second launch, no extra read.
//
// What bounds it on an H100.  Bytes: u, dt and y (3 * B * L * D floats)
// plus B, C and A; 403 MB at falcon-mamba-7b's width (L = 4,096,
// D = 8,192, N = 16), 0.12 ms at 3.35 TB/s.  Exps: one per (b, t, d, n),
// 537 M there, and the special-function unit gives 16 a clock per SM,
// about 0.14 ms on 132 SMs.  Every channel of a row reads the same B_t
// and C_t: read once per channel they would be 4.3 GB through L2 there.
// So the design reads B and C once per block of 32 channels and keeps the
// instructions around each exp to about eight.
//
// Design.
// - Threads.  nl lanes share a channel, each holding EG of its state
//   entries in registers (EG = 1 up to N = 4, 4 up to N = 16, 8 above; nl
//   the power of two that covers N, at most 32): a warp holds 32 / nl
//   channels and a block 32 channels of one batch row.  Each lane adds
//   h_t[n] C_t[n] over its entries and the channel's lanes sum that by
//   xor shuffles, log2(nl) a step.  One grid dimension holds every block,
//   B folded in, so any B launches.
// - Serial runs, in groups.  A thread walks its segment's steps in order,
//   GROUP = 8 at a time (4 with 8 entries a lane): first the group's
//   loads and exps, which do not wait on the state, then the chains
//   h = a h + b; so a warp has 8 EG exps and their loads in flight.
// - Staging.  Each chunk of at most 64 steps of dt and u ([T][32], 16-byte
//   cp.async where the rows align) and of B and C ([T][nl EG]) lands in
//   shared memory, double-buffered: the next chunk is in flight while
//   this one is scanned.  B and C are read once per block, as wide loads
//   of the lane's entries that all the block's channels share.  An N past
//   256 is scanned in tiles of nl EG entries, one stage each, the state
//   between tiles in the workspace.
// - Exps.  A is scaled by log2(e) as a lane loads its entries, and each
//   decay is one `ex2.approx.ftz.f32` (the unit's 2^x, about 2 ulp; the
//   hold is 1e-4).
// - Parallel over time.  The pairs (a, b) compose as
//   (a1, b1) o (a2, b2) = (a2 a1, a2 b1 + b2).  Where B * D channels give
//   the card too few warps (the benchmark's 256), the plan cuts L into
//   segments across blocks: pass 1 (`TOTALS`) scans each segment from
//   zero to its end state and its decay exp2(A log2(e) sum dt),
//   `carry_kernel` composes them in order into each segment's start
//   state, and pass 2 scans each segment from its start and writes y.
//   That reads u, dt and B twice and takes each exp twice; one pass, as
//   at falcon-mamba-7b's width, reads every input once.  A chunk split
//   into runs across the warps of a block instead needs each run scanned
//   twice (a_t, b_t kept in registers) and a carry composed across the
//   warps for every entry: about twice the instructions a step, and it
//   measured slower at both shapes (PERF.md).
//
// The plan is the wrapper's (`mamba_scan.scan_plan`); the launcher checks
// it and runs every launch of a call on the caller's stream.

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_WARPS = 8;
constexpr int GROUP = 8;  // a chunk is whole groups of steps

// Steps a thread scans as a group: GROUP, or half of it with 8 entries a
// lane, which would not fit the registers.
template <int EG>
__host__ __device__ constexpr int group_steps() {
  return EG == 8 ? GROUP / 2 : GROUP;
}
constexpr size_t MAX_SMEM = 232448;  // 227 KB, an H100 block's most

struct Shape {
  int B, L, D, N;
  int nl;              // lanes a channel: 32 / nl channels a warp
  int warps;           // warps a block
  int chunk;           // steps staged at once, a multiple of GS
  int segs, seg_len;   // segments of L and their length (whole chunks)
  int vec_ud, vec_bc;  // rows of u and dt, of B and C, copy 16 bytes at once
};

// Words of shared memory a block uses: dt and u [2][2][chunk][DB], B and C
// [2][2][chunk][NP] (double-buffered), and y [chunk][DB]; DB = warps 32 /
// nl channels, NP = nl EG entries.
template <int EG>
size_t smem_words(const Shape& s) {
  const size_t T = s.chunk, DB = (size_t)s.warps * (32 / s.nl),
               NP = (size_t)s.nl * EG;
  return 5 * T * DB + 4 * T * NP;
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// EG consecutive floats of shared memory, as wide loads where they align.
template <int EG>
__device__ __forceinline__ void load_run(const float* p, float (&v)[EG]) {
  if constexpr (EG % 4 == 0) {
#pragma unroll
    for (int q = 0; q < EG / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z,
      v[4 * q + 3] = f.w;
    }
  } else {
    v[0] = *p;
  }
}

// One block: DB = warps 32 / nl channels of batch row b over segment
// seg, chunk by chunk; nl lanes share a channel, each holding EG state
// entries (a tile of NP = nl EG entries; a larger N takes several tiles,
// one stage each).  TOTALS: write each (channel, n)'s state at the
// segment's end, from zero, to ws_h and the segment's decay to ws_p, and
// no y.  Otherwise: start from zero (segment 0) or ws_h (its carry-in) and
// write y, and, with hL, the last segment's end state to hL (B, D, N).
// ws_h also carries the state between chunks when N takes
// several tiles.
template <int EG, bool TOTALS>
__global__ void __launch_bounds__(32 * MAX_WARPS)
scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            const float* __restrict__ A, float* __restrict__ y,
            float* __restrict__ hL, float* __restrict__ ws_h,
            float* __restrict__ ws_p, Shape s) {
  constexpr int GS = group_steps<EG>();
  extern __shared__ float4 smem4[];
  const int NL = s.nl, DB = s.warps * (32 / NL), NP = NL * EG, T = s.chunk;
  float* uds = reinterpret_cast<float*>(smem4);  // [2][dt, u][T][DB]
  float* bcs = uds + 4 * (size_t)T * DB;         // [2][B, C][T][NP]
  float* ys = bcs + 4 * (size_t)T * NP;          // [T][DB]

  const size_t D = s.D, N = s.N;
  const int tiles = (s.N + NP - 1) / NP;
  const int ndb = (s.D + DB - 1) / DB;
  const int dblk = (int)(blockIdx.x % ndb);
  const int seg = (int)(blockIdx.x / ndb % s.segs);
  const size_t b = blockIdx.x / ndb / s.segs;
  const int lane = threadIdx.x & 31;
  const int ch = (threadIdx.x >> 5) * (32 / NL) + lane / NL;  // in block
  const int el = lane % NL;  // the lane's place among its channel's lanes
  const int d0 = dblk * DB;
  const bool live = d0 + ch < s.D;
  const size_t d = d0 + ch;
  const long long t_begin = (long long)seg * s.seg_len;
  const long long t_end = t_begin + s.seg_len < s.L ? t_begin + s.seg_len
                                                    : s.L;
  const size_t row0 = b * s.L;
  const size_t wsb = (b * s.segs + seg) * N;

  // Stage `st` (chunk st / tiles, tile st % tiles) into shared memory, in
  // flight until the next cp_wait_all: B and C of the tile's entries, and
  // with tile 0 the chunk's dt and u.  Rows past the segment and entries
  // past N land as zeros.  DB and NP are powers of two.
  const int db_sh = __ffs(DB) - 1, np_sh = __ffs(NP) - 1;
  auto stage = [&](long long st) {
    const int tile = st % tiles;
    const long long t0 = t_begin + (long long)(st / tiles) * T;
    const int n0 = tile * NP;
    float* bc = bcs + (size_t)(st & 1) * 2 * T * NP;
    const int vb = s.vec_bc ? 4 : 1;
    for (int i = threadIdx.x * vb; i < T * NP; i += blockDim.x * vb) {
      const int tt = i >> np_sh, n = i & (NP - 1);
      const bool in = t0 + tt < t_end && n0 + n < s.N;
      const size_t gi = in ? (row0 + t0 + tt) * N + n0 + n : 0;
      if (vb == 4) {
        cp_async16(bc + i, Bm + gi, in);
        cp_async16(bc + (size_t)T * NP + i, Cm + gi, in);
      } else {
        cp_async4(bc + i, Bm + gi, in);
        cp_async4(bc + (size_t)T * NP + i, Cm + gi, in);
      }
    }
    if (tile == 0) {
      float* ud = uds + (size_t)((st / tiles) & 1) * 2 * T * DB;
      const int vu = s.vec_ud ? 4 : 1;
      for (int i = threadIdx.x * vu; i < T * DB; i += blockDim.x * vu) {
        const int tt = i >> db_sh, cc = i & (DB - 1);
        const bool in = t0 + tt < t_end && d0 + cc < s.D;
        const size_t gi = in ? (row0 + t0 + tt) * D + d0 + cc : 0;
        if (vu == 4) {
          cp_async16(ud + i, dt + gi, in);
          cp_async16(ud + (size_t)T * DB + i, u + gi, in);
        } else {
          cp_async4(ud + i, dt + gi, in);
          cp_async4(ud + (size_t)T * DB + i, u + gi, in);
        }
      }
    }
    cp_commit();
  };

  const long long chunks = (t_end - t_begin + T - 1) / T;
  const long long stages = chunks * tiles;
  float h[EG], a2[EG];  // the lane's entries: state, A * log2(e)
  float sdt = 0.f;      // sum of dt over the segment's earlier chunks
  if (stages > 0) stage(0);
  for (long long st = 0, k = 0; k < chunks; ++k) {
    const long long t0 = t_begin + k * T;
    const bool first = k == 0, last = k == chunks - 1;
    const float* __restrict__ ud = uds + (size_t)(k & 1) * 2 * T * DB + ch;
    float sdt_chunk = 0.f;
    for (int tile = 0; tile < tiles; ++tile, ++st) {
      cp_wait_all();
      __syncthreads();  // this stage is in; the last one's readers are done
      if (st + 1 < stages) stage(st + 1);
      const int n0 = tile * NP + el * EG;
      if (first || tiles > 1) {
        const bool zero = first && (TOTALS || seg == 0);
#pragma unroll
        for (int g = 0; g < EG; ++g) {
          const bool in = live && n0 + g < s.N;
          a2[g] = in ? A[d * N + n0 + g] * LOG2E : 0.f;
          h[g] = in && !zero ? ws_h[(wsb + n0 + g) * D + d] : 0.f;
        }
      }
      const float* __restrict__ bc =
          bcs + (size_t)(st & 1) * 2 * T * NP + el * EG;
      float* __restrict__ yc = ys + ch;
      float sdt_stage = 0.f;
      // GS steps at a time: their loads and exps first, which do not wait
      // on the state, then the GS steps of each chain
      for (int tt = 0; tt < T; tt += GS) {
        float dq[GS], xq[GS], bq[GS][EG], cq[GS][EG], aq[GS][EG];
#pragma unroll
        for (int q = 0; q < GS; ++q) {
          dq[q] = ud[(tt + q) * DB];
          xq[q] = dq[q] * ud[(size_t)T * DB + (tt + q) * DB];
          load_run<EG>(bc + (tt + q) * NP, bq[q]);
          if (!TOTALS)
            load_run<EG>(bc + (size_t)T * NP + (tt + q) * NP, cq[q]);
        }
#pragma unroll
        for (int q = 0; q < GS; ++q)
#pragma unroll
          for (int g = 0; g < EG; ++g) aq[q][g] = ex2(dq[q] * a2[g]);
        float yq[GS];
#pragma unroll
        for (int q = 0; q < GS; ++q) {
          yq[q] = 0.f;
#pragma unroll
          for (int g = 0; g < EG; ++g) {
            h[g] = fmaf(aq[q][g], h[g], xq[q] * bq[q][g]);
            if (!TOTALS) yq[q] = fmaf(h[g], cq[q][g], yq[q]);
          }
          if (TOTALS) sdt_stage += dq[q];
        }
        if (!TOTALS) {
          // y_t of the channel: the sum over its lanes' entries
          for (int off = NL >> 1; off > 0; off >>= 1)
#pragma unroll
            for (int q = 0; q < GS; ++q)
              yq[q] += __shfl_xor_sync(0xffffffffu, yq[q], off);
          if (el == 0) {
#pragma unroll
            for (int q = 0; q < GS; ++q)
              yc[(tt + q) * DB] =
                  tile == 0 ? yq[q] : yc[(tt + q) * DB] + yq[q];
          }
        }
      }
      if (!TOTALS && last && hL != nullptr && seg == s.segs - 1 && live) {
#pragma unroll
        for (int g = 0; g < EG; ++g)
          if (n0 + g < s.N) hL[(b * D + d) * N + n0 + g] = h[g];
      }
      if (tiles > 1 || (TOTALS && last)) {
#pragma unroll
        for (int g = 0; g < EG; ++g) {
          if (live && n0 + g < s.N) {
            const size_t wi = (wsb + n0 + g) * D + d;
            ws_h[wi] = h[g];
            if (TOTALS && last) ws_p[wi] = ex2(a2[g] * (sdt + sdt_stage));
          }
        }
      }
      sdt_chunk = sdt_stage;
    }
    sdt += sdt_chunk;
    if (!TOTALS) {
      __syncthreads();  // every lane's y of the chunk is in
      for (int i = threadIdx.x; i < T * DB; i += blockDim.x) {
        const int tt = i >> db_sh, cc = i & (DB - 1);
        if (t0 + tt < t_end && d0 + cc < s.D)
          y[(row0 + t0 + tt) * D + d0 + cc] = tiles ? ys[i] : 0.f;
      }
    }
  }
}

// The carry pass of a segmented call: for each (b, n, d), walk the
// segments in order, replacing each segment's (state from zero, decay)
// in ws_h with the state at its start.
__global__ void carry_kernel(float* __restrict__ ws_h,
                             const float* __restrict__ ws_p, size_t count,
                             int segs, size_t nd) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t b = i / nd, r = i - b * nd;
  float h = 0.f;
  for (int sg = 0; sg < segs; ++sg) {
    const size_t wi = (b * segs + sg) * nd + r;
    const float hl = ws_h[wi], p = ws_p[wi];
    ws_h[wi] = h;
    h = fmaf(p, h, hl);
  }
}

template <int EG, bool TOTALS>
cudaError_t launch_scan(const float* u, const float* dt, const float* Bm,
                        const float* Cm, const float* A, float* y, float* hL,
                        float* ws_h, float* ws_p, const Shape& s,
                        unsigned blocks, cudaStream_t stream) {
  const size_t smem = smem_words<EG>(s) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<EG, TOTALS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  scan_kernel<EG, TOTALS><<<blocks, 32 * s.warps, smem, stream>>>(
      u, dt, Bm, Cm, A, y, hL, ws_h, ws_p, s);
  return cudaGetLastError();
}

template <int EG>
cudaError_t run(const float* u, const float* dt, const float* Bm,
                const float* Cm, const float* A, float* y, float* hL,
                float* ws_h, float* ws_p, const Shape& s, unsigned blocks,
                cudaStream_t stream) {
  if (s.segs > 1) {
    cudaError_t e = launch_scan<EG, true>(u, dt, Bm, Cm, A, y, nullptr,
                                          ws_h, ws_p, s, blocks, stream);
    if (e != cudaSuccess) return e;
    const size_t nd = (size_t)s.N * s.D, count = (size_t)s.B * nd;
    if (count > 0) {
      carry_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
          ws_h, ws_p, count, s.segs, nd);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  }
  return launch_scan<EG, false>(u, dt, Bm, Cm, A, y, hL, ws_h, ws_p, s,
                                blocks, stream);
}

// The launcher's guard: the sizes it takes, a plan of the shapes the
// kernel is built for (nl lanes a power of two to 32, eg 1, 4 or 8, a
// power of two of warps to MAX_WARPS, whole groups a chunk, segments of
// whole chunks that cover L and no more), its shared memory within the
// card's and its grid within an int, and the workspace it needs.
bool plan_ok(int B, int L, int D, int N, int nl, int eg, int warps,
             int chunk, int segs, int seg_len, const float* ws_h,
             const float* ws_p) {
  const auto pow2 = [](int v) { return v >= 1 && (v & (v - 1)) == 0; };
  if (!(B >= 1 && L >= 1 && D >= 1 && N >= 0 && pow2(nl) && nl <= 32 &&
        (eg == 1 || eg == 4 || eg == 8) && pow2(warps) &&
        warps <= MAX_WARPS && chunk >= GROUP && chunk % GROUP == 0 &&
        segs >= 1 && seg_len >= 1 && seg_len % chunk == 0 &&
        (long long)segs * seg_len >= L &&
        (long long)(segs - 1) * seg_len < L &&
        (ws_h != nullptr || (segs == 1 && N <= nl * eg)) &&
        (ws_p != nullptr || segs == 1)))
    return false;
  const long long DB = (long long)warps * (32 / nl);
  const long long blocks = (long long)B * segs * ((D + DB - 1) / DB);
  const size_t words = 5 * (size_t)chunk * DB + 4 * (size_t)chunk * nl * eg;
  return blocks <= INT_MAX && words * sizeof(float) <= MAX_SMEM;
}

}  // namespace

// All pointers are device pointers to contiguous float32 arrays on card
// `device`: u, dt and y (B, L, D), Bm and Cm (B, L, N), A (D, N); hL
// (B, D, N), which takes the end state, or null for none; ws_h a
// (B, segs, N, D) workspace where segs > 1 or N > nl eg (else null), ws_p
// the same where segs > 1.  The plan (nl, eg, warps, chunk, segs,
// seg_len) is `mamba_scan.scan_plan`'s.  Every launch goes on `stream`
// and none synchronises.  Returns the CUDA error code of the first launch
// that failed (0 on success); cudaErrorInvalidValue for a plan the
// kernel does not take.
extern "C" int mamba_scan(const float* u, const float* dt, const float* Bm,
                          const float* Cm, const float* A, float* y,
                          float* hL, float* ws_h, float* ws_p, int B, int L,
                          int D, int N, int nl, int eg, int warps, int chunk,
                          int segs, int seg_len, int device, void* stream) {
  const auto aligned = [](const float* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const long long DB = (long long)warps * (32 / (nl >= 1 ? nl : 1));
  const Shape s{B, L, D, N, nl, warps, chunk, segs, seg_len,
                D % 4 == 0 && DB % 4 == 0 && aligned(u) && aligned(dt),
                N % 4 == 0 && nl * eg % 4 == 0 && aligned(Bm) &&
                    aligned(Cm)};
  if (!plan_ok(B, L, D, N, nl, eg, warps, chunk, segs, seg_len, ws_h, ws_p))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)((long long)B * segs * ((D + DB - 1) / DB));
  switch (eg) {
    case 1:
      return (int)run<1>(u, dt, Bm, Cm, A, y, hL, ws_h, ws_p, s, nb, st);
    case 4:
      return (int)run<4>(u, dt, Bm, Cm, A, y, hL, ws_h, ws_p, s, nb, st);
    default:
      return (int)run<8>(u, dt, Bm, Cm, A, y, hL, ws_h, ws_p, s, nb, st);
  }
}

// The launcher's guard alone (plan_ok), on the launcher's own arguments
// but the device and the stream: 1 where mamba_scan would launch, 0 where
// it would return cudaErrorInvalidValue.  Launches nothing and touches no
// device.
extern "C" int mamba_scan_plan_ok(const float* u, const float* dt,
                                  const float* Bm, const float* Cm,
                                  const float* A, float* y, float* hL,
                                  float* ws_h, float* ws_p, int B, int L,
                                  int D, int N, int nl, int eg, int warps,
                                  int chunk, int segs, int seg_len) {
  return plan_ok(B, L, D, N, nl, eg, warps, chunk, segs, seg_len, ws_h,
                 ws_p);
}
