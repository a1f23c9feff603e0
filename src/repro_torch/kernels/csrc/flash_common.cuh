// Pieces shared by the prefill attention kernel (flash_attention.cu) and
// its gradient (flash_attention_bwd.cu) on Hopper (sm_90a): cp.async
// staging of tiles in the inputs' dtype, the 3xTF32 mma.sync products of
// the float32 paths, and the wgmma products of the bfloat16 paths over
// the no-swizzle core-matrix layout.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

using bf16_t = __nv_bfloat16;

// -- cp.async staging ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !in (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared; zero when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [row0, row0 + ROWS) of a (n_rows, hd) array into `dst`; rows
// past n_rows become zeros, and the chunks past hd are left alone (zeroed
// once at the start).  bfloat16: the no-swizzle wgmma layout, 8-row x
// 16-byte core matrices in (row group, chunk) order, so chunk e of the
// tile lands at byte 16 e.  float32: row-major rows of HDP + 4 floats.
template <int HDP, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int row0,
                                           int n_rows, int hd) {
  constexpr int EPC = 16 / sizeof(T);    // elements a chunk
  constexpr int CPR = HDP / EPC;         // chunks a row
  const int live = hd / EPC;
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    int row, c;
    T* d;
    if constexpr (sizeof(T) == 2) {
      row = (e >> 3) / CPR * 8 + (e & 7);
      c = (e >> 3) % CPR;
      d = dst + e * 8;
    } else {
      row = e / CPR;
      c = e % CPR;
      d = dst + row * (HDP + 4) + c * 4;
    }
    if (c >= live) continue;
    const bool in = row0 + row < n_rows;
    cp_async16(d, src + (size_t)(in ? row0 + row : 0) * hd + c * EPC, in);
  }
}

template <int BYTES, int THREADS>
__device__ __forceinline__ void zero_smem(void* smem) {
  for (int i = threadIdx.x; i < BYTES / 16; i += THREADS)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
}

// 2^x, flushing a result below 2^-126 to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- float32: 3xTF32 on mma.sync.m16n8k8 ---------------------------------

struct Split {
  uint32_t hi, lo;
};

// hi = x rounded to TF32 (10 mantissa bits, to nearest with ties away
// from zero: the bits of cvt.rna.tf32.f32, which compiles to a longer
// compare-and-select sequence; finite x only), lo = x - hi exactly; the
// tensor core reads lo's top 11 bits
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b with a = (ah, al) and b = (b0, b1) split: the cross terms
// first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], Split b0,
                                           Split b1) {
  mma_tf32(d, al, b0.hi, b1.hi);
  mma_tf32(d, ah, b0.lo, b1.lo);
  mma_tf32(d, ah, b0.hi, b1.hi);
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split_tf32(x[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// -- bfloat16: wgmma -------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between core matrices adjacent in K (`lbo`) and in M or N (`sbo`)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups are pending (they complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the generic-proxy writes to shared memory (cp.async, zeros) before the
// wgmma reads of the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* d) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, float32) += A (64 x 16, K-major) B (16 x N, K-major), both
// bfloat16 from shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db);
// D (64 x N, float32) += A (64 x 16, bfloat16 registers) B (16 x N,
// bfloat16 shared memory, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// D (64 x NC) += A B for the 16 rows of step kk of a staged tile whose
// rows are the product's K and whose columns, from `base` on, its N: the
// tile in the core-matrix layout of rows of LDH elements, read as an
// MN-major B (the transpose bit), N in chunks of 64, 32 and 16 (wgmma's
// N).  `base` is the tile plus 8 x its first column (a multiple of 8).
template <int LDH, int NC>
__device__ __forceinline__ void mn_step(float* acc, const uint32_t* a,
                                        const bf16_t* base, int kk) {
  constexpr uint32_t LBO = LDH * 16;   // 8 rows on: LDH / 8 core matrices
  constexpr uint32_t SBO = 128;        // 8 columns on: the next one
  const bf16_t* b = base + kk * 16 * LDH;
#pragma unroll
  for (int c = 0; c < NC / 64; ++c)
    wgmma_rs<64>(acc + 32 * c, a, smem_desc(b + 64 * 8 * c, LBO, SBO));
  constexpr int n0 = NC / 64 * 64;
  if constexpr (NC % 64 >= 32)
    wgmma_rs<32>(acc + n0 / 2, a, smem_desc(b + n0 * 8, LBO, SBO));
  constexpr int n1 = NC / 32 * 32;
  if constexpr (NC % 32 == 16)
    wgmma_rs<16>(acc + n1 / 2, a, smem_desc(b + n1 * 8, LBO, SBO));
}

// A float32 tile in the accumulator layout -> its two bfloat16 pieces as
// A fragments, x_hi = bf16(x) and x_lo = bf16(x - x_hi): the
// accumulator's 16 columns of step kk are the A fragment's, pair by pair
template <int NJ>
__device__ __forceinline__ void split_p(const float* s, uint32_t* ph,
                                        uint32_t* pl) {
#pragma unroll
  for (int i = 0; i < 2 * NJ; ++i) {
    const float a = s[2 * i], c = s[2 * i + 1];
    ph[i] = pack_bf16(a, c);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&ph[i]);
    pl[i] = pack_bf16(a - __low2float(hi), c - __high2float(hi));
  }
}

}  // namespace flash
