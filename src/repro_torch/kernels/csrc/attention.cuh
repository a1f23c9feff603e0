// Pieces shared by the attention kernels for Hopper (sm_90a):
// flash_attention.cu (prefill) and decode_attention.cu (one token against
// a cache).  Both read float32 or bfloat16 and compute in float32,
// the softmax weight p included: the Pallas kernels cast v to float32
// before the PV product (`v = v_ref[...].astype(jnp.float32)`), so their
// `p.astype(v.dtype)` leaves p float32 for bfloat16 inputs too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float NEG_INF = -1e30f;  // the masked score, as in Pallas

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace attn
