// Shared device helpers of the port's kernels: 16-byte vector copies and
// the elementwise fold, in fp32 or bf16.
//
// The fold is `a + b` per element, computed in fp32 with __fadd_rn (no FMA,
// no reassociation) and, for bf16, rounded back to bf16 after every add
// (__float2bfloat16_rn): the same arithmetic as one bf16 add of the JAX
// reference and of PyTorch, so a kernel equals its plain version bit for
// bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RNR_DTYPE_F32 0
#define RNR_DTYPE_BF16 1

template <typename T>
struct Fold;

template <>
struct Fold<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ uint4 add16(uint4 a, uint4 b) {
    uint4 o;
    o.x = __float_as_uint(__fadd_rn(__uint_as_float(a.x), __uint_as_float(b.x)));
    o.y = __float_as_uint(__fadd_rn(__uint_as_float(a.y), __uint_as_float(b.y)));
    o.z = __float_as_uint(__fadd_rn(__uint_as_float(a.z), __uint_as_float(b.z)));
    o.w = __float_as_uint(__fadd_rn(__uint_as_float(a.w), __uint_as_float(b.w)));
    return o;
  }
};

template <>
struct Fold<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
    __nv_bfloat162 pa = *reinterpret_cast<__nv_bfloat162*>(&a);
    __nv_bfloat162 pb = *reinterpret_cast<__nv_bfloat162*>(&b);
    float2 fa = __bfloat1622float2(pa);
    float2 fb = __bfloat1622float2(pb);
    __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(fa.x, fb.x),
                                             __fadd_rn(fa.y, fb.y));
    return *reinterpret_cast<uint32_t*>(&r);
  }
  static __device__ __forceinline__ uint4 add16(uint4 a, uint4 b) {
    uint4 o;
    o.x = add2(a.x, b.x);
    o.y = add2(a.y, b.y);
    o.z = add2(a.z, b.z);
    o.w = add2(a.w, b.w);
    return o;
  }
};

static inline int rnr_sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return -1;
  return sms;
}
