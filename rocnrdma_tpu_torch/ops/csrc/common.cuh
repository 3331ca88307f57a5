// Shared device helpers of the port's kernels: the elementwise fold in
// fp32 or bf16, the flag protocol, and 16-byte vector copies.
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

// ---------------------------------------------------------------------------
// Flag protocol of the kernels whose blocks talk to each other (ring.cu,
// alltoall.cu). Flags are 32-bit words in device memory, stored with
// system-scope release and read with acquire loads, the counterpart of the
// TPU's DMA and barrier semaphores. Blocks of these kernels run with
// RNR_BLOCK_THREADS threads.

#define RNR_BLOCK_THREADS 256

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.sys.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// One thread spins until *p >= v; the block then proceeds together.
__device__ __forceinline__ void wait_geq(const unsigned* p, unsigned v) {
  if (threadIdx.x == 0) {
    while (ld_acquire(p) < v) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// Every thread's prior writes, then one release of the flag.
__device__ __forceinline__ void publish(unsigned* p, unsigned v, bool add) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (add)
      add_release(p, v);
    else
      st_release(p, v);
  }
}

// dst[i] = src[i] over `bytes` (a multiple of 16). Loads bypass L1 with
// __ldcg: the source may have been written by another block.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                      long long bytes) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  const long long nv = bytes / 16;
  const int T = RNR_BLOCK_THREADS;
  long long i = threadIdx.x;
  for (; i + 3 * T < nv; i += 4 * T) {
    uint4 v0 = __ldcg(s + i), v1 = __ldcg(s + i + T);
    uint4 v2 = __ldcg(s + i + 2 * T), v3 = __ldcg(s + i + 3 * T);
    __stcg(d + i, v0);
    __stcg(d + i + T, v1);
    __stcg(d + i + 2 * T, v2);
    __stcg(d + i + 3 * T, v3);
  }
  for (; i < nv; i += T) __stcg(d + i, __ldcg(s + i));
}

__device__ __forceinline__ int wrap(int v, int n) { return ((v % n) + n) % n; }

// Lane width of a kernel whose rank runs `lanes` blocks over `elems`
// elements: a multiple of 128 elements, so every lane starts 16-byte
// aligned.
static inline long long rnr_lane_elems(long long elems, int lanes) {
  long long l = (elems + lanes - 1) / lanes;
  return (l + 127) / 128 * 128;
}
