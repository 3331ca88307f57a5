// combine.cu: the k-operand streaming sum out = x0 + x1 + ... + x(k-1).
//
// Replaces: rocnrdma_tpu/ops/local_pallas.py, pallas_hbm_combine
// (kernel body _hbm_combine_kernel), the on-chip half of a ring step that
// bench_local times against the plain add chain.
//
// Bound on the H100: device-memory bytes. Every element is read once from
// each of the k operands and written once: (k+1) * E * itemsize bytes at
// 3.35 TB/s; the k-1 adds per element are far below the fp32 rate.
//
// Design: the Pallas kernel streams (tile_rows, 128) tiles through an
// n_slots-deep rotation of VMEM slots with explicit async DMAs, because the
// TPU core runs its grid in order and must overlap copies by hand. On Hopper
// the loads a thread has in flight do that job, so the kernel is
// instantiated for each k in 2..8: each thread issues the loads of all k
// operands for RNR_COMBINE_VECS 16-byte vectors (2k loads) before the first
// add, then folds x0 + x1 + ... left to right with fold_left (common.cuh),
// rounding to bf16 after every add as the reference's `acc = acc + x` in
// the working dtype does (local_pallas.py:83-85). One group of vectors a
// thread and as many blocks as groups, which ran faster on the H100 than a
// grid capped at the resident blocks with a grid stride, and than 4 or 8
// vectors a thread (bench/bench_kernel_variants.py). The last block also
// folds the ragged tail of fewer than one vector, element by element.
#include "common.cuh"

#define RNR_MAX_OPERANDS 8
#define RNR_COMBINE_THREADS 256
#define RNR_COMBINE_VECS 2  // 16-byte vectors a thread holds per operand

struct CombineArgs {
  const void* x[RNR_MAX_OPERANDS];
  void* out;
  long long n;  // elements per operand
};

template <typename T, int K>
__global__ void __launch_bounds__(RNR_COMBINE_THREADS)
    combine_kernel(const CombineArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = RNR_COMBINE_VECS;
  const int TH = RNR_COMBINE_THREADS;
  const long long nv = a.n / VEC;
  const long long i = (long long)blockIdx.x * TH * U + threadIdx.x;
  if (i + (U - 1) * TH < nv) {
    uint4 v[U][K];
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int u = 0; u < U; ++u)
        v[u][j] = __ldg(reinterpret_cast<const uint4*>(a.x[j]) + i + u * TH);
#pragma unroll
    for (int u = 0; u < U; ++u)
      reinterpret_cast<uint4*>(a.out)[i + u * TH] = fold_left<T, K>(v[u]);
  } else {  // the group cut by the end
    for (int u = 0; u < U && i + u * TH < nv; ++u) {
      uint4 v[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        v[j] = __ldg(reinterpret_cast<const uint4*>(a.x[j]) + i + u * TH);
      reinterpret_cast<uint4*>(a.out)[i + u * TH] = fold_left<T, K>(v);
    }
  }
  if (blockIdx.x == gridDim.x - 1) {  // ragged tail (< VEC elements)
    for (long long e = nv * VEC + threadIdx.x; e < a.n; e += TH) {
      T acc = reinterpret_cast<const T*>(a.x[0])[e];
#pragma unroll
      for (int j = 1; j < K; ++j)
        acc = Fold<T>::add(acc, reinterpret_cast<const T*>(a.x[j])[e]);
      reinterpret_cast<T*>(a.out)[e] = acc;
    }
  }
}

template <typename T, int K>
static int launch_k(CombineArgs a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long group = (long long)RNR_COMBINE_THREADS * RNR_COMBINE_VECS;
  const long long blocks = (a.n / VEC + group) / group;  // >= 1, for the tail
  void* args[] = {&a};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(combine_kernel<T, K>),
                               dim3((unsigned)blocks), dim3(RNR_COMBINE_THREADS),
                               args, 0, stream);
}

template <typename T>
static int launch(const CombineArgs& a, int k, cudaStream_t s) {
  switch (k) {
    case 2: return launch_k<T, 2>(a, s);
    case 3: return launch_k<T, 3>(a, s);
    case 4: return launch_k<T, 4>(a, s);
    case 5: return launch_k<T, 5>(a, s);
    case 6: return launch_k<T, 6>(a, s);
    case 7: return launch_k<T, 7>(a, s);
    case 8: return launch_k<T, 8>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out = x0 + ... + x(k-1) over n elements on `device`.
extern "C" int rnr_combine(const void* const* xs, int k, void* out,
                           long long n, int dtype, int device, void* stream) {
  if (k < 2 || k > RNR_MAX_OPERANDS || n <= 0) return (int)cudaErrorInvalidValue;
  CombineArgs a = {};
  for (int j = 0; j < k; ++j) a.x[j] = xs[j];
  a.out = out;
  a.n = n;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return rnr_on_device(device, [&] {
    if (dtype == RNR_DTYPE_F32) return launch<float>(a, k, s);
    if (dtype == RNR_DTYPE_BF16) return launch<__nv_bfloat16>(a, k, s);
    return (int)cudaErrorInvalidValue;
  });
}

extern "C" const char* rnr_combine_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
