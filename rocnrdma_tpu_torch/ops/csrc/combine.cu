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
// thousands of threads keep loads in flight on their own, so this first
// kernel is a plain grid-stride loop over 16-byte vectors: each thread loads
// one vector of every operand, folds left to right and stores once. The
// fold rounds to bf16 after every add, as the reference's `acc = acc + x`
// in the working dtype does (local_pallas.py:83-85). Staging through shared
// memory with cp.async/TMA is later work.
#include "common.cuh"

#define RNR_MAX_OPERANDS 8
#define RNR_COMBINE_THREADS 256

struct CombineArgs {
  const void* x[RNR_MAX_OPERANDS];
  void* out;
  int k;
  long long n;  // elements per operand
};

template <typename T>
__global__ void __launch_bounds__(RNR_COMBINE_THREADS)
    combine_kernel(const CombineArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  const long long nv = a.n / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = tid; i < nv; i += stride) {
    uint4 acc = reinterpret_cast<const uint4*>(a.x[0])[i];
    for (int j = 1; j < a.k; ++j)
      acc = Fold<T>::add16(acc, reinterpret_cast<const uint4*>(a.x[j])[i]);
    reinterpret_cast<uint4*>(a.out)[i] = acc;
  }
  // ragged tail (< VEC elements), element by element
  for (long long e = nv * VEC + tid; e < a.n; e += stride) {
    T acc = reinterpret_cast<const T*>(a.x[0])[e];
    for (int j = 1; j < a.k; ++j)
      acc = Fold<T>::add(acc, reinterpret_cast<const T*>(a.x[j])[e]);
    reinterpret_cast<T*>(a.out)[e] = acc;
  }
}

template <typename T>
static int launch(const CombineArgs& a, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, combine_kernel<T>, RNR_COMBINE_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int sms = rnr_sm_count();
  if (sms <= 0) return (int)cudaGetLastError();
  long long work = a.n / VEC + 1;
  long long blocks = (work + RNR_COMBINE_THREADS - 1) / RNR_COMBINE_THREADS;
  long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  combine_kernel<T><<<(unsigned)blocks, RNR_COMBINE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int rnr_combine(const void* const* xs, int k, void* out,
                           long long n, int dtype, void* stream) {
  if (k < 2 || k > RNR_MAX_OPERANDS || n <= 0) return (int)cudaErrorInvalidValue;
  CombineArgs a = {};
  for (int j = 0; j < k; ++j) a.x[j] = xs[j];
  a.out = out;
  a.k = k;
  a.n = n;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == RNR_DTYPE_F32) return launch<float>(a, s);
  if (dtype == RNR_DTYPE_BF16) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rnr_combine_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
