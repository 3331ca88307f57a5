// alltoall.cu: the direct alltoall, every chunk written once, straight into
// its destination's output row.
//
// Replaces: rocnrdma_tpu/ops/ring_pallas.py, pallas_alltoall (body
// _alltoall_kernel, barrier _global_barrier). pallas_alltoallv wraps the
// same kernel and masks at the receiver; so does the port's alltoallv.
//
// Layout: `src[r]` is rank r's (n, per) input row, chunk d destined for
// rank d; `dst[r]` is rank r's (n, per) output row, chunk j = what rank j
// sent rank r. `per` is a multiple of 128 elements (the wrapper pads each
// chunk row-wise, as ring_pallas.py:306-311 does).
//
// Protocol. Rank r runs `lanes` blocks; block b owns sub-range b of every
// chunk and talks only to block b of the other ranks. Each block, in order:
//   1. entry barrier: one arrival on the barrier word of lane b of every
//      other rank, then wait for n-1 on its own (_global_barrier): every
//      peer has entered, so its output may be overwritten;
//   2. direct writes: each thread loads its vectors of sub-range b from all
//      n chunks of x[r] (one contiguous row) before it stores any, then
//      stores chunk d into out[d, r], its own chunk included. The TPU
//      kernel has its n-1 remote copies in flight at once
//      (ring_pallas.py:276-284); here every thread has n loads in flight.
//      No slots and no credits: every destination row is written exactly
//      once, so nothing waits for a consumer;
//   3. exit: one arrival on the arrival word of lane b of every other rank,
//      then wait for n-1 on its own: the drain of _alltoall_kernel
//      (:286-287), after which every chunk of its output lane has landed.
// Flags are epoch-counted: launch e (from 1) of one flag buffer waits for
// e*(n-1) on each word, so back-to-back launches need no reset (the wrapper
// caches the buffer per device, stream, n and lanes and counts the epoch).
// Every block spins on blocks of every rank, so all n*lanes blocks must be
// resident at once: the launch is cooperative and a grid that cannot be is
// refused.
//
// Across processes (one rank a process) the alltoall runs push_across.cu,
// which also serves the allgather there.
//
// Bound on the H100: device-memory bytes. Each chunk is read once and
// written once: 2*n*S bytes over all ranks for S bytes per rank, which is
// also the least any alltoall must move, so this kernel can reach its
// bound. Design against it: 16-byte vectors, n*U of them in flight per
// thread (about 8), one fence per barrier, and lanes sized so n*lanes
// blocks cover the SMs about four times.
#include "common.cuh"

#define RNR_MAX_RANKS 32
#define RNR_A2A_FLAG_WORDS 2  // per lane: barrier, arrivals
#define RNR_A2A_BAR 0
#define RNR_A2A_ARR 1
#define RNR_A2A_BATCH 8  // chunks loaded together when n > 8

struct A2AArgs {
  const void* src[RNR_MAX_RANKS];  // rank input rows, n * per elements
  void* dst[RNR_MAX_RANKS];        // rank output rows, n * per elements
  unsigned* flags[RNR_MAX_RANKS];  // rank flag words, lanes * 2
  int n;
  int lanes;
  int sync;        // 0: skip barrier and arrivals (timing the data pass)
  unsigned epoch;  // launches of this flag buffer, this one included
  long long per;   // chunk elements (multiple of 128)
  long long lane;  // lane elements (multiple of 128)
  RnrDeadline dl;  // meet's deadline argument (kSys only: unused at kGpu)
};

// The flags' memory-model scope: every rank of a launch lives on one GPU,
// so kGpu orders them all.
constexpr RnrScope kA2AScope = kGpu;

// Sub-range [lo, lo + nv vectors) of every chunk of x[r] into out[d, r],
// d = 0..n-1. Each thread loads vectors i + u*TH (u < U) of B chunks, all
// before its first store: N > 0 is n == N, one batch of N chunks; N == 0 is
// any n, in batches of RNR_A2A_BATCH.
template <typename T, int N>
__device__ __forceinline__ void scatter(const A2AArgs& a, int n, int r,
                                        long long lo, long long nv) {
  constexpr int B = N > 0 ? N : RNR_A2A_BATCH;
  constexpr int U = B >= 8 ? 1 : 8 / B;
  const int TH = RNR_BLOCK_THREADS;
  const long long cv = a.per * (long long)sizeof(T) / 16;  // vectors a chunk
  const uint4* in = reinterpret_cast<const uint4*>(static_cast<const T*>(a.src[r]) + lo);
  const long long at = (r * a.per + lo) * (long long)sizeof(T) / 16;
  for (long long i = threadIdx.x; i < nv; i += U * TH) {
    for (int d0 = 0; d0 < n; d0 += B) {
      uint4 v[B][U];
#pragma unroll
      for (int j = 0; j < B; ++j)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if ((N > 0 || d0 + j < n) && i + u * TH < nv)
            v[j][u] = __ldcg(in + (d0 + j) * cv + i + u * TH);
#pragma unroll
      for (int j = 0; j < B; ++j)
        if (N > 0 || d0 + j < n) {
          uint4* q = reinterpret_cast<uint4*>(a.dst[d0 + j]) + at + i;
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (i + u * TH < nv) __stcg(q + u * TH, v[j][u]);
        }
    }
  }
}

template <typename T, int N, RnrScope S>
__global__ void __launch_bounds__(RNR_BLOCK_THREADS)
    alltoall_kernel(const A2AArgs a) {
  const int n = N > 0 ? N : a.n;
  const int r = blockIdx.x / a.lanes;
  const int b = blockIdx.x % a.lanes;
  const long long lo = (long long)b * a.lane;
  const long long hi = lo + a.lane < a.per ? lo + a.lane : a.per;
  const long long nv = hi > lo ? (hi - lo) * (long long)sizeof(T) / 16 : 0;
  const unsigned target = a.epoch * (unsigned)(n - 1);

  if (a.sync) meet<S>(a.flags, n, r, b * RNR_A2A_FLAG_WORDS + RNR_A2A_BAR, target, a.dl);
  scatter<T, N>(a, n, r, lo, nv);
  if (a.sync) meet<S>(a.flags, n, r, b * RNR_A2A_FLAG_WORDS + RNR_A2A_ARR, target, a.dl);
}

template <typename T, RnrScope S = kA2AScope>
static const void* a2a_fn(int n) {
  switch (n) {
    case 2: return reinterpret_cast<const void*>(alltoall_kernel<T, 2, S>);
    case 3: return reinterpret_cast<const void*>(alltoall_kernel<T, 3, S>);
    case 4: return reinterpret_cast<const void*>(alltoall_kernel<T, 4, S>);
    case 5: return reinterpret_cast<const void*>(alltoall_kernel<T, 5, S>);
    case 6: return reinterpret_cast<const void*>(alltoall_kernel<T, 6, S>);
    case 7: return reinterpret_cast<const void*>(alltoall_kernel<T, 7, S>);
    case 8: return reinterpret_cast<const void*>(alltoall_kernel<T, 8, S>);
    default: return reinterpret_cast<const void*>(alltoall_kernel<T, 0, S>);
  }
}

// The kernel for n ranks of `dtype`, or null for another dtype.
static const void* kernel_for(int n, int dtype) {
  if (dtype == RNR_DTYPE_F32) return a2a_fn<float>(n);
  if (dtype == RNR_DTYPE_BF16) return a2a_fn<__nv_bfloat16>(n);
  return nullptr;
}

// Lanes per rank for n ranks and `per`-element chunks on `device`, as
// rnr_ring_lanes chooses them (common.cuh, rnr_lanes). One occupancy query:
// the wrapper caches the answer per shape. Returns lanes (> 0) or
// -cudaError.
extern "C" int rnr_a2a_lanes(int n, long long per, int dtype, int device) {
  const void* fn = kernel_for(n, dtype);
  if (n < 2 || n > RNR_MAX_RANKS || per <= 0 || per % 128 || fn == nullptr)
    return -(int)cudaErrorInvalidValue;
  int lanes = 0;
  const int rc = rnr_on_device(device, [&] {
    lanes = rnr_lanes(fn, n, per);
    return lanes < 0 ? -lanes : 0;
  });
  return rc ? -rc : lanes;
}

// Fills the rest of `a` (its row pointers set) and launches all n ranks'
// blocks on `device`.
static int launch(A2AArgs& a, int n, long long per, int lanes, int dtype,
                  unsigned epoch, int sync, int device, void* stream) {
  const void* fn = kernel_for(n, dtype);
  if (lanes < 1 || per <= 0 || per % 128 || fn == nullptr)
    return (int)cudaErrorInvalidValue;
  a.n = n;
  a.lanes = lanes;
  a.sync = sync;
  a.epoch = epoch;
  a.per = per;
  a.lane = rnr_lane_elems(per, lanes);
  const unsigned blocks = (unsigned)(n * lanes);
  void* args[] = {&a};
  return rnr_on_device(device, [&] {
    return (int)cudaLaunchCooperativeKernel(
        fn, dim3(blocks), dim3(RNR_BLOCK_THREADS), args, 0,
        reinterpret_cast<cudaStream_t>(stream));
  });
}

static void fill(A2AArgs& a, const void* const* src, void* const* dst,
                 void* const* flags, int n) {
  for (int r = 0; r < n; ++r) {
    a.src[r] = src[r];
    a.dst[r] = dst[r];
    a.flags[r] = reinterpret_cast<unsigned*>(flags[r]);
  }
}

// One launch on `device`, the ranks' rows given as pointer tables (one
// pointer a rank). `epoch` counts the launches of this flag buffer, this
// one included; `sync` 0 skips the barrier and the arrivals and leaves the
// flags alone.
extern "C" int rnr_alltoall(const void* const* src, void* const* dst,
                            void* const* flags, int n, long long per,
                            int lanes, int dtype, unsigned epoch, int sync,
                            int device, void* stream) {
  if (n < 2 || n > RNR_MAX_RANKS) return (int)cudaErrorInvalidValue;
  A2AArgs a = {};
  fill(a, src, dst, flags, n);
  return launch(a, n, per, lanes, dtype, epoch, sync, device, stream);
}

// The same launch with every rank's row in one tensor: row r of `src`,
// `dst` and `flags` at base + r * stride (strides in bytes). The tables are
// built here, not by the caller.
extern "C" int rnr_alltoall_rows(const void* src, long long src_stride,
                                 void* dst, long long dst_stride, void* flags,
                                 long long flags_stride, int n, long long per,
                                 int lanes, int dtype, unsigned epoch, int sync,
                                 int device, void* stream) {
  if (n < 2 || n > RNR_MAX_RANKS) return (int)cudaErrorInvalidValue;
  A2AArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.src[r] = static_cast<const char*>(src) + r * src_stride;
    a.dst[r] = static_cast<char*>(dst) + r * dst_stride;
    a.flags[r] = reinterpret_cast<unsigned*>(static_cast<char*>(flags) + r * flags_stride);
  }
  return launch(a, n, per, lanes, dtype, epoch, sync, device, stream);
}

extern "C" const char* rnr_a2a_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
