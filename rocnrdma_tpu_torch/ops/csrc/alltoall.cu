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
//   1. copies x[r, r] into out[r, r];
//   2. global barrier: signals the barrier flag of lane b on every other
//      rank, then waits for n-1 signals on its own (_global_barrier);
//   3. direct writes: for s = 1..n-1, d = (r+s) mod n, copies x[r, d] into
//      out[d, r]. No slots and no credits: every destination row is written
//      exactly once, so nothing has to wait for a consumer;
//   4. arrivals: after its writes, publishes one arrival on each
//      destination's lane b (a system-scope release add), then waits until
//      its own arrival count reaches n-1: the drain of _alltoall_kernel
//      (:286-287), after which every chunk of its output lane has landed.
// Flags are zeroed by the wrapper's memset before each launch. Every block
// spins on blocks of every rank, so all n*lanes blocks must be resident at
// once: the launch is cooperative and a grid that cannot be is refused.
//
// Bound on the H100: device-memory bytes. Each chunk is read once and
// written once: 2*n*S bytes over all ranks for S bytes per rank, which is
// also the least any alltoall must move, so this kernel can reach its
// bound. Design against it: 16-byte vector copies with four loads in flight
// per thread, and lanes sized so n*lanes blocks cover the SMs about twice.
#include "common.cuh"

#define RNR_MAX_RANKS 32
#define RNR_A2A_FLAG_WORDS 2  // per lane: barrier, arrivals
#define RNR_A2A_BAR 0
#define RNR_A2A_ARR 1
#define RNR_MIN_LANE_ELEMS 1024

struct A2AArgs {
  const void* src[RNR_MAX_RANKS];  // rank input rows, n * per elements
  void* dst[RNR_MAX_RANKS];        // rank output rows, n * per elements
  unsigned* flags[RNR_MAX_RANKS];  // rank flag words, lanes * 2
  int n;
  int lanes;
  long long per;   // chunk elements (multiple of 128)
  long long lane;  // lane elements (multiple of 128)
};

template <typename T>
__global__ void __launch_bounds__(RNR_BLOCK_THREADS)
    alltoall_kernel(const A2AArgs a) {
  const int n = a.n;
  const int r = blockIdx.x / a.lanes;
  const int b = blockIdx.x % a.lanes;
  const long long lo = (long long)b * a.lane;
  const long long hi = lo + a.lane < a.per ? lo + a.lane : a.per;
  const long long bytes = hi > lo ? (hi - lo) * (long long)sizeof(T) : 0;
  const T* x = reinterpret_cast<const T*>(a.src[r]);
  unsigned* my_f = a.flags[r] + b * RNR_A2A_FLAG_WORDS;

  // 1. my own chunk stays home
  copy16(reinterpret_cast<T*>(a.dst[r]) + r * a.per + lo, x + r * a.per + lo, bytes);

  // 2. global barrier over lane b of every rank
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int s = 1; s < n; ++s)
      add_release(a.flags[wrap(r + s, n)] + b * RNR_A2A_FLAG_WORDS + RNR_A2A_BAR, 1u);
  }
  wait_geq(my_f + RNR_A2A_BAR, (unsigned)(n - 1));

  // 3. direct writes: my chunk for rank d lands in d's row for source r
  for (int s = 1; s < n; ++s) {
    const int d = wrap(r + s, n);
    copy16(reinterpret_cast<T*>(a.dst[d]) + r * a.per + lo, x + d * a.per + lo, bytes);
  }

  // 4. one arrival on every destination, then wait for all of mine
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int s = 1; s < n; ++s)
      add_release(a.flags[wrap(r + s, n)] + b * RNR_A2A_FLAG_WORDS + RNR_A2A_ARR, 1u);
  }
  wait_geq(my_f + RNR_A2A_ARR, (unsigned)(n - 1));
}

template <typename T>
static int max_coresident(int* total) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, alltoall_kernel<T>, RNR_BLOCK_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int sms = rnr_sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *total = per_sm * sms;
  return 0;
}

// Lanes per rank for n ranks and `per`-element chunks, as rnr_ring_lanes
// chooses them: about two blocks per SM over all ranks, at least
// RNR_MIN_LANE_ELEMS elements a lane, and never more than can be resident
// at once. A lane's block waits on lane b of all n-1 peers, so it is the
// whole n*lanes grid that has to fit. Returns lanes (> 0) or -cudaError.
extern "C" int rnr_a2a_lanes(int n, long long per, int dtype) {
  if (n < 2 || n > RNR_MAX_RANKS || per <= 0 || per % 128) return -(int)cudaErrorInvalidValue;
  int total = 0, e;
  if (dtype == RNR_DTYPE_F32)
    e = max_coresident<float>(&total);
  else if (dtype == RNR_DTYPE_BF16)
    e = max_coresident<__nv_bfloat16>(&total);
  else
    return -(int)cudaErrorInvalidValue;
  if (e) return -e;
  const int sms = rnr_sm_count();
  long long lanes = (per + RNR_MIN_LANE_ELEMS - 1) / RNR_MIN_LANE_ELEMS;
  long long cap = (2LL * sms + n - 1) / n;
  if (lanes > cap) lanes = cap;
  if (lanes > total / n) lanes = total / n;
  if (lanes < 1) lanes = 1;
  const long long lane = rnr_lane_elems(per, (int)lanes);
  return (int)((per + lane - 1) / lane);  // no empty lanes
}

extern "C" int rnr_alltoall(const void* const* src, void* const* dst,
                            void* const* flags, int n, long long per,
                            int lanes, int dtype, void* flags_base,
                            long long flags_bytes, void* stream) {
  if (n < 2 || n > RNR_MAX_RANKS || lanes < 1 || per <= 0 || per % 128)
    return (int)cudaErrorInvalidValue;
  A2AArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.src[r] = src[r];
    a.dst[r] = dst[r];
    a.flags[r] = reinterpret_cast<unsigned*>(flags[r]);
  }
  a.n = n;
  a.lanes = lanes;
  a.per = per;
  a.lane = rnr_lane_elems(per, lanes);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags_base, 0, (size_t)flags_bytes, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  const void* fn;
  if (dtype == RNR_DTYPE_F32)
    fn = reinterpret_cast<const void*>(alltoall_kernel<float>);
  else if (dtype == RNR_DTYPE_BF16)
    fn = reinterpret_cast<const void*>(alltoall_kernel<__nv_bfloat16>);
  else
    return (int)cudaErrorInvalidValue;
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)(n * lanes)),
                                  dim3(RNR_BLOCK_THREADS), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* rnr_a2a_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
