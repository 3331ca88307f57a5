// push_across.cu: allgather and alltoall across processes, one rank a
// process, as one push kernel: each rank stores its pieces straight into
// its peers' rows and drains what its peers pushed into its own row while
// its next pushes are on the wire.
//
// Replaces, in their form across processes (a 1-D mesh that spans
// processes, ops/ipc.py): rocnrdma_tpu/ops/ring_pallas.py::pallas_alltoall
// (body _alltoall_kernel; pallas_alltoallv wraps it and masks at the
// receiver, as the port's alltoallv_across does) and
// ::pallas_ring_allgather (body _ring_allgather_kernel). Allgather is the
// alltoall whose n pieces are one chunk, so one kernel serves both: its
// source stride is 0 for allgather and the piece's length for alltoall.
// The one-process forms stay in alltoall.cu and ring.cu (mode AG).
//
// Layout, in 16-byte vectors: rank r's n pieces of `pv` vectors start at
// `src` (piece d at d * src_stride), the caller's tensor itself when it is
// contiguous and aligned, else a staged copy. `dst[q]` is rank q's
// workspace output row (ops/ipc.py), slot j (j * pv) what rank j pushed
// it. `out` is rank r's result, the caller's output tensor, slot j what
// rank j sent rank r.
//
// Protocol. Rank r runs `lanes` blocks; block b owns vectors [b*lane,
// (b+1)*lane) of every piece, cut into `steps` sub-steps, and talks only to
// block b of the other ranks. Its flag words, in every rank's flags: one
// barrier word and RNR_PUSH_MAX_STEPS arrival words, one a sub-step.
//   1. entry barrier: one arrival on the barrier word of lane b of every
//      other rank, then wait for n-1 on its own: every peer has entered
//      this launch, so (by its stream order) it has drained its row of the
//      last launch, and its row may be overwritten;
//   2. for each sub-step k: push sub-step k of piece d into rank d's row at
//      slot r, for d = r+1, r+2, ... mod n (the n senders start on n
//      different peers), and rank r's own piece straight into `out`; then,
//      while those remote stores are on the wire, wait for sub-step k-1's
//      arrivals from all n-1 peers and drain it: slots j != r of sub-step
//      k-1 of lane b, from rank r's own row into `out`; then one fence and
//      one arrival on arrival word k of lane b of every other rank;
//   3. wait for the last sub-step's arrivals and drain it.
// Every block raises every one of its lane's arrival words once a launch
// (the last sub-step raises the words past `steps` too), so a launch e
// (from 1) waits for e*(n-1) on each word whatever `steps` each launch
// used, and back-to-back launches need no reset. No peer reads rank r's
// input or `out`: only rank r's stream order guards them. Every wait has a
// deadline (common.cuh, wait_geq_until): a peer that never launches makes
// this launch trap, and the wrapper names the word (ops/ipc.py). Block b
// of rank r waits on block b of its peers, which wait on theirs, so a
// rank's grid must be resident at once: the launch is cooperative.
//
// Bound on the H100: NVLink bytes. Each rank sends (n-1)/n of its row to
// its peers and receives as much, at 450 GB/s each way; HBM carries the
// row's read, the received bytes' arrival, and the drain's read and write,
// about 3.75x the row at n = 4 against 3.35 TB/s, so the link binds.
// Design against it: no copy into or out of the workspace on the stream
// (the drain runs inside the kernel, sub-step k-1 behind sub-step k's
// pushes), 16-byte vectors, `vecs` of them in flight a thread, lanes from
// the blocks the card holds when the rank has its card to itself, and one
// fence a sub-step.
#include "common.cuh"

#define RNR_MAX_RANKS 32
#define RNR_PUSH_MAX_STEPS 8
#define RNR_PUSH_WORDS (1 + RNR_PUSH_MAX_STEPS)  // per lane: barrier, arrivals
#define RNR_PUSH_BAR 0
#define RNR_KERNEL_PUSH 4  // the RNR_DIAG_KERNEL of this kernel

struct PushArgs {
  const uint4* src;             // this rank's pieces
  long long src_stride;         // vectors between pieces: 0 allgather, pv alltoall
  uint4* out;                   // this rank's result, n * pv vectors
  uint4* dst[RNR_MAX_RANKS];    // every rank's workspace output row
  unsigned* flags[RNR_MAX_RANKS];  // every rank's flag words, lanes * RNR_PUSH_WORDS
  int n;
  int rank;
  int steps;        // sub-steps a lane, 1..RNR_PUSH_MAX_STEPS
  unsigned epoch;   // launches of this flag region, this one included
  long long pv;     // vectors a piece
  long long lane;   // vectors a lane
  long long step;   // vectors a sub-step
  RnrDeadline dl;
};

// Vectors [s0, s1) of every piece: piece d of `src` into slot r of rank
// d's row (of `out` for d == r), d = r+1, ..., r+n mod n. Each thread
// loads U vectors of a piece before it stores them; allgather's one piece
// is loaded once for all n stores.
template <int U>
__device__ __forceinline__ void push(const PushArgs& a, long long s0, long long s1) {
  const int n = a.n, r = a.rank;
  const long long at = r * a.pv;
  for (long long i = s0 + threadIdx.x; i < s1; i += U * RNR_BLOCK_THREADS) {
    uint4 v[U];
    if (a.src_stride == 0) load_vecs<U>(v, a.src + i, i, s1);
    for (int s = 1; s <= n; ++s) {
      const int d = (r + s) % n;
      if (a.src_stride != 0) load_vecs<U>(v, a.src + d * a.src_stride + i, i, s1);
      store_vecs<U>((d == r ? a.out : a.dst[d]) + at + i, v, i, s1);
    }
  }
}

// After every thread's pushes of sub-step k: one fence, then one arrival on
// arrival word k of lane `word0`'s words of every other rank (the last
// sub-step: words k..RNR_PUSH_MAX_STEPS-1).
__device__ __forceinline__ void arrive(const PushArgs& a, long long word0, int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence<kSys>();
    const int last = k + 1 < a.steps ? k : RNR_PUSH_MAX_STEPS - 1;
    for (int s = 1; s < a.n; ++s) {
      unsigned* f = a.flags[(a.rank + s) % a.n] + word0 + 1;
      for (int w = k; w <= last; ++w) add_relaxed<kSys>(f + w, 1u);
    }
  }
}

template <int U>
__global__ void __launch_bounds__(RNR_BLOCK_THREADS) push_kernel(const PushArgs a) {
  const int n = a.n, r = a.rank;
  const long long lo = (long long)blockIdx.x * a.lane;
  const long long hi = lo + a.lane < a.pv ? lo + a.lane : a.pv;
  const long long word0 = (long long)blockIdx.x * RNR_PUSH_WORDS;
  const unsigned target = a.epoch * (unsigned)(n - 1);
  unsigned* const mine = a.flags[r];

  meet<kSys>(a.flags, n, r, word0 + RNR_PUSH_BAR, target, a.dl);
  long long p0 = lo, p1 = lo;  // the sub-step pushed last, not yet drained
  for (int k = 0; k < a.steps; ++k) {
    const long long s0 = lo + k * a.step < hi ? lo + k * a.step : hi;
    const long long s1 = s0 + a.step < hi ? s0 + a.step : hi;
    push<U>(a, s0, s1);
    if (k > 0) {
      wait_geq_until<kSys>(mine + word0 + k, target, a.dl, word0 + k);
      drain<U>(a.dst[r], a.out, n, r, a.pv, p0, p1);
    }
    arrive(a, word0, k);
    p0 = s0;
    p1 = s1;
  }
  wait_geq_until<kSys>(mine + word0 + a.steps, target, a.dl, word0 + a.steps);
  drain<U>(a.dst[r], a.out, n, r, a.pv, p0, p1);
}

static const void* push_fn(int vecs) {
  switch (vecs) {
    case 1: return reinterpret_cast<const void*>(push_kernel<1>);
    case 2: return reinterpret_cast<const void*>(push_kernel<2>);
    case 4: return reinterpret_cast<const void*>(push_kernel<4>);
    case 8: return reinterpret_cast<const void*>(push_kernel<8>);
    default: return nullptr;
  }
}

// The blocks of the kernel with `vecs` vectors a thread that `device` holds
// resident at once (blocks an SM times SMs): the most lanes one launch may
// have. Returns blocks (> 0) or -cudaError.
extern "C" int rnr_push_resident(int vecs, int device) {
  const void* fn = push_fn(vecs);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const int rc = rnr_on_device(device, [&] {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, RNR_BLOCK_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    const int sms = rnr_sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    blocks = per_sm * sms;
    return 0;
  });
  return rc ? -rc : blocks;
}

// One launch of rank `rank`'s `lanes` blocks on `stream`. `dst` and `flags`
// are tables of n pointers (peers' mapped from CUDA IPC handles); `src`
// and `out` are this process's, 16-byte aligned. `pv`, `src_stride`,
// `lane` and `step` count 16-byte vectors. Each wait gives up after
// `timeout_ns` (0: never), writing its record into `diag` (mapped host
// words, RNR_DIAG_WORDS) before the launch traps.
extern "C" int rnr_push_rank(void* const* dst, void* const* flags, const void* src,
                             long long src_stride, void* out, int n, long long pv,
                             int lanes, long long lane, long long step, int steps,
                             int vecs, unsigned epoch, int rank,
                             unsigned long long timeout_ns, void* diag, int device,
                             void* stream) {
  const void* fn = push_fn(vecs);
  if (fn == nullptr || n < 2 || n > RNR_MAX_RANKS || rank < 0 || rank >= n ||
      lanes < 1 || pv <= 0 || lane <= 0 || (long long)lanes * lane < pv ||
      step <= 0 || steps < 1 || steps > RNR_PUSH_MAX_STEPS ||
      (long long)steps * step < lane || src_stride < 0 ||
      ((uintptr_t)src | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  PushArgs a = {};
  a.src = static_cast<const uint4*>(src);
  a.src_stride = src_stride;
  a.out = static_cast<uint4*>(out);
  for (int q = 0; q < n; ++q) {
    a.dst[q] = static_cast<uint4*>(dst[q]);
    a.flags[q] = static_cast<unsigned*>(flags[q]);
  }
  a.n = n;
  a.rank = rank;
  a.steps = steps;
  a.epoch = epoch;
  a.pv = pv;
  a.lane = lane;
  a.step = step;
  a.dl.timeout_ns = timeout_ns;
  a.dl.diag = static_cast<unsigned*>(diag);
  a.dl.rank = rank;
  a.dl.kernel = RNR_KERNEL_PUSH;
  a.dl.epoch = epoch;
  void* args[] = {&a};
  return rnr_on_device(device, [&] {
    return (int)cudaLaunchCooperativeKernel(fn, dim3((unsigned)lanes),
                                            dim3(RNR_BLOCK_THREADS), args, 0,
                                            reinterpret_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* rnr_push_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
