// reduce_across.cu: allreduce and reduce_scatter (sum) across processes,
// one rank a process, as one push-and-fold kernel: each rank stores the
// chunks its peers own straight into their rows, folds its own chunk where
// the operands landed, in the ring's order, and (allreduce) pushes the
// folded chunk to every peer and drains theirs, each stage a sub-step
// behind the one before it.
//
// Replaces, in their form across processes (a 1-D mesh that spans
// processes, ops/ipc.py): rocnrdma_tpu/ops/ring_pallas.py::
// pallas_ring_allreduce (body _ring_allreduce_kernel),
// ::pallas_ring_reduce_scatter (body _ring_reduce_scatter_kernel) and
// ::pallas_hbm_ring_allreduce (body _hbm_ring_kernel; in place when `out`
// is `src`). The one-process forms stay in ring.cu (modes AR and RS).
//
// What the TPU ring computes: chunk c folded as x[c+n-1] + (... + (x[c+1] +
// x[c])), ranks mod n, from rank c (AR) or c+1 (RS): ring.cu's head note.
// IEEE addition is commutative, so the bits depend only on that order: rank
// r folds chunk r from its n operands in it (fold_left, common.cuh), and
// each rank's result is the one-process kernel's bit for bit.
//
// Layout, in 16-byte vectors: rank r's row is n chunks of `pv` vectors at
// `src` (chunk d at d * pv), the caller's tensor itself when it is
// contiguous, aligned and exactly n chunks long, else a staged copy.
// `inbox[q]` is rank q's workspace input row (ops/ipc.py): slot j (j * pv)
// holds chunk q of rank j's row, pushed by rank j. `outbox[q]` is rank q's
// workspace output row: slot j holds rank j's folded chunk j (AR only).
// `out` is rank r's result: AR n chunks (chunk r folded here, the others
// drained from outbox[r]); RS chunk r alone.
//
// Protocol. Rank r runs `lanes` blocks; block b owns vectors [b*lane,
// (b+1)*lane) of every chunk, cut into `steps` sub-steps, and talks only to
// block b of the other ranks. Its flag words, in every rank's flags: one
// barrier word, RNR_RED_MAX_STEPS reduce words and as many allgather
// words, one of each a sub-step. In pass k = 0, 1, ...:
//   1. (before pass 0) entry barrier: one arrival on the barrier word of
//      lane b of every other rank, then wait for n-1 on its own: every peer
//      has entered this launch, so (by its stream order) it has folded and
//      drained its rows of the last launch, of this kernel or the push
//      kernel, and they may be overwritten;
//   2. push sub-step k of chunk d of `src` into rank d's inbox at slot r,
//      d = r+1, r+2, ... mod n (the n senders start on n different peers);
//   3. wait for reduce word k-1's n-1 arrivals, then fold sub-step k-1 of
//      chunk r from local memory: `src`'s chunk r and the n-1 inbox slots,
//      in the ring's order. RS: store the sum into `out`. AR: store it into
//      `out` at chunk r and push it into every peer's outbox at slot r;
//   4. AR: wait for allgather word k-2's n-1 arrivals, then drain sub-step
//      k-2 of the slots j != r from rank r's outbox into `out`;
//   5. one fence, then one arrival on reduce word k (the pushes of 2) and
//      allgather word k-1 (the folded pushes of 3) of lane b of every other
//      rank.
// The remote stores of 2 and 3 are on the wire while 3 and 4 read local
// memory; the fence of 5 is the pass's one wait for them. Every block
// raises every one of its lane's words once a launch (the last sub-step's
// arrival raises the words past `steps` too, RS the allgather words with
// its last reduce word), so a launch e (from 1) waits for e*(n-1) on each
// word whatever the mode and `steps` of each launch, and back-to-back
// launches need no reset. In place (`out` == `src`, AR): block b writes a
// range of `src` only after it has read it, each vector by the same thread
// (its chunk r: the fold reads, then stores; a chunk d != r: pushed in pass
// k, overwritten by the drain in pass k+2). No peer reads `src` or `out`:
// only rank r's stream order guards them. Every wait has a deadline
// (common.cuh, wait_geq_until): a peer that never launches makes this
// launch trap, and the wrapper names the word (ops/ipc.py). Block b of rank
// r waits on block b of its peers, which wait on theirs, so a rank's grid
// must be resident at once: the launch is cooperative.
//
// Bound on the H100: NVLink bytes. A rank sends (n-1)/n of its row to its
// peers in the reduce and, AR, as much again in the allgather, and
// receives as much, at 450 GB/s each way: 2(n-1)/n * S for AR, (n-1)/n * S
// for RS. HBM carries the row's read, the pushed slots' arrival and their
// read, the fold's store and, AR, the folded slots' arrival and the
// drain's read and write: about 5.25x the row at n = 4 (AR) against 3.35
// TB/s, under half the link's time, so the link binds. Design against it:
// nothing copied into or out of the workspace on the stream (the rows are
// read where the caller holds them, the fold stored where it is returned);
// remote stores only (a store is posted, a remote load waits a round trip);
// the fold and the drain read local memory while the pushes are on the
// wire; 16-byte vectors, `vecs` of them in flight a thread for every
// operand; lanes from the blocks the card holds when the rank has its card
// to itself; one fence a sub-step. Rejected: NVLink SHARP
// (multimem.ld_reduce) folds in the switch in an order that is not the
// ring's, so it cannot be bitwise; mapping the caller's tensors through
// IPC handles needs a host exchange a call, dearer than the copies it
// would save.
#include "common.cuh"

#define RNR_MAX_RANKS 32
#define RNR_RED_MAX_STEPS 8
#define RNR_RED_WORDS (1 + 2 * RNR_RED_MAX_STEPS)  // per lane: barrier, reduce, allgather
#define RNR_RED_BAR 0
#define RNR_RED_R 1                         // reduce word of sub-step k: RNR_RED_R + k
#define RNR_RED_AG (1 + RNR_RED_MAX_STEPS)  // allgather word of sub-step k: RNR_RED_AG + k
#define RNR_RED_MODE_AR 0
#define RNR_RED_MODE_RS 1
#define RNR_KERNEL_REDUCE 5  // the RNR_DIAG_KERNEL of this kernel, plus its mode
#define RNR_FOLD_BATCH 8     // operands loaded together above 8 ranks

struct ReduceArgs {
  const uint4* src;                 // this rank's row, n chunks
  uint4* out;                       // this rank's result: AR n chunks, RS one
  uint4* inbox[RNR_MAX_RANKS];      // every rank's workspace input row
  uint4* outbox[RNR_MAX_RANKS];     // every rank's workspace output row
  unsigned* flags[RNR_MAX_RANKS];   // every rank's flag words, lanes * RNR_RED_WORDS
  int n;
  int rank;
  int mode;         // RNR_RED_MODE_*
  int steps;        // sub-steps a lane, 1..RNR_RED_MAX_STEPS
  unsigned epoch;   // launches of this flag region, this one included
  long long pv;     // vectors a chunk
  long long lane;   // vectors a lane
  long long step;   // vectors a sub-step
  RnrDeadline dl;
};

// Vectors [s0, s1) of every chunk d != r of `src` into slot r of rank d's
// inbox, d = r+1, ..., r+n-1 mod n.
template <int U>
__device__ __forceinline__ void push(const ReduceArgs& a, long long s0, long long s1) {
  const int n = a.n, r = a.rank;
  for (long long i = s0 + threadIdx.x; i < s1; i += U * RNR_BLOCK_THREADS) {
    for (int s = 1; s < n; ++s) {
      const int d = (r + s) % n;
      uint4 v[U];
      load_vecs<U>(v, a.src + d * a.pv + i, i, s1);
      store_vecs<U>(a.inbox[d] + r * a.pv + i, v, i, s1);
    }
  }
}

// Vector i of operand q (a rank) of chunk r's fold: rank r's own chunk
// where it lies, a peer's where it landed.
__device__ __forceinline__ const uint4* operand(const ReduceArgs& a, int q, long long i) {
  return (q == a.rank ? a.src : a.inbox[a.rank]) + q * a.pv + i;
}

// s[u] = the fold of vector i + u*TH of chunk r over its n operands, in
// ring order from rank `first`. N > 0: n == N, every load issued before the
// first add. N == 0: any n, RNR_FOLD_BATCH operands at a time.
template <typename T, int N, int U>
__device__ __forceinline__ void fold_vectors(uint4 (&s)[U], const ReduceArgs& a, int n,
                                             int first, long long i, long long s1) {
  if constexpr (N > 0) {
    uint4 v[U][N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint4* p = operand(a, (first + k) % N, i);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i + u * RNR_BLOCK_THREADS < s1) v[u][k] = __ldcg(p + u * RNR_BLOCK_THREADS);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = fold_left<T, N>(v[u]);
  } else {
    for (int k0 = 0; k0 < n; k0 += RNR_FOLD_BATCH) {
      uint4 v[RNR_FOLD_BATCH][U];
#pragma unroll
      for (int j = 0; j < RNR_FOLD_BATCH; ++j)
        if (k0 + j < n) load_vecs<U>(v[j], operand(a, (first + k0 + j) % n, i), i, s1);
#pragma unroll
      for (int j = 0; j < RNR_FOLD_BATCH; ++j)
        if (k0 + j < n)
#pragma unroll
          for (int u = 0; u < U; ++u)
            s[u] = k0 + j == 0 ? v[j][u] : Fold<T>::add16(s[u], v[j][u]);
    }
  }
}

// Vectors [s0, s1) of chunk r folded: RS into `out`; AR into `out` at
// chunk r and into slot r of every peer's outbox, d = r+1, ... mod n.
template <typename T, int N, int U>
__device__ __forceinline__ void fold(const ReduceArgs& a, long long s0, long long s1) {
  const int n = N > 0 ? N : a.n, r = a.rank;
  const bool rs = a.mode == RNR_RED_MODE_RS;
  const int first = rs ? (r + 1) % n : r;
  const long long at = r * a.pv;
  for (long long i = s0 + threadIdx.x; i < s1; i += U * RNR_BLOCK_THREADS) {
    uint4 s[U];
    fold_vectors<T, N, U>(s, a, n, first, i, s1);
    store_vecs<U>(a.out + (rs ? 0 : at) + i, s, i, s1);
    if (!rs)
      for (int k = 1; k < n; ++k) store_vecs<U>(a.outbox[(r + k) % n] + at + i, s, i, s1);
  }
}

// After every thread's stores of a pass: one fence, then one arrival on
// words [w0, w1) and [w2, w3) of lane `base`'s words of every other rank.
__device__ __forceinline__ void arrive(const ReduceArgs& a, long long base, int w0, int w1,
                                       int w2, int w3) {
  __syncthreads();
  if (threadIdx.x == 0 && w0 + w2 < w1 + w3) {
    fence<kSys>();
    for (int s = 1; s < a.n; ++s) {
      unsigned* f = a.flags[(a.rank + s) % a.n] + base;
      for (int w = w0; w < w1; ++w) add_relaxed<kSys>(f + w, 1u);
      for (int w = w2; w < w3; ++w) add_relaxed<kSys>(f + w, 1u);
    }
  }
}

template <typename T, int N, int U>
__global__ void __launch_bounds__(RNR_BLOCK_THREADS) reduce_kernel(const ReduceArgs a) {
  const int n = N > 0 ? N : a.n, r = a.rank, K = a.steps;
  const bool ar = a.mode == RNR_RED_MODE_AR;
  const long long lo = (long long)blockIdx.x * a.lane;
  const long long hi = lo + a.lane < a.pv ? lo + a.lane : a.pv;
  const long long base = (long long)blockIdx.x * RNR_RED_WORDS;
  const unsigned target = a.epoch * (unsigned)(n - 1);
  const unsigned* const mine = a.flags[r] + base;
  // sub-step k's vectors: [sub(k), sub(k + 1))
  auto sub = [&](int k) { return lo + k * a.step < hi ? lo + k * a.step : hi; };

  meet<kSys>(a.flags, n, r, base + RNR_RED_BAR, target, a.dl);
  for (int k = 0; k <= K + (ar ? 1 : 0); ++k) {
    if (k < K) push<U>(a, sub(k), sub(k + 1));
    if (k >= 1 && k <= K) {
      wait_geq_until<kSys>(mine + RNR_RED_R + k - 1, target, a.dl, base + RNR_RED_R + k - 1);
      fold<T, N, U>(a, sub(k - 1), sub(k));
    }
    if (ar && k >= 2) {
      wait_geq_until<kSys>(mine + RNR_RED_AG + k - 2, target, a.dl, base + RNR_RED_AG + k - 2);
      drain<U>(a.outbox[r], a.out, n, r, a.pv, sub(k - 2), sub(k - 1));
    }
    // reduce word k, the last one through RNR_RED_MAX_STEPS - 1; allgather
    // word k - 1 likewise (RS: all of them with its last reduce word)
    int r0 = 0, r1 = 0, g0 = 0, g1 = 0;
    if (k < K) {
      r0 = RNR_RED_R + k;
      r1 = k + 1 < K ? r0 + 1 : RNR_RED_R + RNR_RED_MAX_STEPS;
      if (!ar && k + 1 == K) g0 = RNR_RED_AG, g1 = RNR_RED_AG + RNR_RED_MAX_STEPS;
    }
    if (ar && k >= 1 && k <= K) {
      g0 = RNR_RED_AG + k - 1;
      g1 = k < K ? g0 + 1 : RNR_RED_AG + RNR_RED_MAX_STEPS;
    }
    arrive(a, base, r0, r1, g0, g1);
  }
}

template <typename T, int U>
static const void* reduce_fn_n(int n) {
  switch (n) {
    case 2: return reinterpret_cast<const void*>(reduce_kernel<T, 2, U>);
    case 3: return reinterpret_cast<const void*>(reduce_kernel<T, 3, U>);
    case 4: return reinterpret_cast<const void*>(reduce_kernel<T, 4, U>);
    case 5: return reinterpret_cast<const void*>(reduce_kernel<T, 5, U>);
    case 6: return reinterpret_cast<const void*>(reduce_kernel<T, 6, U>);
    case 7: return reinterpret_cast<const void*>(reduce_kernel<T, 7, U>);
    case 8: return reinterpret_cast<const void*>(reduce_kernel<T, 8, U>);
    default: return reinterpret_cast<const void*>(reduce_kernel<T, 0, U>);
  }
}

// One value of `vecs` is built (ops/push_cuda.py, VECS_CHOICES): add a
// case here and there to sweep another.
template <typename T>
static const void* reduce_fn_t(int n, int vecs) {
  return vecs == 4 ? reduce_fn_n<T, 4>(n) : nullptr;
}

// The kernel for n ranks of `dtype` with `vecs` vectors a thread, or null.
static const void* reduce_fn(int n, int dtype, int vecs) {
  if (n < 2 || n > RNR_MAX_RANKS) return nullptr;
  if (dtype == RNR_DTYPE_F32) return reduce_fn_t<float>(n, vecs);
  if (dtype == RNR_DTYPE_BF16) return reduce_fn_t<__nv_bfloat16>(n, vecs);
  return nullptr;
}

// The blocks of the kernel for n ranks of `dtype` with `vecs` vectors a
// thread that `device` holds resident at once (blocks an SM times SMs): the
// most lanes one launch may have. Returns blocks (> 0) or -cudaError.
extern "C" int rnr_reduce_resident(int n, int dtype, int vecs, int device) {
  const void* fn = reduce_fn(n, dtype, vecs);
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

// One launch of rank `rank`'s `lanes` blocks on `stream` in `mode`
// (RNR_RED_MODE_*). `inbox`, `outbox` and `flags` are tables of n pointers
// (peers' mapped from CUDA IPC handles); `src` and `out` are this
// process's, 16-byte aligned, and may be the same (AR in place). `pv`,
// `lane` and `step` count 16-byte vectors. Each wait gives up after
// `timeout_ns` (0: never), writing its record into `diag` (mapped host
// words, RNR_DIAG_WORDS) before the launch traps.
extern "C" int rnr_reduce_rank(void* const* inbox, void* const* outbox, void* const* flags,
                               const void* src, void* out, int n, long long pv, int lanes,
                               long long lane, long long step, int steps, int vecs,
                               int dtype, int mode, unsigned epoch, int rank,
                               unsigned long long timeout_ns, void* diag, int device,
                               void* stream) {
  const void* fn = reduce_fn(n, dtype, vecs);
  if (fn == nullptr || rank < 0 || rank >= n || lanes < 1 || pv <= 0 || lane <= 0 ||
      (long long)lanes * lane < pv || step <= 0 || steps < 1 ||
      steps > RNR_RED_MAX_STEPS || (long long)steps * step < lane ||
      (mode != RNR_RED_MODE_AR && mode != RNR_RED_MODE_RS) ||
      (mode == RNR_RED_MODE_RS && src == out) || ((uintptr_t)src | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  ReduceArgs a = {};
  a.src = static_cast<const uint4*>(src);
  a.out = static_cast<uint4*>(out);
  for (int q = 0; q < n; ++q) {
    a.inbox[q] = static_cast<uint4*>(inbox[q]);
    a.outbox[q] = static_cast<uint4*>(outbox[q]);
    a.flags[q] = static_cast<unsigned*>(flags[q]);
  }
  a.n = n;
  a.rank = rank;
  a.mode = mode;
  a.steps = steps;
  a.epoch = epoch;
  a.pv = pv;
  a.lane = lane;
  a.step = step;
  a.dl.timeout_ns = timeout_ns;
  a.dl.diag = static_cast<unsigned*>(diag);
  a.dl.rank = rank;
  a.dl.kernel = RNR_KERNEL_REDUCE + mode;
  a.dl.epoch = epoch;
  void* args[] = {&a};
  return rnr_on_device(device, [&] {
    return (int)cudaLaunchCooperativeKernel(fn, dim3((unsigned)lanes),
                                            dim3(RNR_BLOCK_THREADS), args, 0,
                                            reinterpret_cast<cudaStream_t>(stream));
  });
}

extern "C" const char* rnr_reduce_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
