// ring.cu: the ring collectives (sum) as one direct pass, in three modes of
// one kernel.
//
// Replaces (rocnrdma_tpu/ops/ring_pallas.py):
//   - mode AR, pallas_ring_allreduce (body _ring_allreduce_kernel /
//     _ring_hops / _neighbour_barrier): chunks padded to 128 lanes;
//   - mode AR, pallas_hbm_ring_allreduce (body _hbm_ring_kernel): chunks
//     padded to whole tiles, in place when `src` and `dst` are the same rows;
//   - mode RS, pallas_ring_reduce_scatter (body _ring_reduce_scatter_kernel):
//     rank r keeps chunk r;
//   - mode AG, pallas_ring_allgather (body _ring_allgather_kernel).
// The wrapper's padding fixes the chunk geometry, and with it which chunk
// an element lies in.
//
// What the TPU ring computes. Its hops leave each chunk one fixed fold
// order: in mode AR chunk c is x[c+n-1] + (... + (x[c+1] + x[c])), indices
// mod n (ring_pallas.py:116-117, `o_ref[recv] += comm_buf[slot]` at :98);
// in mode RS the fold starts at rank c+1 (:129). IEEE addition is
// commutative, so the bits depend only on that order. Every rank's memory
// is directly addressable here (one GPU today; NVSwitch peers later), so
// instead of relaying chunks through neighbours' slots, the block that owns
// a chunk reads its n rows itself and folds them in that order: the same
// bits, no hops, no comm slots, no credits.
//
// Protocol. Rank r runs `lanes` blocks; block (r, b) owns sub-range b of
// chunk r and talks only to block b of the other ranks, as in
// alltoall.cu. Each block, in order:
//   1. entry barrier: one arrival on the barrier word of lane b of every
//      other rank, then wait for n-1 on its own (_global_barrier): peers'
//      inputs are ready and their outputs free;
//   2. AR: load its sub-range of chunk r from all n input rows (all loads
//      before the first add), fold acc = x[r]; acc = x[r+k] + acc for
//      k = 1..n-1, store acc into chunk r of all n output rows. In place is
//      safe: each element is read, then written, by one thread only.
//      RS: the same fold from rank r+1 (acc = x[r+1]; k = 2..n), stored
//      into output row r only. AG: load rank r's chunk once and store it
//      into chunk r of all n output rows;
//   3. exit: one arrival on the arrival word of lane b of every other rank,
//      then wait for n-1 on its own: every write into its output lane has
//      landed and no peer still reads its input lane.
// Flags are epoch-counted: launch e (from 1) of one flag buffer waits for
// e*(n-1) on each word, so back-to-back launches need no reset (the wrapper
// caches the buffer per device, stream, n and lanes and counts the epoch).
// Blocks spin on blocks of other ranks, so all n*lanes blocks must be
// resident at once: the launch is cooperative and a grid that cannot be is
// refused.
//
// Across processes (one rank a process) the allreduce and reduce_scatter
// run reduce_across.cu, the allgather push_across.cu: the same fold order,
// so each rank's row is the one-process launch's bit for bit.
//
// Bound on the H100: device-memory bytes. Each mode reads every input
// element once and writes every output element once, which is the least
// any implementation must move: over all ranks, with S bytes per rank,
// AR 2*n*S, RS n*S + S, AG S + n*S (S the gathered row, n*c). On NVLink
// each rank would move (n-1)/n of its reads and writes over the link, the
// 2(n-1)/n*S a ring puts on the wire. Design against it: 16-byte vectors,
// two per thread per operand in AR and RS (2n loads in flight, the fold
// unrolled at compile time for n = 2..8, batches of 8 operands above),
// four per thread in AG, and lanes sized so n*lanes blocks cover the SMs
// about four times.
#include "common.cuh"

#define RNR_MAX_RANKS 32
#define RNR_FLAG_WORDS 2  // per lane: barrier, arrivals
#define RNR_BAR 0
#define RNR_ARR 1
#define RNR_FOLD_BATCH 8  // operands loaded together on the batched path

#define RNR_MODE_AR 0  // allreduce: fold from rank r, store into all rows
#define RNR_MODE_RS 1  // reduce-scatter: fold from rank r+1, store into row r
#define RNR_MODE_AG 2  // allgather: rank r's chunk into all rows

struct RingArgs {
  const void* src[RNR_MAX_RANKS];  // rank input rows (AG: the rank's chunk)
  void* dst[RNR_MAX_RANKS];        // rank output rows (RS: the rank's chunk)
  unsigned* flags[RNR_MAX_RANKS];  // rank flag words, lanes * 2
  int n;
  int lanes;
  int mode;         // RNR_MODE_*
  int sync;         // 0: skip barrier and arrivals (timing the data pass)
  unsigned epoch;   // launches of this flag buffer, this one included
  long long per;    // chunk elements (16-byte multiple)
  long long lane;   // lane elements (multiple of 128)
  RnrDeadline dl;   // meet's deadline argument (kSys only: unused at kGpu)
};

// The flags' memory-model scope. Every rank of a launch lives on one GPU,
// so kGpu orders them all; a kSys fence costs several microseconds more per
// launch on the H100 (bench/bench_kernel_variants.py, PERF.md).
constexpr RnrScope kRingScope = kGpu;

// Vector i of my sub-range of chunk r in operand k of the fold, which is
// rank (first + k)'s input row.
template <typename T>
__device__ __forceinline__ const uint4* operand(const RingArgs& a, int n,
                                                int first, int k, long long off) {
  return reinterpret_cast<const uint4*>(
      static_cast<const T*>(a.src[(first + k) % n]) + off);
}

// s[u] = the fold of vector i + u*TH over all n operands, in ring order
// from rank `first`. N > 0: n == N, every load issued before the first add.
// N == 0: any n, in batches of RNR_FOLD_BATCH operands.
template <typename T, int N, int U>
__device__ __forceinline__ void fold_vectors(uint4 (&s)[U], const RingArgs& a,
                                             int n, int first, long long off,
                                             long long i) {
  const int TH = RNR_BLOCK_THREADS;
  if constexpr (N > 0) {
    uint4 v[U][N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint4* p = operand<T>(a, N, first, k, off) + i;
#pragma unroll
      for (int u = 0; u < U; ++u) v[u][k] = __ldcg(p + u * TH);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = fold_left<T, N>(v[u]);
  } else {
    for (int k0 = 0; k0 < n; k0 += RNR_FOLD_BATCH) {
      uint4 v[RNR_FOLD_BATCH][U];
#pragma unroll
      for (int j = 0; j < RNR_FOLD_BATCH; ++j)
        if (k0 + j < n) {
          const uint4* p = operand<T>(a, n, first, k0 + j, off) + i;
#pragma unroll
          for (int u = 0; u < U; ++u) v[j][u] = __ldcg(p + u * TH);
        }
#pragma unroll
      for (int j = 0; j < RNR_FOLD_BATCH; ++j)
        if (k0 + j < n)
#pragma unroll
          for (int u = 0; u < U; ++u)
            s[u] = k0 + j == 0 ? v[j][u] : Fold<T>::add16(s[u], v[j][u]);
    }
  }
}

// Store s[u] at vector i + u*TH of my sub-range in the output rows: all n
// (AR, at chunk offset `off`) or row r alone (RS, at lane offset `lo`).
template <typename T, int U>
__device__ __forceinline__ void store_vectors(const uint4 (&s)[U],
                                              const RingArgs& a, int n, int r,
                                              long long off, long long lo,
                                              long long i) {
  const int TH = RNR_BLOCK_THREADS;
  const int d0 = a.mode == RNR_MODE_RS ? r : 0;
  const int d1 = a.mode == RNR_MODE_RS ? r + 1 : n;
  const long long at = a.mode == RNR_MODE_RS ? lo : off;
  for (int d = d0; d < d1; ++d) {
    uint4* q = reinterpret_cast<uint4*>(static_cast<T*>(a.dst[d]) + at) + i;
#pragma unroll
    for (int u = 0; u < U; ++u) __stcg(q + u * TH, s[u]);
  }
}

template <typename T, int N, RnrScope S>
__global__ void __launch_bounds__(RNR_BLOCK_THREADS)
    ring_kernel(const RingArgs a) {
  const int n = N > 0 ? N : a.n;
  const int r = blockIdx.x / a.lanes;
  const int b = blockIdx.x % a.lanes;
  const long long lo = (long long)b * a.lane;
  const long long hi = lo + a.lane < a.per ? lo + a.lane : a.per;
  const long long nv = hi > lo ? (hi - lo) * (long long)sizeof(T) / 16 : 0;
  const long long off = r * a.per + lo;  // my sub-range of chunk r in a row
  const int TH = RNR_BLOCK_THREADS;

  if (a.sync)
    meet<S>(a.flags, n, r, b * RNR_FLAG_WORDS + RNR_BAR, a.epoch * (unsigned)(n - 1), a.dl);

  long long i = threadIdx.x;
  if (a.mode == RNR_MODE_AG) {
    const uint4* in = reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.src[r]) + lo);
    for (; i < nv; i += 4 * TH) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u * TH < nv) v[u] = __ldcg(in + i + u * TH);
      const int valid = nv - i >= 4 * TH ? 4 : (int)((nv - i + TH - 1) / TH);
      for (int d = 0; d < n; ++d) {
        uint4* q = reinterpret_cast<uint4*>(static_cast<T*>(a.dst[d]) + off) + i;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (u < valid) __stcg(q + u * TH, v[u]);
      }
    }
  } else {
    const int first = a.mode == RNR_MODE_RS ? (r + 1) % n : r;
    for (; i + TH < nv; i += 2 * TH) {
      uint4 s[2];
      fold_vectors<T, N, 2>(s, a, n, first, off, i);
      store_vectors<T, 2>(s, a, n, r, off, lo, i);
    }
    if (i < nv) {
      uint4 s[1];
      fold_vectors<T, N, 1>(s, a, n, first, off, i);
      store_vectors<T, 1>(s, a, n, r, off, lo, i);
    }
  }

  if (a.sync)
    meet<S>(a.flags, n, r, b * RNR_FLAG_WORDS + RNR_ARR, a.epoch * (unsigned)(n - 1), a.dl);
}

template <typename T, RnrScope S = kRingScope>
static const void* ring_fn(int n) {
  switch (n) {
    case 2: return reinterpret_cast<const void*>(ring_kernel<T, 2, S>);
    case 3: return reinterpret_cast<const void*>(ring_kernel<T, 3, S>);
    case 4: return reinterpret_cast<const void*>(ring_kernel<T, 4, S>);
    case 5: return reinterpret_cast<const void*>(ring_kernel<T, 5, S>);
    case 6: return reinterpret_cast<const void*>(ring_kernel<T, 6, S>);
    case 7: return reinterpret_cast<const void*>(ring_kernel<T, 7, S>);
    case 8: return reinterpret_cast<const void*>(ring_kernel<T, 8, S>);
    default: return reinterpret_cast<const void*>(ring_kernel<T, 0, S>);
  }
}

// The kernel for n ranks of `dtype`, or null for another dtype.
static const void* kernel_for(int n, int dtype) {
  if (dtype == RNR_DTYPE_F32) return ring_fn<float>(n);
  if (dtype == RNR_DTYPE_BF16) return ring_fn<__nv_bfloat16>(n);
  return nullptr;
}

// Lanes per rank for n ranks and `per`-element chunks (rnr_lanes: about
// four blocks an SM over all ranks; four were faster than two for
// reduce-scatter on the H100 and no slower for the other modes,
// bench/bench_kernel_variants.py), on the current device. Returns lanes
// (> 0) or -cudaError.
extern "C" int rnr_ring_lanes(int n, long long per, int dtype) {
  const void* fn = kernel_for(n, dtype);
  if (n < 2 || n > RNR_MAX_RANKS || per <= 0 || fn == nullptr)
    return -(int)cudaErrorInvalidValue;
  return rnr_lanes(fn, n, per);
}

// One launch of the ring kernel in `mode` (RNR_MODE_*) on `device`, every
// rank's blocks. `epoch` counts the launches of this flag buffer, this one
// included; `sync` 0 skips the barrier and the arrivals and leaves the flags
// alone.
extern "C" int rnr_ring(const void* const* src, void* const* dst,
                        void* const* flags, int n, long long per, int lanes,
                        int dtype, int mode, unsigned epoch, int sync,
                        int device, void* stream) {
  const void* fn = kernel_for(n, dtype);
  const int itemsize = dtype == RNR_DTYPE_BF16 ? 2 : 4;
  if (n < 2 || n > RNR_MAX_RANKS || lanes < 1 || per <= 0 ||
      per * itemsize % 16 || mode < RNR_MODE_AR || mode > RNR_MODE_AG ||
      fn == nullptr)
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.src[r] = src[r];
    a.dst[r] = dst[r];
    a.flags[r] = reinterpret_cast<unsigned*>(flags[r]);
  }
  a.n = n;
  a.lanes = lanes;
  a.mode = mode;
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

extern "C" const char* rnr_ring_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
