// Shared device helpers of the port's kernels: the elementwise fold in
// fp32 or bf16, and the flag protocol.
//
// The fold is `a + b` per element, computed in fp32 with __fadd_rn (no FMA,
// no reassociation) and, for bf16, rounded back to bf16 after every add
// (__float2bfloat16_rn): the same arithmetic as one bf16 add of the JAX
// reference and of PyTorch, so a kernel equals its plain version bit for
// bit. IEEE addition is commutative, so `acc + x` and `x + acc` give the
// same bits: only the order in which operands join the sum matters.
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

// x0 + x1 + ... + x(K-1) over one 16-byte vector of each operand, left to
// right, one rounding per add. The caller loads all K vectors first, so
// their loads are in flight together (combine.cu, and ring.cu for n <= 8).
template <typename T, int K>
__device__ __forceinline__ uint4 fold_left(const uint4 (&v)[K]) {
  uint4 acc = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = Fold<T>::add16(acc, v[k]);
  return acc;
}

// launch() (returning 0 or a cudaError) with `device` current, the
// caller's device restored after: cheaper than switching from Python.
template <typename F>
static int rnr_on_device(int device, F&& launch) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if (prev != device && (e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  const int rc = launch();
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

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
// alltoall.cu). Flags are 32-bit counters in device memory, the
// counterpart of the TPU's DMA and barrier semaphores, raised with atomic
// adds and read with relaxed loads, at a memory-model scope: kGpu orders
// the blocks of one GPU, kSys also peers over NVLink and the host. A
// release is one fence before any number of relaxed adds (`meet`): on the
// H100 a kGpu fence costs about a microsecond, a kSys one several, and a
// `red.release.sys` per peer (each its own system fence) tens
// (bench/bench_kernel_variants.py, PERF.md). Flags are epoch-counted: the
// wrappers cache one buffer per (device, stream, n, lanes), zero it once
// and never reset it; launch e waits for e*(n-1) on each word. Blocks of
// these kernels run with RNR_BLOCK_THREADS threads.

#define RNR_BLOCK_THREADS 256

enum RnrScope { kGpu, kSys };

template <RnrScope S>
__device__ __forceinline__ void fence() {
  if constexpr (S == kSys)
    asm volatile("fence.acq_rel.sys;" ::: "memory");
  else
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

template <RnrScope S>
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  if constexpr (S == kSys)
    asm volatile("ld.relaxed.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <RnrScope S>
__device__ __forceinline__ void add_relaxed(unsigned* p, unsigned v) {
  if constexpr (S == kSys)
    asm volatile("red.relaxed.sys.global.add.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// One thread spins on relaxed loads until *p >= v, then one fence makes
// the acquire; the block then proceeds together. The comparison is on the
// signed difference, so an epoch-counted flag may wrap around 2^32
// (ring.cu) while no waiter is 2^31 behind.
template <RnrScope S = kSys>
__device__ __forceinline__ void wait_geq(const unsigned* p, unsigned v) {
  if (threadIdx.x == 0) {
    while ((int)(ld_relaxed<S>(p) - v) < 0) __nanosleep(64);
    fence<S>();
  }
  __syncthreads();
}

__device__ __forceinline__ int wrap(int v, int n) { return ((v % n) + n) % n; }

// ---------------------------------------------------------------------------
// The bounded wait of the kernels whose ranks live in other processes (one
// rank a process, peers' rows and flags mapped through CUDA IPC). There a
// peer that died, or that made another call, would leave a wait spinning
// for good, so each wait has a deadline: `timeout_ns` from when it began,
// read from %globaltimer (0: none). On expiry one thread of the launch
// writes what it waited for into `diag`, pinned host memory mapped into the
// device (RNR_DIAG_WORDS words: RNR_DIAG_* below), and every expiring
// thread traps: the launch fails, as an NCCL timeout aborts its
// communicator, and the wrapper names the record (ops/ipc.py). The
// one-process kernels keep the unbounded wait_geq above.

#define RNR_DIAG_WORDS 8
#define RNR_DIAG_STATE 0   // 0 none, 1 being written, 2 written
#define RNR_DIAG_RANK 1
#define RNR_DIAG_LANE 2
#define RNR_DIAG_WORD 3    // index of the flag word in the rank's flags
#define RNR_DIAG_SEEN 4    // its value when the deadline passed
#define RNR_DIAG_TARGET 5  // the value waited for
#define RNR_DIAG_EPOCH 6
#define RNR_DIAG_KERNEL 7  // ring.cu's RNR_MODE_*, or RNR_KERNEL_A2A

struct RnrDeadline {
  unsigned long long timeout_ns;  // 0: no deadline
  unsigned* diag;                 // device address of the mapped words
  int rank;                       // the rank this launch runs
  int kernel;                     // written into RNR_DIAG_KERNEL
  unsigned epoch;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// (`d` by value: a reference would copy the whole kernel argument block to
// every thread's stack)
__device__ __noinline__ void expire(RnrDeadline d, long long word,
                                    unsigned seen, unsigned target) {
  if (d.diag != nullptr && atomicCAS_system(d.diag + RNR_DIAG_STATE, 0u, 1u) == 0u) {
    volatile unsigned* w = d.diag;
    w[RNR_DIAG_RANK] = (unsigned)d.rank;
    w[RNR_DIAG_LANE] = blockIdx.x;
    w[RNR_DIAG_WORD] = (unsigned)word;
    w[RNR_DIAG_SEEN] = seen;
    w[RNR_DIAG_TARGET] = target;
    w[RNR_DIAG_EPOCH] = d.epoch;
    w[RNR_DIAG_KERNEL] = (unsigned)d.kernel;
    __threadfence_system();
    w[RNR_DIAG_STATE] = 2u;
    __threadfence_system();
  }
  __trap();
}

// wait_geq with the deadline: word `word` of my flags is at p.
template <RnrScope S>
__device__ __forceinline__ void wait_geq_until(const unsigned* p, unsigned v,
                                               const RnrDeadline& d,
                                               long long word) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = global_ns();
    unsigned seen;
    while ((int)((seen = ld_relaxed<S>(p)) - v) < 0) {
      if (d.timeout_ns != 0 && global_ns() - t0 > d.timeout_ns) expire(d, word, seen, v);
      __nanosleep(64);
    }
    fence<S>();
  }
  __syncthreads();
}

// One arrival on word `word` of every other rank's flags (rank q's word is
// flags[q] + word), after every thread's prior writes: one fence, then
// relaxed adds. Then wait until my own word reaches `target`: unbounded at
// kGpu (every rank in this launch), with `d`'s deadline at kSys.
template <RnrScope S>
__device__ __forceinline__ void meet(unsigned* const* flags, int n, int r,
                                     long long word, unsigned target,
                                     const RnrDeadline& d) {
  __syncthreads();
  if (threadIdx.x == 0) {
    fence<S>();
    for (int s = 1; s < n; ++s) add_relaxed<S>(flags[wrap(r + s, n)] + word, 1u);
  }
  if constexpr (S == kSys)
    wait_geq_until<S>(flags[r] + word, target, d, word);
  else
    wait_geq<S>(flags[r] + word, target);
}

// Lane width of a kernel whose rank runs `lanes` blocks over `elems`
// elements: a multiple of 128 elements, so every lane starts 16-byte
// aligned.
static inline long long rnr_lane_elems(long long elems, int lanes) {
  long long l = (elems + lanes - 1) / lanes;
  return (l + 127) / 128 * 128;
}

#define RNR_MIN_LANE_ELEMS 1024

// Lanes per rank of kernel `fn` for n ranks and `per`-element chunks, on
// the current device: enough blocks to cover the SMs about four times, at
// least RNR_MIN_LANE_ELEMS elements a lane, and never more than can be
// resident at once. A block waits on lane b of all n-1 peers, so the
// blocks of all n ranks have to fit on one card together: the whole n*lanes
// grid in one process, and with one rank a process all n processes'
// grids at once when they share the card under MPS (on separate cards the
// cap is only stricter than needed). The answer depends only on n, per, the
// kernel and the card's model, so every process of a job on like cards
// gets the same lanes, which the epoch-counted flags of a launch across
// processes require. Returns lanes (> 0) or -cudaError.
static inline int rnr_lanes(const void* fn, int n, long long per) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, RNR_BLOCK_THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  const int sms = rnr_sm_count();
  if (sms <= 0) return -(int)cudaErrorInvalidDevice;
  const long long total = (long long)per_sm * sms;
  long long lanes = (per + RNR_MIN_LANE_ELEMS - 1) / RNR_MIN_LANE_ELEMS;
  const long long cap = (4LL * sms + n - 1) / n;
  if (lanes > cap) lanes = cap;
  if (lanes > total / n) lanes = total / n;
  if (lanes < 1) lanes = 1;
  const long long lane = rnr_lane_elems(per, (int)lanes);
  return (int)((per + lane - 1) / lane);  // no empty lanes
}
