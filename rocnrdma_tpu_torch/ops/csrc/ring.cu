// ring.cu: the ring collectives (sum) with a slot/flag/credit protocol, in
// three modes of one kernel.
//
// Replaces (rocnrdma_tpu/ops/ring_pallas.py):
//   - mode AR, pallas_ring_allreduce (body _ring_allreduce_kernel /
//     _ring_hops / _neighbour_barrier): one tile per chunk, out of place
//     (the wrapper passes `src`);
//   - mode AR, pallas_hbm_ring_allreduce (body _hbm_ring_kernel): chunks cut
//     into tiles, hops walked in (step, tile) order, in place (`src` null);
//   - mode RS, pallas_ring_reduce_scatter (body _ring_reduce_scatter_kernel):
//     copy in the whole buffer, then the -1-shifted reduce phase, n-1
//     accumulate hops with send (r-s-1), recv (r-s-2); rank r keeps chunk r;
//   - mode AG, pallas_ring_allgather (body _ring_allgather_kernel): copy the
//     rank's one chunk into chunk r, then n-1 overwrite hops with send
//     (r-s), recv (r-s-1).
// On Hopper every buffer already lives in device memory, so the TPU's VMEM
// tier and HBM tier differ here only in the tile size. The modes differ
// only in the hop count, the hop indices, fold or overwrite, and the
// copy-in; barrier, slots, credits, drain, lanes and launch are shared.
//
// Protocol (per ring lane; the TPU semaphores become flag words):
//   - rank buffers, 2-slot comm buffers and flag words are pointer tables
//     indexed by rank. In this slice every entry points into one GPU's
//     memory; peer pointers fill the same tables later.
//   - lanes: rank r runs `lanes` blocks; block b owns sub-range b of every
//     tile and talks only to block b of ranks r-1 and r+1, so the lanes are
//     independent rings and the blocks of one rank never synchronise.
//   - entry barrier: each lane signals both ring neighbours and waits for
//     both (_entry_barrier with offsets -1, +1).
//   - hop g uses slot g % 2. Before reusing a slot (g >= 2) the sender
//     waits for the credit of that slot's previous use. It then copies its
//     outbound tile lane into the right neighbour's slot, and one thread
//     publishes the slot's sequence number with a system-scope release
//     store. The receiver spins on an acquire load of its own flag, folds
//     (`mine + recvd`) or overwrites, and returns a credit to its left
//     neighbour. Trailing credits are drained (_ring_hops :83-107).
//   - flags are sequence numbers; the wrapper's launch zeroes them with
//     cudaMemsetAsync on the stream first.
//   - all n*lanes blocks spin on each other, so all must be resident at
//     once: the launch is cooperative, which refuses a grid that cannot be.
//
// Bound on the H100: device-memory bytes. Per rank, with S the rank buffer
// and C = S/n a chunk (elements): an accumulate hop reads the outbound
// chunk and writes the peer slot (2C), then reads mine, reads the slot and
// writes mine (3C): 5C. An overwrite hop moves 2C + 2C = 4C. The copy-in
// reads and writes what it copies. So per rank:
//   AR out of place (n-1)*9C + 2S, in place (n-1)*9C;
//   RS (n-1)*5C + 2S;
//   AG, with c the rank's one chunk, 2c + (n-1)*4c.
// The least any of them must move, over all ranks, is each input read once
// and each output written once: AR 2*n*S, RS n*S + S, AG S + n*S with S =
// n*c the gathered row. Design against it: 16-byte vector copies, four in
// flight per thread, and lanes sized so n*lanes blocks cover the SMs.
#include "common.cuh"

#define RNR_MAX_RANKS 32
#define RNR_RING_THREADS RNR_BLOCK_THREADS
#define RNR_FLAG_WORDS 8  // per lane: recv[2], credit[2], barrier, pad
#define RNR_RECV 0
#define RNR_CRED 2
#define RNR_BAR 4
#define RNR_MIN_LANE_ELEMS 1024

#define RNR_MODE_AR 0  // allreduce: n-1 accumulate, then n-1 overwrite hops
#define RNR_MODE_RS 1  // reduce-scatter: n-1 accumulate hops, offset -1
#define RNR_MODE_AG 2  // allgather: n-1 overwrite hops, owned offset 0

struct RingArgs {
  const void* src[RNR_MAX_RANKS];  // copy-in source per rank, or null
  void* data[RNR_MAX_RANKS];       // rank working buffer, n * per elements
  void* comm[RNR_MAX_RANKS];       // rank comm slots, 2 * tile elements
  unsigned* flags[RNR_MAX_RANKS];  // rank flag words, lanes * 8
  int n;
  int lanes;
  int mode;        // RNR_MODE_*
  long long per;   // chunk elements (multiple of tile)
  long long tile;  // tile elements (multiple of 128)
  long long lane;  // lane elements (multiple of 128)
};

// mine[i] = mine[i] + recvd[i] over `bytes` (a multiple of 16).
template <typename T>
__device__ __forceinline__ void fold16(void* mine, const void* recvd,
                                      long long bytes) {
  uint4* m = reinterpret_cast<uint4*>(mine);
  const uint4* r = reinterpret_cast<const uint4*>(recvd);
  const long long nv = bytes / 16;
  const int TH = RNR_RING_THREADS;
  long long i = threadIdx.x;
  for (; i + TH < nv; i += 2 * TH) {
    uint4 a0 = __ldcg(m + i), a1 = __ldcg(m + i + TH);
    uint4 b0 = __ldcg(r + i), b1 = __ldcg(r + i + TH);
    __stcg(m + i, Fold<T>::add16(a0, b0));
    __stcg(m + i + TH, Fold<T>::add16(a1, b1));
  }
  for (; i < nv; i += TH) __stcg(m + i, Fold<T>::add16(__ldcg(m + i), __ldcg(r + i)));
}

template <typename T>
__global__ void __launch_bounds__(RNR_RING_THREADS)
    ring_kernel(const RingArgs a) {
  const int n = a.n;
  const int r = blockIdx.x / a.lanes;
  const int b = blockIdx.x % a.lanes;
  const int left = wrap(r - 1, n), right = wrap(r + 1, n);
  const long long lo = (long long)b * a.lane;
  const long long hi = lo + a.lane < a.tile ? lo + a.lane : a.tile;
  const long long bytes = hi > lo ? (hi - lo) * (long long)sizeof(T) : 0;
  const long long n_tiles = a.per / a.tile;

  T* mine = reinterpret_cast<T*>(a.data[r]);
  T* my_slots = reinterpret_cast<T*>(a.comm[r]);
  T* right_slots = reinterpret_cast<T*>(a.comm[right]);
  unsigned* my_f = a.flags[r] + b * RNR_FLAG_WORDS;
  unsigned* left_f = a.flags[left] + b * RNR_FLAG_WORDS;
  unsigned* right_f = a.flags[right] + b * RNR_FLAG_WORDS;

  // copy in: AG the rank's one chunk into chunk r; AR (out of place) and RS
  // the whole buffer. My lane of every tile either way.
  if (a.src[r] != nullptr) {
    const T* src = reinterpret_cast<const T*>(a.src[r]);
    if (a.mode == RNR_MODE_AG) {
      for (long long t = 0; t < n_tiles; ++t)
        copy16(mine + r * a.per + t * a.tile + lo, src + t * a.tile + lo, bytes);
    } else {
      for (long long c = 0; c < (long long)n * n_tiles; ++c)
        copy16(mine + c * a.tile + lo, src + c * a.tile + lo, bytes);
    }
  }

  // entry barrier with both ring neighbours (n == 2: one neighbour, twice)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    add_release(left_f + RNR_BAR, 1u);
    add_release(right_f + RNR_BAR, 1u);
  }
  wait_geq(my_f + RNR_BAR, 2u);

  const long long steps = a.mode == RNR_MODE_AR ? 2LL * (n - 1) : (long long)(n - 1);
  const long long hops = steps * n_tiles;
  for (long long g = 0; g < hops; ++g) {
    const int step = (int)(g / n_tiles);
    const long long t = g % n_tiles;
    bool accumulate;
    int send_idx, recv_idx;
    if (a.mode == RNR_MODE_RS) {  // _ring_reduce_scatter_kernel's hops
      accumulate = true;
      send_idx = wrap(r - step - 1, n);
      recv_idx = wrap(r - step - 2, n);
    } else if (a.mode == RNR_MODE_AG) {  // _ring_allgather_kernel's hops
      accumulate = false;
      send_idx = wrap(r - step, n);
      recv_idx = wrap(r - step - 1, n);
    } else {  // _ring_allreduce_kernel's hops
      accumulate = step < n - 1;
      const int s = accumulate ? step : step - (n - 1);
      send_idx = accumulate ? wrap(r - s, n) : wrap(r + 1 - s, n);
      recv_idx = accumulate ? wrap(r - s - 1, n) : wrap(r - s, n);
    }
    const int slot = (int)(g & 1);
    const unsigned use = (unsigned)(g >> 1);  // earlier uses of this slot

    if (g >= 2) wait_geq(my_f + RNR_CRED + slot, use);  // slot consumed
    // remote write: my outbound lane into the right neighbour's slot
    copy16(right_slots + slot * a.tile + lo,
           mine + send_idx * a.per + t * a.tile + lo, bytes);
    publish(right_f + RNR_RECV + slot, use + 1u, false);
    // the left neighbour's write into my slot
    wait_geq(my_f + RNR_RECV + slot, use + 1u);
    T* dst = mine + recv_idx * a.per + t * a.tile + lo;
    const T* in = my_slots + slot * a.tile + lo;
    if (accumulate)
      fold16<T>(dst, in, bytes);
    else
      copy16(dst, in, bytes);
    publish(left_f + RNR_CRED + slot, 1u, true);  // credit to the sender
  }
  // drain the credits still owed for each used slot
  for (int slot = 0; slot < 2 && slot < hops; ++slot)
    wait_geq(my_f + RNR_CRED + slot, (unsigned)((hops - slot + 1) / 2));
}

template <typename T>
static int max_coresident(int* total) {
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_kernel<T>, RNR_RING_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int sms = rnr_sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  *total = per_sm * sms;
  return 0;
}

// Lanes per rank for n ranks and this tile: enough blocks to cover the SMs
// about twice, at least RNR_MIN_LANE_ELEMS elements per lane, and never
// more than can be resident at once. Returns lanes (> 0) or -cudaError.
extern "C" int rnr_ring_lanes(int n, long long tile, int dtype) {
  if (n < 2 || n > RNR_MAX_RANKS || tile <= 0 || tile % 128) return -(int)cudaErrorInvalidValue;
  int total = 0, e;
  if (dtype == RNR_DTYPE_F32)
    e = max_coresident<float>(&total);
  else if (dtype == RNR_DTYPE_BF16)
    e = max_coresident<__nv_bfloat16>(&total);
  else
    return -(int)cudaErrorInvalidValue;
  if (e) return -e;
  const int sms = rnr_sm_count();
  long long lanes = (tile + RNR_MIN_LANE_ELEMS - 1) / RNR_MIN_LANE_ELEMS;
  long long cap = (2LL * sms + n - 1) / n;
  if (lanes > cap) lanes = cap;
  if (lanes > total / n) lanes = total / n;
  if (lanes < 1) lanes = 1;
  const long long lane = rnr_lane_elems(tile, (int)lanes);
  return (int)((tile + lane - 1) / lane);  // no empty lanes
}

// One launch of the ring kernel in `mode` (RNR_MODE_*). `src` may be null
// only in mode AR (in place).
extern "C" int rnr_ring(const void* const* src, void* const* data,
                        void* const* comm, void* const* flags, int n,
                        long long per, long long tile, int lanes, int dtype,
                        int mode, void* flags_base, long long flags_bytes,
                        void* stream) {
  if (n < 2 || n > RNR_MAX_RANKS || lanes < 1 || tile <= 0 || tile % 128 ||
      per % tile || mode < RNR_MODE_AR || mode > RNR_MODE_AG ||
      (mode != RNR_MODE_AR && src == nullptr))
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.src[r] = src ? src[r] : nullptr;
    a.data[r] = data[r];
    a.comm[r] = comm[r];
    a.flags[r] = reinterpret_cast<unsigned*>(flags[r]);
  }
  a.n = n;
  a.lanes = lanes;
  a.mode = mode;
  a.per = per;
  a.tile = tile;
  a.lane = rnr_lane_elems(tile, lanes);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(flags_base, 0, (size_t)flags_bytes, s);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  const void* fn;
  if (dtype == RNR_DTYPE_F32)
    fn = reinterpret_cast<const void*>(ring_kernel<float>);
  else if (dtype == RNR_DTYPE_BF16)
    fn = reinterpret_cast<const void*>(ring_kernel<__nv_bfloat16>);
  else
    return (int)cudaErrorInvalidValue;
  e = cudaLaunchCooperativeKernel(fn, dim3((unsigned)(n * lanes)),
                                  dim3(RNR_RING_THREADS), args, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* rnr_ring_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
