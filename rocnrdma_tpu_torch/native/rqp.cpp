// rqp — userspace shared-memory queue pairs with ibverbs-shaped semantics.
//
// The reference framework's L1 is an `ibv_*` queue-pair layer: create a QP,
// exchange connection handles out-of-band, register memory, post send/recv
// work requests, poll a completion queue. On the GPU the *device* data plane
// is the port's kernels and NCCL (see rocnrdma_tpu_torch/transport, /ops), but
// the framework still needs a native host-side control/bootstrap plane — the
// piece the reference built on verbs over the NIC. This file is that piece,
// rebuilt for single-host multi-process simulation: POSIX shared memory in
// place of the NIC, the same post_send / post_recv / poll_cq contract.
//
// One shm segment holds TWO unidirectional message rings (A->B and B->A).
// The `listen` side creates the segment; the `connect` side opens it with
// the rings swapped. Head/tail indices are C11-atomic monotonic counters in
// the shared mapping, so a pair of processes (or threads) can drive the ring
// lock-free (SPSC per direction). Messages are length-prefixed and padded to
// 8 bytes; a message never wraps (the writer inserts a wrap marker instead),
// which keeps payload copies contiguous for the reader.
//
// Exported C ABI (consumed by rocnrdma_tpu_torch/native/__init__.py via ctypes):
//   rqp_listen(name, capacity, mr_capacity) -> handle (creates the segment)
//   rqp_connect(name, timeout_ms)   -> handle   (opens it, swapped rings)
//   rqp_accept(handle, timeout_ms)  -> 0/-1     (wait for peer attach)
//   rqp_post_send(handle, buf, len) -> wr_id    (-1: ring full, retry)
//   rqp_post_recv(handle, buf, cap) -> wr_id    (queue a receive buffer)
//   rqp_poll_cq(handle, cqes, max)  -> n        (drain completions)
//   rqp_close(handle)               / rqp_unlink(name)
//
// One-sided RDMA (the ibv_wr_rdma_write / ibv_wr_rdma_read analogue). The
// segment carries an MR arena split in two halves, one per side; an MR is a
// bump-allocated span of the owner's half and its rkey (side|len|offset
// packed in a u64) is meaningful to EITHER side, so the initiator moves
// bytes with a direct memcpy into the shared mapping — the target's CPU is
// not involved, which is the defining property of one-sided RDMA (here shm
// stands in for the DMA engine):
//   rqp_reg_mr(handle, len)                  -> rkey  (-1: arena full)
//   rqp_mr_addr(handle, rkey)                -> local pointer (own mapping)
//   rqp_rdma_write(handle, rkey, off, buf, len) -> wr_id (CQE opcode WRITE)
//   rqp_rdma_read(handle, rkey, off, buf, len)  -> wr_id (CQE opcode READ)
//
// Completion semantics mirror verbs: a send completes once its bytes are in
// the ring (buffer reusable); a receive completes when a message has been
// copied into the oldest posted receive buffer. RQP_ERR_TRUNC is reported —
// not silently dropped — when a message exceeds the posted buffer. One-sided
// ops complete locally only (opcode RQP_OP_WRITE/READ); the target sees no
// CQE, exactly like the verbs.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x52515031;  // "RQP1"
constexpr uint32_t kAlign = 8;
constexpr uint32_t kWrapMarker = 0xFFFFFFFFu;

struct Ring {
  std::atomic<uint64_t> head;  // bytes written (monotonic)
  std::atomic<uint64_t> tail;  // bytes consumed (monotonic)
  char pad[48];                // keep the two counters off shared cache lines
};

struct ShmHdr {
  uint32_t magic;
  uint32_t capacity;               // data bytes per ring
  uint32_t mr_capacity;            // MR arena bytes per side
  std::atomic<uint32_t> attached;  // bit0 = listener, bit1 = connector
  std::atomic<uint32_t> mr_used[2];  // bump allocator per side's arena half
  Ring ring[2];                    // ring[0]: listener->connector; ring[1]: reverse
  // followed by: ring0 data[capacity], ring1 data[capacity],
  //              arena0[mr_capacity] (listener), arena1[mr_capacity]
};

struct RecvWr {
  int64_t wr_id;
  void* buf;
  uint32_t cap;
};

struct PendingSendCqe {
  int64_t wr_id;
  uint32_t len;
  int32_t opcode;  // RQP_OP_SEND / RQP_OP_WRITE / RQP_OP_READ
};

struct Handle {
  ShmHdr* hdr = nullptr;
  size_t map_len = 0;
  char* send_data = nullptr;  // data area of the ring this side writes
  char* recv_data = nullptr;
  char* arena[2] = {nullptr, nullptr};  // MR arena halves (by side)
  Ring* send_ring = nullptr;
  Ring* recv_ring = nullptr;
  bool is_listener = false;
  int64_t next_wr = 1;
  std::deque<RecvWr> recv_q;          // posted receive buffers, FIFO
  std::deque<PendingSendCqe> send_cq; // sends completed, not yet polled
  std::string shm_name;
};

uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000 + uint64_t(ts.tv_nsec) / 1000000;
}

uint32_t pad8(uint32_t n) { return (n + (kAlign - 1)) & ~(kAlign - 1); }

size_t map_len_for(uint32_t capacity, uint32_t mr_capacity) {
  return sizeof(ShmHdr) + (size_t(capacity) + size_t(mr_capacity)) * 2;
}

// rkey packing: [0][side:1][len:30][offset:32] — always non-negative, so
// the -1 error return stays unambiguous. Side names the arena half the MR
// lives in (0 = listener's), so a peer-received rkey resolves identically
// from both mappings.
int64_t pack_rkey(uint32_t side, uint32_t len, uint32_t off) {
  return (int64_t(side) << 62) | (int64_t(len) << 32) | int64_t(off);
}

Handle* attach(ShmHdr* hdr, size_t mlen, bool listener, const char* name) {
  Handle* h = new Handle();
  h->hdr = hdr;
  h->map_len = mlen;
  h->is_listener = listener;
  h->shm_name = name;
  char* data0 = reinterpret_cast<char*>(hdr) + sizeof(ShmHdr);
  char* data1 = data0 + hdr->capacity;
  h->arena[0] = data1 + hdr->capacity;
  h->arena[1] = h->arena[0] + hdr->mr_capacity;
  if (listener) {
    h->send_ring = &hdr->ring[0]; h->send_data = data0;
    h->recv_ring = &hdr->ring[1]; h->recv_data = data1;
  } else {
    h->send_ring = &hdr->ring[1]; h->send_data = data1;
    h->recv_ring = &hdr->ring[0]; h->recv_data = data0;
  }
  hdr->attached.fetch_or(listener ? 1u : 2u, std::memory_order_release);
  return h;
}

}  // namespace

extern "C" {

struct rqp_cqe {
  int64_t wr_id;
  int32_t opcode;  // 0 = send, 1 = recv
  int32_t status;  // 0 = ok, 1 = truncated
  uint32_t len;
  uint32_t pad_;
};

enum { RQP_OP_SEND = 0, RQP_OP_RECV = 1, RQP_OP_WRITE = 2, RQP_OP_READ = 3,
       RQP_OK = 0, RQP_ERR_TRUNC = 1 };

void* rqp_listen(const char* name, uint32_t capacity, uint32_t mr_capacity) {
  if (capacity < 64) return nullptr;
  capacity = pad8(capacity);
  mr_capacity = pad8(mr_capacity);
  if (mr_capacity > (1u << 30) - 1) return nullptr;  // rkey len field: 30 bits
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t mlen = map_len_for(capacity, mr_capacity);
  if (ftruncate(fd, off_t(mlen)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, mlen, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  ShmHdr* hdr = static_cast<ShmHdr*>(mem);
  std::memset(hdr, 0, sizeof(ShmHdr));
  hdr->capacity = capacity;
  hdr->mr_capacity = mr_capacity;
  std::atomic_thread_fence(std::memory_order_release);
  hdr->magic = kMagic;
  return attach(hdr, mlen, /*listener=*/true, name);
}

void* rqp_connect(const char* name, int timeout_ms) {
  uint64_t deadline = now_ms() + uint64_t(timeout_ms < 0 ? 0 : timeout_ms);
  for (;;) {
    int fd = shm_open(name, O_RDWR, 0600);
    if (fd >= 0) {
      struct stat st;
      if (fstat(fd, &st) == 0 && size_t(st.st_size) > sizeof(ShmHdr)) {
        void* probe = mmap(nullptr, sizeof(ShmHdr), PROT_READ, MAP_SHARED, fd, 0);
        if (probe != MAP_FAILED) {
          uint32_t magic = static_cast<ShmHdr*>(probe)->magic;
          uint32_t cap = static_cast<ShmHdr*>(probe)->capacity;
          uint32_t mr_cap = static_cast<ShmHdr*>(probe)->mr_capacity;
          munmap(probe, sizeof(ShmHdr));
          if (magic == kMagic) {
            size_t mlen = map_len_for(cap, mr_cap);
            void* mem =
                mmap(nullptr, mlen, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
            close(fd);
            if (mem == MAP_FAILED) return nullptr;
            return attach(static_cast<ShmHdr*>(mem), mlen,
                          /*listener=*/false, name);
          }
        }
      }
      close(fd);
    }
    if (now_ms() >= deadline) return nullptr;
    usleep(1000);
  }
}

int rqp_accept(void* hv, int timeout_ms) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h) return -1;
  uint32_t want = h->is_listener ? 2u : 1u;
  uint64_t deadline = now_ms() + uint64_t(timeout_ms < 0 ? 0 : timeout_ms);
  while (!(h->hdr->attached.load(std::memory_order_acquire) & want)) {
    if (now_ms() >= deadline) return -1;
    usleep(1000);
  }
  return 0;
}

// Post a send WR: copy [len][hdr][payload] into the ring if it fits. The
// copy IS the transfer (shm in place of the NIC DMA), so the completion is
// queued immediately and surfaces at the next poll_cq — same contract the
// verbs layer gives the caller: buffer reusable once the CQE is seen. The
// two-part form (hdr + payload gathered into ONE message) exists so a
// caller prefixing a small tag/header never has to concatenate in its own
// language first — the gather happens here, inside the one ring memcpy.
static int64_t post_send_gather(Handle* h, const void* hdr, uint32_t hdr_len,
                                const void* buf, uint32_t len) {
  if (!h || (hdr_len > 0 && !hdr) || (len > 0 && !buf)) return -1;
  uint64_t total64 = uint64_t(hdr_len) + len;
  if (total64 > 0xFFFFFFFFull - kAlign) return -1;  // u32 frame bound
  uint32_t total = uint32_t(total64);
  Ring* r = h->send_ring;
  uint32_t cap = h->hdr->capacity;
  uint32_t need = 4 + pad8(total);
  if (need + 4 > cap) return -1;  // can never fit (+4: wrap marker headroom)
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  uint32_t off = uint32_t(head % cap);
  uint32_t to_end = cap - off;
  uint32_t advance = 0;
  if (to_end < need) {
    // not enough contiguous room: emit wrap marker, restart at offset 0
    if (cap - (head - tail) < uint64_t(to_end) + need) return -1;  // full
    if (to_end >= 4)
      std::memcpy(h->send_data + off, &kWrapMarker, 4);
    advance = to_end;
    off = 0;
  } else if (cap - (head - tail) < need) {
    return -1;  // full
  }
  std::memcpy(h->send_data + off, &total, 4);
  if (hdr_len) std::memcpy(h->send_data + off + 4, hdr, hdr_len);
  if (len) std::memcpy(h->send_data + off + 4 + hdr_len, buf, len);
  r->head.store(head + advance + need, std::memory_order_release);
  int64_t id = h->next_wr++;
  h->send_cq.push_back({id, total, RQP_OP_SEND});
  return id;
}

int64_t rqp_post_send(void* hv, const void* buf, uint32_t len) {
  return post_send_gather(static_cast<Handle*>(hv), nullptr, 0, buf, len);
}

// Scatter-gather send: [hdr][payload] as one message, one ring pass.
int64_t rqp_post_send2(void* hv, const void* hdr, uint32_t hdr_len,
                       const void* buf, uint32_t len) {
  return post_send_gather(static_cast<Handle*>(hv), hdr, hdr_len, buf, len);
}

int64_t rqp_post_recv(void* hv, void* buf, uint32_t cap) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h || (cap > 0 && !buf)) return -1;
  int64_t id = h->next_wr++;
  h->recv_q.push_back({id, buf, cap});
  return id;
}

int rqp_poll_cq(void* hv, rqp_cqe* cqes, int max_cqes) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h || !cqes || max_cqes <= 0) return -1;
  int n = 0;
  // send-side completions first (sends and one-sided ops finish at post time)
  while (n < max_cqes && !h->send_cq.empty()) {
    PendingSendCqe c = h->send_cq.front();
    h->send_cq.pop_front();
    cqes[n++] = {c.wr_id, c.opcode, RQP_OK, c.len, 0};
  }
  // then drain incoming messages into posted receive buffers
  Ring* r = h->recv_ring;
  uint32_t cap = h->hdr->capacity;
  while (n < max_cqes && !h->recv_q.empty()) {
    uint64_t tail = r->tail.load(std::memory_order_relaxed);
    uint64_t head = r->head.load(std::memory_order_acquire);
    if (head == tail) break;  // nothing on the wire
    uint32_t off = uint32_t(tail % cap);
    uint32_t msg_len;
    if (cap - off < 4) {  // implicit wrap (marker didn't fit either)
      tail += cap - off;
      off = 0;
    }
    std::memcpy(&msg_len, h->recv_data + off, 4);
    if (msg_len == kWrapMarker) {
      tail += cap - off;
      off = 0;
      std::memcpy(&msg_len, h->recv_data + off, 4);
    }
    RecvWr wr = h->recv_q.front();
    h->recv_q.pop_front();
    uint32_t copy_len = msg_len <= wr.cap ? msg_len : wr.cap;
    if (copy_len && wr.buf)
      std::memcpy(wr.buf, h->recv_data + off + 4, copy_len);
    r->tail.store(tail + 4 + pad8(msg_len), std::memory_order_release);
    cqes[n++] = {wr.wr_id, RQP_OP_RECV,
                 msg_len <= wr.cap ? RQP_OK : RQP_ERR_TRUNC, copy_len, 0};
  }
  return n;
}

// -- one-sided RDMA ---------------------------------------------------------

// Register an MR of `len` bytes in THIS side's arena half; returns its rkey
// (valid on either side), or -1 when the arena is exhausted (registration is
// bump-allocated for the life of the segment, like a pinned region).
int64_t rqp_reg_mr(void* hv, uint32_t len) {
  Handle* h = static_cast<Handle*>(hv);
  // len bound: fits the 30-bit rkey field AND keeps pad8/off+need arithmetic
  // far from uint32 wraparound (a wrapped CAS would corrupt the watermark
  // and retroactively invalidate every issued rkey)
  if (!h || len == 0 || len > (1u << 30) - 1) return -1;
  uint32_t side = h->is_listener ? 0 : 1;
  uint32_t need = pad8(len);
  std::atomic<uint32_t>& used = h->hdr->mr_used[side];
  uint32_t off = used.load(std::memory_order_relaxed);
  for (;;) {
    if (uint64_t(off) + need > h->hdr->mr_capacity) return -1;
    if (used.compare_exchange_weak(off, off + need,
                                   std::memory_order_acq_rel))
      break;
  }
  return pack_rkey(side, len, off);
}

bool unpack_rkey(Handle* h, int64_t rkey, uint64_t off, uint32_t len,
                 char** ptr) {
  if (rkey < 0) return false;
  uint32_t side = uint32_t((rkey >> 62) & 1);
  uint32_t mr_len = uint32_t((rkey >> 32) & 0x3FFFFFFFu);
  uint32_t mr_off = uint32_t(rkey & 0xFFFFFFFFu);
  // the MR must lie entirely inside space the owner actually registered
  // (the bump-allocator watermark), so a forged in-capacity rkey is refused
  uint32_t used = h->hdr->mr_used[side].load(std::memory_order_acquire);
  if (mr_off + uint64_t(mr_len) > used) return false;
  // overflow-safe access check: `off + len` could wrap uint64
  if (off > mr_len || len > mr_len - off) return false;
  *ptr = h->arena[side] + mr_off + off;
  return true;
}

// Local pointer into an MR (own mapping) — both sides may use it; the rkey
// carries which arena half the MR lives in.
void* rqp_mr_addr(void* hv, int64_t rkey) {
  Handle* h = static_cast<Handle*>(hv);
  char* p = nullptr;
  if (!h || !unpack_rkey(h, rkey, 0, 0, &p)) return nullptr;
  return p;
}

// One-sided write: memcpy straight into the MR through the shared mapping
// (the DMA). Completes locally (CQE opcode RQP_OP_WRITE); no target CQE.
int64_t rqp_rdma_write(void* hv, int64_t rkey, uint64_t off, const void* buf,
                       uint32_t len) {
  Handle* h = static_cast<Handle*>(hv);
  char* dst = nullptr;
  if (!h || (len > 0 && !buf)) return -1;
  if (!unpack_rkey(h, rkey, off, len, &dst)) return -3;  // bad rkey/bounds
  if (len) std::memcpy(dst, buf, len);
  // release: a subsequent ring message (the usual "data ready" signal)
  // must not be observable before the written bytes
  std::atomic_thread_fence(std::memory_order_release);
  int64_t id = h->next_wr++;
  h->send_cq.push_back({id, len, RQP_OP_WRITE});
  return id;
}

// Standalone acquire fence: callers that observed a doorbell through a
// fenced read and then consume payload through a RAW mapping view (the
// zero-copy take path) place this between the flag load and the view
// loads — the rdma_read fence alone orders the FLAG load after earlier
// loads, not the view's loads after the flag.
void rqp_fence_acquire() {
  std::atomic_thread_fence(std::memory_order_acquire);
}

// One-sided read: memcpy out of the MR into a local buffer.
int64_t rqp_rdma_read(void* hv, int64_t rkey, uint64_t off, void* buf,
                      uint32_t len) {
  Handle* h = static_cast<Handle*>(hv);
  char* src = nullptr;
  if (!h || (len > 0 && !buf)) return -1;
  if (!unpack_rkey(h, rkey, off, len, &src)) return -3;  // bad rkey/bounds
  std::atomic_thread_fence(std::memory_order_acquire);
  if (len) std::memcpy(buf, src, len);
  int64_t id = h->next_wr++;
  h->send_cq.push_back({id, len, RQP_OP_READ});
  return id;
}

// How many bytes are sitting unread in the incoming ring (diagnostics).
uint64_t rqp_rx_pending(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h) return 0;
  Ring* r = h->recv_ring;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

void rqp_close(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  if (!h) return;
  h->hdr->attached.fetch_and(h->is_listener ? ~1u : ~2u,
                             std::memory_order_release);
  munmap(h->hdr, h->map_len);
  delete h;
}

int rqp_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
