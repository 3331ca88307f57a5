// rtcp — TCP queue pairs: the rqp verbs contract over a real network socket.
//
// rqp.cpp gives the framework ibverbs-shaped queue pairs whose "wire" is a
// shared-memory segment — single-host only, the loopback analogue of the
// reference's NIC. This file is the cross-host half: the SAME post_send /
// post_recv / poll_cq contract over TCP, so the host control plane (and the
// gloo-analogue collectives riding the net-plugin vtable) span machines the
// way the reference's RDMA path did. RC-over-IP in spirit: reliable,
// connected, message-framed (4-byte length prefix; TCP_NODELAY).
//
// Exported C ABI (consumed by rocnrdma_tpu_torch/native/__init__.py via ctypes):
//   rtcp_listen(port)                     -> listener (port 0 = ephemeral)
//   rtcp_listen_port(l)                   -> bound port
//   rtcp_accept(l, timeout_ms)            -> conn
//   rtcp_connect(host, port, timeout_ms)  -> conn  (retries until deadline,
//                                            so connect-before-listen races
//                                            resolve like verbs rendezvous)
//   rtcp_post_send(c, buf, len) -> wr_id  (-1: tx queue full, retry)
//   rtcp_post_recv(c, buf, cap) -> wr_id
//   rtcp_poll_cq(c, cqes, max)  -> n      (THE progress engine: flushes tx,
//                                          parses rx frames, fills WRs)
//   rtcp_tx_pending(c) / rtcp_rx_pending(c) / rtcp_close(c) /
//   rtcp_close_listener(l)
//
// One-sided RDMA (ibv_wr_rdma_write/read over the socket). An MR here is a
// heap buffer owned by the connection; WRITE and READ travel as typed frames
// that the TARGET's progress engine applies directly to the MR — no posted
// receive, no target CQE — the soft-NIC emulation of what the reference's
// NIC did in hardware (iWARP does exactly this over TCP):
//   rtcp_reg_mr(c, len)                  -> rkey (-1: failure)
//   rtcp_mr_addr(c, rkey)                -> local pointer into the MR
//   rtcp_rdma_write(c, rkey, off, buf, len) -> wr_id (CQE op WRITE on flush)
//   rtcp_rdma_read(c, rkey, off, buf, len)  -> wr_id (CQE op READ on resp;
//                                           status ST_RERR if remote denied)
// A WRITE that violates the target's MR bounds breaks the connection (the
// verbs QP-error analogue); a bad READ returns a denied response instead,
// so the initiator gets a CQE, not a hang.
//
// Wire format: [len u32][type u32][body] little-endian. type 0 = MSG (user
// payload), 1 = WRITE [rkey i64][off u64][data], 2 = READ_REQ [req i64]
// [rkey i64][off u64][len u32], 3 = READ_RESP [req i64][status u32][data].
//
// Completion semantics: a send completes once every byte of its frame has
// been handed to the kernel (buffer reusable — the verbs contract); a recv
// completes when a whole message has landed in the oldest posted buffer,
// RQP_ERR_TRUNC if it didn't fit. Sockets are non-blocking; all progress
// happens inside post_send/poll_cq calls — no background threads.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

namespace {

// The wire format (4-byte length prefix) is LITTLE-ENDIAN by definition —
// the same byte order the Python layer pins for its tag headers. Every GPU
// host this targets (x86-64) is little-endian; make that assumption fail loudly at
// compile time rather than desynchronize framing at runtime.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "rtcp wire format is little-endian");

// CQE layout shared with rqp.cpp (keep field-for-field identical).
struct Cqe {
  int64_t wr_id;
  int32_t opcode;  // 0 = send, 1 = recv
  int32_t status;  // 0 = ok, 1 = truncated
  uint32_t len;
  uint32_t pad_;
};

enum { OP_SEND = 0, OP_RECV = 1, OP_WRITE = 2, OP_READ = 3,
       ST_OK = 0, ST_TRUNC = 1, ST_RERR = 2 };

enum : uint32_t { FR_MSG = 0, FR_WRITE = 1, FR_READ_REQ = 2, FR_READ_RESP = 3 };

constexpr uint64_t kTxCapBytes = 64ull << 20;  // pending-tx bound per conn
// Parsed-but-unclaimed inbound MSG bound. Generous on purpose: TCP is ONE
// ordered stream, so refusing to stage a MSG head-of-line-blocks every
// typed (one-sided) frame behind it. Below the bound we keep parsing so
// RDMA traffic flows even when the user posts no receives; at the bound we
// stop reading (kernel-buffer backpressure) — heap stays bounded either way.
constexpr int kMaxStagedMsgs = 4096;
constexpr uint64_t kMaxStagedBytes = 64ull << 20;
// Largest frame a peer may announce. Our own sender can never exceed the tx
// cap, so anything bigger is a corrupt or hostile header — without this cap
// a 4-byte 0xFFFFFFFF header would drive a ~4 GiB reserve() on the receiver.
constexpr uint32_t kMaxFrameBytes = uint32_t(kTxCapBytes);

uint64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000 + uint64_t(ts.tv_nsec) / 1000000;
}

struct Listener {
  int fd = -1;
  uint16_t port = 0;
};

struct TxMsg {
  int64_t wr_id;            // 0: internal frame (no completion emitted)
  int32_t opcode = OP_SEND; // CQE opcode when the frame finishes flushing
  std::vector<char> frame;  // [len u32][type u32][body]
  size_t sent = 0;
};

struct RecvWr {
  int64_t wr_id;
  void* buf;
  uint32_t cap;
};

struct RxMsg {
  std::vector<char> payload;
};

struct Mr {
  std::vector<char> buf;
};

struct PendingRead {
  int64_t wr_id;
  void* buf;
  uint32_t len;
};

struct SendDone {
  int64_t wr_id;
  int32_t opcode;
};

struct Conn {
  int fd = -1;
  int64_t next_wr = 1;
  bool broken = false;
  bool eof = false;  // peer sent orderly FIN
  std::deque<TxMsg> txq;
  uint64_t tx_bytes = 0;               // queued-not-yet-written bytes
  std::deque<SendDone> send_done;      // flushed sends/writes awaiting poll
  std::deque<RecvWr> recv_q;           // posted receive buffers, FIFO
  std::deque<RxMsg> staged;            // parsed messages with no WR yet
  uint64_t staged_bytes = 0;           // payload bytes held in `staged`
  // one-sided state
  std::vector<Mr> mrs;                 // rkey low bits index this
  std::deque<Cqe> rx_done;             // completed one-sided reads AND
                                       // direct-landed recvs awaiting poll
  std::vector<std::pair<int64_t, PendingRead>> pending_reads;  // req -> dst
  int64_t next_req = 1;
  // rx parse state: [len u32][type u32] read together into hdr, then the
  // BODY lands in `scratch` — one reusable heap buffer, grown
  // monotonically, never zero-filled — instead of the old per-frame
  // vector (which cost a 64 KiB bounce buffer + an insert copy + a
  // staging copy for every byte on the wire)
  char hdr[8];
  uint32_t hdr_have = 0;
  std::unique_ptr<char[]> scratch;
  uint32_t scratch_cap = 0;
  uint32_t cur_type = 0;               // known as soon as hdr completes
  uint32_t body_len = 0;               // frame body bytes (type excluded)
  uint32_t body_have = 0;
  bool mid_msg = false;
};

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void tune(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  set_nonblock(fd);
}

// Flush as much queued tx as the kernel will take; emit send completions.
void pump_tx(Conn* c) {
  while (!c->txq.empty()) {
    TxMsg& m = c->txq.front();
    while (m.sent < m.frame.size()) {
      ssize_t n = send(c->fd, m.frame.data() + m.sent, m.frame.size() - m.sent,
                       MSG_NOSIGNAL);
      if (n > 0) {
        m.sent += size_t(n);
        c->tx_bytes -= uint64_t(n);
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        return;  // kernel buffer full; try again at next progress call
      } else {
        c->broken = true;
        return;
      }
    }
    if (m.wr_id != 0) c->send_done.push_back({m.wr_id, m.opcode});
    c->txq.pop_front();
  }
}

// Append a frame to the tx queue. wr_id 0 marks internal (protocol) frames
// that complete silently. Returns false on backpressure (caller retries).
bool queue_frame(Conn* c, int64_t wr_id, int32_t opcode, uint32_t type,
                 const void* hdr_bytes, uint32_t hdr_len, const void* data,
                 uint32_t data_len, bool respect_cap) {
  // 64-bit arithmetic: data_len near 2^32 must reject, not wrap into a tiny
  // frame whose memcpy then overruns the heap (the ABI's own guard — the
  // Python MAX_MSG bound must not be the only thing standing)
  uint64_t body64 = 4 + uint64_t(hdr_len) + data_len;
  if (body64 > kMaxFrameBytes) return false;
  uint32_t body_len = uint32_t(body64);
  if (respect_cap && c->tx_bytes + 4 + body64 > kTxCapBytes) return false;
  TxMsg m;
  m.wr_id = wr_id;
  m.opcode = opcode;
  // reserve + range-insert, not resize + memcpy: resize value-initializes,
  // which at multi-MiB frames is a whole extra pass over the payload
  m.frame.reserve(4 + body_len);
  const char* p = reinterpret_cast<const char*>(&body_len);
  m.frame.insert(m.frame.end(), p, p + 4);
  p = reinterpret_cast<const char*>(&type);
  m.frame.insert(m.frame.end(), p, p + 4);
  if (hdr_len) {
    p = static_cast<const char*>(hdr_bytes);
    m.frame.insert(m.frame.end(), p, p + hdr_len);
  }
  if (data_len) {
    p = static_cast<const char*>(data);
    m.frame.insert(m.frame.end(), p, p + data_len);
  }
  c->tx_bytes += m.frame.size();
  c->txq.push_back(std::move(m));
  return true;
}

// Resolve rkey -> MR span with bounds checks (overflow-safe: `off + len`
// could wrap uint64 on hostile frames, so compare subtractively).
char* mr_span(Conn* c, int64_t rkey, uint64_t off, uint64_t len) {
  if (rkey < 0) return nullptr;
  uint32_t id = uint32_t(rkey & 0xFFFFFFFFu);
  uint32_t mr_len = uint32_t((rkey >> 32) & 0x3FFFFFFFu);
  if (id >= c->mrs.size()) return nullptr;
  Mr& mr = c->mrs[id];
  if (mr.buf.size() != mr_len) return nullptr;  // stale/forged rkey
  if (off > mr.buf.size() || len > mr.buf.size() - off) return nullptr;
  return mr.buf.data() + off;
}

// Apply one complete inbound frame (type in c->cur_type, body in scratch).
// Returns false when the frame is a protocol violation (connection breaks).
bool dispatch_frame(Conn* c) {
  uint32_t type = c->cur_type;
  const char* body = c->scratch.get();
  size_t blen = c->body_len;
  switch (type) {
    case FR_MSG: {
      // Fast path — a receive is already posted and nothing is queued
      // ahead of us: land the payload STRAIGHT in the caller's buffer
      // (one copy total on the rx side, down from three). The staged
      // queue must be empty or we would reorder past earlier messages.
      if (!c->recv_q.empty() && c->staged.empty()) {
        RecvWr wr = c->recv_q.front();
        c->recv_q.pop_front();
        uint32_t msg_len = uint32_t(blen);
        uint32_t copy_len = msg_len <= wr.cap ? msg_len : wr.cap;
        if (copy_len && wr.buf) std::memcpy(wr.buf, body, copy_len);
        c->rx_done.push_back({wr.wr_id, OP_RECV,
                              msg_len <= wr.cap ? int32_t(ST_OK)
                                                : int32_t(ST_TRUNC),
                              copy_len, 0});
        return true;
      }
      c->staged.push_back({std::vector<char>(body, body + blen)});
      c->staged_bytes += blen;
      return true;
    }
    case FR_WRITE: {  // [rkey i64][off u64][data] -> straight into the MR
      if (blen < 16) return false;
      int64_t rkey;
      uint64_t off;
      std::memcpy(&rkey, body, 8);
      std::memcpy(&off, body + 8, 8);
      char* dst = mr_span(c, rkey, off, blen - 16);
      if (!dst) return false;  // remote access error: QP goes to error state
      std::memcpy(dst, body + 16, blen - 16);
      return true;
    }
    case FR_READ_REQ: {  // [req i64][rkey i64][off u64][len u32]
      if (blen != 28) return false;
      int64_t req, rkey;
      uint64_t off;
      uint32_t len;
      std::memcpy(&req, body, 8);
      std::memcpy(&rkey, body + 8, 8);
      std::memcpy(&off, body + 16, 8);
      std::memcpy(&len, body + 24, 4);
      char* src = mr_span(c, rkey, off, len);
      uint32_t status = src ? ST_OK : ST_RERR;
      char rhdr[12];
      std::memcpy(rhdr, &req, 8);
      std::memcpy(rhdr + 8, &status, 4);
      // response bypasses the tx cap: it must not deadlock behind user tx
      queue_frame(c, 0, OP_SEND, FR_READ_RESP, rhdr, sizeof(rhdr),
                  src, src ? len : 0, /*respect_cap=*/false);
      return true;
    }
    case FR_READ_RESP: {  // [req i64][status u32][data]
      if (blen < 12) return false;
      int64_t req;
      uint32_t status;
      std::memcpy(&req, body, 8);
      std::memcpy(&status, body + 8, 4);
      for (auto it = c->pending_reads.begin(); it != c->pending_reads.end();
           ++it) {
        if (it->first != req) continue;
        PendingRead pr = it->second;
        c->pending_reads.erase(it);
        uint32_t got = uint32_t(blen - 12);
        uint32_t copy = got < pr.len ? got : pr.len;
        if (status == ST_OK && copy && pr.buf)
          std::memcpy(pr.buf, body + 12, copy);
        c->rx_done.push_back(
            {pr.wr_id, OP_READ,
             status != ST_OK ? int32_t(ST_RERR)
                             : (got < pr.len ? int32_t(ST_TRUNC)
                                             : int32_t(ST_OK)),
             status == ST_OK ? copy : 0, 0});
        return true;
      }
      return false;  // response to a request we never made
    }
    default:
      return false;
  }
}

// Read whatever is on the socket, parsing frames. Stops pulling a new MSG
// frame once `staged` is saturated so an unserviced peer backpressures
// through the kernel socket buffer instead of growing our heap without
// bound — but only MSG frames: one-sided WRITE/READ frames must flow even
// when the user posts no receives (that is the one-sided contract). The
// frame type arrives with the length in the 8-byte header, so the gate
// fires before any body byte is pulled.
// Should the in-flight frame wait before we pull/dispatch its body?
// - FR_MSG waits when staging is hard-bounded and no receive is posted.
// - FR_READ_REQ waits while our response backlog exceeds the tx cap: the
//   responses bypass the cap (they must not deadlock behind user tx), so
//   without this gate a peer posting reads it never polls would amplify its
//   bounded requests into an unbounded response heap on our side. Gating
//   reads cannot deadlock — pump_tx keeps draining regardless.
// - One-sided WRITE frames are never gated (their contract).
bool rx_gated(Conn* c) {
  if (!c->mid_msg) return false;
  if (c->cur_type == FR_MSG)
    return (int(c->staged.size()) >= kMaxStagedMsgs ||
            c->staged_bytes >= kMaxStagedBytes) &&
           c->recv_q.empty();
  if (c->cur_type == FR_READ_REQ) return c->tx_bytes >= kTxCapBytes;
  return false;
}

void ensure_scratch(Conn* c, uint32_t need) {
  if (c->scratch_cap < need) {
    uint32_t cap = c->scratch_cap ? c->scratch_cap : (1u << 16);
    while (cap < need) cap *= 2;
    c->scratch.reset(new char[cap]);  // raw heap: no value-init pass
    c->scratch_cap = cap;
  }
}

void pump_rx(Conn* c) {
  for (;;) {
    if (!c->mid_msg) {
      while (c->hdr_have < 8) {
        ssize_t n = recv(c->fd, c->hdr + c->hdr_have, 8 - c->hdr_have, 0);
        if (n > 0) {
          c->hdr_have += uint32_t(n);
        } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          return;
        } else if (n == 0) {  // orderly shutdown
          if (c->hdr_have != 0) c->broken = true;  // FIN mid-frame: torn
          else c->eof = true;
          return;
        } else {
          c->broken = true;
          return;
        }
      }
      uint32_t frame_len;
      std::memcpy(&frame_len, c->hdr, 4);
      if (frame_len > kMaxFrameBytes || frame_len < 4) {
        c->broken = true;  // protocol violation (every frame has a type)
        return;
      }
      std::memcpy(&c->cur_type, c->hdr + 4, 4);
      c->body_len = frame_len - 4;
      c->body_have = 0;
      c->hdr_have = 0;
      c->mid_msg = true;
      ensure_scratch(c, c->body_len);
    }
    // gate BEFORE pulling body bytes, so a saturated MSG queue
    // backpressures through the kernel socket buffer
    if (rx_gated(c)) return;
    while (c->body_have < c->body_len) {
      // straight into the reusable scratch buffer — no 64 KiB bounce
      // buffer, no per-frame vector growth, no second copy
      ssize_t n = recv(c->fd, c->scratch.get() + c->body_have,
                       c->body_len - c->body_have, 0);
      if (n > 0) {
        c->body_have += uint32_t(n);
      } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        return;
      } else {
        c->broken = true;
        return;
      }
    }
    if (!dispatch_frame(c)) {
      c->broken = true;
      return;
    }
    c->mid_msg = false;
  }
}

}  // namespace

extern "C" {

void* rtcp_listen(uint16_t port) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(port);
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(fd, 64) != 0) {
    close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  set_nonblock(fd);
  Listener* l = new Listener();
  l->fd = fd;
  l->port = ntohs(addr.sin_port);
  return l;
}

int rtcp_listen_port(void* lv) {
  Listener* l = static_cast<Listener*>(lv);
  return l ? int(l->port) : -1;
}

void* rtcp_accept(void* lv, int timeout_ms) {
  Listener* l = static_cast<Listener*>(lv);
  if (!l) return nullptr;
  uint64_t deadline = now_ms() + uint64_t(timeout_ms < 0 ? 0 : timeout_ms);
  for (;;) {
    int fd = accept(l->fd, nullptr, nullptr);
    if (fd >= 0) {
      tune(fd);
      Conn* c = new Conn();
      c->fd = fd;
      return c;
    }
    if (errno != EAGAIN && errno != EWOULDBLOCK) return nullptr;
    if (now_ms() >= deadline) return nullptr;
    struct pollfd p{l->fd, POLLIN, 0};
    poll(&p, 1, 20);
  }
}

void* rtcp_connect(const char* host, uint16_t port, int timeout_ms) {
  uint64_t deadline = now_ms() + uint64_t(timeout_ms < 0 ? 0 : timeout_ms);
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%u", unsigned(port));
  for (;;) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    if (getaddrinfo(host, portstr, &hints, &res) == 0 && res) {
      int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd >= 0) {
        set_nonblock(fd);  // BEFORE connect: the deadline must bound the
                           // kernel SYN cycle, not just the retry loop
        int rc = connect(fd, res->ai_addr, res->ai_addrlen);
        bool ok = (rc == 0);
        if (!ok && errno == EINPROGRESS) {
          uint64_t left = deadline > now_ms() ? deadline - now_ms() : 0;
          struct pollfd p{fd, POLLOUT, 0};
          if (poll(&p, 1, int(left)) > 0 && (p.revents & POLLOUT)) {
            int err = 0;
            socklen_t elen = sizeof(err);
            ok = (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen) == 0 &&
                  err == 0);
          }
        }
        if (ok) {
          freeaddrinfo(res);
          tune(fd);
          Conn* c = new Conn();
          c->fd = fd;
          return c;
        }
        close(fd);
      }
    }
    if (res) freeaddrinfo(res);
    if (now_ms() >= deadline) return nullptr;
    usleep(2000);  // listener may not be up yet: rendezvous retry
  }
}

int64_t rtcp_post_send(void* cv, const void* buf, uint32_t len) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || (len > 0 && !buf)) return -1;
  if (c->broken) return -2;  // dead conn, distinct from backpressure
  pump_tx(c);  // opportunistic flush frees queue room
  if (c->broken) return -2;
  int64_t id = c->next_wr;
  if (!queue_frame(c, id, OP_SEND, FR_MSG, nullptr, 0, buf, len,
                   /*respect_cap=*/true))
    return -1;  // backpressure
  c->next_wr++;
  pump_tx(c);
  return id;
}

// Scatter-gather send: [hdr][payload] as one MSG frame — queue_frame already
// gathers a header and a body into one frame, so a tag-prefixing caller
// never concatenates on its side.
int64_t rtcp_post_send2(void* cv, const void* hdr, uint32_t hdr_len,
                        const void* buf, uint32_t len) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || (hdr_len > 0 && !hdr) || (len > 0 && !buf)) return -1;
  if (c->broken) return -2;
  pump_tx(c);
  if (c->broken) return -2;
  int64_t id = c->next_wr;
  if (!queue_frame(c, id, OP_SEND, FR_MSG, hdr, hdr_len, buf, len,
                   /*respect_cap=*/true))
    return -1;
  c->next_wr++;
  pump_tx(c);
  return id;
}

// -- one-sided RDMA ---------------------------------------------------------

int64_t rtcp_reg_mr(void* cv, uint32_t len) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || len == 0 || len > (1u << 30) - 1) return -1;
  uint32_t id = uint32_t(c->mrs.size());
  c->mrs.push_back({std::vector<char>(len, 0)});
  return (int64_t(len) << 32) | int64_t(id);
}

void* rtcp_mr_addr(void* cv, int64_t rkey) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c) return nullptr;
  return mr_span(c, rkey, 0, 0);
}

int64_t rtcp_rdma_write(void* cv, int64_t rkey, uint64_t off, const void* buf,
                        uint32_t len) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || (len > 0 && !buf)) return -1;
  if (c->broken) return -2;
  pump_tx(c);
  if (c->broken) return -2;
  char whdr[16];
  std::memcpy(whdr, &rkey, 8);
  std::memcpy(whdr + 8, &off, 8);
  int64_t id = c->next_wr;
  if (!queue_frame(c, id, OP_WRITE, FR_WRITE, whdr, sizeof(whdr), buf, len,
                   /*respect_cap=*/true))
    return -1;
  c->next_wr++;
  pump_tx(c);
  return id;
}

int64_t rtcp_rdma_read(void* cv, int64_t rkey, uint64_t off, void* buf,
                       uint32_t len) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || (len > 0 && !buf)) return -1;
  if (c->broken) return -2;
  pump_tx(c);
  if (c->broken) return -2;
  int64_t req = c->next_req;
  char rhdr[28];
  std::memcpy(rhdr, &req, 8);
  std::memcpy(rhdr + 8, &rkey, 8);
  std::memcpy(rhdr + 16, &off, 8);
  std::memcpy(rhdr + 24, &len, 4);
  int64_t id = c->next_wr;
  if (!queue_frame(c, 0, OP_SEND, FR_READ_REQ, rhdr, sizeof(rhdr), nullptr, 0,
                   /*respect_cap=*/true))
    return -1;
  c->next_wr++;
  c->next_req++;
  c->pending_reads.push_back({req, {id, buf, len}});
  pump_tx(c);
  return id;
}

int64_t rtcp_post_recv(void* cv, void* buf, uint32_t cap) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || (cap > 0 && !buf)) return -1;
  int64_t id = c->next_wr++;
  c->recv_q.push_back({id, buf, cap});
  return id;
}

int rtcp_poll_cq(void* cv, Cqe* cqes, int max_cqes) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c || !cqes || max_cqes <= 0) return -1;
  pump_tx(c);
  pump_rx(c);
  int n = 0;
  while (n < max_cqes && !c->send_done.empty()) {
    SendDone d = c->send_done.front();
    c->send_done.pop_front();
    cqes[n++] = {d.wr_id, d.opcode, ST_OK, 0, 0};
  }
  while (n < max_cqes && !c->rx_done.empty()) {
    cqes[n++] = c->rx_done.front();
    c->rx_done.pop_front();
  }
  while (n < max_cqes && !c->staged.empty() && !c->recv_q.empty()) {
    RxMsg m = std::move(c->staged.front());
    c->staged.pop_front();
    c->staged_bytes -= uint64_t(m.payload.size());
    RecvWr wr = c->recv_q.front();
    c->recv_q.pop_front();
    uint32_t msg_len = uint32_t(m.payload.size());
    uint32_t copy_len = msg_len <= wr.cap ? msg_len : wr.cap;
    if (copy_len && wr.buf) std::memcpy(wr.buf, m.payload.data(), copy_len);
    cqes[n++] = {wr.wr_id, OP_RECV, msg_len <= wr.cap ? ST_OK : ST_TRUNC,
                 copy_len, 0};
  }
  // peer gone (and everything it sent already drained): surfaced, not hung
  if (n == 0 && (c->broken || (c->eof && c->staged.empty() && !c->mid_msg)))
    return -2;
  return n;
}

uint64_t rtcp_tx_pending(void* cv) {
  Conn* c = static_cast<Conn*>(cv);
  return c ? c->tx_bytes : 0;
}

int rtcp_wait_readable(void* cv, int timeout_ms) {
  // Kernel-level idle wait for the BLOCKING recv helper: park in poll()
  // (GIL released by the ctypes call) instead of a Python sleep/poll
  // loop. A process hosting the bootstrap store runs one serving thread
  // per client connection, and sub-ms Python polling across a dozen
  // idle connections measurably steals the GIL from that rank's data
  // path (observed: ~2x on every collective the store host runs).
  // Returns 1 when progress is possible now (readable socket, staged or
  // completed work, queued tx to flush, or a dead peer to surface), 0
  // on timeout, -1 on a bad handle.
  Conn* c = static_cast<Conn*>(cv);
  if (!c) return -1;
  if (!c->staged.empty() || !c->rx_done.empty() || !c->send_done.empty()
      || c->mid_msg || c->broken || c->eof)
    return 1;
  short ev = POLLIN;
  if (!c->txq.empty()) ev |= POLLOUT;  // queued tx: the pump must run
  struct pollfd p{c->fd, ev, 0};
  int r = poll(&p, 1, timeout_ms);
  return r < 0 ? -1 : (r > 0 ? 1 : 0);
}

uint64_t rtcp_rx_pending(void* cv) {
  // payload bytes parsed off the socket but not yet claimed by a posted
  // receive — the diagnostic twin of rqp_rx_pending's unread-ring count
  Conn* c = static_cast<Conn*>(cv);
  return c ? c->staged_bytes : 0;
}

void rtcp_close(void* cv) {
  Conn* c = static_cast<Conn*>(cv);
  if (!c) return;
  // Queued frames belong to sends whose completions may already have been
  // polled ("buffer reusable" != "delivered"); dropping them here would
  // strand the peer. Drain with a bounded wait, then half-close so the
  // peer reads clean EOF after the last frame.
  uint64_t deadline = now_ms() + 5000;
  while (!c->txq.empty() && !c->broken && now_ms() < deadline) {
    pump_tx(c);
    if (c->txq.empty() || c->broken) break;
    struct pollfd p{c->fd, POLLOUT, 0};
    poll(&p, 1, 50);
  }
  if (c->fd >= 0) {
    shutdown(c->fd, SHUT_WR);
    // Drain (and discard) already-arrived inbound bytes: close() on a socket
    // with unread rx data sends RST, which would retroactively destroy the
    // frames we just flushed out of the peer's receive buffer. Only wait
    // briefly for the peer's EOF — a peer that keeps its end open must not
    // turn close() into a multi-second stall.
    char sink[1 << 16];
    uint64_t eof_deadline = now_ms() + 250;
    for (;;) {
      ssize_t n = recv(c->fd, sink, sizeof(sink), 0);
      if (n > 0) continue;                      // discard pending data
      if (n == 0) break;                        // peer EOF: clean
      if (errno == EINTR) continue;             // signal: retry, not fatal
      if (errno != EAGAIN && errno != EWOULDBLOCK) break;
      if (now_ms() >= eof_deadline) break;      // peer still open: just go
      struct pollfd p{c->fd, POLLIN, 0};
      poll(&p, 1, 50);
    }
    close(c->fd);
  }
  delete c;
}

void rtcp_close_listener(void* lv) {
  Listener* l = static_cast<Listener*>(lv);
  if (!l) return;
  if (l->fd >= 0) close(l->fd);
  delete l;
}

}  // extern "C"
