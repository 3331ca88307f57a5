"""Native host-side queue pairs (the `ibv_*` layer rebuilt; SURVEY.md §1 L1).

The reference's lowest stratum is InfiniBand verbs + `hipMemRegister`: native
code that moves bytes between hosts and pins the buffers the NIC DMAs. The
port's *device* data plane needs none of that (its kernels and NCCL own the
card's memory and links), but the host plane keeps a native control plane
with the same shape: a C++ shared-memory queue-pair library (`rqp.cpp`) and
its TCP twin (`rtcp.cpp`), compiled on demand with the system toolchain
and driven here through ``ctypes`` — `listen / connect / accept /
post_send / post_recv / poll_cq`, verbs semantics, no CUDA.

The library is built from THIS package's sources into
``rocnrdma_tpu_torch/native/_build/`` (or ``$RQP_LIB_DIR/rocnrdma_tpu_torch``),
never from or into the JAX package's cache: a process that loads both
packages holds two separate libraries.

Used by the multi-process harness and the net-plugin vtable
(`transport/plugin.py`) for out-of-band control messages, rendezvous, and the
host-side (gloo-analogue) collective path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading
import time

from rocnrdma_tpu_torch import lockwitness as _lockwitness

_SRCS = [os.path.join(os.path.dirname(__file__), f)
         for f in ("rqp.cpp", "rtcp.cpp")]

# Sanitizer build flavors (ROCNRDMA_SANITIZE=asan|ubsan|tsan): the same
# sources, instrumented, cached in a per-flavor subdir of _build so the
# plain .so is never clobbered. ASAN/TSAN-instrumented code additionally
# needs its runtime loaded FIRST in the process — a ctypes host (python)
# must be launched with LD_PRELOAD pointing at the runtime;
# sanitizer_env() below builds that environment (the JAX package's
# tests/test_native_sanitize.py drives the same sources under each
# flavor: tsan is the data-race flavor, and the QP poll/wait paths are
# where the native threads actually share state).
_SANITIZE = os.environ.get("ROCNRDMA_SANITIZE", "").strip().lower()
_SAN_FLAGS = {
    "": [],
    "asan": ["-fsanitize=address", "-fno-omit-frame-pointer", "-g"],
    "ubsan": ["-fsanitize=undefined", "-fno-sanitize-recover=undefined",
              "-g"],
    "tsan": ["-fsanitize=thread", "-fno-omit-frame-pointer", "-g"],
}
# the flavor nests INSIDE an explicit RQP_LIB_DIR too: a sanitizer run
# must never pick up (or overwrite) the plain cached .so just because the
# cache location was overridden
# An explicit RQP_LIB_DIR may be shared with the JAX package, whose
# loader reads the same variable: the port nests under a directory of its
# own there, so it never loads a library built from the reference's
# sources (two copies of one library, side by side in one process).
_LIB_DIR = os.path.join(
    os.path.join(os.environ["RQP_LIB_DIR"], "rocnrdma_tpu_torch")
    if os.environ.get("RQP_LIB_DIR")
    else os.path.join(os.path.dirname(__file__), "_build"),
    _SANITIZE).rstrip("/")
_LIB = os.path.join(_LIB_DIR, "librqp.so")

_build_lock = _lockwitness.make_lock("native/__init__.py::_build_lock")
_lib = None


def sanitizer_env(flavor: str) -> dict:
    """Environment for a python process that should run the native layer
    under the ``flavor`` sanitizer build: selects the flavor
    (``ROCNRDMA_SANITIZE``), preloads the asan runtime where required,
    and configures the runtimes to fail loudly (abort on error; leak
    detection ON, with the interpreter's own allocations suppressed —
    python "leaks" by LSAN's accounting, the native library must not).
    """
    if flavor not in _SAN_FLAGS or not flavor:
        raise ValueError(f"unknown sanitizer flavor {flavor!r}; "
                         f"know {sorted(k for k in _SAN_FLAGS if k)}")
    env = {"ROCNRDMA_SANITIZE": flavor}
    if flavor == "asan":
        rt = subprocess.run(["g++", "-print-file-name=libasan.so"],
                            capture_output=True, text=True,
                            check=True).stdout.strip()
        env["LD_PRELOAD"] = rt
        env["ASAN_OPTIONS"] = "abort_on_error=1:detect_leaks=1"
        env["LSAN_OPTIONS"] = ("suppressions="
                               + os.path.join(os.path.dirname(__file__),
                                              "lsan.supp")
                               + ":print_suppressed=0")
    elif flavor == "ubsan":
        env["UBSAN_OPTIONS"] = "print_stacktrace=1:halt_on_error=1"
    elif flavor == "tsan":
        rt = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                            capture_output=True, text=True,
                            check=True).stdout.strip()
        env["LD_PRELOAD"] = rt
        # halt_on_error: a detected race must fail the test run, not
        # scroll past it. history_size at max: the QP poll loops are
        # hot and the default ring drops the racing stack otherwise.
        env["TSAN_OPTIONS"] = "halt_on_error=1:history_size=7"
    return env


def _as_cbuf(data):
    """(ctypes-passable buffer, nbytes) WITHOUT copying when possible.

    bytes pass through; any other C-contiguous buffer (numpy array,
    memoryview, bytearray) is wrapped via ``from_buffer`` — a borrowed
    view, valid because both native planes copy synchronously during the
    ctypes call (shm: memcpy into the shared arena; tcp: frame queued into
    conn-owned storage). Read-only non-bytes buffers still copy (ctypes
    cannot borrow them)."""
    if isinstance(data, bytes):
        return data, len(data)
    try:
        mv = memoryview(data).cast("B")
    except TypeError:
        # non-C-contiguous (strided numpy slice etc.): serialize, as the
        # old bytes(data) path always did for every input
        b = bytes(data)
        return b, len(b)
    if mv.readonly:
        b = bytes(mv)
        return b, len(b)
    return (ctypes.c_char * mv.nbytes).from_buffer(mv), mv.nbytes

OP_SEND = 0
OP_RECV = 1
OP_WRITE = 2   # one-sided RDMA write completed (initiator-side CQE)
OP_READ = 3    # one-sided RDMA read completed (initiator-side CQE)
OK = 0
ERR_TRUNC = 1
ERR_REMOTE = 2  # remote denied the one-sided access (bad rkey/bounds)


class _CQE(ctypes.Structure):
    _fields_ = [("wr_id", ctypes.c_int64), ("opcode", ctypes.c_int32),
                ("status", ctypes.c_int32), ("len", ctypes.c_uint32),
                ("pad", ctypes.c_uint32)]


@dataclasses.dataclass(frozen=True)
class Completion:
    """One completion-queue entry (the ``ibv_wc`` analogue)."""

    wr_id: int
    opcode: int   # OP_SEND | OP_RECV
    status: int   # OK | ERR_TRUNC
    length: int


def build(force: bool = False) -> str:
    """Compile rqp.cpp + rtcp.cpp → ``librqp.so`` with system g++ (cached).
    ``ROCNRDMA_SANITIZE=asan|ubsan`` selects an instrumented flavor in its
    own cache dir (``_build/<flavor>``)."""
    if _SANITIZE not in _SAN_FLAGS:
        raise ValueError(
            f"ROCNRDMA_SANITIZE={_SANITIZE!r} is not a build flavor; "
            f"know {sorted(k for k in _SAN_FLAGS if k)} (or unset)")
    with _build_lock:
        stale = (force or not os.path.exists(_LIB)
                 or os.path.getmtime(_LIB) < max(map(os.path.getmtime, _SRCS)))
        if stale:
            os.makedirs(_LIB_DIR, exist_ok=True)
            tmp = _LIB + f".tmp.{os.getpid()}"
            # -lrt: shm_open/shm_unlink live in librt on pre-2.34 glibc
            # (newer glibc ships an empty librt, so the flag is harmless
            # everywhere — without it the .so builds fine and then fails
            # at dlopen with "undefined symbol: shm_open")
            # the COMPILER is not the subject under test: when this
            # process itself runs under an LD_PRELOADed sanitizer runtime
            # (sanitizer_env), g++/cc1plus would inherit it and abort on
            # their own exit-time "leaks" before producing any .so
            env = {k: v for k, v in os.environ.items() if k != "LD_PRELOAD"}
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                 *_SAN_FLAGS[_SANITIZE], "-o", tmp,
                 *_SRCS, "-pthread", "-lrt"],
                check=True, capture_output=True, text=True, env=env)
            os.replace(tmp, _LIB)  # atomic: concurrent builds don't clash
    return _LIB


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except OSError:
        # a cached .so from another toolchain/glibc (e.g. built without
        # -lrt where shm_open needed it) can dlopen-fail while looking
        # fresh by mtime — rebuild once with today's flags before giving up
        lib = ctypes.CDLL(build(force=True))
    lib.rqp_listen.restype = ctypes.c_void_p
    lib.rqp_listen.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                               ctypes.c_uint32]
    lib.rqp_connect.restype = ctypes.c_void_p
    lib.rqp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rqp_accept.restype = ctypes.c_int
    lib.rqp_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rqp_post_send.restype = ctypes.c_int64
    lib.rqp_post_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint32]
    lib.rqp_post_recv.restype = ctypes.c_int64
    lib.rqp_post_recv.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_uint32]
    for pfx in ("rqp", "rtcp"):
        s2 = getattr(lib, f"{pfx}_post_send2")
        s2.restype = ctypes.c_int64
        s2.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                       ctypes.c_char_p, ctypes.c_uint32]
    lib.rqp_poll_cq.restype = ctypes.c_int
    lib.rqp_poll_cq.argtypes = [ctypes.c_void_p, ctypes.POINTER(_CQE),
                                ctypes.c_int]
    lib.rqp_rx_pending.restype = ctypes.c_uint64
    lib.rqp_rx_pending.argtypes = [ctypes.c_void_p]
    for pfx in ("rqp", "rtcp"):
        reg = getattr(lib, f"{pfx}_reg_mr")
        reg.restype = ctypes.c_int64
        reg.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        addr = getattr(lib, f"{pfx}_mr_addr")
        addr.restype = ctypes.c_void_p
        addr.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        wr = getattr(lib, f"{pfx}_rdma_write")
        wr.restype = ctypes.c_int64
        wr.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                       ctypes.c_char_p, ctypes.c_uint32]
        rd = getattr(lib, f"{pfx}_rdma_read")
        rd.restype = ctypes.c_int64
        rd.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                       ctypes.c_void_p, ctypes.c_uint32]
    lib.rqp_fence_acquire.restype = None
    lib.rqp_fence_acquire.argtypes = []
    lib.rqp_close.restype = None
    lib.rqp_close.argtypes = [ctypes.c_void_p]
    lib.rqp_unlink.restype = ctypes.c_int
    lib.rqp_unlink.argtypes = [ctypes.c_char_p]
    lib.rtcp_listen.restype = ctypes.c_void_p
    lib.rtcp_listen.argtypes = [ctypes.c_uint16]
    lib.rtcp_listen_port.restype = ctypes.c_int
    lib.rtcp_listen_port.argtypes = [ctypes.c_void_p]
    lib.rtcp_accept.restype = ctypes.c_void_p
    lib.rtcp_accept.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtcp_connect.restype = ctypes.c_void_p
    lib.rtcp_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                 ctypes.c_int]
    lib.rtcp_post_send.restype = ctypes.c_int64
    lib.rtcp_post_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
    lib.rtcp_post_recv.restype = ctypes.c_int64
    lib.rtcp_post_recv.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint32]
    lib.rtcp_poll_cq.restype = ctypes.c_int
    lib.rtcp_poll_cq.argtypes = [ctypes.c_void_p, ctypes.POINTER(_CQE),
                                 ctypes.c_int]
    lib.rtcp_tx_pending.restype = ctypes.c_uint64
    lib.rtcp_tx_pending.argtypes = [ctypes.c_void_p]
    lib.rtcp_wait_readable.restype = ctypes.c_int
    lib.rtcp_wait_readable.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rtcp_rx_pending.restype = ctypes.c_uint64
    lib.rtcp_rx_pending.argtypes = [ctypes.c_void_p]
    lib.rtcp_close.restype = None
    lib.rtcp_close.argtypes = [ctypes.c_void_p]
    lib.rtcp_close_listener.restype = None
    lib.rtcp_close_listener.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    """True if the native library is (or can be) built on this machine."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def fence_acquire() -> None:
    """Acquire fence: place between a doorbell/flag load (observed through
    any fenced path) and subsequent RAW ``MemoryRegion.view`` loads, so
    the view cannot observe pre-doorbell slot bytes on weakly-ordered
    CPUs. Pairs with the release fence ``rqp_rdma_write`` issues after its
    memcpy."""
    _load().rqp_fence_acquire()


class _Closeable:
    """Idempotent close + context-manager/teardown idiom, shared by every
    native handle wrapper. Subclasses implement ``_do_close``."""

    _closed = False

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._do_close()

    def _do_close(self) -> None:
        raise NotImplementedError

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class _QpBase(_Closeable):
    """Work-request plumbing shared by both wire planes (shm ``rqp_*`` and
    TCP ``rtcp_*``): posted-receive buffer ownership, completion draining,
    the bounded-retry blocking send/recv helpers, teardown. Subclasses bind
    a C-symbol prefix and add their plane's connection setup."""

    _PREFIX = ""                 # "rqp" | "rtcp"
    MAX_MSG = (1 << 32) - 1      # u32 frame bound; planes may tighten

    def __init__(self, handle: int, name: str):
        if not handle:
            raise OSError(f"{self._PREFIX}: could not open {name!r}")
        self._h = handle
        self.name = name
        self._recv_bufs: dict[int, bytearray] = {}
        # one-sided read destinations: wr_id -> (bytearray, ctypes view);
        # entries live until their completion is polled (the buffer is the
        # registered local MR of the read, verbs-style)
        self._read_bufs: dict[int, tuple] = {}
        # completions drained by a blocking helper while waiting for its own
        # wr; replayed (in order) by the next poll_cq so nothing is lost
        self._pending_cqes: list[tuple] = []
        self._closed = False
        # serializes the kernel-parked idle wait (rtcp_wait_readable, up
        # to 50 ms holding the raw native pointer inside C) against a
        # concurrent close(): _guard's closed-check alone is a TOCTOU —
        # close() freeing the Conn under a parked poll() is a
        # use-after-free the pre-park sleep-beat never risked
        self._wait_lock = _lockwitness.make_lock(
            "native/__init__.py::_QpBase._wait_lock")

    def _fn(self, op: str):
        return getattr(_load(), f"{self._PREFIX}_{op}")

    def _guard(self) -> None:
        # a verb on a CLOSED queue pair would hand freed native state to
        # C — observed as a segfault when a stale request handle pumped
        # its comm after an elastic heal's p2p teardown. Refuse here, in
        # Python, with the named error the failure contract promises.
        if self._closed:
            raise OSError(f"{self._PREFIX}: queue pair {self.name!r} "
                          f"is closed")

    # -- work requests -----------------------------------------------------

    def post_send(self, data: bytes) -> int:
        """Queue ``data`` for the peer; wr_id, or -1 on backpressure (retry),
        or -2 when the connection is dead."""
        self._guard()
        data = bytes(data)
        if len(data) > self.MAX_MSG:
            # ctypes would silently wrap the u32 length — a >4 GiB payload
            # must be an error, not a tiny frame with an OK completion
            raise ValueError(
                f"{self._PREFIX}: {len(data)} B message exceeds the "
                f"{self.MAX_MSG} B frame bound; chunk at the caller")
        return self._fn("post_send")(self._h, data, len(data))

    def send(self, data: bytes, timeout_s: float = 10.0) -> int:
        """``post_send`` with bounded retry on backpressure."""
        deadline = time.monotonic() + timeout_s
        while True:
            wr = self.post_send(data)
            if wr >= 0:
                return wr
            if wr == -2:
                raise OSError(f"{self._PREFIX}: peer closed/reset on {self.name!r}")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{self._PREFIX}: send backpressured past "
                                   f"deadline on {self.name!r}")
            time.sleep(0.0005)

    def post_send2(self, hdr: bytes, payload) -> int:
        """Scatter-gather post: ``[hdr][payload]`` travels as ONE message
        without a Python-side concatenation — the native layer gathers both
        parts directly into its ring/tx queue (the zero-copy tag-prefix
        send path: ``payload`` may be any C-contiguous buffer and is
        borrowed, not serialized). wr_id, -1 on backpressure (retry), -2
        when the connection is dead."""
        self._guard()
        data, n = _as_cbuf(payload)
        if len(hdr) + n > self.MAX_MSG:
            raise ValueError(
                f"{self._PREFIX}: {len(hdr) + n} B message exceeds the "
                f"{self.MAX_MSG} B frame bound; chunk at the caller")
        return self._fn("post_send2")(self._h, hdr, len(hdr), data, n)

    def post_recv(self, nbytes: int, buf: bytearray | None = None) -> int:
        """Register a receive buffer of ``nbytes``; returns its wr_id.
        ``buf``: an optional recycled bytearray (exactly ``nbytes`` long) to
        post instead of allocating — the comm-level buffer pool hands frames
        back here so the steady state allocates nothing."""
        self._guard()
        if buf is None or len(buf) != nbytes:
            buf = bytearray(nbytes)
        cbuf = (ctypes.c_char * nbytes).from_buffer(buf)
        wr = self._fn("post_recv")(self._h, cbuf, nbytes)
        if wr >= 0:
            self._recv_bufs[wr] = buf
        return wr

    def poll_cq(self, max_cqes: int = 16) -> list[tuple[Completion, object]]:
        """Drain completions; each recv completion carries its payload as a
        ZERO-COPY memoryview of the posted buffer (``payload.obj`` is the
        backing bytearray — recyclable via ``post_recv(buf=...)`` once the
        consumer is done; ``bytes(payload)`` if it must outlive the pool).
        Completions stashed by a blocking helper are replayed first."""
        self._guard()
        out = self._pending_cqes
        self._pending_cqes = []
        arr = (_CQE * max_cqes)()
        n = self._fn("poll_cq")(self._h, arr, max_cqes)
        if n == -2:
            if out:  # deliver what we have; the error resurfaces next poll
                return out
            raise OSError(f"{self._PREFIX}: peer closed/reset on {self.name!r}")
        for i in range(max(n, 0)):
            c = Completion(arr[i].wr_id, arr[i].opcode, arr[i].status,
                           arr[i].len)
            payload = None
            if c.opcode == OP_RECV:
                payload = memoryview(self._recv_bufs.pop(c.wr_id))[:c.length]
            elif c.opcode == OP_READ:
                self._read_bufs.pop(c.wr_id, None)  # dst now filled; release
            out.append((c, payload))
        return out

    def recv(self, timeout_s: float = 10.0) -> bytes:
        """Blocking receive of exactly one message.

        Posts its own 64 KiB buffer — but only when none is already
        outstanding, so a retry after a timeout reuses the posted WR instead
        of leaking one registered buffer per attempt.
        """
        if not self._recv_bufs:
            self.post_recv(1 << 16)
        deadline = time.monotonic() + timeout_s
        while True:
            # the wait lock covers this round's guard AND its native
            # poll_cq — close() holds the same lock around the native
            # free, so a concurrent close either lands between rounds
            # (the guard refuses named) or waits the round out; without
            # it the guard-then-poll gap hands C a freed handle. recv
            # is the blocking STORE-protocol receive, not the framed
            # data path, so the uncontended acquire per round is cheap.
            with self._wait_lock:
                self._guard()
                cqes = self.poll_cq()
            for c, payload in cqes:
                if c.opcode == OP_RECV:
                    if c.status != OK:
                        raise OSError(
                            f"{self._PREFIX}: recv truncated on {self.name!r}")
                    # bytes, not the poll_cq memoryview: recv()'s callers
                    # (bootstrap JSON RPCs) hold the payload past this call
                    return bytes(payload)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{self._PREFIX}: recv timed out on {self.name!r}")
            self._recv_idle(deadline)

    def _recv_idle(self, deadline: float) -> None:
        """One idle beat of the blocking ``recv`` wait. The shm plane
        spins with a short sleep (its ring has no waitable fd); the TCP
        plane overrides this with a kernel-level poll() on the socket —
        zero GIL churn from idle store-serving threads, instant wake on
        data (see ``rtcp_wait_readable``)."""
        time.sleep(0.0005)

    # -- one-sided RDMA ----------------------------------------------------

    def reg_mr(self, nbytes: int) -> "MemoryRegion":
        """Register an ``nbytes`` memory region with this QP (the
        ``ibv_reg_mr`` analogue). Share ``mr.rkey`` with the peer out of
        band (e.g. over ``send``); the peer then moves bytes with
        ``rdma_write`` / ``rdma_read`` while this side's CPU stays out of
        the path."""
        self._guard()
        rkey = self._fn("reg_mr")(self._h, nbytes)
        if rkey < 0:
            raise OSError(f"{self._PREFIX}: MR registration of {nbytes} B "
                          f"failed on {self.name!r} (arena full?)")
        return MemoryRegion(self, rkey, nbytes)

    def post_rdma_write(self, rkey: int, data, offset: int = 0) -> int:
        """One-sided write of ``data`` (bytes or any C-contiguous buffer —
        numpy arrays/memoryviews pass ZERO-COPY; both native planes copy
        into their own storage synchronously during the call, so the
        caller's buffer is free the moment this returns) into the MR named
        by ``rkey`` at ``offset``; wr_id (CQE opcode OP_WRITE), -1 on
        backpressure, raises on invalid rkey/bounds (shm plane detects
        locally)."""
        self._guard()
        data, _n = _as_cbuf(data)
        if len(data) > self.MAX_MSG:
            raise ValueError(
                f"{self._PREFIX}: {len(data)} B one-sided write exceeds the "
                f"{self.MAX_MSG} B bound; chunk at the caller")
        if offset < 0:
            raise ValueError(f"{self._PREFIX}: negative offset {offset}")
        wr = self._fn("rdma_write")(self._h, rkey, offset, data, len(data))
        if wr == -2:
            raise OSError(f"{self._PREFIX}: peer closed/reset on {self.name!r}")
        if wr == -3:
            raise OSError(f"{self._PREFIX}: invalid rkey/bounds for one-sided "
                          f"write on {self.name!r}")
        return wr

    def rdma_write(self, rkey: int, data: bytes, offset: int = 0,
                   timeout_s: float = 10.0) -> None:
        """Blocking one-sided write: post, then wait for the local CQE."""
        self._await_rdma(
            lambda: self.post_rdma_write(rkey, data, offset), OP_WRITE,
            timeout_s)

    def post_rdma_read(self, rkey: int, into: bytearray, offset: int = 0) -> int:
        """One-sided read of ``len(into)`` bytes from the MR at ``offset``
        into the caller's buffer; completes with a CQE (opcode OP_READ,
        status ERR_REMOTE if the target denied the access). The buffer must
        stay alive until the completion is polled — it IS the registered
        local MR, verbs-style."""
        self._guard()
        n = len(into)
        if n > self.MAX_MSG:
            raise ValueError(
                f"{self._PREFIX}: {n} B one-sided read exceeds the "
                f"{self.MAX_MSG} B bound; chunk at the caller")
        if offset < 0:
            raise ValueError(f"{self._PREFIX}: negative offset {offset}")
        cbuf = (ctypes.c_char * n).from_buffer(into)
        wr = self._fn("rdma_read")(self._h, rkey, offset, cbuf, n)
        if wr == -2:
            raise OSError(f"{self._PREFIX}: peer closed/reset on {self.name!r}")
        if wr == -3:
            raise OSError(f"{self._PREFIX}: invalid rkey/bounds for one-sided "
                          f"read on {self.name!r}")
        if wr >= 0:
            self._read_bufs[wr] = (into, cbuf)
        return wr

    def rdma_read(self, rkey: int, nbytes: int, offset: int = 0,
                  timeout_s: float = 10.0) -> bytes:
        """Blocking one-sided read; returns the fetched bytes."""
        out = bytearray(nbytes)
        self._await_rdma(
            lambda: self.post_rdma_read(rkey, out, offset), OP_READ,
            timeout_s)
        return bytes(out)

    def _await_rdma(self, post, opcode: int, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while True:
            wr = post()
            if wr >= 0:
                break
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{self._PREFIX}: one-sided op backpressured past "
                    f"deadline on {self.name!r}")
            time.sleep(0.0005)
        while True:
            mine = None
            for c, payload in self.poll_cq():
                if mine is None and c.wr_id == wr and c.opcode == opcode:
                    mine = c
                else:
                    # foreign CQEs drained while waiting are replayed by the
                    # next poll_cq — verbs semantics: nothing is lost
                    self._pending_cqes.append((c, payload))
            if mine is not None:
                if mine.status == ERR_REMOTE:
                    raise OSError(
                        f"{self._PREFIX}: remote denied one-sided access "
                        f"(bad rkey/bounds) on {self.name!r}")
                if mine.status != OK:
                    raise OSError(
                        f"{self._PREFIX}: one-sided op failed "
                        f"(status {mine.status}) on {self.name!r}")
                return
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{self._PREFIX}: one-sided completion timed out on "
                    f"{self.name!r}")
            time.sleep(0.0005)

    # -- teardown ----------------------------------------------------------

    def _do_close(self) -> None:
        # _closed is already True (close() flips it before dispatching
        # here); the wait lock lets a parked _recv_idle — or recv()'s
        # in-flight guard+poll_cq round, which drains these very
        # buffers — finish before they are cleared and the native
        # state is freed under it
        with self._wait_lock:
            # drop ctypes views into posted bytearrays before freeing
            self._recv_bufs.clear()
            self._read_bufs.clear()
            self._pending_cqes.clear()
            self._fn("close")(self._h)
        self._post_close()

    def _post_close(self) -> None:
        """Plane-specific cleanup hook (shm unlink etc.)."""


class MemoryRegion:
    """A registered memory region (the ``ibv_mr`` analogue).

    ``rkey`` is the token the peer uses for one-sided access — ship it out
    of band (typically over the QP's own send/recv). ``read``/``write`` give
    the OWNER byte access to the region through the local mapping.
    """

    def __init__(self, qp: "_QpBase", rkey: int, nbytes: int):
        self._qp = qp
        self.rkey = rkey
        self.nbytes = nbytes

    def _addr(self) -> int:
        addr = self._qp._fn("mr_addr")(self._qp._h, self.rkey)
        if not addr:
            raise OSError(f"{self._qp._PREFIX}: MR address lookup failed")
        return addr

    def read(self, offset: int = 0, nbytes: int | None = None) -> bytes:
        nbytes = self.nbytes - offset if nbytes is None else nbytes
        if offset < 0 or nbytes < 0 or offset + nbytes > self.nbytes:
            raise ValueError(f"read [{offset}, {offset + nbytes}) outside "
                             f"{self.nbytes} B MR")
        return ctypes.string_at(self._addr() + offset, nbytes)

    def view(self, offset: int = 0, nbytes: int | None = None):
        """ZERO-COPY uint8 numpy view of the region through the local
        mapping — the owner reading its own MR without the memcpy
        ``read`` pays. Ordering caveat: a raw view does not fence; when
        consuming a peer's one-sided write, establish visibility first by
        reading the (separately written) doorbell through the fenced path
        (``rdma_read``/``read``), the way ``_rdma_ring_io.take`` does. The
        view aliases the mapping: it is invalidated by ``close()`` and its
        bytes change whenever the peer writes — consume before releasing
        whatever protocol window (credit slot) protects it."""
        import numpy as np
        nbytes = self.nbytes - offset if nbytes is None else nbytes
        if offset < 0 or nbytes < 0 or offset + nbytes > self.nbytes:
            raise ValueError(f"view [{offset}, {offset + nbytes}) outside "
                             f"{self.nbytes} B MR")
        buf = (ctypes.c_char * nbytes).from_address(self._addr() + offset)
        return np.frombuffer(buf, np.uint8)

    def write(self, data: bytes, offset: int = 0) -> None:
        data = bytes(data)
        if offset < 0 or offset + len(data) > self.nbytes:
            raise ValueError(f"write [{offset}, {offset + len(data)}) outside "
                             f"{self.nbytes} B MR")
        ctypes.memmove(self._addr() + offset, data, len(data))


class QueuePair(_QpBase):
    """One endpoint of a shared-memory queue pair.

    ``QueuePair.listen(name)`` creates the channel; ``QueuePair.connect(name)``
    attaches the peer. Both then use verbs-style ``post_send`` /
    ``post_recv`` / ``poll_cq``. Posted receive *buffers* (bytearrays) stay
    owned by the QP until their completion is polled, mirroring memory
    registration: the buffer handed to ``post_recv`` is the registered MR.
    """

    _PREFIX = "rqp"

    def __init__(self, handle: int, name: str, is_listener: bool):
        super().__init__(handle, name)
        self.is_listener = is_listener

    # -- connection setup (listen / connect / accept) ----------------------

    @classmethod
    def listen(cls, name: str, capacity: int = 1 << 20,
               mr_capacity: int = 1 << 20) -> "QueuePair":
        lib = _load()
        lib.rqp_unlink(name.encode())  # drop stale segment from a dead run
        return cls(lib.rqp_listen(name.encode(), capacity, mr_capacity),
                   name, True)

    @classmethod
    def connect(cls, name: str, timeout_s: float = 10.0) -> "QueuePair":
        lib = _load()
        return cls(lib.rqp_connect(name.encode(), int(timeout_s * 1000)),
                   name, False)

    def accept(self, timeout_s: float = 10.0) -> None:
        """Block until the peer has attached."""
        if _load().rqp_accept(self._h, int(timeout_s * 1000)) != 0:
            raise TimeoutError(f"rqp: peer never attached to {self.name!r}")

    def rx_pending(self) -> int:
        """Unread bytes in the incoming ring (diagnostics)."""
        return _load().rqp_rx_pending(self._h)

    def tx_pending(self) -> int:
        """Bytes queued but not yet handed to the wire: always 0 on the
        shm plane — ``post_send`` memcpys into the shared ring (or
        backpressures with wr_id -1) synchronously during the call, so
        nothing ever waits in user space. Present for verb-surface parity
        with :class:`TcpQueuePair` (the conformance pass holds the two
        bindings to one surface), and it makes ``_flush_tx`` uniformly
        correct instead of feature-detected."""
        return 0

    def _post_close(self) -> None:
        if self.is_listener:
            _load().rqp_unlink(self.name.encode())


class TcpListener(_Closeable):
    """Listening endpoint of the TCP plane (``rtcp.cpp``).

    ``TcpListener()`` binds an ephemeral port; ``.handle`` ("host:port") is
    the out-of-band connection handle; ``.accept()`` yields one
    :class:`TcpQueuePair` per inbound peer (a listener can serve many).
    """

    def __init__(self, port: int = 0, host: str | None = None):
        self._h = _load().rtcp_listen(port)
        if not self._h:
            raise OSError(f"rtcp: could not listen on port {port}")
        self.port = _load().rtcp_listen_port(self._h)
        # the address peers dial: overridable for multi-host, loopback default
        self.host = host or os.environ.get("RTCP_HOST", "127.0.0.1")
        self.handle = f"{self.host}:{self.port}"

    def accept(self, timeout_s: float = 10.0) -> "TcpQueuePair":
        conn = _load().rtcp_accept(self._h, int(timeout_s * 1000))
        if not conn:
            raise TimeoutError(f"rtcp: no peer dialed {self.handle!r}")
        return TcpQueuePair(conn, self.handle)

    def _do_close(self) -> None:
        _load().rtcp_close_listener(self._h)


class TcpQueuePair(_QpBase):
    """One connected TCP queue pair: ``QueuePair``'s verbs surface, cross-host.

    Same work-request contract as the shm plane, a real socket underneath,
    so callers like the net-plugin's ``_HostComm`` run unchanged over either
    wire.
    """

    _PREFIX = "rtcp"
    # The 64 MiB tx/frame cap minus worst-case protocol overhead across every
    # frame kind (MSG header 8 B, WRITE 24 B, READ_RESP 20 B), with slack —
    # so any payload the bound admits fits every frame it may ride in.
    MAX_MSG = (64 << 20) - 64
    is_listener = False          # no shm segment to unlink at close

    @classmethod
    def connect(cls, handle: str, timeout_s: float = 10.0) -> "TcpQueuePair":
        """Dial a listener's ``"host:port"`` handle (retries until timeout)."""
        host, port = handle.rsplit(":", 1)
        conn = _load().rtcp_connect(host.encode(), int(port),
                                    int(timeout_s * 1000))
        return cls(conn, handle)

    def accept(self, timeout_s: float = 10.0) -> None:
        """Connected at construction — verbs parity no-op."""

    def tx_pending(self) -> int:
        """Bytes queued but not yet handed to the kernel (diagnostics)."""
        return _load().rtcp_tx_pending(self._h)

    def rx_pending(self) -> int:
        """Payload bytes parsed off the socket but not yet claimed by a
        posted receive (staged messages; diagnostics — the rtcp twin of
        the shm plane's unread-ring count)."""
        return _load().rtcp_rx_pending(self._h)

    def _recv_idle(self, deadline: float) -> None:
        # park in the kernel until the socket is readable (or there is
        # other progress to make — staged frames, queued tx, a dead
        # peer): the idle beat of blocking store-protocol receives.
        # Capped at 50 ms so a concurrent close() surfaces promptly.
        # The wait lock (held for at most one beat) keeps close() from
        # deleting the Conn while the poll reads it; the closed
        # re-check under the lock closes the check-then-park window.
        ms = max(1, min(50, int((deadline - time.monotonic()) * 1000)))
        with self._wait_lock:
            if self._closed:
                return
            _load().rtcp_wait_readable(self._h, ms)
