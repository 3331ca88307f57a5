"""The CUDA IPC workspace of the kernels across processes.

On a 1-D mesh that spans processes (``rank_mesh(n, group=g)``, one rank a
process) the ring and alltoall kernels read and write the peers' rows
directly, as in one process, through pointers that CUDA IPC maps into
this process (``ops/csrc/ipc.cu``): on this card, or on another over
NVLink. Each process owns one device allocation, its ``Workspace``, laid
out as

- flag words: for each kernel (ring, alltoall) and each lane count L up to
  ``max_lanes``, a region of L * ``FLAG_WORDS`` words, zeroed once at the
  allocation and epoch-counted per (kernel, L) as the one-process
  wrappers count theirs (a launch e waits for e*(n-1) on each word);
- the input row and the output row, ``capacity`` bytes each.

A call copies this process's row into its input row, launches its rank's
blocks (``rnr_ring_rank`` / ``rnr_alltoall_rank``) with the tables of every
rank's input rows, output rows and flag region, and copies its result out
of its output row, all on the current stream; then it waits for them on
the host (``finish``), so that a bounded wait that expired surfaces at the
call that ran it, as ``PeerWaitExpired``. Only the barrier and the
arrivals of the kernels order the peers: a peer reads this input row, and
writes this output row, only between this process's entry into a launch
and its exit from it, and this process's copies happen before and after
on its own stream (``tests/test_torch_ring.py``'s protocol model).

The handles are exchanged once, with a header, by one all-gather on the
span's cross group (gloo while the processes share a card), and each
peer's allocation is opened once. A call that needs more bytes grows the
workspace: every process makes the same calls, so all grow at the same
call, each closes what it opened, allocates anew, and all exchange again.
The header carries the rank, the device, the capacity, the flag layout,
the launches so far and the call that grew it (kernel, dtype, chunk,
lanes); a peer whose header differs raises ``WorkspaceMismatch`` before
any launch. Calls that do not grow the workspace are not compared: a peer
that diverges there (another verb, size or dtype) is caught by the
kernels' bounded wait.

Every kernel of the path is built before the first exchange, so that no
peer is still compiling when another one's wait starts. ``close`` (and
``close_all``, from ``runtime.init.shutdown_runtime``) unmaps the peers,
waits on the cross group until every peer has unmapped this process's
allocation, and frees it, before the process group goes; at exit, or
after an aborted job, it only unmaps.
"""

from __future__ import annotations

import atexit
import ctypes

import torch

from rocnrdma_tpu_torch.ops import _build

# the bounded wait's deadline: a peer missing this long fails the launch
WAIT_TIMEOUT_S = 5.0
FLAG_WORDS = 2  # per lane, as ring.cu's RNR_FLAG_WORDS and alltoall.cu's
KERNELS = ("ring", "alltoall")  # the flag regions, in the workspace's order
DIAG_WORDS = 8  # common.cuh's RNR_DIAG_WORDS, its RNR_DIAG_* below
_STATE, _RANK, _LANE, _WORD, _SEEN, _TARGET, _EPOCH, _KERNEL = range(DIAG_WORDS)
# RNR_DIAG_KERNEL: ring.cu's modes, alltoall.cu's RNR_KERNEL_A2A
KERNEL_NAMES = {0: "ring (allreduce)", 1: "ring (reduce_scatter)",
                2: "ring (allgather)", 3: "alltoall"}
_ALIGN = 256  # bytes, every region's start
_GRAIN = 2 << 20  # capacity grows in whole 2 MiB
_HANDLE_WORDS = 8  # int64 words of the header holding the 64-byte handle

# live workspaces, closed by close_all
_LIVE: list = []


class PeerWaitExpired(RuntimeError):
    """A kernel across processes gave up waiting for its peers: one of them
    died, or made another call. The launch trapped, so this process's CUDA
    context is lost, as after an NCCL timeout."""


class WorkspaceMismatch(RuntimeError):
    """The processes of a span disagree on their workspaces (shape, dtype,
    lanes or the calls made so far): no kernel was launched."""


def _lib():
    return _build.load("ipc")


def _check(rc: int, what: str) -> None:
    _build.check(_lib(), "rnr_ipc_error", rc, what)


def _up(v: int, to: int) -> int:
    return -(-v // to) * to


class _Mem:
    """``nbytes`` of device memory at ``ptr`` as ``torch.as_tensor`` takes it
    (``__cuda_array_interface__``): a uint8 view, owning nothing."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {"shape": (nbytes,), "typestr": "|u1",
                                         "data": (ptr, False), "version": 2}


_DIAG: list = []  # [the host words, the device address], once a process


def diag():
    """This process's diagnostic words (``ops/csrc/ipc.cu``, rnr_ipc_diag):
    (the host array of ``DIAG_WORDS``, the device address kernels write)."""
    if not _DIAG:
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        _check(_lib().rnr_ipc_diag(ctypes.byref(host), ctypes.byref(dev)), "ipc diag words")
        _DIAG.extend([(ctypes.c_uint * DIAG_WORDS).from_address(host.value), dev.value])
    return _DIAG[0], _DIAG[1]


def expired(timeout_s: float = WAIT_TIMEOUT_S) -> PeerWaitExpired | None:
    """The error naming this process's expired wait, or None when no wait
    of this process expired."""
    if not _DIAG or _DIAG[0][_STATE] == 0:
        return None
    w = list(_DIAG[0])
    word = w[_WORD]
    what = "entry barrier" if word % FLAG_WORDS == 0 else "exit arrivals"
    return PeerWaitExpired(
        f"the {KERNEL_NAMES.get(w[_KERNEL], w[_KERNEL])} kernel across processes "
        f"gave up after {timeout_s:g} s: rank {w[_RANK]}, lane {w[_LANE]}, flag word "
        f"{word} ({what}) at launch {w[_EPOCH]} saw {w[_SEEN]}, waited for "
        f"{w[_TARGET]} ({(w[_TARGET] - w[_SEEN]) & 0xFFFFFFFF} arrival(s) missing): a "
        f"peer died or made another call. The launch trapped, so this process's "
        f"CUDA context is lost (as after an NCCL timeout): tear the job down")


class Workspace:
    """This process's CUDA IPC workspace for one ``ProcessSpan`` (module
    docstring), on ``device``."""

    def __init__(self, span, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"an IPC workspace lives on a CUDA device, got {device}")
        self.span, self.device = span, device
        self.n, self.rank = span.size, span.index
        self.timeout_s = WAIT_TIMEOUT_S
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        # the kernels' lanes cap (common.cuh, rnr_lanes): about 4 blocks an
        # SM over all n ranks
        self.max_lanes = -(-4 * sms // self.n)
        self._region = FLAG_WORDS * 4 * self.max_lanes * (self.max_lanes + 1) // 2
        self.flag_bytes = _up(len(KERNELS) * self._region, _ALIGN)
        self.capacity = 0
        self.base = None       # this process's allocation
        self.bases: tuple = ()  # every rank's, as mapped here (own at rank)
        self.epochs: dict = {}  # (kernel, lanes) -> launches of its flags
        self.launches = 0
        self._tables: dict = {}
        self._rows = None
        _build.build(("ipc", "ring_across", "alltoall_across"))
        _LIVE.append(self)

    # -- layout --------------------------------------------------------

    def _flags_off(self, kernel: str, lanes: int) -> int:
        if not 1 <= lanes <= self.max_lanes:
            raise ValueError(f"{lanes} lanes, the workspace holds 1..{self.max_lanes}")
        return (KERNELS.index(kernel) * self._region
                + FLAG_WORDS * 4 * lanes * (lanes - 1) // 2)

    def _offsets(self) -> tuple[int, int]:
        return self.flag_bytes, self.flag_bytes + self.capacity

    def tables(self, kernel: str, lanes: int) -> tuple:
        """The kernels' tables (every rank's input row, output row, flag
        region of ``kernel`` at ``lanes``), each a C array of n pointers."""
        key = (kernel, lanes)
        if key not in self._tables:
            i, o = self._offsets()
            f = self._flags_off(kernel, lanes)
            self._tables[key] = tuple((ctypes.c_void_p * self.n)(*[b + off for b in self.bases])
                                      for off in (i, o, f))
        return self._tables[key]

    def rows(self, dtype: torch.dtype, in_elems: int, out_elems: int,
             call: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """This process's input and output rows as ``dtype`` tensors of
        ``in_elems`` and ``out_elems``, the workspace grown first where it
        is too small (collectively: every process grows at the same call,
        ``call`` = (kernel, dtype code, chunk elements, lanes) in its
        header)."""
        isz = torch.empty((), dtype=dtype).element_size()
        need = max(in_elems, out_elems) * isz
        if need > self.capacity:
            self._grow(_up(need, _GRAIN), call)
        i, o = self._rows
        return i[:in_elems * isz].view(dtype), o[:out_elems * isz].view(dtype)

    # -- the exchange --------------------------------------------------

    def _header(self, handle: bytes, call: tuple) -> list:
        words = [self.rank, self.device.index, self.capacity, self.flag_bytes,
                 self.max_lanes, self.launches, *call]
        return words + list(int.from_bytes(handle[k:k + 8], "little", signed=True)
                            for k in range(0, 8 * _HANDLE_WORDS, 8))

    def _grow(self, capacity: int, call: tuple) -> None:
        from rocnrdma_tpu_torch.collectives._exchange import cross_allgather

        lib = _lib()
        hb = lib.rnr_ipc_handle_bytes()
        if hb > 8 * _HANDLE_WORDS:
            raise RuntimeError(f"a CUDA IPC handle of {hb} bytes does not fit the header")
        old = self.base
        self._unmap()
        base, handle = ctypes.c_void_p(), ctypes.create_string_buffer(8 * _HANDLE_WORDS)
        self.capacity = capacity
        _check(lib.rnr_ipc_alloc(self.flag_bytes + 2 * capacity, self.device.index,
                                 ctypes.byref(base), handle), "ipc workspace allocation")
        self.base = base.value
        mine = self._header(handle.raw, call)
        got = cross_allgather(torch.tensor(mine, dtype=torch.int64, device=self.device),
                              self.span).cpu().tolist()
        # every process has unmapped the old allocations: free ours
        if old is not None:
            _check(lib.rnr_ipc_free(ctypes.c_void_p(old), self.device.index),
                   "ipc workspace free")
        body = len(mine) - _HANDLE_WORDS
        for q, h in enumerate(got):
            same = h[2:body] == mine[2:body] and h[0] == q
            if not same:
                raise WorkspaceMismatch(
                    f"rank {q}'s IPC workspace header {h[:body]} differs from rank "
                    f"{self.rank}'s {mine[:body]} (rank, device, capacity, flag bytes, "
                    f"max lanes, launches so far, kernel, dtype code, chunk, lanes): the "
                    f"processes made other calls; no kernel was launched")
        bases = []
        for q, h in enumerate(got):
            if q == self.rank:
                bases.append(self.base)
                continue
            raw = b"".join(v.to_bytes(8, "little", signed=True) for v in h[body:])
            ptr = ctypes.c_void_p()
            _check(lib.rnr_ipc_open(raw, self.device.index, ctypes.byref(ptr)),
                   f"opening rank {q}'s IPC workspace (device {h[1]})")
            bases.append(ptr.value)
        self.bases = tuple(bases)
        self.epochs, self._tables = {}, {}  # a new allocation's flags are zero
        i, o = self._offsets()
        view = torch.as_tensor(_Mem(self.base, self.flag_bytes + 2 * capacity),
                               device=self.device)
        self._rows = (view[i:i + capacity], view[o:o + capacity])

    # -- a launch ------------------------------------------------------

    def launch(self, kernel: str, lanes: int, lib, fn: str, *args) -> None:
        """One launch of this rank's blocks on the current stream: ``lib``'s
        C entry ``fn`` (``rnr_ring_rank`` or ``rnr_alltoall_rank``) with the
        tables of ``kernel`` at ``lanes``, then ``args``, then this launch's
        epoch, the rank, the deadline, the diagnostic words, the device and
        the stream. The epoch advances only when the launch went in."""
        src, dst, flags = self.tables(kernel, lanes)
        epoch = self.epochs.get((kernel, lanes), 0) + 1
        device = self.device.index
        rc = getattr(lib, fn)(src, dst, flags, *args, epoch & 0xFFFFFFFF, self.rank,
                              int(self.timeout_s * 1e9), diag()[1], device,
                              torch._C._cuda_getCurrentRawStream(device))
        _build.check(lib, "rnr_ring_error" if kernel == "ring" else "rnr_a2a_error", rc,
                     f"{kernel} kernel launch across processes")
        self.epochs[(kernel, lanes)] = epoch
        self.launches += 1

    def finish(self) -> None:
        """Wait for this process's queued work; raise ``PeerWaitExpired``
        when a bounded wait of it expired."""
        try:
            torch.cuda.current_stream(self.device).synchronize()
        except RuntimeError as e:
            err = expired(self.timeout_s)
            if err is not None:
                raise err from e
            raise
        err = expired(self.timeout_s)
        if err is not None:
            raise err

    # -- teardown ------------------------------------------------------

    def _unmap(self) -> None:
        """Unmap every peer's allocation (errors ignored: after a trap the
        context is gone, and the process with it)."""
        lib = _lib()
        for q, b in enumerate(self.bases):
            if q != self.rank:
                lib.rnr_ipc_close(ctypes.c_void_p(b), self.device.index)
        self.bases, self._tables, self._rows = (), {}, None

    def close(self, collective: bool = True) -> None:
        """Unmap the peers and free this process's allocation; once. A peer
        maps that allocation until it has unmapped it, so the free waits
        for every process of the span to unmap (one all-gather on the cross
        group, as in ``_grow``). Without ``collective``, or after a wait of
        this process expired (a peer gone, the context lost), nothing waits
        and the allocation is left to the process's exit."""
        from rocnrdma_tpu_torch.collectives._exchange import cross_allgather

        if self in _LIVE:
            _LIVE.remove(self)
        if self.base is None:
            return
        self._unmap()
        if collective and expired(self.timeout_s) is None:
            cross_allgather(torch.zeros(1, dtype=torch.int32, device=self.device),
                            self.span).cpu()
            _lib().rnr_ipc_free(ctypes.c_void_p(self.base), self.device.index)
        self.base, self.capacity = None, 0


def close_all(collective: bool = True) -> None:
    """Close every live workspace of this process (``Workspace.close``)."""
    for ws in list(_LIVE):
        ws.close(collective)


# at exit the peers may be gone and the group with them: unmap only
atexit.register(close_all, False)
