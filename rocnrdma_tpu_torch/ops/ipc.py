"""The CUDA IPC workspace of the kernels across processes.

On a 1-D mesh that spans processes (``rank_mesh(n, group=g)``, one rank a
process) the kernels across processes store into the peers' rows
directly, through pointers that CUDA IPC maps into this process
(``ops/csrc/ipc.cu``): on this card, or on another over NVLink. Each
process owns one device allocation, its ``Workspace``, laid out as

- flag words: for each kernel (``push``, ``reduce``) and each lane count
  L up to its ``max_lanes``, a region of L * ``FLAG_WORDS[kernel]``
  words, zeroed once at the allocation and epoch-counted per (kernel, L)
  as the one-process wrappers count theirs (a launch e waits for e*(n-1)
  on each word);
- the input row and the output row, ``capacity`` bytes each.

Both kernels read this process's row where the caller holds it and only
store remotely (``ops/push_cuda.py``). The push kernel (``rnr_push_rank``:
allgather, alltoall) stores into the peers' output rows and drains its own
output row into the caller's result inside the launch: it takes the tables
of the output rows and flag regions. The reduce kernel
(``rnr_reduce_rank``: allreduce, reduce_scatter) stores the chunks its
peers own into their input rows, folds its own chunk from its input row
into the caller's result and, for the allreduce, stores the folded chunk
into the peers' output rows and drains its own: it takes the tables of the
input rows, the output rows and the flag regions. The push kernel's
wrappers stage a row they cannot read in place in this process's input
row, on the current stream before the launch. Then every call waits on
the host (``finish``), so that a bounded wait that expired surfaces at the
call that ran it, as ``PeerWaitExpired``. Only the barriers and the
arrivals of the kernels order the peers: a peer writes this process's
rows only between this process's entry into a launch and its exit from
it, since every launch starts with a barrier of all ranks, and each
launch reads the rows only after their arrivals (the protocol models of
``tests/test_torch_push.py`` and ``tests/test_torch_reduce.py``).

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
# per lane: push_across.cu's RNR_PUSH_WORDS, reduce_across.cu's
# RNR_RED_WORDS; the flag regions in the workspace's order
FLAG_WORDS = {"push": 9, "reduce": 17}
KERNELS = tuple(FLAG_WORDS)
_ERRORS = {"push": "rnr_push_error", "reduce": "rnr_reduce_error"}
# the row tables (0 input, 1 output) each kernel's C entry takes before its flags
_ROW_TABLES = {"push": (1,), "reduce": (0, 1)}
# sub-steps a lane at most, each with its arrival word (the reduce kernel:
# a reduce word and an allgather word): RNR_PUSH_MAX_STEPS, RNR_RED_MAX_STEPS
MAX_STEPS = 8
DIAG_WORDS = 8  # common.cuh's RNR_DIAG_WORDS, its RNR_DIAG_* below
_STATE, _RANK, _LANE, _WORD, _SEEN, _TARGET, _EPOCH, _KERNEL = range(DIAG_WORDS)
# RNR_DIAG_KERNEL: push_across.cu's RNR_KERNEL_PUSH, reduce_across.cu's
# RNR_KERNEL_REDUCE plus its mode (0 allreduce, 1 reduce_scatter)
KERNEL_NAMES = {4: "push (allgather, alltoall)", 5: "reduce (allreduce)",
                6: "reduce (reduce_scatter)"}
_PUSH_CODE = 4
# the lanes of a kernel with a card to itself: at most this many blocks an
# SM (ops/push_cuda.py's geometry stays within it)
BLOCKS_PER_SM_CAP = 4
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
    push = w[_KERNEL] == _PUSH_CODE
    k = word % FLAG_WORDS["push" if push else "reduce"] - 1
    what = ("entry barrier" if k < 0 else f"arrivals of sub-step {k}" if push
            else f"reduce arrivals of sub-step {k}" if k < MAX_STEPS
            else f"allgather arrivals of sub-step {k - MAX_STEPS}")
    return PeerWaitExpired(
        f"the {KERNEL_NAMES.get(w[_KERNEL], w[_KERNEL])} kernel across processes "
        f"gave up after {timeout_s:g} s: rank {w[_RANK]}, lane {w[_LANE]}, flag word "
        f"{word} ({what}) at launch {w[_EPOCH]} saw {w[_SEEN]}, waited for "
        f"{w[_TARGET]} ({(w[_TARGET] - w[_SEEN]) & 0xFFFFFFFF} arrival(s) missing): a "
        f"peer died or made another call. The launch trapped, so this process's "
        f"CUDA context is lost (as after an NCCL timeout): tear the job down")


def max_lanes(n: int, sms: int, per_card: int) -> dict:
    """The most lanes each kernel may launch with, on a card of ``sms``
    SMs that ``per_card`` of the span's n processes share: on a shared card
    the one-process ring kernel's cap (common.cuh, rnr_lanes: about 4
    blocks an SM over all n ranks, which must fit one card together), on a
    card of its own ``BLOCKS_PER_SM_CAP`` blocks an SM (its peers' grids
    are on their own cards)."""
    cap = -(-4 * sms // n) if per_card > 1 else BLOCKS_PER_SM_CAP * sms
    return dict.fromkeys(KERNELS, cap)


def _triangle(kernel: str, lanes: int) -> int:
    """Bytes of ``kernel``'s flag regions for 1..``lanes`` lanes."""
    return FLAG_WORDS[kernel] * 4 * lanes * (lanes + 1) // 2


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
        self.max_lanes = max_lanes(self.n, sms, span.per_card)
        self._regions, off = {}, 0
        for k in KERNELS:
            self._regions[k] = off
            off += _triangle(k, self.max_lanes[k])
        self.flag_bytes = _up(off, _ALIGN)
        self.capacity = 0
        self.base = None       # this process's allocation
        self.bases: tuple = ()  # every rank's, as mapped here (own at rank)
        self.epochs: dict = {}  # (kernel, lanes) -> launches of its flags
        self.launches = 0
        self._tables: dict = {}
        self._rows = None
        _build.build(("ipc", "push_across", "reduce_across"))
        _LIVE.append(self)

    # -- layout --------------------------------------------------------

    def _flags_off(self, kernel: str, lanes: int) -> int:
        if not 1 <= lanes <= self.max_lanes[kernel]:
            raise ValueError(f"{lanes} lanes of the {kernel} kernel, the workspace "
                             f"holds 1..{self.max_lanes[kernel]}")
        return self._regions[kernel] + _triangle(kernel, lanes - 1)

    def _offsets(self) -> tuple[int, int]:
        return self.flag_bytes, self.flag_bytes + self.capacity

    def tables(self, kernel: str, lanes: int) -> tuple:
        """``kernel``'s tables: every rank's rows it takes (``_ROW_TABLES``:
        the push kernel's output rows, the reduce kernel's input and output
        rows), then every rank's flag region of ``kernel`` at ``lanes``, each
        a C array of n pointers."""
        key = (kernel, lanes)
        if key not in self._tables:
            rows = self._offsets()
            offs = [rows[t] for t in _ROW_TABLES[kernel]] + [self._flags_off(kernel, lanes)]
            self._tables[key] = tuple((ctypes.c_void_p * self.n)(*[b + off for b in self.bases])
                                      for off in offs)
        return self._tables[key]

    def rows(self, dtype: torch.dtype, in_elems: int, out_elems: int,
             call: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """This process's input and output rows as ``dtype`` tensors of
        ``in_elems`` and ``out_elems``, the workspace grown first where it
        is too small (collectively: every process grows at the same call,
        ``call`` = (kernel, dtype code, chunk elements, lanes) in its
        header)."""
        isz = dtype.itemsize
        need = max(in_elems, out_elems) * isz
        if need > self.capacity:
            self._grow(_up(need, _GRAIN), call)
        i, o = self._rows
        return i[:in_elems * isz].view(dtype), o[:out_elems * isz].view(dtype)

    # -- the exchange --------------------------------------------------

    def _header(self, handle: bytes, call: tuple) -> list:
        words = [self.rank, self.device.index, self.capacity, self.flag_bytes,
                 *self.max_lanes.values(), self.launches, *call]
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
                    f"max lanes of the push and reduce kernels, launches so far, kernel, "
                    f"dtype code, chunk, lanes): the "
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
        C entry ``fn`` (``rnr_push_rank`` or ``rnr_reduce_rank``) with the
        tables of ``kernel`` at ``lanes``, then ``args``, then this launch's
        epoch, the rank, the deadline, the diagnostic words, the device and
        the stream. The epoch advances only when the launch went in."""
        epoch = self.epochs.get((kernel, lanes), 0) + 1
        device = self.device.index
        rc = getattr(lib, fn)(*self.tables(kernel, lanes), *args, epoch & 0xFFFFFFFF,
                              self.rank, int(self.timeout_s * 1e9), diag()[1], device,
                              torch._C._cuda_getCurrentRawStream(device))
        _build.check(lib, _ERRORS[kernel], rc, f"{kernel} kernel launch across processes")
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
