"""Build the port's CUDA kernels and load them with ctypes.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` on its own into
``ops/_build/lib<name>_<hash>.so`` (a plain C interface: pointers and the
stream travel as ``c_void_p``), at first use, so a fresh checkout builds
everything the first time a kernel is called. ``push_across.cu`` is the
allgather and alltoall across processes, ``reduce_across.cu`` the
allreduce and reduce_scatter there. ``build()`` starts one ``nvcc`` per
library at once and waits for all. The hash
covers the sources and the flags, so an edited kernel is rebuilt and a
current one is reused.
A failed build raises with the ``nvcc`` command and its output; nothing
falls back.

Importing this module runs nothing: ``nvcc`` exists only on the machine
with the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("alltoall", "combine", "ipc", "push_across", "reduce_across", "ring")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_VP, _INT, _UINT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
_ULL, _PVP = ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_void_p)
# argtypes/restype of every exported C function, by library
_SIGNATURES = {
    "alltoall": {
        "rnr_a2a_lanes": ([_INT, _LL, _INT, _INT], _INT),
        "rnr_alltoall": ([_VP, _VP, _VP, _INT, _LL, _INT, _INT, _UINT, _INT, _INT,
                          _VP], _INT),
        "rnr_alltoall_rows": ([_VP, _LL, _VP, _LL, _VP, _LL, _INT, _LL, _INT, _INT,
                               _UINT, _INT, _INT, _VP], _INT),
        "rnr_a2a_error": ([_INT], ctypes.c_char_p),
    },
    "combine": {
        "rnr_combine": ([_VP, _INT, _VP, _LL, _INT, _INT, _VP], _INT),
        "rnr_combine_error": ([_INT], ctypes.c_char_p),
    },
    "push_across": {
        "rnr_push_resident": ([_INT, _INT], _INT),
        "rnr_push_rank": ([_VP, _VP, _VP, _LL, _VP, _INT, _LL, _INT, _LL, _LL, _INT, _INT,
                           _UINT, _INT, _ULL, _VP, _INT, _VP], _INT),
        "rnr_push_error": ([_INT], ctypes.c_char_p),
    },
    "reduce_across": {
        "rnr_reduce_resident": ([_INT, _INT, _INT, _INT], _INT),
        "rnr_reduce_rank": ([_VP, _VP, _VP, _VP, _VP, _INT, _LL, _INT, _LL, _LL, _INT, _INT,
                             _INT, _INT, _UINT, _INT, _ULL, _VP, _INT, _VP], _INT),
        "rnr_reduce_error": ([_INT], ctypes.c_char_p),
    },
    "ipc": {
        "rnr_ipc_handle_bytes": ([], _INT),
        "rnr_ipc_alloc": ([_LL, _INT, _PVP, _VP], _INT),
        "rnr_ipc_open": ([_VP, _INT, _PVP], _INT),
        "rnr_ipc_close": ([_VP, _INT], _INT),
        "rnr_ipc_free": ([_VP, _INT], _INT),
        "rnr_ipc_diag": ([_PVP, _PVP], _INT),
        "rnr_ipc_error": ([_INT], ctypes.c_char_p),
    },
    "ring": {
        "rnr_ring_lanes": ([_INT, _LL, _INT], _INT),
        "rnr_ring": ([_VP, _VP, _VP, _INT, _LL, _INT, _INT, _INT, _UINT, _INT,
                      _INT, _VP], _INT),
        "rnr_ring_error": ([_INT], ctypes.c_char_p),
    },
}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as fp:
                h.update(fn.encode() + fp.read())
    return h.hexdigest()[:12]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_digest(name)}.so")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once. Returns {name: library path}."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (cmd, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, todo[name])  # atomic: concurrent builders agree
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if needed), with the argtypes
    and restype of each exported function declared."""
    lib = ctypes.CDLL(build([name])[name])
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, restype
    return lib


def row_pointers(t, n: int) -> ctypes.Array:
    """A C table of the addresses of rows 0..n-1 of tensor ``t`` (the
    per-rank pointer tables the kernels take), passed where an argument is
    a ``c_void_p``. The caller keeps ``t`` alive while the kernel may use
    it."""
    base, stride = t.data_ptr(), t.stride(0) * t.element_size()
    return (ctypes.c_void_p * n)(*range(base, base + n * stride, stride))


def check(lib: ctypes.CDLL, err_fn: str, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = getattr(lib, err_fn)(abs(rc)).decode()
        raise RuntimeError(f"{what} failed: CUDA error {abs(rc)} ({msg})")
