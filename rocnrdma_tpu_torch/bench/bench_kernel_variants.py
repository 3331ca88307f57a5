"""``bench_kernel_variants`` - the design choices of the ring and combine
kernels (``ops/csrc/ring.cu``, ``ops/csrc/combine.cu``), each variant timed
beside the committed form in one process on the card. A variant is the
committed source with one substitution, compiled by ``nvcc`` into
``ops/_build/variants/`` (all at once) and swapped in for the wrappers'
library; every variant is first held bitwise to the plain version.

- ``ring_scope_sys``: the ring kernel's flags at system scope (the scope
  ranks on other GPUs need) instead of GPU scope. Timed: a 4 KiB-per-rank
  allreduce launch, device time, with and without its barrier and
  arrivals (``device_s``: the launches queued behind a spinning kernel).
- ring lanes covering the SMs twice instead of four times (the lane count
  is passed to the launch, no rebuild): every mode at 8 ranks x 1 GiB fp32.
- ``ring_ag_bulk``: the allgather staged through shared memory with 1-D
  bulk copies (``cp.async.bulk`` with an mbarrier; thread 0 loads a tile
  of the rank's chunk once and stores it to all n rows) instead of
  16-byte vector copies: 8 ranks x 1 GiB gathered fp32.
- ``combine_vecs{1,4,8}``, ``combine_threads128``: the combine kernel with
  1, 4 or 8 vectors a thread, or 128-thread blocks, beside ``torch.add``:
  k = 2 and 3 at 256 MiB fp32 per operand.
- The alltoall kernel (``ops/csrc/alltoall.cu``) at 8 ranks x 4 KiB, 16 MiB
  and 1 GiB fp32 per rank, each variant beside the committed form, so a
  gain splits into host path, fences and data pass:
  ``parent_host`` (the committed kernel behind the previous wrapper: an
  occupancy query, a fresh zeroed flag buffer, a ``Stream`` object and
  three ctypes pointer tables on every call); ``a2a_release_sys`` (the
  previous barrier: a system fence, then a ``red.release.sys`` per peer);
  ``a2a_scope_sys`` (one fence, system scope); ``a2a_sequential`` (the
  previous data pass: the n chunks one after another, four loads in flight
  a thread); ``a2a_bulk`` (the data pass as 1-D bulk copies through shared
  memory, ``cp.async.bulk`` with an mbarrier); lanes covering the SMs
  twice instead of four times; and ``parent`` (all of the previous form at
  once: its barrier, its data pass, twice the SMs and its host path).
  At 4 KiB each row has the host enqueue and the device time of a call
  (``enqueue_s``, ``device_s``) besides the event time; above it the event
  time of back-to-back calls.

    python -m rocnrdma_tpu_torch.bench.bench_kernel_variants --out chiprun_out/variants.jsonl
    python -m rocnrdma_tpu_torch.bench.bench_kernel_variants --parts alltoall

Each point is the mean of ``--iters`` back-to-back calls between CUDA
events, ``--rounds`` times in turns. With every rank on one GPU the times
are HBM numbers, not NVLink ones.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.timing import device_s, enqueue_s
from rocnrdma_tpu_torch.ops import _build, alltoall_cuda, local_cuda, ring_cuda

_AG_VECTOR_START = "  long long i = threadIdx.x;\n  if (a.mode == RNR_MODE_AG) {"
_AG_VECTOR_END = "  } else {\n    const int first"
_AG_BULK = r"""  long long i = threadIdx.x;
  if (a.mode == RNR_MODE_AG) {
    __shared__ alignas(128) unsigned char stage[4][8192];
    __shared__ alignas(8) unsigned long long full[4];
    if (threadIdx.x == 0) {
      const long long bytes = nv * 16, tiles = (bytes + 8191) / 8192;
      const char* in = reinterpret_cast<const char*>(static_cast<const T*>(a.src[r]) + lo);
      for (int s = 0; s < 4; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"((unsigned)__cvta_generic_to_shared(&full[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      auto size_of = [&](long long t) {
        return (unsigned)(bytes - t * 8192 < 8192 ? bytes - t * 8192 : 8192);
      };
      auto load = [&](long long t) {
        const unsigned mb = (unsigned)__cvta_generic_to_shared(&full[t % 4]);
        const unsigned sm = (unsigned)__cvta_generic_to_shared(&stage[t % 4][0]);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(mb), "r"(size_of(t)) : "memory");
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                     " [%0], [%1], %2, [%3];"
                     :: "r"(sm), "l"(in + t * 8192), "r"(size_of(t)), "r"(mb) : "memory");
      };
      for (long long t = 0; t < tiles && t < 4; ++t) load(t);
      for (long long t = 0; t < tiles; ++t) {
        const unsigned mb = (unsigned)__cvta_generic_to_shared(&full[t % 4]);
        unsigned done = 0;
        while (!done)
          asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                       " selp.u32 %0, 1, 0, p; }"
                       : "=r"(done) : "r"(mb), "r"((unsigned)((t / 4) & 1)) : "memory");
        const unsigned sm = (unsigned)__cvta_generic_to_shared(&stage[t % 4][0]);
        for (int d = 0; d < n; ++d) {
          char* q = reinterpret_cast<char*>(static_cast<T*>(a.dst[d]) + off) + t * 8192;
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                       :: "l"(q), "r"(sm), "r"(size_of(t)) : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        if (t + 4 < tiles) {
          asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          load(t + 4);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
    __syncthreads();
"""


def _ag_bulk(src: str) -> str:
    head, rest = src.split(_AG_VECTOR_START, 1)
    return head + _AG_BULK + _AG_VECTOR_END + rest.split(_AG_VECTOR_END, 1)[1]


_A2A_KERNEL = "template <typename T, int N, RnrScope S>\n__global__"
_A2A_RELEASE_SYS = r"""// the previous barrier: a system fence, then one release add per peer
__device__ __forceinline__ void meet_release_sys(unsigned* const* flags, int n,
                                                 int r, long long word,
                                                 unsigned target, const RnrDeadline&) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int s = 1; s < n; ++s)
      asm volatile("red.release.sys.global.add.u32 [%0], %1;"
                   :: "l"(flags[wrap(r + s, n)] + word), "r"(1u) : "memory");
  }
  wait_geq<kSys>(flags[r] + word, target);
}

"""
_A2A_SEQUENTIAL = r"""// the previous data pass: chunk after chunk, four loads in flight a thread
template <typename T, int N>
__device__ __forceinline__ void scatter_seq(const A2AArgs& a, int n, int r,
                                            long long lo, long long nv) {
  const int TH = RNR_BLOCK_THREADS;
  const long long cv = a.per * (long long)sizeof(T) / 16;
  const uint4* in = reinterpret_cast<const uint4*>(static_cast<const T*>(a.src[r]) + lo);
  const long long at = (r * a.per + lo) * (long long)sizeof(T) / 16;
  for (int s = 0; s < n; ++s) {
    const int d = wrap(r + s, n);
    const uint4* sp = in + d * cv;
    uint4* dp = reinterpret_cast<uint4*>(a.dst[d]) + at;
    long long i = threadIdx.x;
    for (; i + 3 * TH < nv; i += 4 * TH) {
      uint4 v0 = __ldcg(sp + i), v1 = __ldcg(sp + i + TH);
      uint4 v2 = __ldcg(sp + i + 2 * TH), v3 = __ldcg(sp + i + 3 * TH);
      __stcg(dp + i, v0);
      __stcg(dp + i + TH, v1);
      __stcg(dp + i + 2 * TH, v2);
      __stcg(dp + i + 3 * TH, v3);
    }
    for (; i < nv; i += TH) __stcg(dp + i, __ldcg(sp + i));
  }
}

"""
_A2A_BULK = r"""// the data pass as 1-D bulk copies: thread 0 streams 8 KiB tiles of all n
// chunks through 4 shared-memory stages, global -> shared on an mbarrier,
// shared -> global as bulk groups
template <typename T, int N>
__device__ __forceinline__ void scatter_bulk(const A2AArgs& a, int n, int r,
                                             long long lo, long long nv) {
  __shared__ alignas(128) unsigned char stage[4][8192];
  __shared__ alignas(8) unsigned long long full[4];
  if (threadIdx.x == 0 && nv > 0) {
    const long long bytes = nv * 16, pieces = (bytes + 8191) / 8192, tiles = n * pieces;
    const char* in = reinterpret_cast<const char*>(static_cast<const T*>(a.src[r]) + lo);
    const long long chunk = a.per * (long long)sizeof(T);
    const long long at = (r * a.per + lo) * (long long)sizeof(T);
    for (int s = 0; s < 4; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"((unsigned)__cvta_generic_to_shared(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    auto size_of = [&](long long t) {
      const long long left = bytes - (t % pieces) * 8192;
      return (unsigned)(left < 8192 ? left : 8192);
    };
    auto load = [&](long long t) {
      const unsigned mb = (unsigned)__cvta_generic_to_shared(&full[t % 4]);
      const unsigned sm = (unsigned)__cvta_generic_to_shared(&stage[t % 4][0]);
      const char* g = in + (t / pieces) * chunk + (t % pieces) * 8192;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(mb), "r"(size_of(t)) : "memory");
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                   " [%0], [%1], %2, [%3];"
                   :: "r"(sm), "l"(g), "r"(size_of(t)), "r"(mb) : "memory");
    };
    for (long long t = 0; t < tiles && t < 3; ++t) load(t);
    for (long long t = 0; t < tiles; ++t) {
      const unsigned mb = (unsigned)__cvta_generic_to_shared(&full[t % 4]);
      unsigned done = 0;
      while (!done)
        asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                     " selp.u32 %0, 1, 0, p; }"
                     : "=r"(done) : "r"(mb), "r"((unsigned)((t / 4) & 1)) : "memory");
      const unsigned sm = (unsigned)__cvta_generic_to_shared(&stage[t % 4][0]);
      char* q = static_cast<char*>(a.dst[t / pieces]) + at + (t % pieces) * 8192;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(q), "r"(sm), "r"(size_of(t)) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (t + 3 < tiles) {  // stage (t+3)%4 held tile t-1: its store must have read it
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(t + 3);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
  __syncthreads();
}

"""


def _a2a_release_sys(src: str) -> str:
    src = _sub(_A2A_KERNEL, _A2A_RELEASE_SYS + _A2A_KERNEL)(src)
    return _sub("meet<S>(", "meet_release_sys(")(src)


def _a2a_data_pass(name: str, body: str):
    def apply(src: str) -> str:
        src = _sub(_A2A_KERNEL, body + _A2A_KERNEL)(src)
        return _sub("scatter<T, N>(a, n, r, lo, nv);", f"{name}<T, N>(a, n, r, lo, nv);")(src)
    return apply


def _sub(old: str, new: str):
    def apply(src: str) -> str:
        if old not in src:
            raise SystemExit(f"variant substitution not found: {old!r}")
        return src.replace(old, new)
    return apply


# name -> (library, the substitution in its source)
VARIANTS = {
    "ring_scope_sys": ("ring", _sub("constexpr RnrScope kRingScope = kGpu;",
                                    "constexpr RnrScope kRingScope = kSys;")),
    "ring_ag_bulk": ("ring", _ag_bulk),
    "combine_vecs1": ("combine", _sub("#define RNR_COMBINE_VECS 2", "#define RNR_COMBINE_VECS 1")),
    "combine_vecs4": ("combine", _sub("#define RNR_COMBINE_VECS 2", "#define RNR_COMBINE_VECS 4")),
    "combine_vecs8": ("combine", _sub("#define RNR_COMBINE_VECS 2", "#define RNR_COMBINE_VECS 8")),
    "combine_threads128": ("combine", _sub("#define RNR_COMBINE_THREADS 256",
                                           "#define RNR_COMBINE_THREADS 128")),
    "a2a_scope_sys": ("alltoall", _sub("constexpr RnrScope kA2AScope = kGpu;",
                                       "constexpr RnrScope kA2AScope = kSys;")),
    "a2a_release_sys": ("alltoall", _a2a_release_sys),
    "a2a_sequential": ("alltoall", _a2a_data_pass("scatter_seq", _A2A_SEQUENTIAL)),
    "a2a_bulk": ("alltoall", _a2a_data_pass("scatter_bulk", _A2A_BULK)),
    "parent": ("alltoall", lambda src: _a2a_data_pass("scatter_seq", _A2A_SEQUENTIAL)(
        _a2a_release_sys(src))),
}
PARTS = ("ring", "combine", "alltoall")


def build_variants(libs=("ring", "combine", "alltoall")) -> dict[str, ctypes.CDLL]:
    """Compile every variant of the named libraries, all ``nvcc`` processes
    at once."""
    root = os.path.join(_build.BUILD_DIR, "variants")
    procs = {}
    for name, (lib, apply) in VARIANTS.items():
        if lib not in libs:
            continue
        d = os.path.join(root, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, f"{lib}.cu")
        with open(path) as fp:
            src = apply(fp.read())
        with open(path, "w") as fp:
            fp.write(src)
        so = os.path.join(d, f"lib{lib}.so")
        procs[name] = (lib, so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        cdll = ctypes.CDLL(so)
        for fn, (argtypes, restype) in _build._SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes, getattr(cdll, fn).restype = argtypes, restype
        libs[name] = cdll
    return libs


@contextlib.contextmanager
def swapped(name: str, cdll):
    """The wrappers run on ``cdll`` in place of the committed ``name``
    library; the cached lanes and flags start afresh."""
    committed = _build.load

    def load(lib: str):
        return cdll if lib == name else committed(lib)
    def clear():
        for mod in (ring_cuda, alltoall_cuda):
            mod._lanes.cache_clear()
            mod._FLAGS.clear()
    _build.load = load
    clear()
    try:
        yield
    finally:
        _build.load = committed
        clear()


def events_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _randn(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda")


def ring_part(args, libs, row, n: int = 8) -> None:
    # ring flags' scope: a 4 KiB-per-rank allreduce launch, device time
    x = _randn((n, 1024), 1)
    out = torch.empty_like(x)
    want = ring_cuda.ring_allreduce_plain(x)
    for rnd in range(args.rounds):
        for name in ("committed", "ring_scope_sys"):
            with (swapped("ring", libs[name]) if name != "committed"
                  else contextlib.nullcontext()):
                for sync in (True, False):
                    def fn(sync=sync):
                        ring_cuda._launch(x, out, n, 128, ring_cuda.MODE_AR, sync=sync)
                    out.zero_()
                    fn()
                    if not torch.equal(out, want):
                        raise SystemExit(f"{name}: disagrees with the plain version")
                    h = enqueue_s(fn, 200)
                    row(variant=name, what="ring AR 8 x 4 KiB kernel", sync=sync,
                        round=rnd, device_us=device_s(fn, 200, h) * 1e6)
    # ring lanes and the bulk-copy allgather, 8 x 1 GiB fp32
    per = (1 << 30) // 4 // n
    big = _randn((n, n * per), 2)
    rs_out = torch.empty((n, per), device="cuda")
    gat = _randn((n, per), 3)
    ag_out = torch.empty((n, n * per), device="cuda")
    modes = {"AR in place": (big, big, ring_cuda.MODE_AR),
             "RS": (big, rs_out, ring_cuda.MODE_RS),
             "AG": (gat, ag_out, ring_cuda.MODE_AG)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    four = ring_cuda._lanes(torch.cuda.current_device(), n, per, 0)
    two = min(four, -(-2 * sms // n))
    committed_lanes = ring_cuda._lanes
    for rnd in range(args.rounds):
        for lanes in (two, four):
            ring_cuda._lanes = lambda *_, lanes=lanes: lanes
            try:
                for what, (src, dst, mode) in modes.items():
                    ms = events_ms(lambda: ring_cuda._launch(src, dst, n, per, mode),
                                   args.iters)
                    row(variant=f"lanes {lanes}", what=f"ring {what} 8 x 1 GiB",
                        round=rnd, ms=ms)
            finally:
                ring_cuda._lanes = committed_lanes
        for name in ("committed", "ring_ag_bulk"):
            with (swapped("ring", libs[name]) if name != "committed"
                  else contextlib.nullcontext()):
                got = ring_cuda.ring_allgather(gat)
                if not torch.equal(got, gat.reshape(1, -1).expand(n, -1)):
                    raise SystemExit(f"{name}: allgather disagrees with the plain version")
                del got
                ms = events_ms(lambda: ring_cuda._launch(gat, ag_out, n, per,
                                                         ring_cuda.MODE_AG), args.iters)
                row(variant=name, what="ring AG 8 x 1 GiB gathered", round=rnd, ms=ms)
    del big, rs_out, gat, ag_out
    torch.cuda.empty_cache()


def combine_part(args, libs, row) -> None:
    # combine: vectors a thread and block size, beside torch.add
    xs = [_randn((64 << 20,), 10 + j) for j in range(3)]
    names = ("committed", "combine_vecs1", "combine_vecs4", "combine_vecs8",
             "combine_threads128")
    for k in (2, 3):
        ops_ = xs[:k]
        want = local_cuda.hbm_combine_plain(*ops_)
        for rnd in range(args.rounds):
            row(variant="torch.add", what=f"combine k={k} 256 MiB", round=rnd,
                ms=events_ms(lambda: local_cuda.hbm_combine_plain(*ops_), 4 * args.iters))
            for name in names:
                with (swapped("combine", libs[name]) if name != "committed"
                      else contextlib.nullcontext()):
                    if not torch.equal(local_cuda.hbm_combine(*ops_), want):
                        raise SystemExit(f"{name}: disagrees with the plain version")
                    row(variant=name, what=f"combine k={k} 256 MiB", round=rnd,
                        ms=events_ms(lambda: local_cuda.hbm_combine(*ops_),
                                     4 * args.iters))


def _parent_host_call(lib, x: torch.Tensor, lanes: int) -> torch.Tensor:
    """The previous wrapper's host path around the committed kernel, for an
    aligned (n, n, per) input: per call an occupancy query, a fresh zeroed
    flag buffer (epoch 1), a ``Stream`` object, three ctypes tables."""
    n, per = x.shape[0], x.shape[2]
    src = x.reshape(n, n * per)
    out = torch.empty_like(src)
    code = local_cuda.DTYPE_CODES[x.dtype]
    dev = x.device
    with torch.cuda.device(dev):
        q = lib.rnr_a2a_lanes(n, per, code, dev.index)
        _build.check(lib, "rnr_a2a_error", min(q, 0), "alltoall lane query")
        flags = torch.zeros((n, lanes * alltoall_cuda.FLAG_WORDS), dtype=torch.int32,
                            device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rnr_alltoall(*(_build.row_pointers(t, n) for t in (src, out, flags)),
                              n, per, lanes, code, 1, 1, dev.index, stream)
    _build.check(lib, "rnr_a2a_error", rc, "alltoall kernel launch (cooperative)")
    return out.view(x.shape)


def alltoall_part(args, libs, row, n: int = 8) -> None:
    """Every alltoall variant at 4 KiB, 16 MiB and 1 GiB fp32 per rank."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.cuda.current_device()
    committed_lanes = alltoall_cuda._lanes
    for label, rank_bytes in (("4 KiB", 4 << 10), ("16 MiB", 16 << 20), ("1 GiB", 1 << 30)):
        per = rank_bytes // 4 // n
        x = _randn((n, n, per), 20)
        want = alltoall_cuda.alltoall_plain(x)
        four = alltoall_cuda._lanes(dev, n, per, 0)
        two = min(four, -(-2 * sms // n))
        # name -> (library, lanes, host path)
        arms = {"committed": ("committed", four, "new"),
                "parent_host": ("committed", four, "parent"),
                "a2a_release_sys": ("a2a_release_sys", four, "new"),
                "a2a_scope_sys": ("a2a_scope_sys", four, "new"),
                "a2a_sequential": ("a2a_sequential", four, "new"),
                "a2a_bulk": ("a2a_bulk", four, "new"),
                f"lanes {two}": ("committed", two, "new"),
                "parent": ("parent", two, "parent")}
        for rnd in range(args.rounds):
            for name, (lib, lanes, host) in arms.items():
                with (swapped("alltoall", libs[lib]) if lib != "committed"
                      else contextlib.nullcontext()):
                    alltoall_cuda._lanes = lambda *_, lanes=lanes: lanes
                    try:
                        cdll = _build.load("alltoall")
                        fn = ((lambda: _parent_host_call(cdll, x, lanes)) if host == "parent"
                              else (lambda: alltoall_cuda.alltoall(x)))
                        if not torch.equal(fn(), want):
                            raise SystemExit(f"alltoall {name} {label}: disagrees with "
                                             f"the plain version")
                        rec = {"variant": name, "what": f"alltoall 8 x {label}",
                               "lanes": lanes, "round": rnd,
                               "events_us": events_ms(fn, args.iters) * 1e3}
                        if rank_bytes < 1 << 20:
                            h = enqueue_s(fn, 200)
                            rec.update(host_us=h * 1e6, device_us=device_s(fn, 200, h) * 1e6)
                        row(**rec)
                    finally:
                        alltoall_cuda._lanes = committed_lanes
        del x, want
        torch.cuda.empty_cache()


def run(args) -> list[dict]:
    topo = cli_common.setup_backend(None, "auto", default_ranks=1)
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        raise SystemExit(f"--parts takes {','.join(PARTS)}, got {args.parts}")
    libs = build_variants(parts)
    rows = []

    def row(**kw):
        rec = {"bench": "bench_kernel_variants", "device": topo.device_name, **kw}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    for part in parts:
        {"ring": ring_part, "combine": combine_part, "alltoall": alltoall_part}[part](
            args, libs, row)
    if args.out:
        with open(args.out, "a") as fp:
            for r in rows:
                fp.write(json.dumps(r) + "\n")
    return rows


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_kernel_variants",
                                description="ring, combine and alltoall kernel variants")
    p.add_argument("--parts", type=str, default=",".join(PARTS),
                   help="which kernels' variants: ring,combine,alltoall")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--iters", type=int, default=5, help="calls per timed span")
    p.add_argument("--out", type=str, default=None, help="append JSONL rows here")
    return p


def main(argv=None) -> int:
    run(make_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
