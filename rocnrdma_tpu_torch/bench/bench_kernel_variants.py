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

    python -m rocnrdma_tpu_torch.bench.bench_kernel_variants --out chiprun_out/variants.jsonl

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
from rocnrdma_tpu_torch.ops import _build, local_cuda, ring_cuda

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
}


def build_variants() -> dict[str, ctypes.CDLL]:
    """Compile every variant, all ``nvcc`` processes at once."""
    root = os.path.join(_build.BUILD_DIR, "variants")
    procs = {}
    for name, (lib, apply) in VARIANTS.items():
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
    library; the ring's cached lanes and flags start afresh."""
    committed = _build.load

    def load(lib: str):
        return cdll if lib == name else committed(lib)
    _build.load = load
    ring_cuda._lanes.cache_clear()
    ring_cuda._FLAGS.clear()
    try:
        yield
    finally:
        _build.load = committed
        ring_cuda._lanes.cache_clear()
        ring_cuda._FLAGS.clear()


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


def run(args) -> list[dict]:
    topo = cli_common.setup_backend(None, "auto", default_ranks=1)
    libs = build_variants()
    n, rows = 8, []

    def row(**kw):
        rec = {"bench": "bench_kernel_variants", "device": topo.device_name, **kw}
        rows.append(rec)
        print(json.dumps(rec), flush=True)

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
    if args.out:
        with open(args.out, "a") as fp:
            for r in rows:
                fp.write(json.dumps(r) + "\n")
    return rows


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bench_kernel_variants",
                                description="ring and combine kernel variants")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--iters", type=int, default=5, help="calls per timed span")
    p.add_argument("--out", type=str, default=None, help="append JSONL rows here")
    return p


def main(argv=None) -> int:
    run(make_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
