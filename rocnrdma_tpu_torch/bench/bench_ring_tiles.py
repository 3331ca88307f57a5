"""``bench_ring_tiles`` - the ring kernel's two tiers side by side: the
one-tile tier (``ring_allreduce``: one tile per chunk, out of place) and
the tiled tier (``hbm_ring_allreduce``: chunks cut into ``tile_rows * 128``
element tiles, in place) at several ``tile_rows``, at each size. These are
the numbers behind ``cuda_ring``'s tier policy in ``transport/api.py``.

    python -m rocnrdma_tpu_torch.bench.bench_ring_tiles --ranks 8 \\
        --sizes 4M,16M,64M,256M,1G --tile-rows 512,2048,8192,32768,131072

A tile count that does not fit a chunk (``tile_rows * 128`` elements above
the chunk) is skipped: it would pad the chunk, not tile it. Every point is
first held bitwise to its plain version, then timed. ``mini_hops`` is the
kernel's (step, tile) hop count, ``2 * (n-1) * tiles``. With every rank on
one GPU the times are HBM numbers, not NVLink ones.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.runner import DTYPES, parse_size
from rocnrdma_tpu_torch.bench.timing import time_fn
from rocnrdma_tpu_torch.ops import ring_cuda


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bench_ring_tiles",
        description="ring kernel: one-tile tier vs the tiled tier per tile size")
    p.add_argument("--ranks", type=int, default=8)
    p.add_argument("--sizes", type=str, default="4M,16M,64M,256M,1G",
                   help="comma list of per-rank bytes")
    p.add_argument("--tile-rows", type=str, default="512,2048,8192,32768,131072")
    p.add_argument("--dtypes", type=str, default="float32")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--iters", type=int, default=3, help="calls per timed repeat")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", type=str, default=None, help="append JSONL records here")
    return p


def run(args) -> list[dict]:
    topo = cli_common.setup_backend(args.ranks, args.platform)
    n, dev = args.ranks, topo.device
    tile_rows = [int(t) for t in args.tile_rows.split(",")]
    rng = np.random.default_rng(0)
    rows = []
    for dname in args.dtypes.split(","):
        dtype = DTYPES[dname]
        isz = dtype.itemsize
        for size in (parse_size(s) for s in args.sizes.split(",")):
            elems = size // isz
            per = -(-elems // n)
            x = torch.from_numpy(rng.standard_normal((n, elems), dtype=np.float32)
                                 ).to(dev).to(dtype)
            tiers = [("one_tile", None)] + [("tiled", tr) for tr in tile_rows
                                            if tr * ring_cuda.LANES <= per]
            for tier, tr in tiers:
                if tr is None:
                    fn = ring_cuda.ring_allreduce
                    got, want = fn(x), ring_cuda.ring_allreduce_plain(x)
                    tiles, arg = 1, x
                else:
                    def fn(v, tr=tr):
                        return ring_cuda.hbm_ring_allreduce(v, tile_rows=tr)
                    arg = x.clone()
                    got = fn(x.clone())
                    want = ring_cuda.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr)
                    tiles = -(-per // (tr * ring_cuda.LANES))
                if not torch.equal(got, want):
                    raise SystemExit(f"{tier} tile_rows={tr} at {size} B: kernel "
                                     f"disagrees with its plain version")
                del got, want
                sec = time_fn(fn, arg, warmup=1, repeats=args.repeats,
                              calls_per_repeat=args.iters).mean_s
                del arg
                rec = {"bench": "bench_ring_tiles", "tier": tier, "tile_rows": tr,
                       "tiles_per_chunk": tiles, "mini_hops": 2 * (n - 1) * tiles,
                       "ranks": n, "dtype": dname, "size_bytes": size,
                       "ms": sec * 1e3,
                       "busbw_GBps": M.busbw_GBps("allreduce", n, size, sec),
                       "platform": topo.platform, "device": topo.device_name,
                       "link": "hbm-loopback"}
                rows.append(rec)
                print(f"{dname:9s} {size:>11d} B  {tier:8s} tile_rows={str(tr):>7s} "
                      f"tiles={tiles:>5d} mini_hops={rec['mini_hops']:>6d}  "
                      f"{rec['ms']:10.4f} ms  busbw {rec['busbw_GBps']:8.2f} GB/s",
                      flush=True)
            del x
    if args.out:
        with open(args.out, "a") as fp:
            for rec in rows:
                fp.write(json.dumps(rec) + "\n")
    return rows


def main(argv=None) -> int:
    run(make_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
