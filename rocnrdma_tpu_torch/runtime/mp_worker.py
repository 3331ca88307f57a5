"""Worker entry for the multi-process harness (``runtime/multiprocess.py``).

Counterpart of ``rocnrdma_tpu/runtime/mp_worker.py``'s device tasks. Each
worker is one process of the group: it joins the rendezvous
(``init_runtime``), runs its task over the process group, and reports on
stdout.

Tasks:

- ``allreduce``: ``torch.distributed.all_reduce`` of each rank's buffer
  (the reference's jitted global psum); every rank checks the sum.
- ``alltoall``: ``all_to_all_single`` of each rank's buffer (the
  reference's global transpose); every rank checks that row j of what it
  got is what rank j sent it.
- ``fault``: ``--fault-rank`` exits 3 BEFORE the rendezvous (prints
  ``FAULT``); the others must fail their deadline-bounded init with a named
  error, printed as ``CLEAN-ABORT``, exit 4.
- ``hang``: forks a grandchild and blocks far past any deadline; the
  harness must reap the WHOLE process group.

A rank's buffer has ``--size`` elements (default 8; alltoall rounds it up
to a multiple of the world size): rank r's is ``r + 1`` everywhere (the
reference's values) or, with ``--seed``, row r of a seeded normal draw
every rank can make. A passing rank prints ``OK rank=i/n``. The
reference's ``hierarchical`` task needs a mesh that spans processes (the
multi-GPU slice); its chaos and heal tasks wait for the host plane.
"""

from __future__ import annotations

import argparse
import sys
import time

# tasks that build an NCCL communicator on the card (one process per GPU)
NCCL_TASKS = ("allreduce", "alltoall")
TASKS = NCCL_TASKS + ("fault", "hang")

INIT_TIMEOUT_S = 15  # the rendezvous deadline, as the reference's workers


def _rows(n: int, elems: int, seed):
    """Every rank's buffer, rank-major (each rank can draw all of them)."""
    import numpy as np
    if seed is None:
        return np.repeat(np.arange(1, n + 1, dtype=np.float32)[:, None], elems, 1)
    return np.random.default_rng(seed).standard_normal((n, elems), dtype=np.float32)


def _collective(task: str, rank: int, n: int, size: int | None, seed, device) -> None:
    import numpy as np
    import torch

    elems = size or 8
    if task == "alltoall":
        elems = -(-elems // n) * n
    rows = _rows(n, elems, seed)
    local = torch.from_numpy(rows[rank].copy()).to(device)
    if task == "allreduce":
        torch.distributed.all_reduce(local)
        got, want = local.cpu().numpy(), rows.sum(0)
        # the constant rows sum exactly; seeded ones in the backend's order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        out = torch.empty_like(local)
        torch.distributed.all_to_all_single(out, local)
        got = out.cpu().numpy().reshape(n, -1)
        # chunk j of the result is rank j's chunk for this rank
        np.testing.assert_array_equal(got, rows.reshape(n, n, -1)[:, rank])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--task", choices=TASKS, default="allreduce")
    p.add_argument("--fault-rank", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--size", type=int, default=None,
                   help="elements of each rank's buffer (default 8)")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    args = p.parse_args(argv)

    if args.task == "hang":
        # fork a grandchild and block far past any test deadline:
        # run_workers' timeout path must reap the WHOLE process group
        import subprocess
        child = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(600)"])
        print(f"CHILD {child.pid}", flush=True)
        time.sleep(600)
        return 0

    if args.task == "fault" and args.process_id == args.fault_rank:
        # die before the rendezvous: the injected fault
        print("FAULT: rank dying before init barrier", flush=True)
        return 3

    from rocnrdma_tpu_torch.runtime.init import init_runtime, shutdown_runtime

    try:
        info = init_runtime(coordinator=args.coordinator,
                            num_processes=args.num_processes,
                            process_id=args.process_id,
                            timeout_s=INIT_TIMEOUT_S, platform=args.platform)
    except RuntimeError as e:
        if args.task == "fault":
            # expected: surviving ranks surface the lost peer cleanly
            print(f"CLEAN-ABORT: {e}", flush=True)
            return 4
        raise
    import torch
    device = (torch.device("cuda", torch.cuda.current_device())
              if info.backend == "nccl" else torch.device("cpu"))
    n, rank = info.world_size, info.rank
    _collective(args.task, rank, n, args.size, args.seed, device)
    print(f"OK rank={rank}/{n} backend={info.backend}", flush=True)
    shutdown_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main())
