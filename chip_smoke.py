#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``rocnrdma_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each timed, any failure exits non-zero:

1. probe: the card's name and ``nvidia-smi`` name/power limit; no CUDA
   device -> exit 2 before anything else runs;
2. build: compile every CUDA kernel of the port from ``ops/csrc`` with nvcc,
   one process per source, all at once (the Triton kernel compiles at its
   first launch, in phase 3);
3. kernels: each kernel wrapper on the card against its plain PyTorch
   version, bitwise in fp32 and bf16. Ring allreduce: n in {2,3,4,8,12}
   (12 takes the kernel's batched path), 1000 elements / 1 MiB / 64 MiB
   per rank, one tile and tiles of 8/64/512 rows, a 50-round stress loop
   with launches of n=8 and n=3 interleaved on their cached flags.
   Combine: k in 2..8 at 1000 elements and 1 MiB + 3 elements, k in {2,3}
   at 256 MiB. Ring reduce-scatter and allgather: n in {2,3,4,8,12}, one
   tile and tiles of 8/64/512 rows; reduce-scatter at about 1 MiB and 64
   MiB per rank (rounded down to n*128 elements) and 3*n*128 elements,
   allgather at a 700-element chunk and 1 MiB / 64 MiB gathered per rank.
   Alltoall: n in {2,3,8}, 77-element chunks, 1 MiB / 64 MiB per rank. A
   50-round stress loop at n=8 for reduce-scatter, and for alltoall with
   alltoallv and an n=3 alltoall interleaved on their cached flags.
   Pipelined (Triton) combine: k in 2..8 at 100 and 1000 elements and
   1 MiB + 3 elements (ragged ends), k in {2,3} at 256 MiB;
4. main paths, each with the launch counts zeroed before and read after,
   8 ranks on the one GPU, every point of every sweep checked against
   numpy (``--preset ring8 --fake-devices 8``: 4 KiB..256 MiB per rank,
   fp32 and bf16):
   - ``bench_allreduce --algos fused,ring,ring_bidir,cuda_ring``, then
     1 GiB fp32 per rank through ``Transport.allreduce``, ``cuda_ring`` and
     ``fused``, checked on the card against the plain ring;
   - ``bench_reducescatter --algos fused,ring,cuda_ring``, then 1 GiB fp32
     input per rank through ``Transport.reduce_scatter``;
   - ``bench_allgather --algos fused,ring,cuda_ring``, then 1 GiB fp32
     gathered per rank through ``Transport.allgather``;
   - ``bench_alltoall --algos fused,ring,bruck,cuda_ring``, then 1 GiB fp32
     per rank through ``Transport.alltoall`` (the ``BASELINE.json:2``
     metric), and ``Transport.alltoallv`` once with ragged counts;
   each 1 GiB point runs ``cuda_ring`` and ``fused``, held to the plain
   version, and prints its algbw and busbw;
5. ``bench_local`` with cuda2,cuda3,torch2,torch3,pipe2,pipe3 at 256 MiB
   per operand, the combine kernels' launch counts zeroed before and read
   after;
6. schedules: the explicit schedules, rooted verbs and sendrecv through the
   bench CLIs' runner, 8 ranks on the one GPU, fp32, every arm checked
   against numpy before it is timed (no kernel is on this path; the launch
   counts are zeroed before and printed after):
   - ``tree64`` scaled to 8 ranks: allreduce at 1 GiB per rank with tree,
     khd, dtree, ptree, ktree and fused; reduce_scatter and allgather khd
     and fused at 1 GiB; first each of those arms on a 1 GiB input made on
     the card, held to the fused arm (the data-moving allgather bitwise,
     the reductions within twice the (n-1)-add rounding bound);
   - ``multislice`` scaled to a 2x4 mesh, 1 MiB..256 MiB per rank:
     hierarchical (intra ring, then khd), khd2d and fused allreduce, the
     hierarchical allreduce with a bfloat16 cross-slice phase at 64 MiB,
     and the hierarchical and fused alltoall at 256 MiB;
   - broadcast, reduce, gather and scatter binomial and fused at 256 MiB
     per rank with root 3, and sendrecv with shift 3;
   each arm's time, busbw and peak device memory (which must stay under
   60 GiB) in one table;
7. tuner, after the schedules: the per-launch dispatch alpha
   (``tuner.measure_alpha``, three runs) and the fold ladder at widths
   2, 3, 4, 8, 16, 32 and 64 (``bench/fold_ladder.py``), printed beside
   ``nvidia-smi``'s name and power limit; then a ``Transport`` with the
   committed ``rocnrdma_tpu_torch/results/tuning_h100_8x1.json``: at each
   size of its sweep ``auto`` must run the table's arm (``stats()``), which
   must be the sweep's winner, and match ``fused`` (data-moving verbs
   bitwise, sums within twice the (n-1)-add rounding bound);
   ``algo="model"`` for the four verbs at 4 KiB, 1 MiB and 256 MiB, held
   the same way; ``khd`` without digits at 8 x 16 MiB bitwise equal to
   ``khd`` with ``digits=khd_model_digits(...)`` (allreduce and
   reduce_scatter); the model's price of every allreduce arm at 8 x 1 GiB
   beside the arms' measured times there, and the model's pick beside the
   sweep's winner at every size of the table;
8. workloads, 8 ranks on the one GPU, each path with the launch counts
   zeroed before it and read after it:
   - the top-k MoE layer at Mixtral-8x7B width (``workloads.moe --model
     mixtral-8x7b --routing topk --tokens 4096 --expert-compute``) with
     ``cuda_ring`` (the alltoall kernel) and ``fused``; then the same layer
     on one input through both arms, bitwise equal, each timed, beside two
     alltoalls of its dispatch shape (the alltoall share of the step);
   - ``workloads.ddp_replay`` and ``workloads.fsdp_replay`` at ``--scale
     16`` (the Llama-3-8B trace, ~2 GiB a rank) with ``cuda_ring`` (the
     ring kernel's AR, RS and AG modes) and ``fused``, every mode, through
     the CLI; then, in the same counted run, ``replay`` in every mode on
     one set of buffers, each output of its timed repeats held to the
     ring's plain version: ``cuda_ring`` bitwise, ``fused`` bitwise
     (allgather) or within twice the (n-1)-add rounding bound (sums);
   - ``workloads.overlap`` at its defaults, ``fused`` and ``ring``;
   - ``graft_entry.entry()`` and ``dryrun_multichip(8)`` on the card;
9. headline: ``bench.headline`` with one rank (the fold) and with
   ``--fake-devices 8`` (the allreduce; its ``cuda_ring`` candidate
   launches the in-place ring kernel; then the alltoall leg), each scored
   line printed here, each followed by the MFU leg on stderr; a line on
   stderr that says a leg or candidate failed, a missing forward or train
   MFU line, a ``cuda_ring`` candidate missing from the 8-rank winner
   line or a missing alltoall artifact fails the phase; then
   ``bench.mfu_profile --profile`` and its top ops by device time;
10. tooling, after the headline: ``runtime.topo_cli --json`` on the card
   (one device with ``nvidia-smi``'s name and power limit, the parsed
   link matrix, printed raw before it, and ring order [0]; the matrix is
   ``nvidia-smi topo -m``'s, or where that cannot run, as in a container
   without the PCI tree, the NVLink P2P matrix ``topo -p2p n``); ``trace --measured --align-steps`` at 8 x 4 MiB fp32 for ring,
   dtree and khd (khd at ``khd_model_digits``' digits): each capture gives
   exactly the schedule's step count (14 for ring, 20 for dtree), every
   step device time above 0, and the call's output under the capture
   bitwise the output without it; per step predicted vs measured printed,
   the alignments written under ``smoke_out/tooling/``; ``first_contact
   --fake-devices 8 --sizes 4K,1M,16M --calibrate-widths 2,8`` with
   ``RNR_HW_CAL_DIR`` under ``smoke_out/`` (the package's ``results/``
   stays as it was), exit 0 and every report row ok, its launch counts
   zeroed before and read after (its CLI smoke and sweep run the ring and
   alltoall kernels through ``cuda_ring``); the process runtime over NCCL:
   ``run_workers(1, "allreduce")`` and ``(1, "alltoall")``,
   ``run_workers(2, "fault", fault_rank=1)`` ending in the survivor's clean
   abort, and ``run_workers(2, "allreduce")`` refused on one GPU with the
   named "fewer GPUs than processes" error;
11. host plane, after the tooling (no kernel runs on it): the port's
   ``librqp.so`` built from ``rocnrdma_tpu_torch/native/*.cpp`` into its
   ``_build`` (path and seconds printed); ``bench_host`` fleets of 4 OS
   processes on the card machine's host, ``--plane tcp --transport msg
   --sizes 64K,1M,16M`` and ``--plane shm --transport rdma --sizes
   1M,16M``, every rank holding the zero-copy gate (GB/s and
   ``payload_bytes_copied`` printed per point), then ``bench_host
   --smoke`` against the port's own floors; the tensor front door: 4
   processes, each with CUDA tensors on the one card, run all_reduce,
   all_gather, all_to_all, broadcast and send/recv at 4 KiB, 1 MiB and
   64 MiB fp32 over tcp, each result a CUDA tensor on the input's device,
   bitwise the call on the numpy arrays ``.cpu()`` gives; the staging
   GB/s each way at 64 MiB beside the call's total; a bf16, an e4m3fn and
   an e5m2 CUDA tensor's all_reduce bitwise the CPU tensor's, and an
   e4m3fnuz one raises ``HostPlaneDtypeError``; ``DeviceMeshNet`` with 8 ranks as rows
   of one CUDA tensor, every (src, dst) pair bitwise the row copy and
   every request complete; the fp8 codec resolving with torch, also in a
   process where ``ml_dtypes`` cannot be imported, a seeded frame's sha256
   equal to the one ``tests/test_torch_plugin_codec.py`` pins against
   ``ml_dtypes``, and the int8 and fp8 codecs' encode and decode GB/s;
12. chaos and heal, after the host plane (``runtime.mp_worker`` fleets of
   OS processes, the device plane an NCCL group on the one card; any
   failed step fails the phase): (a) ``kill-a-host``, 3 processes, seed
   11, rank 1 killed at op 25, 4 rounds of 2048 elements, twice: every
   survivor exits 0 on epoch 1 with members [0, 2], re-initialises once
   (its heal ms and ``member-device-*`` spans printed), and its
   ``DEVICE-LOCAL`` after the heal launches the ring kernel on the card
   (the launches counted in the worker), bitwise to the integer oracle;
   ``DEVICE-GLOBAL`` is named unsupported with fewer GPUs than members;
   the ``FAULTLOG``/``HEALLOG``/``DEVICEHEAL`` lines are equal across the
   two runs; (b) with one warm spare (4 processes, seed 13, rank 2
   killed) the spare is promoted (``now-rank=2/3``); (c) one process, a
   world of one on NCCL: an ``all_reduce``, ``reinit_runtime`` (the
   communicator aborted, a new group joined), an ``all_reduce`` on the new
   group, the fence, the re-init's ms and spans; (d) the degraded mode
   (``device_heal_fail``): every survivor exits 4 with
   ``DEVICEHEAL-FAILED`` and ``HOST-PLANE-OK`` in under 90 s; (e) one
   ``kill-and-heal`` and one ``die-mid-collective`` fleet;
13. the Transport across processes, after the chaos phase (no kernel runs
   on it): ``run_workers(2, "hierarchical")`` on the one card, a 2-D
   ``('slice', 'intra')`` mesh whose slice axis is the process boundary,
   each process holding its rows on the card and passing only those;
   once at the reference's shape (2 x 2 ranks, 4 x 8 fp32 a rank) and
   once at full width (the ``multislice`` preset cut to 2 x 4: 64 MiB fp32
   a rank, 512 MiB of rows on the card). The calls are every (verb, algo)
   pair of a 2-D mesh: the hierarchical allreduce (ring and khd intra
   phases, ring and fused cross phases, bf16 ``cross_dtype``, avg, max, a
   ragged buffer), the hierarchical alltoall with fused, rotation and
   Bruck cross phases, khd2d's allreduce, reduce_scatter and allgather,
   the fused allreduce, reduce_scatter, allgather, alltoall, broadcast,
   reduce, gather and scatter (the gathering verbs on one 64 MiB-gathered
   buffer a rank, the rooted ones at roots off process 0) and a
   ``group()``. Every rank holds every result to the one-process port on
   the card (bitwise, the fused reductions within rtol 1e-5, atol 1e-6)
   and to the reference's checks against numpy; a failing rank or a
   missing call fails the phase. Printed: each call's ms, the cross
   leg's backend (gloo, staged through pinned host memory, while the
   processes share one GPU) and its bytes and GB/s each way;
14. the 1-D rank mesh across processes, after phase 13:
   ``run_workers(8, "rank-mesh")``, the ``ring8`` preset's world of 8
   ranks, one process each (with several GPUs, one process a GPU, up to
   8), a ``rank_mesh(8, group=WORLD)`` whose rank axis is the process
   boundary, each process holding its row on the card and passing only
   it; once at the reference's shape (8 fp32 a rank, rank r's row r + 1)
   and once at full width (64 MiB fp32 a rank, seeded rows), both cases
   in one fleet (``--cases``, one start of the 8 processes). The calls
   are every 1-D (verb, algo) pair (``mp_worker.RANK_CALLS``: the
   allreduce fused, ring, ring_bidir, tree, khd at the radix ladder's
   digits and at 2,2,2, dtree, ptree, ktree, avg, max and a ragged
   buffer; reduce_scatter and allgather fused, ring and khd; alltoall
   fused, rotation and Bruck; the fused alltoallv; the rooted verbs fused
   and binomial at roots off process 0; sendrecv at shift 3; a
   ``prog_ring_allreduce`` program; a ``group()``), and ``cuda_ring``:
   the ring and alltoall kernels across processes, each process
   launching its rank's blocks with the peers' rows and flags mapped
   through CUDA IPC (the allreduce, the tiled in-place allreduce at 3 x
   128-element tiles, reduce_scatter, allgather, alltoall, alltoallv and
   a ``group()``; the reduce_scatter on a buffer not of whole
   n*128-element chunks refused by both meshes alike). The kernels build
   once here first. Every rank holds every result to the one-process
   port on the card (bitwise, the fused reductions within rtol 1e-5,
   atol 1e-6) and to the reference's checks, each ``cuda_ring`` result
   also bitwise to its kernels' plain PyTorch versions on every rank's
   rows at the same shapes (``RANKPLAINERRS``), and counts its kernels'
   launches across processes from 0 (``RANKLAUNCHES``): each
   ``cuda_ring`` call must launch its kernel once a run. A failing rank
   (an expired bounded wait among them), a missing call, a plain-version
   error other than 0, a launch count off (a plain-version fallback), rows off
   the card, or a cross leg other than gloo staged with one GPU (NCCL
   unstaged with a GPU a process) fails the phase. With a GPU a process
   a third case runs the headline size, 1 GiB fp32 a rank, for the
   ``cuda_ring`` and ``fused`` allreduce, with their busbw beside the
   NVLink datasheet bound. Printed: each call's ms, each ``cuda_ring``
   call beside its verb's ``fused`` and ``ring``, the cross leg's backend
   and its GB/s each way; all of it to ``smoke_out/rank_mesh.json``;
15. one JSON line ``{"kernels": [...]}``: per kernel its launches on its
   main path, its time, its plain version's and the library call's time at
   the main path's shapes, and its bound: the larger of its bytes (each
   input read once, each output written once) at the datasheet HBM rate
   and its fp32 adds at the datasheet fp32 rate. Before it, the ring and
   alltoall kernels' bytes moved at those shapes beside the bound's bytes;
   a 4 KiB-per-rank ``cuda_ring`` allreduce and alltoall, each split into
   host enqueue time and device time, with its kernel timed alone with and
   without its barrier and arrivals; and per verb the ``cuda_ring`` arm
   against ``fused`` at 4 KiB and at the sweep's crossover size. Each
   kernel's ``workload_launches`` are its launches on the workload and
   headline paths (phases 8 and 9), its ``chaos_launches`` those of the
   healed fleets' ``DEVICE-LOCAL`` (phase 12), its ``across_launches``
   those across processes in phase 14 (every rank's, both cases; rows
   1-5 must have some, the local folds have no form across processes),
   its ``cli_across_launches`` rank 0's in phase 16's CLI sweeps, its
   ``workload_across_launches`` rank 0's in phase 16's workload CLIs, its
   ``tools_launches`` rank 0's in phase 16's tool fleets;
16. bench_mesh, after phase 14 and before the kernels line: the bench
   CLIs across processes, each launched as a launcher launches it
   (``runtime.multiprocess.run_cli``: the reference's
   ``COORDINATOR_ADDRESS``, ``WORLD_SIZE`` and ``RANK`` in each process's
   environment), each process one rank of ``rank_mesh(N, group=WORLD)``.
   On one card, ``bench_allreduce`` and ``bench_alltoall`` as 2
   processes each, the two fleets at once, ``--sizes 4K,1M --algos fused,ring,cuda_ring --repeats 2
   --iters 3 --check-plain``: every rank exits 0, every point of rank 0's
   ``--out`` is checked, with ``extra.link == "host-loopback"`` (gloo
   staged through pinned memory), and each ``cuda_ring`` point launched
   its kernel across processes and is bitwise its kernels' plain versions
   on every rank (an agreed check: one rank's difference fails them all).
   ``python3 chip_smoke.py --bench-mesh`` runs the probe and this phase
   alone; on a machine with several GPUs (the 4-card run), it runs
   ``bench_allreduce``, ``bench_reducescatter``, ``bench_allgather`` and
   ``bench_alltoall`` as 4 processes, a GPU each, ``--preset ring8
   --sizes 4K,1G --dtypes float32 --algos fused,ring,ring_bidir,cuda_ring``
   (``extra.link == "nvlink"``), ``bench_allreduce`` once more under
   torchrun (its agent hosts the store), and the headline across the 4
   processes: one scored line from rank 0 against 0.9 x 450 GB/s, no leg
   or candidate failed, the alltoall row written.
   The workload CLIs across processes, each launched through ``run_cli``
   as its own fleet. On one card, 2 processes over gloo staged through
   pinned memory, four fleets at a time: ``moe --routing uniform`` and
   ``--routing topk`` with ``fused``, ``ring`` and ``cuda_ring``;
   ``ddp_replay --scale 1024 --bucket-mb 1024`` (34 buckets) and
   ``fsdp_replay --scale 4096`` (102 calls a step), both ``--modes
   sequential,jit_fused --repeats 2``, with ``fused`` and ``cuda_ring``;
   ``overlap`` with ``fused``. With several GPUs, a GPU a process over
   NCCL (``extra.link == "nvlink"``), one fleet at a time at full width:
   ``moe --model mixtral-8x7b --routing topk --tokens 4096`` (4 experts,
   one a rank) with ``fused`` and ``cuda_ring``; ``ddp_replay`` and
   ``fsdp_replay`` on the whole Llama-3-8B trace at ``--scale 16``, every
   mode, with ``fused`` and ``cuda_ring``; ``overlap`` at its defaults.
   Every rank exits 0; rank 0's records are on the fleet's link across
   its processes with finite times; each ``cuda_ring`` run is
   ``--check-plain`` (every result bitwise its kernels' plain versions
   on every rank, an agreed check) and launched its kernels across
   processes; each run's ms a step printed beside the card's name and
   power limit.
   The tools across processes, each launched through ``run_cli`` as its
   own fleet (``TOOLS_ONE_CARD``: 2 processes over gloo staged, all six
   fleets at once, beside the workload fleets; ``TOOLS_MESH``: a GPU a
   process over NCCL, one fleet at a time, after them): the tuner's
   sweep (one card ``allreduce,alltoall`` at 4K and 1M with
   ``fused,ring,cuda_ring``; several GPUs the four ring verbs at 4K, 1M
   and 1G with every 1-D arm), ``trace --measured --align-steps``
   (``ring`` at 2 x 4 MiB; ``khd`` at 4 x 4 MiB with the model's digits),
   ``first_contact`` (its calibration under ``RNR_HW_CAL_DIR`` in
   ``OUT_DIR``; cut on one card, its dryrun left to phase 10; at its
   defaults with several GPUs),
   ``bench_local``, ``fold_ladder`` and ``mfu_profile`` (cut on one card;
   256 MiB an operand, the default ladder and the headline's MFU shape
   with several GPUs). Every rank exits 0; rank 0's records name the
   fleet's link and process count and carry finite times (the tuner's
   table keyed by the layout, the trace a lane group and aligned steps a
   rank, a row a rank of each local fold, a profile a rank); every
   ``cuda_ring`` point of ``first_contact``'s cli_smoke is bitwise its
   kernels' plain versions on every rank; rank 0's launches over the
   tool fleets include the ring and alltoall kernels across processes
   and both combine kernels (the kernels line's ``tools_launches``).

``python3 chip_smoke.py --host-plane`` runs the probe and phase 11 alone,
``--chaos`` the probe and phase 12 alone, ``--hierarchical`` the probe and
phase 13 alone, ``--rank-mesh`` the probe and phase 14 alone,
``--bench-mesh`` the probe and phase 16 alone.
The last line is ``{"ok": true, "device": {...}}``. With ranks sharing one
GPU, every bus bandwidth printed here is an HBM number, not NVLink.
This script imports nothing of JAX or of the JAX package.
"""

import concurrent.futures
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import torch

MiB = 1 << 20
PHASE_S: dict[str, float] = {}
CROSSOVER: dict[str, dict] = {}  # verb -> crossover() of its ring8 sweep


@contextlib.contextmanager
def phase(name: str):
    print(f"## phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    PHASE_S[name] = time.perf_counter() - t0
    print(f"## phase {name}: {PHASE_S[name]:.1f} s", flush=True)


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda",
                       dtype=torch.float32).to(dtype)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def hold(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Require ``got`` bitwise equal to ``want``, in every dtype; returns
    the max abs error (0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = max_abs_err(got, want)
    if torch.equal(got, want):
        return err
    raise AssertionError(f"{what}: kernel disagrees with its plain version "
                         f"(max abs err {err})")


def check_ring_kernels(ops) -> None:
    for n in (2, 3, 4, 8, 12):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, elems in (("1000 el", 1000), ("1 MiB", MiB // isz),
                                 ("64 MiB", 64 * MiB // isz)):
                x = randn((n, elems), dtype, seed=n * 1000 + elems % 997)
                x0 = x.clone()
                what = f"ring n={n} {label} {dtype}"
                hold(what, ops.ring_allreduce(x), ops.ring_allreduce_plain(x))
                if not torch.equal(x, x0):
                    raise AssertionError(f"{what}: out-of-place kernel changed its input")
                for tr in (8, 64, 512):
                    y = x.clone()
                    ret = ops.hbm_ring_allreduce(y, tile_rows=tr)
                    if ret.data_ptr() != y.data_ptr():
                        raise AssertionError(f"{what}: hbm ring did not return its input")
                    hold(f"hbm {what} tile_rows={tr}", y,
                         ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr))
                del x, x0, y
        torch.cuda.synchronize()
        print(f"ring kernels n={n}: ok", flush=True)
    # counterpart of test_pallas_allreduce_backpressure_stress: back-to-back
    # launches on the cached, epoch-counted flags, with a launch of another
    # n (its own flags) in between
    x = randn((8, 3 * 128 * 8 + 37), torch.float32, seed=7)
    x3 = randn((3, 3 * 128 * 8 + 37), torch.float32, seed=8)
    want = ops.ring_allreduce_plain(x)
    want_hbm = ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=8)
    want3 = ops.ring_allreduce_plain(x3)
    for i in range(50):
        hold(f"stress round {i}", ops.ring_allreduce(x), want)
        hold(f"n=3 stress round {i}", ops.ring_allreduce(x3), want3)
        hold(f"hbm stress round {i}", ops.hbm_ring_allreduce(x.clone(), tile_rows=8),
             want_hbm)
    torch.cuda.synchronize()
    print("ring stress x50: ok", flush=True)


def check_combine_kernel(ops) -> None:
    for k in range(2, 9):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            sizes = [("1000 el", 1000), ("1 MiB + 3 el", MiB // isz + 3)]
            if k <= 3:
                sizes.append(("256 MiB", 256 * MiB // isz))
            for label, elems in sizes:
                xs = [randn((elems,), dtype, seed=10 * k + j) for j in range(k)]
                hold(f"combine k={k} {label} {dtype}", ops.hbm_combine(*xs),
                     ops.hbm_combine_plain(*xs))
                del xs
    torch.cuda.synchronize()
    print("combine kernel: ok", flush=True)


def check_rs_ag_kernels(ops) -> None:
    for n in (2, 3, 4, 8, 12):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            align = n * 128
            for label, elems in (("3*n*128 el", 3 * align),
                                 ("~1 MiB", MiB // isz // align * align),
                                 ("~64 MiB", 64 * MiB // isz // align * align)):
                x = randn((n, elems), dtype, seed=n * 100 + elems % 991)
                x0 = x.clone()
                want = ops.ring_reduce_scatter_plain(x)
                for tr in (None, 8, 64, 512):
                    hold(f"reduce_scatter n={n} {label} {dtype} tile_rows={tr}",
                         ops.ring_reduce_scatter(x, tile_rows=tr), want)
                if not torch.equal(x, x0):
                    raise AssertionError("reduce_scatter kernel changed its input")
                del x, x0, want
            for label, chunk in (("700-el chunk", 700),
                                 ("1 MiB gathered", MiB // isz // n),
                                 ("64 MiB gathered", 64 * MiB // isz // n)):
                x = randn((n, chunk), dtype, seed=n * 200 + chunk % 991)
                want = ops.ring_allgather_plain(x)
                if not torch.equal(want, x.reshape(1, -1).expand(n, -1)):
                    raise AssertionError("allgather plain version is not the concatenation")
                for tr in (None, 8, 64, 512):
                    hold(f"allgather n={n} {label} {dtype} tile_rows={tr}",
                         ops.ring_allgather(x, tile_rows=tr), want)
                del x, want
        torch.cuda.synchronize()
        print(f"reduce_scatter/allgather kernels n={n}: ok", flush=True)
    # the reduce-scatter stress loop: many tiles, many slot reuses
    x = randn((8, 8 * 3 * 128 * 8), torch.float32, seed=8)
    want = ops.ring_reduce_scatter_plain(x)
    for i in range(50):
        hold(f"reduce_scatter stress round {i}", ops.ring_reduce_scatter(x, tile_rows=8),
             want)
    torch.cuda.synchronize()
    print("reduce_scatter stress x50: ok", flush=True)


def check_alltoall_kernel(ops) -> None:
    for n in (2, 3, 8):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            for label, chunk in (("77-el chunks", 77), ("1 MiB", MiB // isz // n),
                                 ("64 MiB", 64 * MiB // isz // n)):
                x = randn((n, n, chunk), dtype, seed=n * 300 + chunk % 991)
                got = ops.alltoall(x)
                hold(f"alltoall n={n} {label} {dtype}", got, ops.alltoall_plain(x))
                hold(f"alltoall twice n={n} {label} {dtype}", ops.alltoall(got), x)
                del x, got
        torch.cuda.synchronize()
        print(f"alltoall kernel n={n}: ok", flush=True)
    # back-to-back launches on the cached, epoch-counted flags: alltoall and
    # alltoallv share the kernel and its flags, a launch of another n (its
    # own flags) in between
    from rocnrdma_tpu_torch.collectives.alltoall import ragged_mask
    from rocnrdma_tpu_torch.ops import alltoall_cuda
    x = randn((8, 8, 1000), torch.float32, seed=9)
    x3 = randn((3, 3, 1000), torch.float32, seed=10)
    y = randn((8, 8, 125, 8), torch.float32, seed=11)
    counts = torch.randint(0, 126, (8, 8), generator=torch.Generator().manual_seed(3))
    want, want3 = ops.alltoall_plain(x), ops.alltoall_plain(x3)
    want_v = ragged_mask(ops.alltoall_plain(y), counts)[0]
    for i in range(50):
        hold(f"alltoall stress round {i}", ops.alltoall(x), want)
        hold(f"alltoall n=3 stress round {i}", ops.alltoall(x3), want3)
        hold(f"alltoallv stress round {i}", ops.alltoallv(y, counts)[0], want_v)
    torch.cuda.synchronize()
    for (_, _, n, _), (words, epoch) in alltoall_cuda._FLAGS.items():
        if epoch < 1 or not bool((words == epoch * (n - 1)).all()):
            raise AssertionError(f"alltoall flags n={n}: not at epoch {epoch}'s counts")
    print("alltoall stress x50: ok", flush=True)


def check_pipelined_combine_kernel(ops) -> None:
    # sizes with a ragged end (100: less than one 128-element row; 1000;
    # 1 MiB + 3 elements) and without one (256 MiB)
    for k in range(2, 9):
        for dtype in (torch.float32, torch.bfloat16):
            isz = torch.finfo(dtype).bits // 8
            sizes = [("100 el", 100), ("1000 el", 1000), ("1 MiB + 3 el", MiB // isz + 3)]
            if k <= 3:
                sizes.append(("256 MiB", 256 * MiB // isz))
            for label, elems in sizes:
                xs = [randn((elems,), dtype, seed=20 * k + j) for j in range(k)]
                hold(f"pipelined combine k={k} {label} {dtype}",
                     ops.hbm_combine_pipelined(*xs), ops.hbm_combine_plain(*xs))
                del xs
    torch.cuda.synchronize()
    print("pipelined combine kernel: ok", flush=True)


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time for the work: the larger of its bytes at the HBM rate
    and its fp32 operations at the non-tensor-core fp32 rate."""
    from rocnrdma_tpu_torch.hw import bytes_bound_ms, fp32_ops_bound_ms
    b, o = bytes_bound_ms(nbytes, kind), fp32_ops_bound_ms(ops, kind)
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations"}


def ms_of(fn, *args, repeats=5, iters=5) -> float:
    from rocnrdma_tpu_torch.bench.timing import time_fn
    return time_fn(fn, *args, warmup=1, repeats=repeats,
                   calls_per_repeat=iters).mean_s * 1e3


def ring_bytes(mode: str, n: int, per: int, isz: int) -> int:
    """Bytes the ring kernel moves in ``mode`` ("ar", "rs", "ag") for n
    ranks and chunks of ``per`` elements: each of its input elements read
    once and each output element written once. Rows hold n chunks, but a
    reduce-scatter writes one chunk a rank and an allgather reads one."""
    reads = per if mode == "ag" else n * per
    writes = per if mode == "rs" else n * per
    return n * (reads + writes) * isz


def alltoall_bytes(n: int, padded: int, isz: int) -> int:
    """Bytes the alltoall kernel moves for n ranks of n chunks of ``padded``
    elements: each chunk read once and written once."""
    return 2 * n * n * padded * isz


def small_call_split(ops, t, n: int, calls: int = 200) -> dict:
    """A 4 KiB-per-rank ``cuda_ring`` allreduce (one tile) and alltoall, each
    split into its host enqueue time and its device time, beside its kernel
    alone with and without its barrier and arrivals (``sync=False``: the
    data pass only). ``barrier_us`` is the difference of the two kernel
    times."""
    from rocnrdma_tpu_torch.bench.timing import device_s, enqueue_s
    from rocnrdma_tpu_torch.ops import alltoall_cuda, ring_cuda
    x = randn((n, 1024), torch.float32, seed=18)
    per = 1024 // n
    out = torch.empty_like(x)
    a2a_in = x.reshape(n, n, per)
    cases = {  # verb -> (the arm's input, the plain result, a launch of the kernel)
        "allreduce": (x, ops.ring_allreduce_plain(x), lambda sync: (
            ring_cuda._launch(x, out, n, per, ring_cuda.MODE_AR, sync=sync))),
        "alltoall": (a2a_in, ops.alltoall_plain(a2a_in).reshape(n, 1024),
                     lambda sync: alltoall_cuda._launch(x, out, n, per, sync=sync)),
    }
    split = {}
    for verb, (arg, want, launch) in cases.items():
        arm = t.jit_fn(verb, "cuda_ring")
        fns = {"cuda_ring_call": lambda: arm(arg),
               "kernel": lambda: launch(True),
               "kernel_no_barrier": lambda: launch(False)}
        part = split[verb] = {}
        for name, fn in fns.items():
            out.zero_()
            got = fn()
            hold(f"4 KiB {verb} {name}", out if got is None else got.reshape(n, 1024), want)
            for _ in range(20):
                fn()
            h = enqueue_s(fn, calls)
            part[name] = {"host_us": h * 1e6, "device_us": device_s(fn, calls, h) * 1e6}
        part["cuda_ring_call"]["events_us"] = ms_of(arm, arg) * 1e3
        part["barrier_us"] = (part["kernel"]["device_us"]
                              - part["kernel_no_barrier"]["device_us"])
    return split


def crossover(sweep, dtype: str = "float32") -> dict:
    """The kernel arm (``cuda_ring``) against the library arm (``fused``)
    in one sweep, us per call: both at the smallest size, and the smallest
    size from which ``cuda_ring`` is at or under ``fused`` at every larger
    size (None if there is none)."""
    us = {(r.algo, r.size_bytes): r.mean_s * 1e6 for r in sweep if r.dtype == dtype}
    sizes = sorted(s for a, s in us if a == "cuda_ring")
    wins = [us[("cuda_ring", s)] <= us[("fused", s)] for s in sizes]
    cross = next((s for i, s in enumerate(sizes) if all(wins[i:])), None)

    def point(s):
        return {"bytes": s, "cuda_ring_us": us[("cuda_ring", s)], "fused_us": us[("fused", s)]}
    return {"smallest": point(sizes[0]), "crossover": cross and point(cross)}


# collective -> (bench CLI, Transport verb, the sweep's algos, kernel counter)
VERBS = {
    "reducescatter": ("bench_reducescatter", "reduce_scatter", "fused,ring,cuda_ring",
                      "ring_reduce_scatter"),
    "allgather": ("bench_allgather", "allgather", "fused,ring,cuda_ring",
                  "ring_allgather"),
    "alltoall": ("bench_alltoall", "alltoall", "fused,ring,bruck,cuda_ring",
                 "alltoall"),
}


def main_verb(ops, runner, collective: str, x: torch.Tensor, plain, kind: str,
              n: int = 8) -> tuple[int, float]:
    """Drive one verb's main path with the launch counts zeroed first: its
    CLI's ring8 sweep, then the 1 GiB fp32 point ``x`` through ``cuda_ring``
    (held bitwise to ``plain``) and ``fused``, timed; alltoall also runs
    ``alltoallv`` once. Returns (the kernel's launches, the point's max abs
    error)."""
    from rocnrdma_tpu_torch.metrics import BenchRecord, format_table
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport

    bench, verb, algos, counter = VERBS[collective]
    ops.reset_launch_counts()
    argv = ["--preset", "ring8", "--fake-devices", str(n), "--algos", algos,
            "--repeats", "3", "--iters", "5"]
    sweep = runner.run_sweep(bench, collective,
                             runner.make_parser(bench, collective).parse_args(argv))
    if {r.algo for r in sweep} != set(algos.split(",")):
        raise AssertionError(f"{bench} sweep ran {sorted({r.algo for r in sweep})}")
    CROSSOVER[verb] = crossover(sweep)

    t = Transport(rank_mesh(n))
    run = getattr(t, verb)
    got = run(x, "cuda_ring")
    want = plain(x)
    err = hold(f"1 GiB {verb} cuda_ring vs plain", got, want)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"1 GiB {verb} cuda_ring: non-finite result")
    del got
    fused = run(x, "fused")
    same = (torch.allclose(fused, want, rtol=1e-5, atol=1e-5)
            if verb == "reduce_scatter" else torch.equal(fused, want))
    if not same:
        raise AssertionError(f"1 GiB {verb} fused vs plain: max abs err "
                             f"{max_abs_err(fused, want)}")
    del fused, want
    size = x[0].numel() * x.element_size() * (n if verb == "allgather" else 1)
    recs = []
    for algo in ("cuda_ring", "fused"):
        ms = ms_of(t.jit_fn(verb, algo), x, repeats=3, iters=2)
        recs.append(BenchRecord.measure(
            bench, collective, algo, n, size, "float32", ms / 1e3,
            platform="gpu", device=kind, link="hbm-loopback"))
    print(format_table(recs))
    if verb == "alltoall":  # the ragged verb on the same kernel
        g = torch.Generator().manual_seed(5)
        counts = torch.randint(0, 65, (n, n), generator=g)
        y = randn((n, n, 64, 1024), torch.float32, seed=17)
        out, rc = t.alltoallv(y, counts, "cuda_ring")
        want, want_rc = t.alltoallv(y, counts, "fused")
        hold("alltoallv cuda_ring vs fused", out, want)
        if not torch.equal(rc, want_rc) or not torch.equal(rc.cpu(), counts.T):
            raise AssertionError("alltoallv: recv_counts differ")
        del y, out, want
    stats = t.stats()
    print(t.format_stats())
    need = [f"{verb}/cuda_ring", f"{verb}/fused"]
    if verb == "alltoall":
        need += ["alltoallv/cuda_ring", "alltoallv/fused"]
    for key in need:
        if stats.get(key, {}).get("calls", 0) < 1:
            raise AssertionError(f"Transport.stats shows no {key} call: {stats}")
    launched = ops.launch_counts()
    print(f"launches on the {bench} path: {launched}", flush=True)
    if launched[counter] < 1:
        raise AssertionError(f"{bench} path never launched {counter}")
    return launched[counter], err


PEAK_LIMIT = 60 << 30  # bytes of device memory an arm may hold at its peak


def sweep(runner, bench: str, collective: str, argv: list, algos: set) -> list:
    """One bench CLI run through the runner; every arm of ``algos`` must
    have been checked and timed."""
    args = runner.make_parser(bench, collective).parse_args(argv)
    recs = runner.run_sweep(bench, collective, args)
    ran = {r.algo for r in recs}
    if ran != algos or not all(r.extra.get("checked") for r in recs):
        raise AssertionError(f"{bench} {' '.join(argv)}: ran {sorted(ran)}, "
                             f"want {sorted(algos)}, every point checked")
    return recs


def sum_bound(x: torch.Tensor, n: int, verb: str) -> torch.Tensor:
    """Twice the (n-1)-add rounding bound gamma * sum_r |x_r| of a sum over
    the ranks of rank-major fp32 ``x``: the arm and its reference each lie
    within it of the exact sum. One rank's output shape (it bounds every
    rank), reduce-scatter as ``(n, c)``, row r bounding rank r's chunk."""
    u = 2.0 ** -24
    gamma = (n - 1) * u / (1 - (n - 1) * u)
    b = 2 * gamma * x.abs().sum(0)
    return b.reshape(n, -1) if verb == "reduce_scatter" else b


def within(what: str, got: torch.Tensor, want: torch.Tensor,
           bound: torch.Tensor) -> float:
    """Require ``got`` finite and within ``bound`` of ``want``; returns the
    max abs error."""
    diff = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
        raise AssertionError(f"{what}: off by {float(diff.max())}, beyond twice the "
                             f"rounding bound")
    return float(diff.max()) if diff.numel() else 0.0


def hold_to_fused(t, verb: str, x: torch.Tensor, algos, n: int) -> dict:
    """Each arm of ``verb`` on ``x`` against the fused arm on the card
    (1-D mesh): a verb that only moves data bitwise, a sum within
    ``sum_bound``. Returns the max abs error per arm."""
    want = getattr(t, verb)(x, "fused")
    bound = None if verb in ("allgather", "alltoall") else sum_bound(x, n, verb)
    errs = {}
    for algo in algos:
        got = getattr(t, verb)(x, algo)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"1 GiB {verb} {algo}: non-finite or misshapen")
        if bound is None:
            errs[algo] = hold(f"1 GiB {verb} {algo} vs fused", got, want)
        else:
            # row by row: the temporaries stay 1 GiB deep
            errs[algo] = max(within(
                f"1 GiB {verb} {algo} vs fused, rank {r}", got[r], want[r],
                bound[r] if verb == "reduce_scatter" else bound) for r in range(n))
        del got
    return errs


def schedules_phase(ops, runner, kind: str, n: int = 8) -> list:
    """The explicit schedules, rooted verbs and sendrecv at full width
    through the bench CLIs' runner (see the module docstring, phase 6).
    Returns the records."""
    from rocnrdma_tpu_torch.metrics import GiB
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport

    ops.reset_launch_counts()
    common = ["--fake-devices", str(n), "--repeats", "3", "--iters", "2"]
    trees = ("tree", "khd", "dtree", "ptree", "ktree")
    # the 1 GiB arms held to the fused arm on the card, before the sweeps
    # time them (the sweeps check each point against numpy first)
    t = Transport(rank_mesh(n))
    errs = {}
    x = randn((n, GiB // 4), torch.float32, seed=21)
    errs["allreduce"] = hold_to_fused(t, "allreduce", x, trees, n)
    errs["reduce_scatter"] = hold_to_fused(t, "reduce_scatter", x, ("khd",), n)
    del x
    x = randn((n, GiB // 4 // n), torch.float32, seed=22)
    errs["allgather"] = hold_to_fused(t, "allgather", x, ("khd",), n)
    del x
    print("1 GiB arms against fused on the card, max abs err: " + json.dumps(errs))
    recs = []
    # the tree64 point, scaled to 8 ranks on the one card
    recs += sweep(runner, "bench_allreduce", "allreduce",
                  ["--preset", "tree64", "--algos", ",".join(trees + ("fused",))]
                  + common, set(trees) | {"fused"})
    for bench, coll in (("bench_reducescatter", "reducescatter"),
                        ("bench_allgather", "allgather")):
        recs += sweep(runner, bench, coll, ["--ranks", str(n), "--sizes", "1G",
                                            "--algos", "khd,fused"] + common,
                      {"khd", "fused"})
    if {(r.n_ranks, r.size_bytes) for r in recs} != {(n, GiB)}:
        raise AssertionError("the tree64 point should be 8 ranks at 1 GiB")
    # the multislice sweep, scaled to a 2x4 mesh
    ms = ["--preset", "multislice"] + common
    recs += sweep(runner, "bench_allreduce", "allreduce",
                  ms + ["--algos", "hierarchical,khd2d,fused"],
                  {"hierarchical", "khd2d", "fused"})
    recs += sweep(runner, "bench_allreduce", "allreduce",
                  ms + ["--algos", "hierarchical", "--intra-algo", "khd"],
                  {"hierarchical"})
    recs += sweep(runner, "bench_allreduce", "allreduce",
                  ms + ["--algos", "hierarchical", "--cross-dtype", "bfloat16",
                        "--sizes", "64M"], {"hierarchical"})
    recs += sweep(runner, "bench_alltoall", "alltoall",
                  ms + ["--algos", "hierarchical,fused", "--sizes", "256M"],
                  {"hierarchical", "fused"})
    # the rooted verbs and sendrecv at 256 MiB per rank
    for coll in ("broadcast", "reduce", "gather", "scatter"):
        recs += sweep(runner, f"bench_{coll}", coll,
                      ["--ranks", str(n), "--sizes", "256M", "--algos",
                       "binomial,fused", "--root", "3"] + common,
                      {"binomial", "fused"})
    recs += sweep(runner, "bench_sendrecv", "sendrecv",
                  ["--ranks", str(n), "--sizes", "256M", "--shift", "3"] + common,
                  {"fused"})
    print(f"launches on the schedules path (no kernel is on it): "
          f"{ops.launch_counts()}", flush=True)

    print(f"schedules at full width, {kind}, fp32, us per call "
          f"(busbw in GB/s, peak device memory in GiB):")
    print(f"{'collective':>13} {'algo':>12} {'knobs':>22} {'mesh':>5} {'bytes':>11} "
          f"{'time(us)':>11} {'busbw':>8} {'peak GiB':>9}")
    for r in recs:
        knobs = ",".join(f"{k}={r.extra[k]}" for k in
                         ("cross_dtype", "intra_algo", "root", "shift", "op")
                         if r.extra.get(k) is not None)
        mesh = "x".join(map(str, r.extra["mesh2d"])) if r.extra.get("mesh2d") else str(r.n_ranks)
        print(f"{r.collective:>13} {r.algo:>12} {knobs:>22} {mesh:>5} {r.size_bytes:>11} "
              f"{r.mean_s * 1e6:>11.1f} {r.busbw_GBps:>8.2f} "
              f"{r.extra['peak_mem_bytes'] / GiB:>9.2f}")
    over = [(r.collective, r.algo, r.size_bytes) for r in recs
            if r.extra["peak_mem_bytes"] > PEAK_LIMIT]
    if over:
        raise AssertionError(f"arms above {PEAK_LIMIT >> 30} GiB of device memory: {over}")
    return recs


# the arms' measured ms at 8 x 1 GiB fp32 on one card (the tree64 point,
# PERF.md section 6)
MEASURED_1GIB_MS = {"fused": 12.326, "tree": 20.700, "khd": 21.099, "ktree": 22.909,
                    "dtree": 34.942, "ptree": 37.517}
TUNING_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "rocnrdma_tpu_torch", "results", "tuning_h100_8x1.json")


def verb_input(verb: str, n: int, size: int, seed: int) -> torch.Tensor:
    """A rank-major fp32 input of message size ``size`` (the tuning table's
    key: per rank, for allgather the gathered total)."""
    e = size // 4
    shape = {"allreduce": (n, e), "reduce_scatter": (n, e),
             "allgather": (n, e // n), "alltoall": (n, n, e // n)}[verb]
    return randn(shape, torch.float32, seed)


def dispatched(t, verb: str, x: torch.Tensor, algo: str) -> str:
    """Run ``verb`` on ``x`` under the policy ``algo`` and return the arm
    ``Transport.stats`` counted for the call."""
    before = {k: v["calls"] for k, v in t.stats().items()}
    getattr(t, verb)(x, algo)
    ran = [k.split("/")[1] for k, v in t.stats().items()
           if v["calls"] != before.get(k, 0)]
    if len(ran) != 1:
        raise AssertionError(f"{verb} {algo}: stats moved for {ran}")
    return ran[0]


def tuner_phase(kind: str, smi: str, n: int = 8) -> None:
    """The tuner's device half on the card (see the module docstring,
    phase 7)."""
    from rocnrdma_tpu_torch.bench import fold_ladder
    from rocnrdma_tpu_torch.metrics import GiB
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport
    from rocnrdma_tpu_torch.transport import tuner as TU

    alphas = [TU.measure_alpha() for _ in range(3)]
    print(f"dispatch alpha ({smi}): runs {[round(a * 1e9, 1) for a in alphas]} ns, "
          f"median {sorted(alphas)[1] * 1e9:.1f} ns per launch", flush=True)
    rows = fold_ladder.run_ladder((2, 3, 4, 8, 16, 32, 64), fold_ladder.ADDEND_BUDGET,
                                  GiB, 2, 10, 3, 3, torch.device("cuda"))
    print(f"fold ladder ({smi}), median accounted GB/s at (w+1) bytes/element: "
          + json.dumps({r["n_ops"]: round(r["GBps_median"], 1) for r in rows}), flush=True)

    # the committed table under auto: each of its sizes runs the table's arm
    table = TU.TuningTable.load(TUNING_TABLE)
    t = Transport(rank_mesh(n), tuning=table)
    if t.platform != "gpu" or table.lookup("allreduce", 4096, n, 1, "gpu") is None:
        raise AssertionError(f"{TUNING_TABLE} has no gpu row for {n} ranks")
    seed = 30
    picks = []
    for verb, by_size in sorted(table.meta["times_s"].items()):
        for size in sorted(map(int, by_size)):
            x = verb_input(verb, n, size, seed)
            seed += 1
            arm = table.lookup(verb, size, n, 1, "gpu")
            ran = dispatched(t, verb, x, "auto")
            if ran != arm:
                raise AssertionError(f"{verb} at {size} B: auto ran {ran}, the table says {arm}")
            hold_to_fused(t, verb, x, ("auto",), n)
            times = by_size[str(size)]
            winner = min(times, key=times.get)
            if winner != arm:
                raise AssertionError(f"{verb} at {size} B: table {arm}, its sweep's winner {winner}")
            model = t._resolve("model", verb, size)
            picks.append({"verb": verb, "bytes": size, "sweep_winner": winner,
                          "sweep_us": times[winner] * 1e6, "model_pick": model,
                          "model_pick_sweep_us": times.get(model, float("nan")) * 1e6})
            del x
    # algo="model" at three sizes of each verb
    models = {}
    for verb in ("allreduce", "reduce_scatter", "allgather", "alltoall"):
        for size in (4 << 10, 1 << 20, 256 << 20):
            x = verb_input(verb, n, size, seed)
            seed += 1
            models[f"{verb}@{size}"] = dispatched(t, verb, x, "model")
            hold_to_fused(t, verb, x, ("model",), n)
            del x
    # khd without digits runs the model's digits, bitwise
    digits = {}
    for verb in ("allreduce", "reduce_scatter"):
        x = verb_input(verb, n, 16 << 20, seed)
        seed += 1
        digits[verb] = t.khd_model_digits(verb, t._msg_bytes(verb, x))
        hold(f"{verb} khd vs khd digits={digits[verb]}", getattr(t, verb)(x, "khd"),
             getattr(t, verb)(x, "khd", digits=digits[verb]))
        del x
    print(f"algo=model dispatched ({smi}): {json.dumps(models)}; khd digits at "
          f"8 x 16 MiB: {json.dumps(digits)}", flush=True)
    # the model's price of each arm at 8 x 1 GiB beside the measured times
    alpha, beta, hbm = t._constants("allreduce")
    price = {a: TU.model_time("allreduce", a, n, GiB, alpha, beta, hbm,
                              device_kind=kind) * 1e3
             for a in ("ring", "ring_bidir", "tree", "khd", "dtree", "ptree", "ktree",
                       "cuda_ring")}
    price["fused"] = TU.fused_model_time("allreduce", n, GiB, alpha, beta, hbm,
                                         device_kind=kind) * 1e3
    print(f"model ms at 8 x 1 GiB allreduce ({smi}; alpha {alpha:.3e} s, beta "
          f"{beta:.3e} s/B, hbm_beta {hbm:.3e} s/B) vs measured (the tree64 point, PERF.md): "
          + json.dumps({a: [round(ms, 3), MEASURED_1GIB_MS.get(a)]
                        for a, ms in sorted(price.items(), key=lambda kv: kv[1])}))
    print(f"model pick vs sweep winner at the table's sizes ({smi}): " + json.dumps(picks),
          flush=True)


OUT_DIR = "smoke_out"  # artifacts of the headline and mfu_profile runs


def count_launches(ops, label: str, fn, need: tuple = ()) -> dict:
    """Run ``fn()`` with the launch counts zeroed before it; read them after
    and require each kernel of ``need`` launched. Returns the counts."""
    ops.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    got = dict(ops.launch_counts())
    print(f"launches on the {label} path: {got}", flush=True)
    for k in need:
        if got[k] < 1:
            raise AssertionError(f"the {label} path never launched {k}")
    return got


def moe_part(ops, n: int, launches: dict) -> dict:
    """The top-k MoE layer at Mixtral-8x7B width, 4096 tokens a rank
    (phase 8)."""
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport
    from rocnrdma_tpu_torch.workloads import moe
    from rocnrdma_tpu_torch.workloads import routing as R

    T, spec = 4096, moe.MOE_MODELS["mixtral-8x7b"]
    d, k = spec["d_model"], spec["top_k"]
    for algo in ("cuda_ring", "fused"):
        argv = ["--model", "mixtral-8x7b", "--routing", "topk", "--tokens", str(T),
                "--fake-devices", str(n), "--algo", algo, "--expert-compute",
                "--repeats", "3", "--iters", "5"]
        launches[f"moe/{algo}"] = count_launches(
            ops, f"moe {algo}", lambda: moe.main(argv),
            ("alltoall",) if algo == "cuda_ring" else ())
    if launches["moe/fused"]["alltoall"]:
        raise AssertionError("the fused MoE path launched the alltoall kernel")
    # one input through both arms: the kernel only moves data, so the
    # layer's output is the fused arm's bit for bit
    t = Transport(rank_mesh(n))
    cap = R.expert_capacity(T, n, k, 1.25)
    tok = randn((n, T, d), torch.float32, seed=40)
    logits = randn((n, T, n), torch.float32, seed=41)
    res = {"tokens": T, "d_model": d, "capacity": cap}
    outs = {}
    for algo in ("cuda_ring", "fused"):
        step = moe.moe_topk_step(t, algo, True, n, cap, k)
        out, keep = step(tok, logits)
        if not bool(torch.isfinite(out).all()) or out.shape != tok.shape:
            raise AssertionError(f"moe {algo}: non-finite or misshapen output")
        outs[algo] = out
        res[f"step_ms_{algo}"] = ms_of(lambda a, b: step(a, b)[0], tok, logits,
                                       repeats=3, iters=5)
    res["max_abs_err"] = hold("moe layer cuda_ring vs fused", outs["cuda_ring"],
                              outs["fused"])
    res["drop_rate"] = R.route_stats(keep)["drop_rate"]
    del outs, out, keep
    disp = randn((n, n, cap * d), torch.float32, seed=42)
    for algo in ("cuda_ring", "fused"):
        a2a = ms_of(t.jit_fn("alltoall", algo), disp, repeats=3, iters=5)
        res[f"alltoall_ms_{algo}"] = a2a
        res[f"alltoall_share_{algo}"] = 2 * a2a / res[f"step_ms_{algo}"]
    del disp, tok, logits
    return res


def replay_part(ops, n: int, launches: dict) -> dict:
    """The Llama-3-8B DDP and FSDP replays at 1/16 size (phase 8). Returns
    ms per step of each checked replay and the fused arms' max errors."""
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport
    from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows
    from rocnrdma_tpu_torch.workloads import ddp_replay, fsdp_replay
    from rocnrdma_tpu_torch.workloads.llama_trace import LLAMA3_8B, generate_trace

    scale, modes = 16, ddp_replay.MODES
    common = ["--fake-devices", str(n), "--scale", str(scale), "--repeats", "3"]
    t = Transport(rank_mesh(n))
    res = {"ms": {}, "ddp_fused_err": 0.0, "fsdp_rs_fused_err": 0.0}

    def ar_plain(b):
        tr = cuda_ring_tile_rows(b)
        return (ops.ring_allreduce_plain(b) if tr is None
                else ops.hbm_ring_allreduce_plain(b.clone(), tr))

    def check(what, algo, got, want, x, verb, err_key):
        # cuda_ring bitwise; fused: data moves bitwise, sums within the bound
        if algo == "cuda_ring" or verb == "allgather":
            hold(f"{what} {algo} vs plain", got, want)
        else:
            res[err_key] = max(res[err_key], within(
                f"{what} {algo} vs plain", got, want, sum_bound(x, n, verb)))

    def ddp(algo):
        ddp_replay.main(common + ["--algo", algo])
        torch.cuda.empty_cache()
        bufs = ddp_replay._bucket_arrays(t, generate_trace(LLAMA3_8B), scale, "float32")
        for mode in modes:
            out = []
            res["ms"][f"ddp/{algo}/{mode}"] = 1e3 * ddp_replay.replay(
                t, bufs, algo, mode, repeats=2, out=out)
            for i, (b, got) in enumerate(zip(bufs, out)):
                check(f"ddp {mode} bucket {i}", algo, got, ar_plain(b), b, "allreduce",
                      "ddp_fused_err")
            del out
        print(f"ddp {algo}: {len(bufs)} buckets x {len(modes)} modes held to the plain "
              f"ring", flush=True)
        del bufs
        torch.cuda.empty_cache()

    def fsdp(algo):
        fsdp_replay.main(common + ["--algo", algo])
        torch.cuda.empty_cache()
        units = fsdp_replay.flat_units(LLAMA3_8B)
        shards, fulls = fsdp_replay._unit_arrays(t, units, scale, "float32",
                                                 grain=fsdp_replay.CUDA_RING_GRAIN)
        plan = fsdp_replay.step_plan(len(units))
        for mode in modes:
            out = []
            res["ms"][f"fsdp/{algo}/{mode}"] = 1e3 * fsdp_replay.replay(
                t, shards, fulls, algo, mode, repeats=2, out=out)
            for (kind, i), got in zip(plan, out):
                if kind == "ag":
                    check(f"fsdp {mode} unit {i} allgather", algo, got,
                          ops.ring_allgather_plain(shards[i]), shards[i], "allgather",
                          "fsdp_rs_fused_err")
                else:
                    check(f"fsdp {mode} unit {i} reduce_scatter", algo, got,
                          ops.ring_reduce_scatter_plain(fulls[i]), fulls[i],
                          "reduce_scatter", "fsdp_rs_fused_err")
            del out
        print(f"fsdp {algo}: {len(plan)} collectives x {len(modes)} modes held to the "
              f"plain ring", flush=True)
        del shards, fulls
        torch.cuda.empty_cache()

    for wl, run, need in (("ddp", ddp, ("ring_allreduce",)),
                          ("fsdp", fsdp, ("ring_reduce_scatter", "ring_allgather"))):
        for algo in ("cuda_ring", "fused"):
            launches[f"{wl}/{algo}"] = count_launches(
                ops, f"{wl}_replay {algo}", lambda: run(algo),
                need if algo == "cuda_ring" else ())
    return res


def workloads_phase(ops, n: int = 8) -> dict:
    """The workloads on the card (module docstring, phase 8). Returns the
    launch counts per path and the MoE and replay results."""
    from rocnrdma_tpu_torch import graft_entry
    from rocnrdma_tpu_torch.workloads import overlap

    launches = {}
    res = {"moe": moe_part(ops, n, launches)}
    print("moe layer, Mixtral-8x7B width, 8 ranks, fp32, ms (alltoall share: two "
          "alltoalls of the dispatch over the step): " + json.dumps(res["moe"]), flush=True)
    torch.cuda.empty_cache()
    res["replay"] = replay_part(ops, n, launches)
    for algo in ("fused", "ring"):
        launches[f"overlap/{algo}"] = count_launches(
            ops, f"overlap {algo}",
            lambda: overlap.main(["--fake-devices", str(n), "--algo", algo]))

    def graft():
        fn, args = graft_entry.entry()
        out, new = fn(*args)
        if not all(bool(torch.isfinite(v).all()) for v in [out, *new]):
            raise AssertionError("graft entry: non-finite output")
        graft_entry.dryrun_multichip(n)
    launches["graft"] = count_launches(ops, "graft entry + dryrun_multichip(8)", graft,
                                       ("ring_allreduce", "alltoall"))
    res["launches"] = launches
    return res


def headline_phase(ops, n: int = 8) -> dict:
    """The headline's two branches and mfu_profile (module docstring,
    phase 9). Returns the launch counts per branch and the scored lines."""
    from rocnrdma_tpu_torch.bench import headline, mfu_profile

    res = {}
    a2a_path = os.path.join(OUT_DIR, "alltoall_algbw.json")
    for label, argv, need in (
            ("1 rank", [], ()),
            (f"{n} ranks", ["--fake-devices", str(n), "--out", a2a_path],
             ("hbm_ring_allreduce",))):
        out, err = io.StringIO(), io.StringIO()
        if os.path.exists(a2a_path):
            os.remove(a2a_path)  # the artifact must come from this run

        def run():
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                if headline.main(argv) != 0:
                    raise AssertionError(f"headline {label}: non-zero exit")
        try:
            res[f"launches {label}"] = count_launches(ops, f"headline {label}", run,
                                                      need)
        finally:
            sys.stderr.write(err.getvalue())
            sys.stderr.flush()
        # headline.main keeps its scored line when an extra leg or a candidate
        # fails, and says so on stderr: here any such line fails the phase
        notes = err.getvalue().splitlines()
        if any("failed" in ln for ln in notes):
            raise AssertionError(f"headline {label}: a leg or candidate failed")
        for head in ("# flagship step (", "# flagship TRAIN step ("):
            if not any(ln.startswith(head) for ln in notes):
                raise AssertionError(f"headline {label}: no '{head}' line")
        if label != "1 rank":
            won = [ln for ln in notes if ln.startswith("# allreduce @ ")]
            if len(won) != 1 or "cuda_ring=" not in won[0]:
                raise AssertionError(f"headline {label}: cuda_ring missing from {won}")
            if not os.path.exists(a2a_path):
                raise AssertionError(f"headline {label}: no alltoall artifact")
        row = json.loads(out.getvalue().splitlines()[0])  # the scored line comes first
        want = "local_reduce_GBps" if label == "1 rank" else "allreduce_busbw_GBps_per_chip"
        if row["metric"] != want or not 0 < row["value"] < float("inf"):
            raise AssertionError(f"headline {label}: bad scored line {row}")
        res[label] = row
        print(f"headline ({label}): {json.dumps(row)}", flush=True)
    torch.cuda.empty_cache()
    rows = os.path.join(OUT_DIR, "mfu_profile.jsonl")
    if mfu_profile.main(["--profile", os.path.join(OUT_DIR, "mfu_profile"),
                         "--out", rows]) != 0:
        raise AssertionError("mfu_profile: non-zero exit")
    with open(rows) as fp:
        res["mfu_profile"] = json.loads(fp.read().splitlines()[-1])
    if (not res["mfu_profile"].get("top_ops")
            or res["mfu_profile"].get("top_ops_clock") != "device"):
        raise AssertionError("mfu_profile --profile gave no top ops by device time")
    return res


def tooling_phase(ops, kind: str, smi: str, n: int = 8) -> dict:
    """The device-plane tooling and the process runtime on the card (module
    docstring, phase 10). Returns the per-step alignments and the seconds
    of each part."""
    from rocnrdma_tpu_torch import first_contact, hw, trace
    from rocnrdma_tpu_torch.runtime import multiprocess, rank_mesh, topo_cli
    from rocnrdma_tpu_torch.transport import Transport

    res, secs = {}, {}
    out_dir = os.path.join(OUT_DIR, "tooling")
    os.makedirs(out_dir, exist_ok=True)

    # topo_cli --json: one device, its nvidia-smi name and power limit
    t0 = time.perf_counter()
    _, source, raw = topo_cli.link_matrix()  # topo -m, or where it fails, -p2p n
    print(f"link matrix from {source}:\n{raw}", flush=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if topo_cli.main(["--json"]) != 0:
            raise AssertionError("topo_cli --json: non-zero exit")
    doc = json.loads(buf.getvalue())
    print(f"topo_cli --json: {json.dumps(doc)}", flush=True)
    name, power = (c.strip() for c in smi.splitlines()[0].split(","))
    dev = doc["devices"]
    if (doc["n_devices"], len(dev), doc["ring_order"]) != (1, 1, [0]):
        raise AssertionError(f"topo_cli: expected one device and ring [0], got {doc}")
    if ((dev[0]["name"], dev[0]["power_limit"]) != (name, power) or not dev[0]["pci_bus_id"]
            or dev[0]["cuda"] != 0):
        raise AssertionError(f"topo_cli: device {dev[0]} is not {smi!r}")
    if doc["links"] != [["X"]] or doc["gpus"] != [0]:
        raise AssertionError(f"topo_cli: links {doc['links']} for one GPU")
    secs["topo_cli"] = time.perf_counter() - t0

    # trace --measured --align-steps: ring, dtree, khd at 8 x 4 MiB fp32
    t0 = time.perf_counter()
    size = 4 * MiB
    digits = Transport(rank_mesh(n)).khd_model_digits("allreduce", size)
    for algo in ("ring", "dtree", "khd"):
        path = os.path.join(out_dir, f"trace_align_{algo}{n}_h100.trace.json")
        argv = ["--collective", "allreduce", "--algo", algo, "--ranks", str(n),
                "--size", "4M", "--fake-devices", str(n), "--measured",
                "--align-steps", "--out", path]
        pinned = digits if algo == "khd" else None
        if pinned:
            argv += ["--digits", ",".join(map(str, pinned))]
        if trace.main(argv) != 0:
            raise AssertionError(f"trace {algo}: non-zero exit")
        with open(path) as fp:
            od = json.load(fp)["otherData"]
        steps = od["step_diff"]
        want = max(e.step for e in trace.schedule_events(
            "allreduce", algo, n, size, digits=pinned)) + 1
        if len(steps) != want or want != {"ring": 14, "dtree": 20}.get(algo, want):
            raise AssertionError(f"trace {algo}: {len(steps)} aligned steps, "
                                 f"the schedule has {want}")
        if not all(r["measured_max_us"] > 0 for r in steps):
            raise AssertionError(f"trace {algo}: a step without device time")
        if not od.get("capture_bitwise_equal") or od.get("nvidia_smi") != smi:
            raise AssertionError(f"trace {algo}: capture not checked or no smi line")
        pred = sum(r["predicted_us"] for r in steps)
        meas = sum(r["measured_max_us"] for r in steps)
        res[algo] = {"digits": list(pinned) if pinned else None, "steps": len(steps),
                     "predicted_us": round(pred, 3), "measured_us": round(meas, 3),
                     "per_step_us": [[r["predicted_us"], r["measured_max_us"]]
                                     for r in steps]}
        print(f"trace {algo} ({smi}), {n} x 4 MiB fp32, per step [predicted, measured "
              f"device us]: " + json.dumps(res[algo]["per_step_us"]), flush=True)
        print(f"trace {algo}: {len(steps)} steps, predicted {pred:.1f} us, measured "
              f"{meas:.1f} us (x{meas / pred:.2f})", flush=True)
    secs["trace"] = time.perf_counter() - t0

    # first_contact, its calibration kept out of the package's results/
    t0 = time.perf_counter()
    fc_dir = os.path.join(out_dir, "first_contact")
    cal_dir = os.path.join(out_dir, "hw_cal")
    shutil.rmtree(fc_dir, ignore_errors=True)  # report.jsonl appends
    old = os.environ.get("RNR_HW_CAL_DIR")
    os.environ["RNR_HW_CAL_DIR"] = cal_dir
    rc = []
    try:
        res["first_contact launches"] = count_launches(
            ops, "first_contact", lambda: rc.append(first_contact.main(
                ["--outdir", fc_dir, "--fake-devices", str(n), "--sizes",
                 "4K,1M,16M", "--calibrate-widths", "2,8"])),
            need=("ring_allreduce", "ring_reduce_scatter", "ring_allgather",
                  "alltoall"))
    finally:
        if old is None:
            os.environ.pop("RNR_HW_CAL_DIR")
        else:
            os.environ["RNR_HW_CAL_DIR"] = old
        hw._CAL_CACHE.clear()  # later phases price with hw.MEASURED again
    with open(os.path.join(fc_dir, "report.jsonl")) as fp:
        report = [json.loads(ln) for ln in fp.read().splitlines()]
    for row in report:
        print(f"first_contact: {json.dumps(row)}", flush=True)
    if rc != [0] or len(report) != 7 or not all(r["ok"] for r in report):
        raise AssertionError(f"first_contact: exit {rc}, report {report}")
    if not report[0]["artifact"].startswith(cal_dir):
        raise AssertionError(f"first_contact: calibration at {report[0]['artifact']}")
    secs["first_contact"] = time.perf_counter() - t0

    # the process runtime over NCCL: a world of one, the fault, the refusal
    t0 = time.perf_counter()
    for task in ("allreduce", "alltoall"):
        rs = multiprocess.run_workers(1, task, timeout_s=120, platform="auto")
        if rs[0].returncode != 0 or "OK rank=0/1 backend=nccl" not in rs[0].stdout:
            raise AssertionError(f"run_workers(1, {task}): {rs[0]}")
        print(f"run_workers(1, {task!r}): {rs[0].stdout.strip()}", flush=True)
    tf = time.perf_counter()
    rs = multiprocess.run_workers(2, "fault", timeout_s=120, fault_rank=1,
                                  platform="auto")
    by = {r.process_id: r for r in rs}
    if (by[1].returncode, by[0].returncode) != (3, 4) or "CLEAN-ABORT" not in by[0].stdout:
        raise AssertionError(f"run_workers(2, 'fault'): {rs}")
    print(f"run_workers(2, 'fault') in {time.perf_counter() - tf:.1f} s: "
          f"{by[0].stdout.strip()[:300]}", flush=True)
    try:
        multiprocess.run_workers(2, "allreduce", platform="auto")
    except RuntimeError as e:
        if "fewer GPUs than processes" not in str(e):
            raise
        print(f"run_workers(2, 'allreduce') refused: {e}", flush=True)
    else:
        if torch.cuda.device_count() < 2:
            raise AssertionError("run_workers(2, 'allreduce') ran on one GPU")
    secs["runtime"] = time.perf_counter() - t0
    res["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    print(f"tooling seconds: {json.dumps(res['seconds'])}", flush=True)
    return res


# sha256 of the fp8 frame of default_rng(0).standard_normal(65536) * 150
# (fp32); tests/test_torch_plugin_codec.py pins it against ml_dtypes
FP8_ROUNDTRIP_SHA256 = (
    "b798f439b8a8c7cf330b2ad8fb4d5aff11b89e1532ea7834f87231a633c11a96")
FRONT_DOOR_RANKS = 4
FRONT_DOOR_SIZES = (4 << 10, 1 << 20, 64 << 20)


def front_door_worker(rank: int, world: int, port: int) -> int:
    """One rank of phase 11's front-door check, a process of its own:
    ``python chip_smoke.py --front-door-worker RANK WORLD PORT``. Prints
    one ``FRONTDOOR {json}`` line; any mismatch raises."""
    import numpy as np

    from rocnrdma_tpu_torch import distributed as dist

    dev = torch.device("cuda", 0)
    pg = dist.init_process_group(rank=rank, world_size=world,
                                 master_addr="127.0.0.1", master_port=port,
                                 plane="tcp", timeout_s=120.0)
    res = {"rank": rank, "checks": 0, "call_ms": {}}

    def seeded(r: int, size: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(1000 * r + size)
        return torch.randn(size // 4, device=dev, generator=g)

    def same(got, want) -> None:
        if not (isinstance(got, torch.Tensor) and got.device == dev
                and got.dtype == torch.float32):
            raise AssertionError(f"rank {rank}: result {type(got)} "
                                 f"{getattr(got, 'device', None)}, want a "
                                 f"float32 tensor on {dev}")
        host = got.cpu().numpy()
        if host.shape != want.shape or host.tobytes() != want.tobytes():
            raise AssertionError(f"rank {rank}: CUDA result differs from the "
                                 f"numpy path ({host.shape} vs {want.shape})")
        res["checks"] += 1

    try:
        for size in FRONT_DOOR_SIZES:
            x = seeded(rank, size)
            calls = {
                "all_reduce": lambda v: pg.all_reduce(v),
                "all_gather": lambda v: pg.all_gather(v),
                "all_to_all": lambda v: pg.all_to_all(v.reshape(world, -1)),
                "broadcast": lambda v: pg.broadcast(v, src=world - 1),
            }
            for name, call in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = call(x)
                torch.cuda.synchronize()
                res["call_ms"][f"{name}@{size}"] = (time.perf_counter() - t0) * 1e3
                same(got, call(x.cpu().numpy()))
            # send/recv: even ranks send to the next odd rank
            if rank % 2 == 0:
                pg.send(x, rank + 1)
                pg.send(x.cpu().numpy(), rank + 1)
            else:
                got = pg.recv(torch.empty_like(x), rank - 1)
                want = pg.recv(np.empty(x.numel(), np.float32), rank - 1)
                same(got, want)
                same(got, seeded(rank - 1, size).cpu().numpy())
        # the staging each way at 64 MiB, best of three
        x = seeded(rank, FRONT_DOOR_SIZES[-1])
        d2h, h2d = [], []
        for _ in range(3):
            door = dist._Door(torch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arr = door.stage(x)
            d2h.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = door.to_tensor(arr, dev)
            torch.cuda.synchronize()
            h2d.append(time.perf_counter() - t0)
            door.done()
            if not torch.equal(back, x):
                raise AssertionError("staging round trip changed the tensor")
        res["staging_GBps"] = {"d2h": x.nbytes / min(d2h) / 1e9,
                               "h2d": x.nbytes / min(h2d) / 1e9}
        res["staging_stats"] = dist.staging_stats()
        # bf16 folds as the reference's ml_dtypes arrays do: the CUDA
        # tensor's result is a bf16 tensor on the card, bitwise the CPU one's
        xb = seeded(rank, 1 << 20).to(torch.bfloat16)
        got, want = pg.all_reduce(xb), pg.all_reduce(xb.cpu())
        if not (got.device == dev and got.dtype == torch.bfloat16
                and torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))):
            raise AssertionError(f"rank {rank}: a bf16 CUDA tensor's fold is not "
                                 f"the CPU tensor's")
        res["bf16"] = "folded, bitwise the CPU tensor's"
        # so do e4m3fn and e5m2 (their bits, never torch's saturating cast
        # on the way back); the fnuz formats stay refused
        for fp8 in (torch.float8_e4m3fn, torch.float8_e5m2):
            x8 = (seeded(rank, 1 << 16) * 64).to(fp8)
            got, want = pg.all_reduce(x8), pg.all_reduce(x8.cpu())
            if not (got.device == dev and got.dtype == fp8
                    and torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))):
                raise AssertionError(f"rank {rank}: a {fp8} CUDA tensor's fold is not "
                                     f"the CPU tensor's")
        try:
            pg.all_reduce(torch.zeros(16, dtype=torch.uint8, device=dev).view(
                torch.float8_e4m3fnuz))
            raise AssertionError("an fnuz fp8 CUDA tensor entered the host plane")
        except dist.HostPlaneDtypeError as e:
            res["fp8"] = "e4m3fn, e5m2 folded bitwise the CPU tensor's; fnuz: " + \
                str(e).split(":")[0]
        pg.barrier()
    finally:
        pg.destroy()
    print("FRONTDOOR " + json.dumps(res), flush=True)
    return 0


def host_plane_phase(smi: str) -> dict:
    """The host plane on the card's machine (module docstring, phase 11)."""
    import argparse
    import hashlib
    import importlib.util
    import socket

    import numpy as np

    from rocnrdma_tpu_torch import native
    from rocnrdma_tpu_torch.bench import bench_host
    from rocnrdma_tpu_torch.bench.host_tune import codec_rates, host_cpu
    from rocnrdma_tpu_torch.metrics import format_host_table
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import codec
    from rocnrdma_tpu_torch.transport.plugin import DeviceMeshNet

    res, secs = {"smi": smi}, {}
    cpu = host_cpu()
    res["host_cpu"] = cpu
    print(f"host: {cpu}", flush=True)

    # the port's native library, from the port's sources
    t0 = time.perf_counter()
    lib = native.build(force=True)
    secs["build"] = time.perf_counter() - t0
    if not os.environ.get("RQP_LIB_DIR"):
        want_dir = os.path.join(os.path.dirname(os.path.abspath(native.__file__)),
                                "_build")
        if os.path.dirname(lib) != want_dir:
            raise AssertionError(f"librqp.so built at {lib}, not under {want_dir}")
    print(f"built {lib} in {secs['build']:.1f} s", flush=True)

    # bench_host fleets: 4 OS processes, every rank holding the copy gate
    t0 = time.perf_counter()
    fleets = {}
    for plane, transport, sizes in (("tcp", "msg", "64K,1M,16M"),
                                    ("shm", "rdma", "1M,16M")):
        ns = argparse.Namespace(
            ranks=4, plane=plane, transport=transport, sizes=sizes,
            collectives=",".join(bench_host.COLLECTIVES), repeats=3, iters=3,
            lat_iters=200, bulk_size="32M", bulk_rounds=40, small_ops=256,
            bucket_size="4M", node_map=None, smoke=True)
        recs = bench_host._run_fleet(ns)
        print(f"bench_host --ranks 4 --plane {plane} --transport {transport} "
              f"--sizes {sizes} ({cpu}):", flush=True)
        print(format_host_table(recs), flush=True)
        points = {}
        for r in recs:
            copied = r.extra["wire"]["payload_bytes_copied"]
            if copied:
                raise AssertionError(f"{plane}/{transport} {r.collective} "
                                     f"{r.size_bytes} B: {copied} B copied")
            points[f"{r.collective}@{r.size_bytes}"] = round(r.algbw_GBps, 4)
        if len(recs) != len(bench_host.COLLECTIVES) * len(sizes.split(",")):
            raise AssertionError(f"{plane}/{transport}: {len(recs)} records")
        fleets[f"{plane}/{transport}"] = points
        print(f"payload_bytes_copied == 0 on every rank of {len(recs)} points",
              flush=True)
    res["bench_host_GBps"] = fleets
    secs["bench_host"] = time.perf_counter() - t0

    # bench_host --smoke against the port's own floors
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "rocnrdma_tpu_torch.bench.bench_host",
                        "--smoke"], capture_output=True, text=True, timeout=600)
    print(r.stdout, flush=True)
    if r.returncode != 0:
        raise AssertionError(f"bench_host --smoke exit {r.returncode}:\n{r.stderr[-4000:]}")
    res["smoke"] = [line for line in r.stdout.splitlines()
                    if line.startswith("smoke gate ok")]
    if len(res["smoke"]) != 7:
        raise AssertionError(f"bench_host --smoke: {len(res['smoke'])} gates ok, want 7")
    secs["smoke"] = time.perf_counter() - t0

    # the tensor front door: 4 processes, CUDA tensors on the one card
    t0 = time.perf_counter()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--front-door-worker",
         str(rk), str(FRONT_DOOR_RANKS), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rk in range(FRONT_DOOR_RANKS)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    workers = []
    for rk, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("FRONTDOOR ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"front-door rank {rk}: exit {p.returncode}\n"
                                 f"{err[-4000:]}")
        workers.append(json.loads(lines[-1][len("FRONTDOOR "):]))
    want_checks = [4 * len(FRONT_DOOR_SIZES) + (2 * len(FRONT_DOOR_SIZES)
                                                if rk % 2 else 0)
                   for rk in range(FRONT_DOOR_RANKS)]
    if [w["checks"] for w in workers] != want_checks:
        raise AssertionError(f"front door checks {[w['checks'] for w in workers]}, "
                             f"want {want_checks}")
    big = FRONT_DOOR_SIZES[-1]
    res["front_door"] = {
        "checks": sum(w["checks"] for w in workers),
        "staging_GBps_64MiB": [{k: round(v, 3) for k, v in w["staging_GBps"].items()}
                               for w in workers],
        "call_ms_64MiB": {verb: round(max(w["call_ms"][f"{verb}@{big}"]
                                          for w in workers), 3)
                          for verb in ("all_reduce", "all_gather", "all_to_all",
                                       "broadcast")},
        "bf16": workers[0]["bf16"], "fp8": workers[0]["fp8"]}
    print(f"front door ({smi}; {cpu}): " + json.dumps(res["front_door"]), flush=True)
    secs["front_door"] = time.perf_counter() - t0

    # DeviceMeshNet: 8 ranks as rows of one CUDA tensor, every pair
    t0 = time.perf_counter()
    n = 8
    net = DeviceMeshNet(rank_mesh(n))
    net.init()
    x = randn((n, MiB // 4), torch.float32, seed=21)
    mr = net.reg_mr((0, 1), x)
    pairs = 0
    for src in range(n):
        for dst in range(n):
            if src == dst:
                continue
            handle, lc = net.listen(dst)
            req = net.irecv(net.accept(lc), net.isend(net.connect(src, handle), mr))
            out = req.wait()
            if not net.test(req)[0]:
                raise AssertionError(f"DeviceMeshNet ({src}, {dst}) never completed")
            want = torch.zeros_like(x)
            want[dst] = x[src]
            if out.device != x.device or not torch.equal(out, want):
                raise AssertionError(f"DeviceMeshNet ({src}, {dst}) is not the row copy")
            pairs += 1
    res["device_mesh_net_pairs"] = pairs
    print(f"DeviceMeshNet: {pairs} (src, dst) pairs of 8 x 1 MiB rows on "
          f"{x.device}, each bitwise the row copy", flush=True)
    secs["device_mesh_net"] = time.perf_counter() - t0

    # the fp8 codec with torch, here and in a process where ml_dtypes
    # cannot be imported (a stub module that raises shadows it)
    fp8 = codec.get("fp8")
    frame = (np.random.default_rng(0).standard_normal(65536) * 150).astype(np.float32)
    digest = hashlib.sha256(bytes(fp8.encode(frame))).hexdigest()
    stub = os.path.join(OUT_DIR, "no_ml_dtypes")
    os.makedirs(stub, exist_ok=True)
    with open(os.path.join(stub, "ml_dtypes.py"), "w") as f:
        f.write("raise ImportError('ml_dtypes is hidden from this process')\n")
    code = ("import hashlib, sys, numpy as np\n"
            "from rocnrdma_tpu_torch.transport import codec\n"
            "x = (np.random.default_rng(0).standard_normal(65536) * 150)"
            ".astype(np.float32)\n"
            "print(hashlib.sha256(bytes(codec.get('fp8').encode(x))).hexdigest())\n"
            "print(sys.modules.get('ml_dtypes') is None)\n")
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                           [os.path.abspath(stub), here])))
    hidden = r.stdout.split()
    if r.returncode != 0 or hidden != [FP8_ROUNDTRIP_SHA256, "True"]:
        raise AssertionError(f"fp8 without ml_dtypes: exit {r.returncode}, "
                             f"{r.stdout!r} {r.stderr[-2000:]}")
    if digest != FP8_ROUNDTRIP_SHA256:
        raise AssertionError(f"fp8 frame sha256 {digest}, want {FP8_ROUNDTRIP_SHA256}")
    res["codec"] = {"fp8_sha256_ok": True, "fp8_without_ml_dtypes_ok": True,
                    "ml_dtypes_importable": importlib.util.find_spec("ml_dtypes")
                    is not None, "GBps_1MiB": codec_rates()}
    print(f"codec ({cpu}): " + json.dumps(res["codec"]), flush=True)
    res["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    return res


# phase 12: the device heal and the chaos tasks on the card's machine
CHAOS_KILL = dict(seed=11, rounds=4, kill_ranks="1", kill_ops="25", size=2048)


def _line(r, key: str) -> str:
    for ln in r.stdout.splitlines():
        if ln.startswith(key + " "):
            return ln[len(key) + 1:]
    raise AssertionError(f"rank {r.process_id} printed no {key} line "
                         f"(exit {r.returncode}):\n{r.stdout[-3000:]}\n"
                         f"{r.stderr[-3000:]}")


def _device_launches(r, epoch: int) -> dict:
    """The ``DEVICE-LAUNCHES`` line of ``epoch``: the kernel launches of
    that epoch's DEVICE-LOCAL allreduce, which must be on the card."""
    for ln in r.stdout.splitlines():
        if ln.startswith(f"DEVICE-LAUNCHES epoch={epoch} "):
            _, _, on, counts = ln.split(" ", 3)
            if not on.startswith("on=cuda"):
                raise AssertionError(f"rank {r.process_id}: DEVICE-LOCAL ran {on}")
            return json.loads(counts)
    raise AssertionError(f"rank {r.process_id}: no DEVICE-LAUNCHES epoch={epoch}:\n"
                         f"{r.stdout[-3000:]}")


def _survivors_healed(rs, victim: int, epoch: str, members: str, launches: dict) -> list:
    """Every survivor of a kill-a-host fleet exited 0 on ``epoch`` with
    ``members``, its DEVICE-LOCAL ran the ring kernel on the card after the
    heal, and it re-initialised once; returns the survivors' heal ms."""
    by = {r.process_id: r for r in rs}
    if by[victim].returncode != 7:
        raise AssertionError(f"victim exit {by[victim].returncode}:\n{by[victim].stdout}")
    ms = []
    for r in rs:
        if r.process_id == victim:
            continue
        if r.returncode != 0:
            raise AssertionError(f"survivor {r.process_id} exit {r.returncode}:\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        if (_line(r, "EPOCH"), _line(r, "MEMBERS")) != (epoch, members):
            raise AssertionError(f"survivor {r.process_id}: epoch "
                                 f"{_line(r, 'EPOCH')}, members {_line(r, 'MEMBERS')}")
        if f"DEVICE-LOCAL ok epoch={epoch}" not in r.stdout:
            raise AssertionError(f"survivor {r.process_id}: no DEVICE-LOCAL ok:\n{r.stdout}")
        got = _device_launches(r, int(epoch))
        if sum(got.values()) < 1:
            raise AssertionError(f"survivor {r.process_id}: DEVICE-LOCAL launched no kernel")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        heal = json.loads(_line(r, "DEVICEHEAL_MS"))
        if len(heal) != 1 or heal[0] <= 0.0:
            raise AssertionError(f"survivor {r.process_id}: DEVICEHEAL_MS {heal}")
        ms.append(heal[0])
    return ms


def nccl_reinit_worker() -> int:
    """Phase 12 (c), a process of its own: an NCCL world of one runs an
    all_reduce, aborts and re-creates its communicator with
    ``reinit_runtime``, and runs one on the new group."""
    import torch.distributed as dist

    from rocnrdma_tpu_torch.obs import FLIGHT
    from rocnrdma_tpu_torch.runtime import init as rinit
    from rocnrdma_tpu_torch.runtime.multiprocess import free_port

    info = rinit.init_runtime(coordinator=f"127.0.0.1:{free_port()}",
                              num_processes=1, process_id=0, timeout_s=60,
                              platform="auto")
    dev = torch.device("cuda", torch.cuda.current_device())

    def reduced(seed: int) -> float:
        x = randn((1 << 20,), torch.float32, seed=seed)
        want = x.clone()
        dist.all_reduce(x)
        torch.cuda.synchronize()
        if not torch.equal(x, want):  # a world of one sums to itself
            raise AssertionError(f"all_reduce on {dist.get_backend()} changed the data")
        return float(x.abs().sum())

    before = (info.backend, dist.get_backend(), id(dist.group.WORLD))
    reduced(31)
    store: dict = {}

    def agree(key, value=None, timeout_s=30.0):
        return store.setdefault(key, value) if value is not None else store[key]

    healed = rinit.reinit_runtime([0], 1, 0, agree=agree, timeout_s=60.0,
                                  platform="auto")
    after = (healed.backend, dist.get_backend(), id(dist.group.WORLD))
    reduced(32)
    fence = rinit.device_fence([0], 0, 1, timeout_s=10.0)
    spans = {kind[len("member-device-"):]: round(a["dur"] * 1000.0, 3)
             for _, kind, a in FLIGHT.events() if kind.startswith("member-device-")}
    shut = [a for _, kind, a in FLIGHT.events() if kind == "device-plane-shutdown"]
    res = {"device": str(dev), "torch": torch.__version__,
           "backend_before": before[1], "backend_after": after[1],
           "new_world_group": before[2] != after[2], "fence": fence,
           "shutdown_clean": [a["clean"] for a in shut],
           "reinit_ms": round(healed.reinit_s * 1000.0, 3), "spans_ms": spans}
    rinit.shutdown_runtime()
    print("NCCLREINIT " + json.dumps(res), flush=True)
    return 0


def chaos_phase(smi: str) -> dict:
    """The device heal and the chaos tasks (module docstring, phase 12)."""
    from rocnrdma_tpu_torch.ops import _build
    from rocnrdma_tpu_torch.runtime.multiprocess import run_workers

    _build.build()  # the fleets' processes find the kernels built
    res, secs, launches = {"smi": smi}, {}, {}

    # (a) kill-a-host twice: the heal, the ring kernel after it, replay
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        rs = run_workers(3, "kill-a-host", timeout_s=240.0, platform="auto", **CHAOS_KILL)
        res.setdefault("kill_a_host_ms", []).append(
            _survivors_healed(rs, 1, "1", "[0, 2]", launches))
        for r in rs:
            if r.process_id != 1 and "DEVICE-GLOBAL" not in r.stdout:
                raise AssertionError(f"survivor {r.process_id}: no DEVICE-GLOBAL line")
        runs.append(rs)
    for a, b in zip(*runs):
        if a.process_id == 1:
            continue
        for key in ("FAULTLOG", "HEALLOG", "DEVICEHEAL"):
            if _line(a, key) != _line(b, key):
                raise AssertionError(f"survivor {a.process_id}: {key} differs across runs")
    r0 = runs[0][0]
    res["device_global"] = [ln for ln in r0.stdout.splitlines()
                            if ln.startswith("DEVICE-GLOBAL")]
    res["device_spans_ms"] = json.loads(_line(r0, "DEVICESPANS"))
    print(f"kill-a-host x2 ({smi}): heal ms {res['kill_a_host_ms']}, rank 0 spans "
          f"{res['device_spans_ms']}, {res['device_global']}", flush=True)
    secs["kill_a_host_x2"] = time.perf_counter() - t0

    # (b) the spare promotion keeps the world at 3
    t0 = time.perf_counter()
    rs = run_workers(4, "kill-a-host", timeout_s=240.0, platform="auto", spares=1,
                     **dict(CHAOS_KILL, seed=13, kill_ranks="2"))
    res["spare_ms"] = _survivors_healed(rs, 2, "1", "[0, 1, 2]", launches)
    if "now-rank=2/3" not in rs[3].stdout:
        raise AssertionError(f"the spare was not promoted into rank 2:\n{rs[3].stdout}")
    print(f"kill-a-host spares=1: heal ms {res['spare_ms']}, spare now-rank=2/3", flush=True)
    secs["spare"] = time.perf_counter() - t0

    # (c) the NCCL communicator's abort and re-create, a world of one
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--nccl-reinit-worker"],
                       capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("NCCLREINIT ")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"NCCL re-create: exit {r.returncode}\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-4000:]}")
    res["nccl_reinit"] = json.loads(lines[-1][len("NCCLREINIT "):])
    nr = res["nccl_reinit"]
    if (nr["backend_before"], nr["backend_after"]) != ("nccl", "nccl") \
            or not nr["new_world_group"] or nr["shutdown_clean"] != [True]:
        raise AssertionError(f"NCCL re-create: {nr}")
    print(f"NCCL abort + re-create ({smi}): " + json.dumps(nr), flush=True)
    secs["nccl_reinit"] = time.perf_counter() - t0

    # (d) degraded mode: a silent coordinator, the host plane still serves
    t0 = time.perf_counter()
    rs = run_workers(3, "kill-a-host", timeout_s=240.0, platform="auto",
                     device_heal_fail=True, **CHAOS_KILL)
    secs["degraded"] = time.perf_counter() - t0
    for r in rs:
        if r.process_id == 1:
            continue
        if r.returncode != 4 or "HOST-PLANE-OK" not in r.stdout \
                or "device-plane heal failed" not in _line(r, "DEVICEHEAL-FAILED"):
            raise AssertionError(f"degraded survivor {r.process_id}: exit {r.returncode}\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    if secs["degraded"] >= 90.0:
        raise AssertionError(f"degraded mode took {secs['degraded']:.1f} s")
    print(f"kill-a-host --device-heal-fail: survivors exit 4 named, HOST-PLANE-OK, "
          f"{secs['degraded']:.1f} s", flush=True)

    # (e) the host-plane chaos tasks on this machine's host
    t0 = time.perf_counter()
    rs = run_workers(4, "kill-and-heal", timeout_s=150.0, seed=11, rounds=6,
                     kill_ranks="2", kill_ops="49")
    for r in rs:
        want = 7 if r.process_id == 2 else 0
        if r.returncode != want or (want == 0 and _line(r, "MEMBERS") != "[0, 1, 3]"):
            raise AssertionError(f"kill-and-heal rank {r.process_id}: exit {r.returncode}\n"
                                 f"{r.stdout[-3000:]}\n{r.stderr[-2000:]}")
    secs["kill_and_heal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rs = run_workers(4, "die-mid-collective", timeout_s=120.0, seed=7, rounds=6,
                     fault_rank=2)
    for r in rs:
        want = 7 if r.process_id == 2 else 4
        if r.returncode != want or (want == 4 and "ring wire stalled" not in r.stdout):
            raise AssertionError(f"die-mid-collective rank {r.process_id}: exit "
                                 f"{r.returncode}\n{r.stdout[-3000:]}")
    secs["die_mid_collective"] = time.perf_counter() - t0
    print("kill-and-heal: survivors exit 0 on [0, 1, 3]; die-mid-collective: "
          "survivors exit 4 naming the stalled hop", flush=True)
    res["launches"] = launches
    res["seconds"] = {k: round(v, 1) for k, v in secs.items()}
    return res


# phase 13: (label, ranks a process, elements of a rank's (8, size) rows)
HIER_CASES = (("reference", 2, 8), ("full_width", 4, 64 * MiB // 4 // 8))


def hierarchical_phase(smi: str) -> dict:
    """The Transport across processes (module docstring, phase 13)."""
    from rocnrdma_tpu_torch.runtime.mp_worker import HIER_CALLS
    from rocnrdma_tpu_torch.runtime.multiprocess import run_workers

    res = {"smi": smi, "gpus": torch.cuda.device_count()}
    names = set(HIER_CALLS)
    for label, per_slice, size in HIER_CASES:
        t0 = time.perf_counter()
        rs = run_workers(2, "hierarchical", timeout_s=240.0, platform="auto",
                         per_slice=per_slice, size=size)
        secs = time.perf_counter() - t0
        for r in rs:
            if r.returncode != 0 or f"OK rank={r.process_id}/2 hierarchical" \
                    not in r.stdout:
                raise AssertionError(f"hierarchical {label} rank {r.process_id}: exit "
                                     f"{r.returncode}\n{r.stdout[-3000:]}\n"
                                     f"{r.stderr[-4000:]}")
        ranks = [{"ms": json.loads(_line(r, "HIERTIMES")),
                  "max_abs_err": json.loads(_line(r, "HIERERRS")),
                  "cross": json.loads(_line(r, "HIERCROSS"))} for r in rs]
        for rank in ranks:
            if set(rank["ms"]) != names or set(rank["max_abs_err"]) != names:
                raise AssertionError(f"hierarchical {label}: calls "
                                     f"{sorted(rank['ms'])}, want {sorted(names)}")
            cross = rank["cross"]
            if not cross["device"].startswith("cuda"):
                raise AssertionError(f"hierarchical {label}: rows on {cross['device']}")
            want = ("gloo", True) if res["gpus"] < 2 else ("nccl", False)
            if (cross["backend"], cross["staged"]) != want:
                raise AssertionError(f"hierarchical {label}: cross leg {cross}, "
                                     f"want {want} with {res['gpus']} GPU(s)")
        res[label] = {"per_slice": per_slice, "rank_bytes": 2 * per_slice * size * 4,
                      "seconds": round(secs, 1), "ranks": ranks}
        for name in sorted(names):  # ms of the steady calls, per rank
            print(f"  {label} {name:<24} ms " + " | ".join(
                ", ".join(f"{v:.1f}" for v in r["ms"][name][1:]) for r in ranks)
                + f"  max_abs_err {max(r['max_abs_err'][name] for r in ranks):.3g}",
                flush=True)
        print(f"hierarchical {label}, 2 processes x {per_slice} ranks x "
              f"{2 * per_slice * size * 4} bytes a rank ({smi}): cross leg "
              f"{ranks[0]['cross']['backend']} (staged {ranks[0]['cross']['staged']}), "
              f"{secs:.1f} s; HIERCROSS per rank: "
              + json.dumps([r["cross"] for r in ranks]), flush=True)
    return res


# phase 14: (label, elements of a rank's row, seed: None = the reference's rows)
# (label, elements a rank, seed, the calls or None for every one)
RANK_CASES = (("reference", 8, None, None), ("full_width", 64 * MiB // 4, 7, None))
# with a GPU a process: the headline size, the kernel against NCCL
RANK_HEADLINE = ("headline", 1024 * MiB // 4, 7, "allreduce/cuda_ring,allreduce/fused")
NVLINK_GBPS = 450.0  # datasheet: NVLink 4, each way per H100 (not measured)


def _median(vals: list) -> float:
    vals = sorted(vals)
    return vals[len(vals) // 2]


def nvlink_bound_ms(name: str, n: int, rank_bytes: int) -> float:
    """The least ms of the ``rank-mesh`` task's ``cuda_ring`` call ``name``
    at NVLink's datasheet rate, a GPU a rank: each rank's kernel moves
    (n-1)/n of its rank's bytes each way (a ``group()`` two verbs' worth)."""
    verbs = 2 if name.startswith("group/") else 1
    return verbs * (n - 1) / n * rank_bytes / (NVLINK_GBPS * 1e9) * 1e3


def rank_mesh_phase(smi: str) -> dict:
    """The 1-D rank mesh across processes (module docstring, phase 14)."""
    from rocnrdma_tpu_torch.metrics import busbw_GBps
    from rocnrdma_tpu_torch.ops import _build
    from rocnrdma_tpu_torch.runtime.mp_worker import (RANK_CALLS, rank_launches,
                                                      rank_refused)
    from rocnrdma_tpu_torch.runtime.multiprocess import WorkerResult, run_workers

    gpus = torch.cuda.device_count()
    n = 8 if gpus < 2 else min(gpus, 8)
    want = ("gloo", True) if gpus < n else ("nccl", False)
    res = {"smi": smi, "gpus": gpus, "processes": n, "across_launches": {}}
    full = {}
    _build.build()  # the kernels, once, before the workers load them
    # the two cases in one fleet (one start of 8 processes); with a GPU a
    # process, the headline case in a fleet of its own (its calls differ)
    fleets = [RANK_CASES] + ([(RANK_HEADLINE,)] if gpus >= 2 else [])
    runs = []
    for cases in fleets:
        t0 = time.perf_counter()
        rs = run_workers(n, "rank-mesh", timeout_s=300.0, platform="auto",
                         calls=cases[0][3], cases=",".join(
                             f"{size}:{'-' if seed is None else seed}"
                             for _, size, seed, _ in cases))
        secs = time.perf_counter() - t0
        for r in rs:
            if r.returncode != 0 or f"OK rank={r.process_id}/{n} rank-mesh" \
                    not in r.stdout:
                raise AssertionError(f"rank-mesh {cases[0][0]} rank {r.process_id}: "
                                     f"exit {r.returncode}\n{r.stdout[-3000:]}\n"
                                     f"{r.stderr[-4000:]}")
        for i, case in enumerate(cases):
            # each case's lines: after its RANKCASE line
            part = [WorkerResult(r.process_id, r.returncode,
                                 r.stdout.split("RANKCASE ")[i + 1], r.stderr) for r in rs]
            runs.append((case, part, secs))
    for (label, size, seed, only), rs, secs in runs:
        ran = only.split(",") if only else list(RANK_CALLS)
        names = set(ran) - rank_refused(n, size)
        launches = rank_launches(names, n, size)
        ranks = [{"ms": json.loads(_line(r, "RANKTIMES")),
                  "max_abs_err": json.loads(_line(r, "RANKERRS")),
                  "plain_err": json.loads(_line(r, "RANKPLAINERRS")),
                  "cross": json.loads(_line(r, "RANKCROSS")),
                  "launches": json.loads(_line(r, "RANKLAUNCHES"))} for r in rs]
        kernel_calls = {name for name in names if "cuda_ring" in name}
        for rank in ranks:
            if set(rank["ms"]) != names or set(rank["max_abs_err"]) != names:
                raise AssertionError(f"rank-mesh {label}: calls {sorted(rank['ms'])}, "
                                     f"want {sorted(names)}")
            # each cuda_ring result bitwise its kernels' plain versions
            if set(rank["plain_err"]) != kernel_calls or any(rank["plain_err"].values()):
                raise AssertionError(f"rank-mesh {label}: against the plain versions "
                                     f"{rank['plain_err']}, want 0 for {sorted(kernel_calls)}")
            # every cuda_ring call launched its kernel once a run: none fell
            # back to a plain version
            if rank["launches"] != launches:
                raise AssertionError(f"rank-mesh {label}: kernel launches across "
                                     f"processes {rank['launches']}, want {launches}")
            cross = rank["cross"]
            if not cross["device"].startswith("cuda"):
                raise AssertionError(f"rank-mesh {label}: rows on {cross['device']}")
            if (cross["backend"], cross["staged"]) != want:
                raise AssertionError(f"rank-mesh {label}: cross leg {cross}, want "
                                     f"{want} with {gpus} GPU(s) and {n} processes")
            for k, v in rank["launches"].items():
                res["across_launches"][k] = res["across_launches"].get(k, 0) + v
        full[label] = ranks
        # per call, the median over the ranks of each steady call's ms
        calls = {name: [round(_median([r["ms"][name][i] for r in ranks]), 3)
                        for i in (1, 2)] for name in ran if name in names}
        for name, ms in calls.items():
            plain = (f", vs plain {max(r['plain_err'][name] for r in ranks):.3g}"
                     if name in kernel_calls else "")
            print(f"  {label} {name:<30} ms (median of {n} ranks) "
                  + ", ".join(f"{v:.1f}" for v in ms)
                  + f"  max_abs_err {max(r['max_abs_err'][name] for r in ranks):.3g}"
                  + plain, flush=True)
        beside = {name: {algo: calls.get(name.split("/")[0] + "/" + algo)
                         for algo in ("cuda_ring", "fused", "ring")} | {"call": calls[name]}
                  for name in calls if "cuda_ring" in name}
        print(f"rank-mesh {label} cuda_ring calls beside the verb's fused and ring, ms "
              f"(median of {n} ranks; {smi}): " + json.dumps(beside), flush=True)
        gbps = {way: [r["cross"][f"{way}_GBps"] for r in ranks]
                for way in ("wire", "d2h", "h2d")}
        cross = {"backend": ranks[0]["cross"]["backend"],
                 "staged": ranks[0]["cross"]["staged"],
                 "calls": ranks[0]["cross"]["calls"],
                 "bytes_per_rank": [r["cross"]["bytes"] for r in ranks],
                 **{f"{way}_GBps": [min(v), max(v)] if None not in v else None
                    for way, v in gbps.items()}}
        res[label] = {"rank_bytes": size * 4, "seed": seed,
                      "fleet_seconds": round(secs, 1),
                      "cross": cross, "ms": calls, "launches_per_rank": launches}
        if gpus >= 2 and size * 4 >= MiB:
            res[label]["nvlink_bound_ms"] = {
                name: round(nvlink_bound_ms(name, n, size * 4), 4)
                for name in calls if "cuda_ring" in name}
            print(f"rank-mesh {label} cuda_ring NVLink bound ms (datasheet 450 GB/s each "
                  f"way): " + json.dumps(res[label]["nvlink_bound_ms"]), flush=True)
        if label == "headline":
            res[label]["busbw_GBps"] = {
                name: round(busbw_GBps("allreduce", n, size * 4, min(ms) / 1e3), 1)
                for name, ms in calls.items()}
            bound_ms = nvlink_bound_ms("allreduce/cuda_ring", n, size * 4)
            res[label]["nvlink_bound"] = {
                "ms": round(bound_ms, 3),
                "busbw_GBps": round(busbw_GBps("allreduce", n, size * 4, bound_ms / 1e3), 1),
                "source": "datasheet, NVLink 4 at 450 GB/s each way per GPU"}
            print(f"rank-mesh headline, {n} x 1 GiB fp32 ({smi}): busbw GB/s "
                  f"{res[label]['busbw_GBps']}, NVLink bound {res[label]['nvlink_bound']}",
                  flush=True)
        print(f"rank-mesh {label}, {n} processes x {size * 4} bytes a rank ({smi}): "
              f"cross leg {cross['backend']} (staged {cross['staged']}), {secs:.1f} s, "
              f"GB/s [min, max] over ranks: wire {cross['wire_GBps']}, "
              f"d2h {cross['d2h_GBps']}, h2d {cross['h2d_GBps']}", flush=True)
    for k, v in res["across_launches"].items():
        if v < 1:
            raise AssertionError(f"rank-mesh: the kernel wrapper {k} never launched")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "rank_mesh.json"), "w") as f:
        json.dump({"summary": res, "ranks": full}, f)
    return res


# phase 16: the bench CLIs across processes, run as a launcher runs them
# (bench, collective); one card: 2 processes, 4 KiB and 1 MiB a rank; with
# several GPUs (--bench-mesh), a GPU a process at 4 KiB and 1 GiB fp32
CLI_ONE_CARD = (("bench_allreduce", "allreduce"), ("bench_alltoall", "alltoall"))
CLI_MESH = CLI_ONE_CARD[:1] + (("bench_reducescatter", "reducescatter"),
                               ("bench_allgather", "allgather"), CLI_ONE_CARD[1])


def cli_fleet(n: int, bench: str, argv: list, link: str, timeout_s: float = 600.0) -> list:
    """``bench`` as ``n`` processes (``run_cli``, the launcher's environment),
    ``--check-plain``: every rank exits 0, every record of rank 0's
    ``--out`` is checked, on ``link`` across ``n`` processes, and each
    ``cuda_ring`` record launched a kernel across processes and is bitwise
    its kernels' plain versions on every rank. Returns the records."""
    recs = fleet_records(n, f"bench.{bench}", argv + ["--check-plain"],
                         os.path.join("cli", f"{bench}_{n}.jsonl"), timeout_s)
    for rec in recs:
        ex = rec["extra"]
        what = f"{bench} x {n} {rec['algo']} {rec['size_bytes']} B"
        if not ex["checked"] or ex["link"] != link or ex["processes"] != n:
            raise AssertionError(f"{what}: checked {ex['checked']}, link {ex['link']}, "
                                 f"processes {ex['processes']}; want {link}, {n}")
        if rec["algo"] == "cuda_ring":
            across = {k: v for k, v in ex.get("launches", {}).items()
                      if k.endswith("_across")}
            if not across or min(across.values()) < 1 or ex.get("plain_max_abs_err") != 0:
                raise AssertionError(f"{what}: launches {ex.get('launches')}, against "
                                     f"the plain versions {ex.get('plain_max_abs_err')}")
    return recs


# the workload CLIs across processes: (tag, module, argv, the kernels a
# cuda_ring run must launch across processes); one card: 2 processes over
# gloo staged, kept short (a cuda_ring call across time-sliced contexts
# costs ~34 ms); several GPUs: a GPU a process over NCCL at full width
_WL_SHORT = ["--repeats", "2", "--iters", "3"]
_REPLAY_SHORT = ["--modes", "sequential,jit_fused", "--repeats", "2"]
WL_ONE_CARD = tuple(
    (f"moe_{routing}_{algo}", "moe", ["--routing", routing, "--algo", algo] + _WL_SHORT,
     ("alltoall",)) for routing in ("uniform", "topk") for algo in ("fused", "ring", "cuda_ring")
) + tuple(
    (f"{wl}_{algo}", wl, argv + ["--algo", algo] + _REPLAY_SHORT, need)
    for wl, argv, need in (
        ("ddp_replay", ["--scale", "1024", "--bucket-mb", "1024"], ("ring_allreduce",)),
        ("fsdp_replay", ["--scale", "4096"], ("ring_reduce_scatter", "ring_allgather")))
    for algo in ("fused", "cuda_ring")
) + (("overlap_fused", "overlap", ["--algo", "fused"] + _WL_SHORT, ()),)
WL_MESH = tuple(
    (f"moe_mixtral_{algo}", "moe", ["--model", "mixtral-8x7b", "--routing", "topk",
                                    "--tokens", "4096", "--algo", algo], ("alltoall",))
    for algo in ("fused", "cuda_ring")
) + tuple(
    (f"{wl}_{algo}", wl, ["--scale", "16", "--algo", algo, "--repeats", "3"], need)
    for wl, need in (("ddp_replay", ("ring_allreduce",)),
                     ("fsdp_replay", ("ring_reduce_scatter", "ring_allgather")))
    for algo in ("fused", "cuda_ring")
) + (("overlap_fused", "overlap", [], ()),)


def fleet_records(n: int, module: str, argv: list, out: str, timeout_s: float) -> list:
    """``rocnrdma_tpu_torch.<module>`` as ``n`` processes (``run_cli``, the
    launcher's environment) writing ``--out`` under ``OUT_DIR`` (``out``):
    every rank exits 0 and only rank 0 printed a table. Returns rank 0's
    records, all from this run."""
    from rocnrdma_tpu_torch.runtime.multiprocess import run_cli

    out = os.path.abspath(os.path.join(OUT_DIR, out))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)  # the records must come from this run
    rs = run_cli(n, f"rocnrdma_tpu_torch.{module}", argv + ["--out", out],
                 timeout_s=timeout_s)
    for r in rs:
        if r.returncode != 0:
            raise AssertionError(f"{module} x {n} rank {r.process_id}: exit "
                                 f"{r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    if any("busbw GB/s" in r.stdout for r in rs[1:]):
        raise AssertionError(f"{module} x {n}: a rank other than 0 printed the table")
    with open(out) as fp:
        return [json.loads(line) for line in fp.read().splitlines()]


def workload_fleet(n: int, tag: str, module: str, argv: list, need: tuple, link: str,
                   timeout_s: float = 900.0) -> list:
    """The workload CLI ``module`` as ``n`` processes (``fleet_records``):
    rank 0's records are on ``link`` across ``n`` processes, with finite
    positive times; a ``cuda_ring`` run is ``--check-plain`` (its results
    bitwise its kernels' plain versions on every rank, agreed across the
    fleet, else every rank exits non-zero) and launched each kernel of
    ``need`` across processes. Returns the records."""
    cuda_ring = "cuda_ring" in argv
    recs = fleet_records(n, f"workloads.{module}",
                         argv + (["--check-plain"] if cuda_ring else []),
                         os.path.join("workloads", f"{tag}_{n}.jsonl"), timeout_s)
    if not recs:
        raise AssertionError(f"{tag} x {n}: rank 0 wrote no record")
    for rec in recs:
        ex = rec["extra"]
        what = f"{tag} x {n} {ex.get('mode', '')}"
        if (ex.get("link") != link or ex.get("processes") != n
                or not 0 < rec["mean_s"] < float("inf")):
            raise AssertionError(f"{what}: link {ex.get('link')}, processes "
                                 f"{ex.get('processes')}, mean_s {rec['mean_s']}; "
                                 f"want {link}, {n}")
        launched = ex.get("launches", {})
        if cuda_ring:
            if ex.get("plain_max_abs_err") != 0 or any(
                    launched.get(k + "_across", 0) < 1 for k in need):
                raise AssertionError(f"{what}: launches {launched}, against the plain "
                                     f"versions {ex.get('plain_max_abs_err')}")
        elif launched:
            raise AssertionError(f"{what}: the {rec['algo']} arm launched {launched}")
    return recs


def _cli_rows(recs: list) -> dict:
    """{algo: {size: [us, busbw GB/s, peak GiB]}} of a CLI's records."""
    out = {}
    for rec in recs:
        out.setdefault(rec["algo"], {})[rec["size_bytes"]] = [
            round(rec["mean_s"] * 1e6, 1), round(rec["busbw_GBps"], 2),
            round(rec["extra"].get("peak_mem_bytes", 0) / 2**30, 2)]
    return out


def bench_mesh_phase(smi: str) -> dict:
    """The bench CLIs, the workload CLIs and the headline across processes
    (module docstring, phase 16). Returns each CLI's rows and each workload's ms a step, rank 0's
    launches across processes per kernel in each, and with several GPUs
    the headline's scored line."""
    from rocnrdma_tpu_torch.ops import _build

    gpus = torch.cuda.device_count()
    _build.build()  # the kernels, once, before the processes load them
    smi = f"{smi.splitlines()[0]} x {gpus}"  # nvidia-smi prints a line a GPU
    res = {"smi": smi, "gpus": gpus, "launches": {}, "seconds": {}}
    if gpus < 2:
        n, link, clis = 2, "host-loopback", CLI_ONE_CARD
        argv = ["--sizes", "4K,1M", "--algos", "fused,ring,cuda_ring",
                "--repeats", "2", "--iters", "3"]
    else:
        n, link, clis = min(gpus, 4), "nvlink", CLI_MESH
        argv = ["--preset", "ring8", "--sizes", "4K,1G", "--dtypes", "float32",
                "--algos", "fused,ring,ring_bidir,cuda_ring", "--repeats", "3",
                "--iters", "5"]
    res["processes"] = n

    def fleet(bench):
        t0 = time.perf_counter()
        recs = cli_fleet(n, bench, argv, link)
        return recs, round(time.perf_counter() - t0, 1)

    if gpus < 2:
        # on one card the two fleets share it at once (their times are
        # time-sliced HBM numbers either way): one fleet start fewer
        with concurrent.futures.ThreadPoolExecutor(len(clis)) as pool:
            runs = list(pool.map(fleet, [bench for bench, _ in clis]))
    else:  # each fleet takes every GPU
        runs = [fleet(bench) for bench, _ in clis]
    for (bench, collective), (recs, secs) in zip(clis, runs):
        res["seconds"][bench] = secs
        ran = {r["algo"] for r in recs}
        if "cuda_ring" not in ran or "fused" not in ran:
            raise AssertionError(f"{bench} x {n}: ran {sorted(ran)}")
        for rec in recs:
            for k, v in rec["extra"].get("launches", {}).items():
                res["launches"][k] = res["launches"].get(k, 0) + v
        res[bench] = _cli_rows(recs)
        print(f"{bench} across {n} processes ({link}; {smi}) [us, busbw GB/s, peak "
              f"GiB] by algo and bytes: " + json.dumps(res[bench]), flush=True)
    kind = torch.cuda.get_device_name(0)
    if gpus < 2:  # one card: the tool fleets beside the workload fleets
        with concurrent.futures.ThreadPoolExecutor(1) as side:
            tools = side.submit(tools_across, n, link, gpus, kind, smi)
            res["workloads"], res["workload_launches"] = workloads_across(
                n, link, gpus, smi)
            res["tools"], res["tools_launches"] = tools.result()
    else:
        res["workloads"], res["workload_launches"] = workloads_across(n, link, gpus, smi)
        res["tools"], res["tools_launches"] = tools_across(n, link, gpus, kind, smi)
    if gpus >= 2:
        res["torchrun"] = torchrun_check(n)
        res["headline"] = headline_across(n, smi)
    return res


def workloads_across(n: int, link: str, gpus: int, smi: str) -> tuple:
    """The workload CLIs across ``n`` processes (module docstring, phase 16):
    ``WL_ONE_CARD`` on one card, four fleets at a time (the replays'
    cuda_ring runs first, their time-sliced calls take longest, the other
    cuda_ring runs last, so that few contexts spin on the card at once),
    ``WL_MESH`` one fleet at a time with several GPUs. Returns each run's ms
    a step (per mode for the replays) and rank 0's launches across
    processes per kernel."""
    runs = WL_ONE_CARD if gpus < 2 else WL_MESH

    def first(run):
        return 0 if "cuda_ring" not in run[2] else (-1 if "replay" in run[1] else 1)

    def fleet(run):
        tag, module, argv, need = run
        t0 = time.perf_counter()
        recs = workload_fleet(n, tag, module, argv, need, link)
        return recs, round(time.perf_counter() - t0, 1)

    if gpus < 2:
        order = sorted(runs, key=first)
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            done = dict(zip([r[0] for r in order], pool.map(fleet, order)))
    else:
        done = {r[0]: fleet(r) for r in runs}
    steps, launches = {}, {}
    for tag, _, _, _ in runs:
        recs, secs = done[tag]
        for rec in recs:
            for k, v in rec["extra"].get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
        steps[tag] = {"seconds": secs, "ms": {
            rec["extra"].get("mode", "step"): round(rec["extra"].get(
                "step_ms", rec["mean_s"] * 1e3), 3) for rec in recs}}
        print(f"{tag} across {n} processes ({link}; {smi}): ms a step "
              f"{json.dumps(steps[tag]['ms'])}, fleet {secs} s", flush=True)
    print(f"workloads across {n} processes, rank 0's launches across processes: "
          f"{json.dumps({k: v for k, v in launches.items() if k.endswith('_across')})}",
          flush=True)
    return steps, launches


# the tools across processes (phase 16): (tag, module, argv), each run as
# its own fleet through run_cli; the --out, --outdir or --profile paths are
# added under OUT_DIR/tools. One card: 2 processes over gloo staged, cut
# short, all fleets at once; several GPUs: a GPU a process over NCCL, one
# fleet at a time, at the reference's sizes
_TOOL_SHORT = ["--repeats", "2", "--trials", "1"]
TOOLS_ONE_CARD = (
    ("tuner", "transport.tuner", ["--verbs", "allreduce,alltoall", "--sizes", "4K,1M",
                                  "--algos", "fused,ring,cuda_ring"]),
    ("trace", "trace", ["--algo", "ring", "--size", "4M", "--measured", "--align-steps"]),
    # its dryrun runs in phase 10's one-process first_contact; across
    # processes with several GPUs
    ("first_contact", "first_contact", ["--sizes", "4K,1M", "--smoke-size", "64K",
                                        "--calibrate-widths", "2", "--skip-dryrun"]),
    ("bench_local", "bench.bench_local", ["--size", "64M", "--kernels",
                                          "torch2,cuda2,pipe2", "--k2", "8"] + _TOOL_SHORT),
    ("fold_ladder", "bench.fold_ladder", ["--widths", "2,4", "--budget", "1G",
                                          "--per-op-cap", "256M"] + _TOOL_SHORT),
    ("mfu_profile", "bench.mfu_profile", ["--tokens", "1024", "--d-model", "512",
                                          "--ffn", "2048", "--k2", "8"] + _TOOL_SHORT),
)
TOOLS_MESH = (
    ("tuner", "transport.tuner", [
        "--verbs", "allreduce,reduce_scatter,allgather,alltoall", "--sizes", "4K,1M,1G",
        "--algos", "fused,ring,ring_bidir,tree,khd,dtree,ptree,ktree,bruck,cuda_ring"]),
    ("trace", "trace", ["--algo", "khd", "--size", "4M", "--measured", "--align-steps"]),
    ("first_contact", "first_contact", []),
    ("bench_local", "bench.bench_local", ["--size", "256M"]),
    ("fold_ladder", "bench.fold_ladder", []),
    ("mfu_profile", "bench.mfu_profile", ["--tokens", "4096", "--d-model", "2048",
                                          "--ffn", "8192"]),
)
KHD_SIZE = 4 * MiB


def _tool_paths(tag: str, n: int) -> tuple:
    """(argv naming where ``tag``'s fleet writes, that path), fresh."""
    path = os.path.abspath(os.path.join(OUT_DIR, "tools", f"{tag}_{n}"))
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if tag == "first_contact":
        return ["--outdir", path], path
    if tag == "mfu_profile":
        return ["--out", path + ".jsonl", "--profile", path], path
    return ["--out", path], path


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and 0 < x < float("inf")


def tool_fleet(n: int, tag: str, module: str, argv: list, link: str, kind: str,
               timeout_s: float = 900.0) -> dict:
    """The tool ``module`` as ``n`` processes (``run_cli``): every rank
    exits 0, and rank 0's records name the fleet's link and process count
    and carry finite times; ``first_contact``'s calibration is kept in
    ``OUT_DIR`` (``RNR_HW_CAL_DIR``) and every ``cuda_ring`` point of its
    cli_smoke is bitwise its kernels' plain versions on every rank.
    Returns what the check read, with rank 0's kernel launches."""
    from rocnrdma_tpu_torch.runtime.multiprocess import run_cli
    from rocnrdma_tpu_torch.transport import tuner

    where, path = _tool_paths(tag, n)
    env = {}
    if tag == "first_contact":
        env["RNR_HW_CAL_DIR"] = os.path.abspath(os.path.join(OUT_DIR, "tools", "hw_cal"))
    if tag == "trace" and "khd" in argv:
        digits = tuner.khd_model_digits(
            "allreduce", n, KHD_SIZE, *tuner.constants_for(kind, "allreduce", 1),
            device_kind=kind)
        argv = argv + ["--digits", ",".join(map(str, digits))]
    t0 = time.perf_counter()
    rs = run_cli(n, f"rocnrdma_tpu_torch.{module}", argv + where, timeout_s=timeout_s,
                 env=env)
    secs = round(time.perf_counter() - t0, 1)
    for r in rs:
        if r.returncode != 0:
            raise AssertionError(f"{tag} x {n} rank {r.process_id}: exit "
                                 f"{r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    what = f"{tag} x {n}"
    out = {"seconds": secs, "launches": {}}

    def launched(counts):
        for k, v in (counts or {}).items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    def fleet_of(rec, name=what):
        if rec.get("link") != link or rec.get("processes") != n:
            raise AssertionError(f"{name}: link {rec.get('link')}, processes "
                                 f"{rec.get('processes')}; want {link}, {n}")

    def rows(p):
        with open(p) as fp:
            return [json.loads(ln) for ln in fp.read().splitlines()]

    if tag == "tuner":
        with open(path) as fp:
            table = json.load(fp)
        meta = table.pop("_meta")
        fleet_of(meta)
        layout = f"gpu/{link}"  # tuner.table_platform's key across processes
        times = meta["times_s"]
        if (not table or any(not k.endswith(f"|{n}|1|{layout}") for k in table)
                or not all(_finite(t) for arms in times.values()
                           for by in arms.values() for t in by.values())):
            raise AssertionError(f"{what}: keys {sorted(table)}, times {times}")
        launched(meta.get("launches"))
        out["us"] = {v: {sz: {a: round(t * 1e6, 1) for a, t in arms.items()}
                         for sz, arms in by.items()} for v, by in times.items()}
        out["policy_agreement"] = meta["policy_agreement"]
    elif tag == "trace":
        with open(path) as fp:
            od = json.load(fp)["otherData"]
        fleet_of(od)
        steps = od["step_diff"]
        if (od.get("measured_ranks") != n or len(steps) != n * od["n_steps"]
                or not od.get("capture_bitwise_equal")
                or not all(_finite(r["measured_max_us"]) for r in steps)):
            raise AssertionError(f"{what}: {json.dumps(od)[:3000]}")
        launched(od.get("launches"))
        out["steps"] = od["n_steps"]
        out["per_rank_us"] = {r: [[x["predicted_us"], x["measured_max_us"]]
                                  for x in steps if x["rank"] == r] for r in range(n)}
    elif tag == "first_contact":
        report = rows(os.path.join(path, "report.jsonl"))
        if (len(report) != 7 - ("--skip-dryrun" in argv)
                or not all(r["ok"] for r in report)):
            raise AssertionError(f"{what}: report {report}")
        if not report[0]["artifact"].startswith(env["RNR_HW_CAL_DIR"]):
            raise AssertionError(f"{what}: calibration at {report[0]['artifact']}")
        smoke = rows(os.path.join(path, "cli_smoke.jsonl"))
        for rec in smoke:
            ex = rec["extra"]
            fleet_of(ex, f"{what} cli_smoke {rec['collective']} {rec['algo']}")
            if not ex["checked"] or (rec["algo"] == "cuda_ring"
                                     and ex.get("plain_max_abs_err") != 0):
                raise AssertionError(f"{what} cli_smoke: {rec}")
        if "cuda_ring" not in {rec["algo"] for rec in smoke}:
            raise AssertionError(f"{what} cli_smoke ran {sorted({r['algo'] for r in smoke})}")
        for r in report:
            launched(r.get("launches"))
        out["steps_s"] = {r["step"]: r["seconds"] for r in report}
        out["alltoall_GBps"] = next(r["value"] for r in report
                                    if r["step"] == "alltoall_scored")
    else:
        recs = rows(path + ".jsonl" if tag == "mfu_profile" else path)
        if sorted({r["rank"] for r in recs}) != list(range(n)):
            raise AssertionError(f"{what}: rows of ranks {[r['rank'] for r in recs]}")
        key = {"bench_local": "GBps", "fold_ladder": "GBps_median",
               "mfu_profile": "full_us"}[tag]
        for rec in recs:
            fleet_of(rec)
            if not _finite(rec[key]):
                raise AssertionError(f"{what}: {rec}")
            if rec["rank"] == 0:
                launched(rec.get("launches"))
        name = {"bench_local": "kernel", "fold_ladder": "n_ops", "mfu_profile": "bench"}[tag]
        out["by_rank"] = {r["rank"]: {} for r in recs}
        for rec in recs:
            out["by_rank"][rec["rank"]][rec[name]] = round(rec[key], 3)
        if tag == "mfu_profile" and not all(
                os.path.exists(os.path.join(path, f"rank{r}", "trace.json"))
                for r in range(n)):
            raise AssertionError(f"{what}: a rank wrote no profile")
    return out


def tools_across(n: int, link: str, gpus: int, kind: str, smi: str) -> tuple:
    """The tools across ``n`` processes (module docstring, phase 16):
    ``TOOLS_ONE_CARD`` on one card, every fleet at once, ``TOOLS_MESH`` one
    fleet at a time with several GPUs. Returns each tool's checks and rank
    0's kernel launches over all of them."""
    runs = TOOLS_ONE_CARD if gpus < 2 else TOOLS_MESH

    def fleet(run):
        tag, module, argv = run
        return tool_fleet(n, tag, module, argv, link, kind)

    if gpus < 2:
        with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
            done = dict(zip([r[0] for r in runs], pool.map(fleet, runs)))
    else:
        done = {r[0]: fleet(r) for r in runs}
    launches = {}
    for tag, res in done.items():
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        print(f"{tag} across {n} processes ({link}; {smi}): "
              + json.dumps({k: v for k, v in res.items() if k != "launches"}), flush=True)
    print(f"tools across {n} processes, rank 0's kernel launches: {json.dumps(launches)}",
          flush=True)
    for k in ("ring_allreduce_across", "alltoall_across", "hbm_combine",
              "hbm_combine_pipelined"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"tools across {n} processes: {k} never launched")
    return done, launches


def torchrun_check(n: int) -> dict:
    """``bench_allreduce`` launched by torchrun (its agent hosts the store):
    every rank exits 0, rank 0's records are checked across n processes."""
    from rocnrdma_tpu_torch.runtime.multiprocess import reserve_port

    out = os.path.join(OUT_DIR, "cli", "torchrun.jsonl")
    if os.path.exists(out):
        os.remove(out)
    port, sock = reserve_port()
    sock.close()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
         "--master-port", str(port), "-m", "rocnrdma_tpu_torch.bench.bench_allreduce",
         "--sizes", "4K", "--algos", "fused,cuda_ring", "--repeats", "2", "--iters", "3",
         "--out", out], capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        raise AssertionError(f"torchrun bench_allreduce: exit {r.returncode}\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    with open(out) as fp:
        recs = [json.loads(line) for line in fp.read().splitlines()]
    if ({x["algo"] for x in recs} != {"fused", "cuda_ring"}
            or any(x["extra"]["processes"] != n or not x["extra"]["checked"]
                   for x in recs)):
        raise AssertionError(f"torchrun bench_allreduce: records {recs}")
    print(f"torchrun bench_allreduce x {n}: " + json.dumps(_cli_rows(recs)), flush=True)
    return _cli_rows(recs)


def headline_across(n: int, smi: str) -> dict:
    """The headline across n processes, a GPU each: rank 0 prints one
    scored line, against 0.9 x NVLink's datasheet rate each way; no leg or
    candidate failed; the alltoall row written."""
    from rocnrdma_tpu_torch.runtime.multiprocess import run_cli

    a2a = os.path.join(OUT_DIR, "alltoall_algbw_across.json")
    if os.path.exists(a2a):
        os.remove(a2a)
    rs = run_cli(n, "rocnrdma_tpu_torch.bench.headline", ["--out", a2a], timeout_s=900)
    for r in rs:
        if r.returncode != 0 or any("failed" in ln for ln in r.stderr.splitlines()
                                    if ln.startswith("#")):
            raise AssertionError(f"headline x {n} rank {r.process_id}: exit "
                                 f"{r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    lines = [[ln for ln in r.stdout.splitlines() if ln.startswith("{")] for r in rs]
    if len(lines[0]) != 1 or any(lines[1:]):
        raise AssertionError(f"headline x {n}: scored lines per rank {lines}")
    row = json.loads(lines[0][0])
    if (row["processes"] != n or row["ranks_per_card"] != 1 or row["link"] != "nvlink"
            or row["bound_GBps"] != 450.0 or not 0 < row["value"] < float("inf")):
        raise AssertionError(f"headline x {n}: bad scored line {row}")
    notes = [ln for ln in rs[0].stderr.splitlines() if ln.startswith("#")]
    with open(a2a) as fp:
        a2a_row = json.load(fp)
    print(f"headline across {n} processes ({smi}): {json.dumps(row)}", flush=True)
    print("\n".join(notes), flush=True)
    return {"line": row, "alltoall": a2a_row, "notes": notes}


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--front-door-worker":
        return front_door_worker(*map(int, sys.argv[2:]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == ["--nccl-reinit-worker"]:
        return nccl_reinit_worker()
    from rocnrdma_tpu_torch import ops
    from rocnrdma_tpu_torch.bench import bench_local, runner
    from rocnrdma_tpu_torch.collectives import (fused_allgather, fused_allreduce,
                                                fused_alltoall, fused_reduce_scatter)
    from rocnrdma_tpu_torch.metrics import BenchRecord, GiB, format_table
    from rocnrdma_tpu_torch.ops import _build
    from rocnrdma_tpu_torch.runtime import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport
    from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows

    kind = torch.cuda.get_device_name(0)
    with phase("probe"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
        print(f"nvidia-smi: {smi}", flush=True)
    if sys.argv[1:] == ["--host-plane"]:  # phase 11 alone, no kernels line
        with phase("host_plane"):
            host = host_plane_phase(smi)
        print(f"host plane ({smi}): " + json.dumps(host))
        return 0
    if sys.argv[1:] == ["--chaos"]:  # phase 12 alone, no kernels line
        with phase("chaos_heal"):
            chaos = chaos_phase(smi)
        print(f"chaos_heal ({smi}): " + json.dumps(chaos))
        return 0
    if sys.argv[1:] == ["--hierarchical"]:  # phase 13 alone, no kernels line
        with phase("hierarchical"):
            hier = hierarchical_phase(smi)
        print(f"hierarchical ({smi}): " + json.dumps(hier))
        return 0
    if sys.argv[1:] == ["--rank-mesh"]:  # phase 14 alone, no kernels line
        with phase("rank_mesh"):
            ranks = rank_mesh_phase(smi)
        print(f"rank_mesh ({smi}): " + json.dumps(ranks))
        return 0
    if sys.argv[1:] == ["--bench-mesh"]:  # phase 16 alone
        with phase("bench_mesh"):
            mesh = bench_mesh_phase(smi)
        print(f"bench_mesh ({smi}): " + json.dumps(mesh))
        return 0

    with phase("build"):
        t0 = time.perf_counter()
        paths = _build.build()
        for name in paths:
            _build.load(name)
        print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s", flush=True)

    with phase("kernels"):
        check_ring_kernels(ops)
        check_combine_kernel(ops)
        check_rs_ag_kernels(ops)
        check_alltoall_kernel(ops)
        check_pipelined_combine_kernel(ops)

    # ---- main path: bench_allreduce (ring kernels) ----
    n = 8
    with phase("main_allreduce"):
        ops.reset_launch_counts()
        argv = ["--preset", "ring8", "--fake-devices", str(n), "--algos",
                "fused,ring,ring_bidir,cuda_ring", "--repeats", "3", "--iters", "5"]
        args = runner.make_parser("bench_allreduce", "allreduce").parse_args(argv)
        sweep = runner.run_sweep("bench_allreduce", "allreduce", args)
        if {r.algo for r in sweep} != {"fused", "ring", "ring_bidir", "cuda_ring"}:
            raise AssertionError(f"sweep ran {sorted({r.algo for r in sweep})}")
        CROSSOVER["allreduce"] = crossover(sweep)

        # the contract point: 1 GiB fp32 per rank, 8 ranks
        t = Transport(rank_mesh(n))
        elems = GiB // 4
        x = randn((n, elems), torch.float32, seed=1)
        tr = cuda_ring_tile_rows(x)
        if tr is None:
            raise AssertionError("1 GiB per rank should take the tiled tier")
        got = t.allreduce(x, "cuda_ring")
        want = ops.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr)
        hbm_err = hold("1 GiB cuda_ring vs plain ring", got, want)
        if not bool(torch.isfinite(got).all()) or got.shape != x.shape:
            raise AssertionError("1 GiB cuda_ring: non-finite or misshapen result")
        del got
        fused = t.allreduce(x, "fused")
        if not torch.allclose(fused, want, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"1 GiB fused vs plain ring: max abs err "
                                 f"{max_abs_err(fused, want)}")
        del fused, want
        recs = []
        for algo in ("cuda_ring", "fused"):
            fn = t.jit_fn("allreduce", algo)
            ms = ms_of(fn, x, repeats=3, iters=2)
            recs.append(BenchRecord.measure(
                "bench_allreduce", "allreduce", algo, n, elems * 4, "float32",
                ms / 1e3, platform="gpu", device=kind, link="hbm-loopback"))
        print(format_table(recs))
        stats = t.stats()
        print(t.format_stats())
        if stats.get("allreduce/cuda_ring", {}).get("calls", 0) < 1:
            raise AssertionError(f"Transport.stats shows no cuda_ring call: {stats}")
        ring_counts = ops.launch_counts()
        print(f"launches on the main path: {ring_counts}", flush=True)
        for k in ("ring_allreduce", "hbm_ring_allreduce"):
            if ring_counts[k] < 1:
                raise AssertionError(f"main path never launched {k}")
        del x

    # ---- main paths: bench_reducescatter, bench_allgather, bench_alltoall
    # (the ring kernel's RS and AG modes, the alltoall kernel), each with
    # its 1 GiB fp32 point ----
    counts, errs = {}, {}
    with phase("main_reducescatter"):
        x = randn((n, GiB // 4), torch.float32, seed=11)
        counts["ring_reduce_scatter"], errs["ring_reduce_scatter"] = main_verb(
            ops, runner, "reducescatter", x, ops.ring_reduce_scatter_plain, kind)
        del x
    with phase("main_allgather"):
        x = randn((n, GiB // 4 // n), torch.float32, seed=12)
        counts["ring_allgather"], errs["ring_allgather"] = main_verb(
            ops, runner, "allgather", x, ops.ring_allgather_plain, kind)
        del x
    with phase("main_alltoall"):
        x = randn((n, n, GiB // 4 // n), torch.float32, seed=13)
        counts["alltoall"], errs["alltoall"] = main_verb(
            ops, runner, "alltoall", x, ops.alltoall_plain, kind)
        del x

    # ---- the explicit schedules, rooted verbs and sendrecv (no kernel) ----
    with phase("schedules"):
        schedules_phase(ops, runner, kind, n)

    # ---- the tuner: calibration, the committed table, algo="model" ----
    with phase("tuner"):
        tuner_phase(kind, smi, n)

    # ---- main path: bench_local (combine kernels) ----
    with phase("main_bench_local"):
        ops.reset_launch_counts()
        largs = bench_local.make_parser().parse_args(
            ["--kernels", "cuda2,cuda3,torch2,torch3,pipe2,pipe3", "--size", "256M"])
        local_rows = bench_local.run(largs)
        combine_counts = ops.launch_counts()
        print(f"launches on bench_local: {combine_counts}", flush=True)
        for k in ("hbm_combine", "hbm_combine_pipelined"):
            if combine_counts[k] < 1:
                raise AssertionError(f"bench_local never launched {k}")
        if len(local_rows) != 6:
            raise AssertionError(f"bench_local gave {len(local_rows)} rows")

    # ---- the workloads and the headline (their own paths) ----
    os.makedirs(OUT_DIR, exist_ok=True)
    with phase("workloads"):
        work = workloads_phase(ops, n)
    with phase("headline"):
        head = headline_phase(ops, n)
    with phase("tooling"):
        tools = tooling_phase(ops, kind, smi, n)
    with phase("host_plane"):
        host = host_plane_phase(smi)
    with phase("chaos_heal"):
        chaos = chaos_phase(smi)
    with phase("hierarchical"):
        hier = hierarchical_phase(smi)
    with phase("rank_mesh"):
        ranks = rank_mesh_phase(smi)
    with phase("bench_mesh"):
        mesh = bench_mesh_phase(smi)
    workload_launches = {}
    for counts_ in list(work["launches"].values()) + [
            v for k, v in head.items() if k.startswith("launches")]:
        for k, v in counts_.items():
            workload_launches[k] = workload_launches.get(k, 0) + v

    # ---- the kernels line, at the main path's shapes ----
    with phase("kernel_times"):
        kernels = []
        # ring_allreduce: a one-tile point of the sweep, 4 MiB fp32
        x = randn((n, 4 * MiB // 4), torch.float32, seed=2)
        S = x[0].numel() * 4
        err = max_abs_err(ops.ring_allreduce(x), ops.ring_allreduce_plain(x))
        kernels.append({
            "name": "ring_allreduce", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:198",
            "launches": ring_counts["ring_allreduce"], "max_abs_err": err,
            "ms": ms_of(ops.ring_allreduce, x),
            "plain_ms": ms_of(ops.ring_allreduce_plain, x),
            **bound(2 * n * S, (n - 1) * x[0].numel(), kind),
            "library_ms": ms_of(fused_allreduce, x),
            "shape": [n, x.shape[1]], "dtype": "float32"})
        moved = {"ring_allreduce": [ring_bytes("ar", n, -(-x.shape[1] // n // 128) * 128, 4),
                                    2 * n * S]}
        del x
        # hbm_ring_allreduce: the 1 GiB contract point, in place, with the
        # cuda_ring arm's tiles
        y = randn((n, GiB // 4), torch.float32, seed=3)
        S = y[0].numel() * 4
        kernels.append({
            "name": "hbm_ring_allreduce", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:432",
            "launches": ring_counts["hbm_ring_allreduce"], "max_abs_err": hbm_err,
            "ms": ms_of(lambda v: ops.hbm_ring_allreduce(v, tile_rows=tr), y,
                        repeats=3, iters=2),
            "plain_ms": ms_of(lambda v: ops.hbm_ring_allreduce_plain(v, tile_rows=tr),
                              y, repeats=3, iters=1),
            **bound(2 * n * S, (n - 1) * y[0].numel(), kind),
            "library_ms": ms_of(fused_allreduce, y, repeats=3, iters=2),
            "shape": [n, y.shape[1]], "dtype": "float32", "tile_rows": tr})
        moved["hbm_ring_allreduce"] = [
            ring_bytes("ar", n, -(-y.shape[1] // n // (tr * 128)) * tr * 128, 4), 2 * n * S]
        del y
        # hbm_combine: bench_local's cuda2 row, 256 MiB fp32 per operand
        a, b = (randn((64 * MiB,), torch.float32, seed=s) for s in (4, 5))
        err = max_abs_err(ops.hbm_combine(a, b), ops.hbm_combine_plain(a, b))
        kernels.append({
            "name": "hbm_combine", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/combine.cu",
            "replaces": "rocnrdma_tpu/ops/local_pallas.py:121",
            "launches": combine_counts["hbm_combine"], "max_abs_err": err,
            "ms": ms_of(ops.hbm_combine, a, b),
            "plain_ms": ms_of(ops.hbm_combine_plain, a, b),
            **bound(3 * a.numel() * 4, a.numel(), kind),
            "library_ms": ms_of(torch.add, a, b),
            "shape": [2, a.numel()], "dtype": "float32"})
        # hbm_combine_pipelined: bench_local's pipe2 row, the same operands
        err = max_abs_err(ops.hbm_combine_pipelined(a, b), ops.hbm_combine_plain(a, b))
        kernels.append({
            "name": "hbm_combine_pipelined", "route": "triton",
            "source": "rocnrdma_tpu_torch/ops/local_triton.py",
            "replaces": "rocnrdma_tpu/ops/local_pallas.py:160",
            "launches": combine_counts["hbm_combine_pipelined"], "max_abs_err": err,
            "ms": ms_of(ops.hbm_combine_pipelined, a, b),
            "plain_ms": ms_of(ops.hbm_combine_plain, a, b),
            **bound(3 * a.numel() * 4, a.numel(), kind),
            "library_ms": ms_of(torch.add, a, b),
            "shape": [2, a.numel()], "dtype": "float32"})
        del a, b
        # ring_reduce_scatter: the 1 GiB point, with the cuda_ring arm's tiles
        x = randn((n, GiB // 4), torch.float32, seed=14)
        S = x[0].numel() * 4
        tr = cuda_ring_tile_rows(x, "reduce_scatter")
        kernels.append({
            "name": "ring_reduce_scatter", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:215",
            "launches": counts["ring_reduce_scatter"],
            "max_abs_err": errs["ring_reduce_scatter"],
            "ms": ms_of(lambda v: ops.ring_reduce_scatter(v, tile_rows=tr), x,
                        repeats=3, iters=2),
            "plain_ms": ms_of(ops.ring_reduce_scatter_plain, x, repeats=3, iters=1),
            **bound(n * S + S, (n - 1) * x[0].numel(), kind),
            "library_ms": ms_of(fused_reduce_scatter, x, repeats=3, iters=2),
            "shape": [n, x.shape[1]], "dtype": "float32", "tile_rows": tr})
        moved["ring_reduce_scatter"] = [ring_bytes("rs", n, x.shape[1] // n, 4), n * S + S]
        del x
        # ring_allgather: the 1 GiB point (1 GiB gathered per rank)
        x = randn((n, GiB // 4 // n), torch.float32, seed=15)
        c = x[0].numel() * 4
        tr = cuda_ring_tile_rows(x, "allgather")
        kernels.append({
            "name": "ring_allgather", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/ring.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:239",
            "launches": counts["ring_allgather"], "max_abs_err": errs["ring_allgather"],
            "ms": ms_of(lambda v: ops.ring_allgather(v, tile_rows=tr), x,
                        repeats=3, iters=2),
            "plain_ms": ms_of(ops.ring_allgather_plain, x, repeats=3, iters=1),
            **bound(n * c + n * n * c, 0, kind),
            "library_ms": ms_of(fused_allgather, x, repeats=3, iters=2),
            "shape": [n, x.shape[1]], "dtype": "float32", "tile_rows": tr})
        moved["ring_allgather"] = [ring_bytes("ag", n, x.shape[1], 4), n * c + n * n * c]
        del x
        # alltoall: the 1 GiB point, the BASELINE.json:2 alltoall metric
        x = randn((n, n, GiB // 4 // n), torch.float32, seed=16)
        S = x[0].numel() * 4
        kernels.append({
            "name": "alltoall", "route": "cuda",
            "source": "rocnrdma_tpu_torch/ops/csrc/alltoall.cu",
            "replaces": "rocnrdma_tpu/ops/ring_pallas.py:290",
            "launches": counts["alltoall"], "max_abs_err": errs["alltoall"],
            "ms": ms_of(ops.alltoall, x, repeats=3, iters=2),
            "plain_ms": ms_of(ops.alltoall_plain, x, repeats=3, iters=1),
            **bound(2 * n * S, 0, kind),
            "library_ms": ms_of(fused_alltoall, x, repeats=3, iters=2),
            "shape": list(x.shape), "dtype": "float32"})
        moved["alltoall"] = [alltoall_bytes(n, -(-x.shape[2] // 128) * 128, 4), 2 * n * S]
        del x
        split = small_call_split(ops, Transport(rank_mesh(n)), n)

    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_S.items()}))
    for name, (b_moved, b_bound) in moved.items():
        if b_moved != b_bound:
            raise AssertionError(f"{name}: the kernel moves {b_moved} bytes, "
                                 f"its bound {b_bound}")
    print("ring and alltoall kernel bytes moved at the kernels line's shapes "
          "[moved, bound]: " + json.dumps(moved))
    print("4 KiB per rank x 8, us per call (host: enqueue; device: queued behind "
          "a spinning kernel): " + json.dumps(split))
    print("cuda_ring vs fused in the ring8 sweeps, fp32, us (crossover: the smallest "
          "size from which cuda_ring is at or under fused): " + json.dumps(CROSSOVER))
    print(f"workloads ({smi}): " + json.dumps(
        {k: v for k, v in work.items() if k != "launches"}))
    print(f"mfu_profile ({smi}): " + json.dumps(head["mfu_profile"]))
    print(f"tooling ({smi}): " + json.dumps(
        {k: v for k, v in tools.items() if k not in ("ring", "dtree", "khd")}
        | {k: {f: v[f] for f in ("digits", "steps", "predicted_us", "measured_us")}
           for k, v in tools.items() if k in ("ring", "dtree", "khd")}))
    print(f"host plane ({smi}): " + json.dumps(host))
    print(f"chaos_heal ({smi}): " + json.dumps(chaos))
    print(f"hierarchical ({smi}): " + json.dumps(hier))
    print(f"rank_mesh ({smi}): " + json.dumps(ranks))
    print(f"bench_mesh ({smi}): " + json.dumps(mesh))
    for kern in kernels:
        kern["workload_launches"] = workload_launches[kern["name"]]
        kern["chaos_launches"] = chaos["launches"].get(kern["name"], 0)
        # phase 14's launches across processes (none for the local folds)
        kern["across_launches"] = ranks["across_launches"].get(kern["name"] + "_across", 0)
        # phase 16's: rank 0's launches across processes in the CLIs' sweeps
        kern["cli_across_launches"] = mesh["launches"].get(kern["name"] + "_across", 0)
        # and in the workload CLIs' runs
        kern["workload_across_launches"] = mesh["workload_launches"].get(
            kern["name"] + "_across", 0)
        # and in the tools' fleets (rank 0's): rows 1-5 across processes,
        # the local folds on rank 0's card
        kern["tools_launches"] = (mesh["tools_launches"].get(kern["name"] + "_across", 0)
                                  + mesh["tools_launches"].get(kern["name"], 0))
        if kern["route"] == "cuda" and "combine" not in kern["name"]                 and kern["across_launches"] < 1:
            raise AssertionError(f"{kern['name']}: no launch across processes in phase 14")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
