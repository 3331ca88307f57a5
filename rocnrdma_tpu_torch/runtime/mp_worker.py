"""Worker entry for the multi-process harness (``runtime/multiprocess.py``).

Counterpart of ``rocnrdma_tpu/runtime/mp_worker.py``. Each worker is one
process of the job: it runs its task and reports on stdout.

Device tasks (the torch process group; ``--platform cpu`` is gloo, the
default is NCCL on the card, one process per GPU):

- ``allreduce``: the ``fused`` allreduce of each rank's buffer on a 1-D
  ``Transport(rank_mesh(n, group=WORLD))``, one rank a process (the
  reference's jitted global psum over its mesh of every process's
  devices); every rank checks the sum.
- ``alltoall``: the same mesh's ``fused`` alltoall of each rank's buffer
  (the reference's global transpose); every rank checks that chunk j of
  what it got is what rank j sent it.
- ``fault``: ``--fault-rank`` exits 3 BEFORE the rendezvous (prints
  ``FAULT``); the others must fail their deadline-bounded init with a named
  error, printed as ``CLEAN-ABORT``, exit 4.

A rank's buffer has ``--size`` elements (default 8; alltoall rounds it up
to a multiple of the world size): rank r's is ``r + 1`` everywhere (the
reference's values) or, with ``--seed``, row r of a seeded normal draw
every rank can make. A passing rank prints ``OK rank=i/n``.

Host-plane chaos tasks (``CHAOS_TASKS``; copies of the reference's, and
like them they import no device framework: no torch): ``chaos-allreduce``,
``die-mid-collective``, ``kill-and-heal``, ``trace-delay``,
``evade-straggler``, ``conformance-drift`` and ``kill-the-store``, with the
reference's flags, output lines and exit codes (0 ok, 4 a named clean
abort, 5 silent corruption, 7 the injected death). See the reference
module's docstring for each.

Both planes (``DEVICE_TASKS``): ``kill-a-host`` runs ``kill-and-heal``'s
self-healing host plane next to a torch process group (the device plane,
its first store at ``--device-coordinator``). After the host plane heals,
the device-heal hook aborts the dead generation's communicators, re-elects
the store's host, joins a new group on the agreed members
(``runtime.init.reinit_runtime``) and proves it: ``DEVICE-LOCAL`` is a
``cuda_ring`` allreduce of two rows on this process's device (the ring
kernel on the card), ``DEVICE-GLOBAL`` the new group's own ``all_reduce``
(on NCCL only with one GPU per member, else printed as
``unsupported-one-gpu``). ``--device-heal-fail`` makes the re-init fail
(a silent coordinator): survivors print ``DEVICEHEAL-FAILED`` and
``HOST-PLANE-OK`` and exit 4.

``hierarchical`` (the reference's task): a 2-D ``('slice', 'intra')``
mesh whose slice axis is the process boundary, process i slice i with
``--per-slice`` ranks as rows on its own device (default 2, the
reference's two CPU devices a process). Each process passes only its own
rows, ``full[rank:rank + 1]``, to the ``Transport``. ``full`` is
``(slices, per_slice, slices * per_slice, --size)`` fp32: at the
reference's size (8) it is the reference's ``default_rng(7)`` draw; at any
other size each (slice, intra) row comes from its own seed, so a process
draws its own rows for its input and every row only for its checks. The
reference's checks: the hierarchical allreduce against ``full.sum((0,
1))`` (summed in float64) and the alltoall against the transpose (rtol
1e-5, atol 1e-6), the bf16 ``cross_dtype`` allreduce at rtol 2e-2, atol
1e-1. Then each result
is held to the one-process port's (``Transport(slice_mesh(m, per_slice,
device))`` on all of ``full``): bitwise for the ring and khd intra phases
with the ring cross phase, bf16 ``cross_dtype``, ``avg`` and ``max``, a
``--size``-element buffer a rank (padded where per_slice does not divide
it), the fused, rotation and Bruck-cross alltoalls, khd2d's allreduce,
reduce_scatter and allgather, the fused allgather, broadcast, gather and
scatter (the gathering verbs on one ``--size`` buffer a rank, the rooted
ones at roots off process 0) and a ``group()`` of a khd2d allreduce and
a fused alltoall; within rtol 1e-5, atol 1e-6 for the ``fused`` cross
phase and the ``fused`` allreduce, reduce_scatter and reduce. It prints each
call's ms (``HIERTIMES``), the cross leg's backend, its bytes and GB/s
through the cross group and staged each way (``HIERCROSS``), on the CPU each result's sha256
(``HIERDIGEST``), and ``OK rank=i/m hierarchical``.

``rank-mesh``: the 1-D counterpart, a ``rank_mesh(n, group=WORLD)`` whose
rank axis is the process boundary, process r rank r with its row on its
own device; it passes only that row, ``(1, --size)``, to the
``Transport``. At the reference's size (8) with no ``--seed`` rank r's
row is ``r + 1`` (the ``allreduce`` task's); otherwise each row comes
from its own seed ``(--seed or 7, r)``, so a process draws its own row
for its input and every row only for its checks. The calls
(``RANK_CALLS``) are every 1-D (verb, algo) pair: the allreduce fused,
ring, ring_bidir, tree, khd at the radix ladder's digits and at explicit
ones, dtree, ptree and ktree, ``avg``, ``max`` and a ragged buffer;
reduce_scatter and allgather fused, ring and khd; alltoall fused,
rotation and Bruck; the fused alltoallv; the four rooted verbs fused and
binomial at roots off process 0; sendrecv at shift 3; the
``prog_ring_allreduce`` program; a ``group()`` of a khd allreduce and a
fused alltoall; and the ``cuda_ring`` arm (the kernels across processes,
``RANK_KERNELS``): the allreduce, the tiled in-place allreduce
(``hbm_ring_allreduce_across`` at ``TILED_ROWS``), the reduce_scatter on
the row tiled to whole ``n*128``-element chunks and on the ``even``
buffer, the allgather, alltoall and alltoallv, and a ``group()`` of its
allreduce and alltoall. Where the world is not a power of two ``tree`` is
refused, and where the ``even`` buffer is not whole ``n*128``-element
chunks so is the reduce_scatter kernel on it, by both meshes with one error
(``rank_refused``, ``RANKREFUSED``). The reference's checks (the ring
allreduce against the float64 sum, rtol 1e-5, atol 1e-6; the fused
alltoall against the transpose), then each result held to the
one-process port's row (``Transport(rank_mesh(n, device))`` on every
row): bitwise, the fused reductions within rtol 1e-5, atol 1e-6; each
``cuda_ring`` call also bitwise to its kernels' plain PyTorch versions
on every row (``_rank_plains``). It prints ``RANKTIMES``, ``RANKERRS``,
``RANKCROSS``, on the CPU ``RANKDIGEST``, the ``cuda_ring`` calls' max
abs err against the plain versions (``RANKPLAINERRS``), the kernels'
launches across processes (``RANKLAUNCHES``: on the card each call's
launches, on the CPU none), and ``OK rank=i/n rank-mesh``.

``hang`` forks a grandchild and blocks far past any deadline; the harness
must reap the WHOLE process group.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

CHAOS_TASKS = ("chaos-allreduce", "die-mid-collective", "kill-and-heal",
               "trace-delay", "evade-straggler", "conformance-drift",
               "kill-the-store")
# tasks that drive BOTH planes: the host-plane chaos stack AND a torch
# process group (run_workers reserves a second port for its store)
DEVICE_TASKS = ("kill-a-host",)
# debug/harness tasks (no torch, no chaos stack)
AUX_TASKS = ("hang",)


def _chaos_input(seed: int, rank: int, rnd: int, size: int):
    """The deterministic per-(rank, round) contribution every rank can
    reconstruct for any other — int64 so the ring reduction is exact and
    the correctness assertion is BITWISE, not allclose."""
    import numpy as np
    rng = np.random.default_rng((seed, rank, rnd))
    return rng.integers(-1_000_000, 1_000_000, size=size, dtype=np.int64)


def _chaos_main(args) -> int:
    import os

    import numpy as np

    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultNet, FaultSchedule
    from rocnrdma_tpu_torch.transport.plugin import (
        HostQPNet,
        ring_allreduce_over_net,
    )

    rank, n = args.process_id, args.num_processes
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=n, port=int(port),
                                           host=host)
    # the chaos profile: every class of fault the schedule knows, at rates
    # the hardened stack must absorb (connect/accept refusals retried by
    # bootstrap_ring, delayed completions absorbed by Request.wait) or
    # surface cleanly. Deterministic per (seed, rank).
    sched = FaultSchedule(
        args.seed, rank,
        connect_refusals=2, accept_refusals=1,
        test_delay_p=0.3, test_delay_polls=(1, 6),
        close_drop_p=0.5)
    net = FaultNet(HostQPNet(), sched)
    net.init()
    die_round = args.rounds // 2
    status = 0
    try:
        send, recv, client = bootstrap.bootstrap_ring(
            net, args.coordinator, rank, n, timeout_s=60.0,
            ns=f"chaos{args.seed}")
        for rnd in range(args.rounds):
            if (args.task == "die-mid-collective" and rank == args.fault_rank
                    and rnd == die_round):
                # peers are already inside round die_round's allreduce;
                # _exit skips every destructor — no FIN, no credit return,
                # exactly a SIGKILLed host
                print(f"FAULT: dying mid-collective round={rnd}", flush=True)
                os._exit(7)
            local = _chaos_input(args.seed, rank, rnd, args.size)
            got = ring_allreduce_over_net(net, send, recv, local, rank, n,
                                          timeout_s=15.0)
            want = _chaos_input(args.seed, 0, rnd, args.size)
            for r in range(1, n):
                want = want + _chaos_input(args.seed, r, rnd, args.size)
            if not np.array_equal(got, want):
                print(f"BAD-RESULT: round {rnd} not bitwise-correct",
                      flush=True)
                status = 5
                break
        if status == 0:
            client.barrier(f"chaos{args.seed}/done", n, 30.0)
            # the vtable close verb, so scheduled close drops get their
            # shot (a dropped close defers to net.close() below)
            net.close_comm(send)
            net.close_comm(recv)
            client.close()
            print(f"OK rank={rank}/{n} rounds={args.rounds}", flush=True)
    except (TimeoutError, OSError) as e:
        # THE contract under chaos: named, typed, clean — never a hang
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        _print_ringfull()
        # chaos timeline dump (injections + absorptions + stalls) when
        # ROCNRDMA_FLIGHT_DUMP asks, mergeable by obs.chrome like any
        # other rank fleet's
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(rank)
        try:
            net.close()
        except (OSError, TimeoutError):
            pass
        if server is not None:
            if status == 0:
                server.wait_idle(timeout_s=5.0)
            server.close()
    return status


def _event_log(prefixes: tuple) -> str:
    """Stable digest of this rank's flight events under ``prefixes``,
    timestamps stripped. The selected kinds carry only membership,
    epoch, slot, and cursor data — deterministic per seed (kills land in
    op space, membership is a function of who died, resume cursors are
    data-flow-determined), so two runs of one seed must digest
    identically on every survivor."""
    import hashlib
    import json

    from rocnrdma_tpu_torch.obs import FLIGHT
    events = [(kind, args) for _, kind, args in FLIGHT.events()
              if kind.startswith(prefixes)]
    return hashlib.sha256(
        json.dumps(events, default=str, sort_keys=True).encode()).hexdigest()


def _heal_log() -> str:
    """The heal timeline digest (see :func:`_event_log`)."""
    return _event_log(("heal-",))


def _grow_log() -> str:
    """The grow/promotion timeline digest: grow-* events (start, members,
    done, aborts), promote-* (the standby side of admission), and
    standby-registered — the elastic-grow half of the replay-equality
    contract next to HEALLOG."""
    return _event_log(("grow-", "promote-", "standby-"))


def _store_log() -> str:
    """The survivable-store timeline digest: store-* flight events
    (failover rotations, replica attaches — deterministic args only:
    ranks, tags, counts; never ports or wall times). Unlike
    :func:`_event_log` this digest SORTS events before hashing: a
    rank's failover events originate on CONCURRENT clients (the main
    client and the watchdog's own thread race to discover a dead
    primary), so set-equality is the replay contract, not
    order-equality — FLIGHT event order between threads is
    scheduler-shaped. The ``*-abort`` kinds are EXCLUDED: an abort
    records that some async work (a proxy flush, a replication forward)
    happened to be in flight when the injected death landed — a wall-
    clock artifact, on the timeline for postmortems but outside the
    replay contract."""
    import hashlib
    import json

    from rocnrdma_tpu_torch.obs import FLIGHT
    events = sorted(
        (kind, json.dumps(args, default=str, sort_keys=True))
        for _, kind, args in FLIGHT.events()
        if kind.startswith("store-") and not kind.endswith("-abort"))
    return hashlib.sha256(json.dumps(events).encode()).hexdigest()


def _chaos_rounds(args, pg, start: int, can_grow: bool,
                  skip_first_ping: bool = False) -> int:
    """The shared round loop of the kill-and-heal task: an in-flight
    neighbour ping across every round's allreduce, the int64 bitwise
    oracle of the then-current membership (keyed by ORIGINAL rank, so
    promoted spares and grow joiners contribute under their adopted
    identities), and — with ``--grow-round`` — a ``grow()`` issued by
    every member at that round's committed-op boundary.

    ``--lanes`` moves the round loop onto the multi-tenant lane
    surface: the allreduces run on a HIGH-PRIORITY "latency" channel
    and TWO neighbour pings ride per round — one on a paced "bulk"
    channel, one on the latency channel — so a kill provably strands
    in-flight frames in BOTH lanes (the per-lane fence counts the
    LANEFENCED acceptance line asserts), while the latency lane's
    collective still heals and retries exactly-once."""
    import numpy as np
    lat = bulkch = co = None
    if getattr(args, "lanes", False):
        lat = pg.channel("latency", priority=8)
        bulkch = pg.channel("bulk", priority=0, credit_bytes=1 << 20)
    # --coalesce: each round's reduction is K small ASYNC allreduces
    # flushed as ONE fused bucket (the coalesce x heal surface): a kill
    # round strands the bucket mid-stream, the heal fences its frames,
    # and the retry re-runs the WHOLE bucket as one op — every member's
    # future must still resolve bitwise on the healed membership. The
    # bucket size trigger is set far above K*size — EXPLICITLY, on the
    # lanes variant too — so the flush is always the explicit barrier
    # (wall-clock triggers would break the replay digests; a size
    # trigger firing mid-round at a large --size would change bucket
    # membership and with it the TRACELOG/COALESCED digests).
    K = 3
    if getattr(args, "coalesce", False):
        co = pg.channel("latency" if lat is not None else "default",
                        bucket_bytes=1 << 30)
    # --codec: the round allreduces ride a quantized lane on
    # FLOAT payloads (the int64 bitwise oracle passes through any codec
    # uncompressed, which would prove nothing): correctness becomes an
    # analytic tolerance against the exact fp32 sum (inputs stay below
    # 2^24 so the fp32 oracle itself is exact), and BITWISENESS becomes
    # the cross-run contract — the CODECLOG line digests every
    # committed result plus the error-feedback residual state
    # (post-heal resets included), and two same-seed runs must print it
    # identically
    qch = None
    codec_hash = None
    if getattr(args, "codec", None):
        import hashlib
        qch = pg.channel("quant", codec=args.codec)
        codec_hash = hashlib.sha256()
    # --hier: the round allreduces run the node-aware two-level
    # schedule — the group was built with a node map, and
    # the kill victim is a NODE LEADER, so the healed retry must
    # re-elect (rebuild the hierarchy around the lowest surviving
    # original rank of the shrunk node) and still commit exactly-once
    algo = "hier" if getattr(args, "hier", False) else None
    for rnd in range(start, args.rounds):
        if can_grow and args.grow_round is not None \
                and rnd == args.grow_round:
            # every member (promoted spares included) grows at the same
            # op boundary; the registered joiners are admitted here
            pg.grow(grace_s=3.0, timeout_s=30.0)
        my_orig = pg.global_ranks[pg.rank]
        # a neighbour ping IN FLIGHT across every round's collective:
        # posted before the allreduce, drained after it. The p2p
        # plane is pumped only by p2p verbs, so at a kill-round abort
        # the predecessor's ping provably sits undelivered — the
        # frames the heal's epoch bump must fence (what the
        # `FENCED > 0` acceptance asserts) and the resume protocol
        # must then re-deliver between CONTINUOUS survivors (RESUMED)
        pings = []
        pred_gid = None
        if pg.world_size > 1 and not (skip_first_ping and rnd == start):
            # a promoted spare resumes INTO an interrupted round: its
            # peers are already blocked in the retried collective and
            # cannot serve p2p wiring until it completes, so the spare
            # must not dial a fresh ping stream ahead of the retry (its
            # peers' kill-round pings toward the dead incarnation fail
            # named either way)
            succ = (pg.rank + 1) % pg.world_size
            pred = (pg.rank - 1) % pg.world_size
            pred_gid = pg.global_ranks[pred]

            def post_ping(surface, tag):
                # the ping's timeout also budgets its heal-time stream
                # RESUME: the lanes variant resumes TWO streams per
                # survivor pair, so (like the collective above) it gets
                # double the headroom — a load-stalled resume that falls
                # back to a stream restart would flip the RESUMED
                # totals the FLEET digest replays
                t = 10.0 if lat is not None else 5.0
                return surface.batch_isend_irecv([
                    ("recv", np.empty(64, np.int64), pred, tag),
                    ("send", _chaos_input(args.seed, my_orig, rnd, 64),
                     succ, tag),
                ], timeout_s=t)

            if lat is None:
                pings.append(post_ping(pg, rnd % 60))
            else:
                # two tenants' streams in flight across the collective:
                # the kill round strands frames in BOTH lanes
                pings.append(post_ping(bulkch, rnd % 30))
                pings.append(post_ping(lat, 30 + rnd % 30))
        # the collective's timeout also budgets a heal it triggers
        # (heal deadline = timeout + grace): the lanes variant does
        # strictly more work inside the heal window (TWO p2p streams
        # resume per survivor pair), so it gets double the headroom —
        # fault decisions are op-keyed, never time-keyed, so the wider
        # deadline cannot perturb the replay digests
        t_op = 10.0 if (lat is not None or co is not None
                        or algo is not None) else 5.0
        if co is not None:
            # K member inputs per round, each reconstructable per
            # (original rank, member index) — the bucket is ONE op,
            # the oracle is per MEMBER
            locs = [_chaos_input(args.seed, my_orig, rnd * K + j,
                                 args.size) for j in range(K)]
            futs = [co.allreduce_async(x, timeout_s=t_op) for x in locs]
            co.flush(timeout_s=t_op)
            gots = [f.wait(timeout_s=t_op) for f in futs]
        elif qch is not None:
            local = _chaos_input(args.seed, my_orig, rnd,
                                 args.size).astype(np.float32)
            got = qch.all_reduce(local, timeout_s=t_op, algorithm=algo)
        else:
            local = _chaos_input(args.seed, my_orig, rnd, args.size)
            got = (lat.all_reduce(local, timeout_s=t_op, algorithm=algo)
                   if lat is not None
                   else pg.all_reduce(local, timeout_s=t_op,
                                      algorithm=algo))
        # the oracle of the CURRENT membership: contributions are
        # keyed by ORIGINAL rank (pg.global_ranks survives re-
        # ranking), so a post-heal round sums exactly the members —
        # a promotion keeps the full width, a shrink drops the dead
        members = pg.global_ranks

        def want_for(idx: int):
            w = _chaos_input(args.seed, members[0], idx, args.size)
            for m in members[1:]:
                w = w + _chaos_input(args.seed, m, idx, args.size)
            return w

        if co is not None:
            bad = [j for j in range(K)
                   if not np.array_equal(gots[j], want_for(rnd * K + j))]
            if bad:
                print(f"BAD-RESULT: round {rnd} bucket members {bad} "
                      f"not bitwise-correct on epoch {pg.last_op_epoch} "
                      f"members {members}", flush=True)
                return 5
        elif qch is not None:
            wantf = want_for(rnd).astype(np.float32)
            tol = 0.08 * max(1.0, float(np.abs(wantf).max()))
            if float(np.abs(got - wantf).max()) > tol:
                print(f"BAD-RESULT: round {rnd} quantized result "
                      f"outside the codec tolerance on epoch "
                      f"{pg.last_op_epoch} members {members}", flush=True)
                return 5
            codec_hash.update(got.tobytes())
        elif not np.array_equal(got, want_for(rnd)):
            print(f"BAD-RESULT: round {rnd} not bitwise-correct on "
                  f"epoch {pg.last_op_epoch} members {members}",
                  flush=True)
            return 5
        for ping in pings:
            try:
                heard = ping[0].wait()
                ping[1].wait()
            except (TimeoutError, OSError, RuntimeError):
                # the collective healed mid-round and this ping's peer
                # PROCESS did not continue (dead, or its slot was
                # re-incarnated by a promotion): the stream's data died
                # with it — named, and the stream restarts next round.
                # Streams between continuous survivors RESUME instead
                # (the else branch still asserts their payloads).
                pass
            else:
                if not np.array_equal(
                        heard, _chaos_input(args.seed, pred_gid,
                                            rnd, 64)):
                    print(f"BAD-RESULT: round {rnd} ping from "
                          f"original rank {pred_gid} corrupted",
                          flush=True)
                    return 5
    if codec_hash is not None:
        # result digest + EF residual digest: both pure functions of
        # the seed's failure story (the residual's post-heal reset is
        # epoch-keyed, never wall-clock-keyed)
        print(f"CODECLOG {codec_hash.hexdigest()} "
              f"{pg.wire_stats()['codec_residual_digest']}", flush=True)
    return 0


def _device_log() -> str:
    """The device-plane heal timeline digest: deviceheal-* events carry
    only epoch/membership/leader/world-count data (never ports or wall
    times — those live in non-digested ``device-*`` events), so two runs
    of one seed digest identically on every survivor."""
    return _event_log(("deviceheal-",))


def _health_transitions(pg) -> list:
    """This rank's fleet-health transition triples ``[prev, state,
    epoch]``, oldest first. Transitions are recorded at protocol points
    (confirmed death, heal/grow entry and commit, admission) —
    membership/epoch data only, so the sequence is a pure function of
    the seed's failure story. Read from the GROUP's durable transition
    log (destroy leaves it intact), not the flight ring: the ring is
    always-on wire tracing and a long-enough soak wraps it, evicting
    the earliest transitions timing-dependently — which would break
    the replay-equality contract the FLEET digest pins. The flight
    events remain the Perfetto-track copy; a pg that never constructed
    falls back to them (near-empty either way)."""
    if pg is not None:
        return pg.health_transitions()
    from rocnrdma_tpu_torch.obs import FLIGHT
    return [[a["prev"], a["state"], a["epoch"]]
            for _, kind, a in FLIGHT.events() if kind == "fleet-health"]


def _fleet_log(transitions: list) -> str:
    """The FLEET telemetry digest: the health-transition sequence plus
    the DETERMINISTIC wire-counter totals (fence/resume counts and
    membership events — ``obs.fleet.DETERMINISTIC_COUNTERS``). Wall-
    clock-shaped counters (frames streamed/overlapped before an abort's
    timeout fired) and every wall-time field are excluded, so two runs
    of one seed must digest identically on every survivor."""
    import hashlib
    import json

    from rocnrdma_tpu_torch.metrics import WIRE
    from rocnrdma_tpu_torch.obs.fleet import DETERMINISTIC_COUNTERS
    snap = WIRE.snapshot()
    totals = {k: snap[k] for k in DETERMINISTIC_COUNTERS}
    return hashlib.sha256(json.dumps(
        [transitions, totals],
        sort_keys=True).encode()).hexdigest()


def _tuner_log() -> str:
    """The self-tuning wire's flight-event sequence, STRUCTURAL fields
    only (kind, plane, epoch, version, dropped-pending): the model's
    version stream moves only at protocol points (epoch fences, broadcast
    commits), so with auto-tuning ON the sequence is a pure function of
    the seed's failure story and two same-seed chaos runs must print it
    identically — the replay line next to HEALLOG."""
    import json

    from rocnrdma_tpu_torch.obs import FLIGHT
    evs = [[kind, a.get("plane"), a.get("epoch"), a.get("version"),
            a.get("dropped_pending"), a.get("bucket")]
           for _, kind, a in FLIGHT.events()
           if kind.startswith("tuner-")]
    return json.dumps(evs, sort_keys=True)


def _print_fleet(pg) -> None:
    """The fleet-plane telemetry lines every chaos rank prints for the
    soak harness: the health-transition sequence (human-checkable) and
    the replay digest — both pure functions of the seed."""
    import json
    trans = _health_transitions(pg)
    print(f"HEALTH {json.dumps(trans)}", flush=True)
    print(f"FLEET {_fleet_log(trans)}", flush=True)


def _print_ringfull() -> None:
    """The flight-ring capacity guard's chaos-harness half: when the
    ring wrapped during a digest-bearing run, say so LOUDLY — evicted
    events would otherwise read as a timing-dependent replay
    divergence (or a silently shortened HEALLOG) with no cause on
    screen."""
    from rocnrdma_tpu_torch.obs import FLIGHT
    if FLIGHT.saturated:
        print(f"RINGFULL flight ring wrapped ({FLIGHT.recorded()} events"
              f" > capacity {FLIGHT.capacity}): digest-relevant events "
              f"may have been evicted — raise ROCNRDMA_FLIGHT_EVENTS",
              flush=True)


def _trace_chaos_main(args) -> int:
    """The causal-tracing acceptance task (module docstring:
    ``trace-delay``)."""
    import json

    import numpy as np

    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.obs import trace as obs_trace
    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultSchedule

    rank, n = args.process_id, args.num_processes
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=n, port=int(port),
                                           host=host)
    # ONLY the victim's receive completions are held — long enough to
    # dominate BOTH the cross-rank clock-alignment skew and the other
    # noise source this verdict races: a GIL-starved healthy rank on a
    # loaded 1-CPU box stalls 60-80 ms without polling at all, and the
    # old 600-900-poll hold (~15-30 ms of µs-scale wait-loop polls)
    # lost the critical path to it. ~0.5 s per held completion keeps
    # the victim's wall the longest by design margin — and since the
    # hold is counted in the victim's OWN polls, load inflates it in
    # proportion to the stalls it must outweigh, so the margin grows
    # with contention instead of shrinking. Decisions key off the
    # rank's own op sequence: replay-equal per seed by construction.
    sched = FaultSchedule(
        args.seed, rank,
        test_delay_p=(1.0 if rank == args.fault_rank else 0.0),
        test_delay_polls=(4000, 6000))
    status = 0
    pg = None
    try:
        pg = dist.init_process_group(
            rank=rank, world_size=n, store_handle=args.coordinator,
            timeout_s=60.0, group_name=f"trace{args.seed}", plane="shm",
            fault_schedule=sched)
        for rnd in range(args.rounds):
            local = _chaos_input(args.seed, rank, rnd, args.size)
            got = pg.all_reduce(local, timeout_s=60.0)
            want = _chaos_input(args.seed, 0, rnd, args.size)
            for r in range(1, n):
                want = want + _chaos_input(args.seed, r, rnd, args.size)
            if not np.array_equal(got, want):
                print(f"BAD-RESULT: round {rnd} not bitwise-correct",
                      flush=True)
                status = 5
                break
        if status == 0:
            # flush this rank's records onto the fleet channel (so a
            # leader-side trace_stats/CLI could assemble them too),
            # then print them for the harness
            pg.publish_telemetry()
            pg.barrier()
            print(f"OK rank={rank}/{n} rounds={args.rounds}", flush=True)
    except (TimeoutError, OSError, RuntimeError) as e:
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        recs = obs_trace.TRACE.snapshot()
        print(f"TRACE {json.dumps(recs)}", flush=True)
        print(f"TRACELOG {obs_trace.digest(recs)}", flush=True)
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        _print_ringfull()
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(rank)
        if pg is not None:
            try:
                pg.destroy(graceful=status == 0)
            except (OSError, TimeoutError):
                pass
        if server is not None:
            if status == 0:
                server.wait_idle(timeout_s=5.0)
            server.close()
    return status


def _print_fleetsnap(pg) -> None:
    """From the surviving LEADER of a clean run: the merged fleet
    snapshot as one artifact (per-rank health, merged histograms,
    fence/resume totals, epoch). Every rank publishes a final snapshot
    and arrives at a barrier first, so the leader's aggregate reads
    every member's post-heal telemetry. Telemetry is an OBSERVER: a
    store flake here must cost the FLEETSNAP line (the harness's
    assertion then names exactly what is missing), never convert a
    bitwise-clean chaos run into a CLEAN-ABORT."""
    import json
    try:
        pg.publish_telemetry()
        pg.barrier()
        if pg.global_ranks[pg.rank] == min(pg.global_ranks):
            print(f"FLEETSNAP {json.dumps(pg.fleet_stats())}", flush=True)
    except (OSError, TimeoutError, RuntimeError) as e:
        print(f"FLEETSNAP-FAILED {type(e).__name__}: {e}", flush=True)


def _print_fleettree(pg) -> None:
    """From the surviving LEADER of a clean run: the telemetry tree's
    root-digest coverage — proof the (possibly re-elected)
    node agents published the healed generation's tree. The leader is
    always the root node's agent (lowest surviving original), so one
    extra explicit publish ticks its aggregation pass with every
    child's digest already in the store (the FLEETSNAP barrier put
    them there). ``root_covers`` null means no digest was published —
    a node-mapped group asserting on this line catches a silently-dead
    tree; best-effort like FLEETSNAP, never converts a clean run into
    an abort."""
    import json
    try:
        if pg.global_ranks[pg.rank] != min(pg.global_ranks):
            return
        pg.publish_telemetry()
        root = pg._tree_root_digest(time.monotonic() + 5.0)
        print("FLEETTREE " + json.dumps(
            {"epoch": pg.epoch, "members": pg.global_ranks,
             "root_covers": None if root is None
             else root.get("covers")}), flush=True)
    except (OSError, TimeoutError, RuntimeError) as e:
        print(f"FLEETTREE-FAILED {type(e).__name__}: {e}", flush=True)


def _verify_device_plane(args, members: list, my_orig: int,
                         epoch: int) -> None:
    """Prove the device plane is ALIVE end-to-end on the agreed
    membership: (1) every member answers through the (re)made store;
    (2) the re-probed topology matches the agreed world; (3) a rebuilt
    mesh consumer (a ``Transport`` over two rows on this process's
    device) completes a ``cuda_ring`` allreduce, the hand-written ring
    kernel on the card and its plain version on the CPU, bitwise against
    the integer oracle; (4) the new process group's own ``all_reduce``
    runs too where its backend can run it: gloo always, NCCL only with
    one GPU per member (NCCL refuses two ranks on one GPU), else the gap
    is printed, named, and nothing else stands in for it. Raises on any
    mismatch; the caller (the device-heal hook) converts that into the
    named device-heal failure."""
    import json

    import numpy as np
    import torch

    from rocnrdma_tpu_torch import ops
    from rocnrdma_tpu_torch.runtime.init import device_fence
    from rocnrdma_tpu_torch.runtime.mesh import rank_mesh, reprobe_topology
    from rocnrdma_tpu_torch.transport import Transport

    device_fence(members, my_orig, epoch, timeout_s=20.0)
    topo = reprobe_topology(expected_processes=len(members),
                            platform=args.platform)
    # the local device collective: two rows of this process on its
    # device. The rows are fp32 integers with |v| < 2^20, so every sum is
    # exact and the check stays bitwise against the int64 oracle
    mesh = rank_mesh(2, topo.device)
    k = mesh.n_ranks
    rows = np.stack([_chaos_input(args.seed, 7_000 + my_orig * 131 + d,
                                  epoch, 64) for d in range(k)])
    before = ops.launch_counts()
    got = Transport(mesh).allreduce(
        torch.from_numpy(rows.astype(np.float32)).to(topo.device),
        algo="cuda_ring")
    after = ops.launch_counts()
    want = np.broadcast_to(rows.sum(axis=0), rows.shape)
    if not np.array_equal(got.cpu().numpy().astype(np.int64), want):
        raise RuntimeError(
            f"device plane: local cuda_ring allreduce not bitwise-"
            f"correct on epoch {epoch} (members {members})")
    launched = {name: after[name] - before[name] for name in after
                if after[name] != before[name]}
    print(f"DEVICE-LOCAL ok epoch={epoch}", flush=True)
    print(f"DEVICE-LAUNCHES epoch={epoch} on={topo.device} "
          f"{json.dumps(launched, sort_keys=True)}", flush=True)
    # the cross-process collective: each process contributes the sum of
    # its rows of a deterministic global matrix
    dist = torch.distributed
    gpus = torch.cuda.device_count() if topo.device.type == "cuda" else 0
    if dist.get_backend() == "nccl" and gpus < len(members):
        print(f"DEVICE-GLOBAL unsupported-one-gpu epoch={epoch} "
              f"gpus={gpus} members={len(members)}", flush=True)
        return
    pi = dist.get_rank()
    full = np.stack([_chaos_input(args.seed, 9_000 + i, epoch, 64)
                     for i in range(k * len(members))])
    mine = torch.from_numpy(
        full[pi * k:(pi + 1) * k].sum(axis=0).astype(np.float32)
    ).to(topo.device)
    dist.all_reduce(mine)
    if not np.array_equal(mine.cpu().numpy().astype(np.int64),
                          full.sum(axis=0)):
        raise RuntimeError(
            f"device plane: global all_reduce not bitwise-correct on "
            f"epoch {epoch}")
    print(f"DEVICE-GLOBAL ok epoch={epoch}", flush=True)


def _device_chaos_main(args) -> int:
    """The ``kill-a-host`` task: the end-to-end "the job survives a host
    death" run. Every member drives BOTH planes — the self-healing
    host-plane ProcessGroup of ``kill-and-heal`` AND a torch process group
    (the device plane: gloo under ``--platform cpu``, NCCL on the card).
    The victim host is hard-killed mid-collective; survivors must heal the
    host plane, then the registered device-heal hook aborts the dead
    generation's communicators, re-elects the store's host (lowest
    surviving original rank, through the group's store), joins a new
    process group on the agreed membership, re-probes the topology,
    rebuilds the mesh consumers, and proves the device plane with the
    bitwise oracle — all bounded, never a hang.

    The first generation's store rides host rank 0 next to the bootstrap
    store; a heal always builds a fresh one on the elected host.
    ``--device-heal-fail`` makes the re-init deterministically fail (the
    elected address is a bound-but-silent port): every survivor must
    surface the named device-heal failure within one deadline window and
    then prove the HOST plane still serves collectives (degraded mode)."""
    import numpy as np

    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.metrics import WIRE
    from rocnrdma_tpu_torch.runtime.init import (init_runtime,
                                                 reinit_runtime,
                                                 shutdown_runtime)
    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultSchedule

    rank, total = args.process_id, args.num_processes
    n = total - args.spares
    role = "member" if rank < n else "spare"
    kill = dict(zip(
        (int(r) for r in (args.kill_ranks or "").split(",") if r),
        (int(o) for o in (args.kill_ops or "").split(",") if o)))
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=total, port=int(port),
                                           host=host)
    sched = FaultSchedule(
        args.seed, rank,
        connect_refusals=1, connect_flake_p=0.2,
        test_delay_p=0.3, test_delay_polls=(1, 4),
        kill_after_ops=kill.get(rank))
    status = 0
    pg = None
    reinit_ms: list = []
    fail_sock = [None]
    group = f"dh{args.seed}"
    try:
        if role == "member":
            # spares defer their first device init to the promotion hook
            init_runtime(coordinator=args.device_coordinator,
                         num_processes=n, process_id=rank,
                         timeout_s=30, platform=args.platform)
            _verify_device_plane(args, list(range(n)), rank, 0)
            pg = dist.init_process_group(
                rank=rank, world_size=n, store_handle=args.coordinator,
                timeout_s=20.0, group_name=group, plane="shm",
                fault_schedule=sched, self_heal=True)
        else:
            pg = dist.init_process_group(
                world_size=n, store_handle=args.coordinator,
                timeout_s=20.0, group_name=group, plane="shm",
                fault_schedule=sched, self_heal=True, spare=True)

        def device_heal(members, epoch):
            my_orig = pg.global_ranks[pg.rank]
            if args.device_heal_fail:
                # deterministic failure injection: the leader squats a
                # port with a listener that never answers and proposes it
                # through the SAME first-writer-wins key the election
                # would use; every rank's re-init then times out named
                # inside its deadline
                import socket as _socket
                key = f"deviceheal/e{epoch}/coord"
                if my_orig == min(members):
                    s = _socket.socket()
                    s.setsockopt(_socket.SOL_SOCKET,
                                 _socket.SO_REUSEADDR, 1)
                    s.bind(("127.0.0.1", 0))
                    s.listen(1)
                    fail_sock[0] = s
                    coord = pg.agree(
                        key, f"127.0.0.1:{s.getsockname()[1]}")
                else:
                    coord = pg.agree(key, None, 20.0)
                reinit_runtime(members, epoch, my_orig,
                               coordinator=coord, timeout_s=6.0,
                               platform=args.platform)
            else:
                info = reinit_runtime(members, epoch, my_orig,
                                      agree=pg.agree, timeout_s=30.0,
                                      platform=args.platform)
                reinit_ms.append(round(info.reinit_s * 1000.0, 3))
                _verify_device_plane(args, members, my_orig, epoch)

        pg.set_device_heal(device_heal)
        if role == "member":
            pg.start_watchdog(interval_s=0.3, timeout_s=2.0)
            start = 0
        else:
            pg.wait_promotion(timeout_s=120.0)
            start = pg.committed_ops
        status = _chaos_rounds(args, pg, start, can_grow=False,
                               skip_first_ping=(role == "spare"))
        if status == 0:
            print(f"OK rank={rank}/{total} rounds={args.rounds} "
                  f"now-rank={pg.rank}/{pg.world_size}", flush=True)
            print(f"EPOCH {pg.epoch}", flush=True)
            print(f"MEMBERS {pg.global_ranks}", flush=True)
            _print_fleetsnap(pg)
            _print_fleettree(pg)
            pg.stop_watchdog()
            # pg is deliberately KEPT after the graceful destroy: destroy
            # is idempotent (the finally's ungraceful call no-ops) and the
            # finally's HEALTH/FLEET lines read the group's durable
            # health-transition log
            pg.destroy(graceful=True)
    except RuntimeError as e:
        if "device-plane heal failed" in str(e):
            # degraded mode: the device plane is down, NAMED, inside its
            # deadline — and the host plane must still serve. One more
            # host collective with the bitwise oracle proves it.
            print(f"DEVICEHEAL-FAILED {type(e).__name__}: {e}",
                  flush=True)
            pg.set_device_heal(None)
            my_orig = pg.global_ranks[pg.rank]
            local = _chaos_input(args.seed, my_orig, 999, args.size)
            got = pg.all_reduce(local, timeout_s=10.0)
            want = _chaos_input(args.seed, pg.global_ranks[0], 999,
                                args.size)
            for m in pg.global_ranks[1:]:
                want = want + _chaos_input(args.seed, m, 999, args.size)
            if np.array_equal(got, want):
                print("HOST-PLANE-OK", flush=True)
            else:
                print("HOST-PLANE-BAD", flush=True)
            print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
            status = 4
        else:
            print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
            status = 4
    except (TimeoutError, OSError) as e:
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        snap = WIRE.snapshot()
        print(f"FENCED {snap['frames_fenced']}", flush=True)
        print(f"RESUMED {snap['frames_resumed']}", flush=True)
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        print(f"HEALLOG {_heal_log()}", flush=True)
        print(f"DEVICEHEAL {_device_log()}", flush=True)
        print(f"DEVICEHEAL_MS {reinit_ms}", flush=True)
        _print_device_spans()
        _print_fleet(pg)
        _print_ringfull()
        if fail_sock[0] is not None:
            fail_sock[0].close()
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(rank)
        if pg is not None:
            try:
                pg.destroy(graceful=False)
            except (OSError, TimeoutError):
                pass
        # the device plane's group goes too, bounded (a peer may be dead)
        shutdown_runtime(timeout_s=5.0, abort=status != 0)
        if server is not None:
            if status == 0:
                server.wait_idle(timeout_s=5.0)
            server.close()
    return status


def _print_device_spans() -> None:
    """Each device-plane restart phase's wall time in ms (the
    ``member-device-*`` flight spans, oldest first): wall time, so
    outside every replay digest."""
    import json

    from rocnrdma_tpu_torch.obs import FLIGHT
    spans = [[kind[len("member-device-"):], a["epoch"],
              round(a["dur"] * 1000.0, 3)]
             for _, kind, a in FLIGHT.events()
             if kind.startswith("member-device-")]
    print(f"DEVICESPANS {json.dumps(spans)}", flush=True)




def _heal_chaos_main(args) -> int:
    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.metrics import WIRE
    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultSchedule

    rank, total = args.process_id, args.num_processes
    # fleet layout: members first, then warm spares, then grow joiners
    n = total - args.spares - args.join
    role = ("member" if rank < n
            else "spare" if rank < n + args.spares else "joiner")
    kill = dict(zip(
        (int(r) for r in (args.kill_ranks or "").split(",") if r),
        (int(o) for o in (args.kill_ops or "").split(",") if o)))
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=total, port=int(port),
                                           host=host)
    # the heal chaos profile: refused + flaky connects (the heal-time
    # re-dials must retry them under the shared backoff), delayed
    # completions (stale frames pile up unreported at the abort, so the
    # epoch fence provably fires), the op-keyed hard kill on the
    # victims, plus the admission-plane faults (refused registrations
    # retried under backoff; a spare death landed AT its promotion).
    # Every class replays deterministically: decisions key off the
    # rank's own op/attempt sequence, and the abort points are data-
    # flow-determined (the victim's last op bounds what could ever be
    # delivered), not wall-clock-determined.
    sched = FaultSchedule(
        args.seed, rank,
        connect_refusals=1, connect_flake_p=0.2,
        test_delay_p=0.3, test_delay_polls=(1, 4),
        kill_after_ops=kill.get(rank),
        join_refusals=1 if role != "member" else 0,
        die_at_promotion=(rank == args.die_at_promotion))
    status = 0
    pg = None
    group = f"heal{args.seed}"
    try:
        if role == "member":
            # --hier: first half of the ranks are node 0, second half
            # node 1 (n=4 -> [0, 0, 1, 1]); the intra plane is shm like
            # the group plane — the chaos surface under test is the
            # hierarchy's REPAIR (kill a node leader), not the mixed-
            # plane speedup the bench scenario measures
            node_map = ([r * 2 // n for r in range(n)]
                        if getattr(args, "hier", False) else None)
            pg = dist.init_process_group(
                rank=rank, world_size=n, store_handle=args.coordinator,
                timeout_s=20.0, group_name=group, plane="shm",
                fault_schedule=sched, self_heal=True, node_of=node_map)
            pg.start_watchdog(interval_s=0.3, timeout_s=2.0)
            start = 0
        elif role == "spare":
            pg = dist.init_process_group(
                world_size=n, store_handle=args.coordinator,
                timeout_s=20.0, group_name=group, plane="shm",
                fault_schedule=sched, self_heal=True, spare=True)
            pg.wait_promotion(timeout_s=120.0)
            # resume the round loop AT the interrupted collective: the
            # adopted committed-op count IS the round index (one
            # allreduce per round), so this process participates in the
            # survivors' transparent retry under the dead rank's identity
            start = pg.committed_ops
        else:  # joiner
            pg = dist.join_process_group(
                store_handle=args.coordinator, group_name=group,
                plane="shm", timeout_s=150.0, fault_schedule=sched,
                self_heal=True)
            start = pg.committed_ops
        status = _chaos_rounds(args, pg, start,
                               can_grow=role in ("member", "spare"),
                               skip_first_ping=(role == "spare"))
        if status == 0:
            print(f"OK rank={rank}/{total} rounds={args.rounds} "
                  f"now-rank={pg.rank}/{pg.world_size}", flush=True)
            print(f"EPOCH {pg.epoch}", flush=True)
            print(f"MEMBERS {pg.global_ranks}", flush=True)
            _print_fleetsnap(pg)
            _print_fleettree(pg)
            pg.stop_watchdog()
            # pg deliberately KEPT (destroy is idempotent): the finally
            # reads its durable health-transition log for HEALTH/FLEET
            pg.destroy(graceful=True)
    except (TimeoutError, OSError, RuntimeError) as e:
        # allowed only for a rank that missed a heal window (it must
        # exit); the soak asserts no survivor actually takes this path
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        import json as _json
        snap = WIRE.snapshot()
        print(f"FENCED {snap['frames_fenced']}", flush=True)
        print(f"RESUMED {snap['frames_resumed']}", flush=True)
        # the per-LANE fence split (lane name -> frames fenced): the
        # lane x epoch acceptance line — a kill under --lanes must
        # strand (and fence) frames in BOTH tenants' lanes, and the
        # split is data-flow-determined, so it replays per seed
        print(f"LANEFENCED "
              f"{_json.dumps(snap['channel_frames_fenced'], sort_keys=True)}",
              flush=True)
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        print(f"HEALLOG {_heal_log()}", flush=True)
        print(f"GROWLOG {_grow_log()}", flush=True)
        # the coalesce x heal acceptance lines: member ops and buckets
        # committed (counted at commit only, so a retried bucket counts
        # once — deterministic per seed), plus the sampled-op structural
        # digest (bucket spans carry member counts, so a replay that
        # split or merged a bucket differently cannot digest equal)
        print(f"COALESCED {snap['ops_coalesced']} "
              f"{snap['buckets_flushed']}", flush=True)
        from rocnrdma_tpu_torch.obs import trace as _obs_trace
        print(f"TRACELOG {_obs_trace.digest(_obs_trace.TRACE.snapshot())}",
              flush=True)
        print(f"TUNERLOG {_tuner_log()}", flush=True)
        _print_fleet(pg)
        _print_ringfull()
        if os.environ.get("ROCNRDMA_CHAOS_DUMP"):
            # replay-divergence triage: the RAW injection log behind
            # FAULTLOG, one line so the harness can diff two runs
            import json as _json
            print(f"FAULTDUMP {_json.dumps(sched.log, default=str)}",
                  flush=True)
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(rank)
        if pg is not None:
            try:
                pg.destroy(graceful=False)
            except (OSError, TimeoutError):
                pass
        if server is not None:
            if status == 0:
                server.wait_idle(timeout_s=5.0)
            server.close()
    return status


def _store_chaos_main(args) -> int:
    """The survivable-store acceptance task (module docstring:
    ``kill-the-store``)."""
    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultSchedule

    rank, n = args.process_id, args.num_processes
    mode = args.store_death
    kill = dict(zip(
        (int(r) for r in (args.kill_ranks or "").split(",") if r),
        (int(o) for o in (args.kill_ops or "").split(",") if o)))
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=n, port=int(port),
                                           host=host)
    # the store chaos profile: the op-keyed hard kill (host mode) or an
    # armed in-process store/proxy close (server/proxy modes — fired at
    # the host rank's Nth DATA op, outside the schedule lock), plus
    # seeded client-side drops of the store connection itself on the odd
    # ranks — the reconnect-replay path must absorb those long before
    # any death fires, at coordinates keyed to each client's own store-
    # RPC stream, so the whole failure story replays per (seed, rank)
    sched = FaultSchedule(
        args.seed, rank,
        kill_after_ops=kill.get(rank) if mode == "host" else None,
        store_conn_drop_ops=(5,) if rank % 2 == 1 else (),
        store_close_after_ops=(args.kill_store_op
                               if mode == "server" and rank == 0
                               else None),
        proxy_close_after_ops=(args.kill_store_op
                               if mode == "proxy" and rank == n // 2
                               else None))
    status = 0
    pg = None
    group = f"store{args.seed}"
    node = rank * 2 // n  # two "nodes", the --hier convention
    try:
        pg = dist.init_process_group(
            rank=rank, world_size=n, store_handle=args.coordinator,
            timeout_s=20.0, group_name=group, plane="shm",
            fault_schedule=sched, self_heal=True)
        # survivable-store bring-up: the deterministic successor (rank 1)
        # hosts the replica sidecar; every rank arms the rotation; the
        # primary attaches AFTER the arm barrier — every key the
        # snapshot must carry is in the store by then, and attach
        # installs the live-replication pointer in the same critical
        # section as the snapshot, so nothing acked can slip between
        if rank == 1:
            pg.host_store_replica()
        pg._client.barrier(f"pg/{group}/store/arm", n, timeout_s=20.0)
        pg.arm_store_failover()
        if server is not None:
            # the harness holds the primary directly (the pg was built
            # on its handle, like every chaos task) — attach is the
            # same call ProcessGroup.attach_store_replica makes for a
            # group-owned server
            server.attach_replica(pg._client.get(
                f"pg/{group}/store/replica", timeout_s=10.0))
        pg._client.barrier(f"pg/{group}/store/attached", n,
                           timeout_s=20.0)
        pg.start_watchdog(interval_s=0.3, timeout_s=2.0)
        if mode == "server" and server is not None:
            # the primary dies IN-PROCESS at rank 0's Nth data op: the
            # hosting RANK survives, every client rotates to the
            # replica, membership never changes
            sched.arm_store_death(server.close)
        elif mode == "proxy":
            # per-node proxies: each node's agent (lowest rank) hosts
            # one, everyone adopts it and re-arms the watchdog so the
            # heartbeat client dials the proxy from birth; node 1's
            # proxy then dies at its agent's Nth data op — ONLY node
            # 1's ranks may re-point (to the primary)
            if rank in (0, n // 2):
                pg.host_node_proxy(node)
            pg._client.barrier(f"pg/{group}/store/proxy-up", n,
                               timeout_s=20.0)
            pg.adopt_node_proxy(node)
            pg.stop_watchdog()
            pg.start_watchdog(interval_s=0.3, timeout_s=2.0)
            if rank == n // 2:
                sched.arm_proxy_death(pg._node_proxy.close)
        status = _chaos_rounds(args, pg, 0, can_grow=False)
        if status == 0:
            # the convergent successor election: every survivor
            # setnx-es the SAME deterministic value (rank 1 — the
            # successor rule), so the winner is identical whoever got
            # there first, and the record rides a replicated namespace
            winner = pg.elect_store_primary(1)
            print(f"OK rank={rank}/{n} rounds={args.rounds} "
                  f"now-rank={pg.rank}/{pg.world_size}", flush=True)
            print(f"EPOCH {pg.epoch}", flush=True)
            print(f"MEMBERS {pg.global_ranks}", flush=True)
            print(f"STOREWINNER {winner}", flush=True)
            pg.stop_watchdog()
            pg.destroy(graceful=True)
    except (TimeoutError, OSError, RuntimeError) as e:
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        import contextlib
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        print(f"HEALLOG {_heal_log()}", flush=True)
        print(f"STORELOG {_store_log()}", flush=True)
        # counted AFTER teardown: the chaos rounds can outrun a 0.3 s
        # heartbeat interval, so a rank whose only client on the dead
        # proxy is the watchdog's may first touch the corpse at the
        # close-time bye — the re-point is deterministic either way,
        # and THIS count is the proxy-death acceptance (node 1's ranks
        # re-point exactly once, node 0's never move)
        from rocnrdma_tpu_torch.obs import FLIGHT
        npoint = sum(1 for _, kind, _a in FLIGHT.events()
                     if kind == "store-failover")
        print(f"STOREPOINT {npoint}", flush=True)
        _print_ringfull()
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(rank)
        if pg is not None:
            try:
                pg.destroy(graceful=False)
            except (OSError, TimeoutError):
                pass
        if server is not None:
            # server mode closed it mid-run; a second close is benign
            # only when guarded — and in host mode this line is never
            # reached (the hosting rank died at its kill op)
            with contextlib.suppress(Exception):
                if status == 0:
                    server.wait_idle(timeout_s=5.0)
                server.close()
    return status


def _evade_chaos_main(args) -> int:
    """The predictive-evasion acceptance task (module docstring:
    ``evade-straggler``)."""
    import json

    import numpy as np

    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultSchedule

    rank, total = args.process_id, args.num_processes
    n = total - args.spares  # members first, warm spares trail
    role = "member" if rank < n else "spare"
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=total, port=int(port),
                                           host=host)
    # chronic slowness, not death: every rank makes the same arming
    # call and FaultSchedule arms it only on the victim. The hold is
    # ~100 ms of completion-poll backoff per receive — far above the
    # scheduler noise of a loaded box, far below any watchdog verdict
    # (the victim's heartbeat thread never stops).
    sched = FaultSchedule(args.seed, rank)
    sched.degrade_rank(args.fault_rank, factor=1000, after_ops=0)
    # committed ops per round: the allreduce plus evasion_tick's two
    # lockstep broadcasts (broadcast_object = size + payload). Barriers
    # and telemetry publishes are store-side, not committed collectives.
    # A promoted spare divides its adopted op count by this to resume
    # the round loop at the right index.
    ops_per_round = 3
    status = 0
    pg = None
    group = f"evade{args.seed}"
    walls = []  # leader: (round, allreduce wall seconds)
    promote_round = None
    drained = False
    # ticks left AFTER the tier-2 promotion: exactly one — the adoption
    # tick the promoted spare joins (it inherits the engine's strike
    # history from the broadcast, and with every counter freshly reset
    # at the promote decision a single tick is provably action-free).
    # Ticking past it would score pure scheduling noise on a healthy
    # fleet — on a loaded box that can manufacture a non-replayable
    # reshape. None = promotion not seen yet (keep ticking).
    post_ticks = None
    try:
        if role == "member":
            pg = dist.init_process_group(
                rank=rank, world_size=n, store_handle=args.coordinator,
                timeout_s=20.0, group_name=group, plane="shm",
                fault_schedule=sched, self_heal=True)
            pg.enable_evasion()
            pg.start_watchdog(interval_s=0.3, timeout_s=2.0)
            # deterministic start line: hold until the warm spare's
            # registration lands, so the promote tick is a pure
            # function of the trace stream, not of process spawn order
            if args.spares:
                if pg.rank == 0:
                    deadline = time.monotonic() + 30.0
                    while pg.live_spares() < args.spares:
                        if time.monotonic() >= deadline:
                            raise TimeoutError(
                                "warm spare never registered")
                        time.sleep(0.05)
                pg.barrier()
            start = 0
        else:  # warm spare
            pg = dist.init_process_group(
                world_size=n, store_handle=args.coordinator,
                timeout_s=20.0, group_name=group, plane="shm",
                fault_schedule=sched, self_heal=True, spare=True)
            # arms locally (no barrier for a standby); the engine
            # adopts the group's strike history at the first tick
            pg.enable_evasion()
            pg.wait_promotion(timeout_s=120.0)
            start = pg.committed_ops // ops_per_round
            post_ticks = 1  # join the survivors' one adoption tick
        for rnd in range(start, args.rounds):
            my_orig = pg.global_ranks[pg.rank]
            local = _chaos_input(args.seed, my_orig, rnd, args.size)
            t0 = time.monotonic()
            got = pg.all_reduce(local, timeout_s=60.0)
            walls.append((rnd, time.monotonic() - t0))
            # original identities are preserved across reshapes AND the
            # promotion (the spare adopts the victim's), so the oracle
            # is the same full-membership sum every round
            want = _chaos_input(args.seed, 0, rnd, args.size)
            for r in range(1, n):
                want = want + _chaos_input(args.seed, r, rnd, args.size)
            if not np.array_equal(got, want):
                print(f"BAD-RESULT: round {rnd} not bitwise-correct",
                      flush=True)
                status = 5
                break
            pg.publish_telemetry()
            pg.barrier()
            if post_ticks == 0:
                continue  # promotion done, adoption tick spent
            if post_ticks is not None:
                post_ticks -= 1
            decision = pg.evasion_tick(timeout_s=60.0)
            if decision is not None and decision["action"] == "promote":
                if int(decision["victim"]) == my_orig:
                    # tier 2 already drained this rank (it is a standby
                    # now): leave the round loop to the promoted spare
                    drained = True
                    break
                promote_round = rnd
                post_ticks = 1
        if status == 0:
            if drained:
                print(f"DRAINED rank={args.fault_rank}", flush=True)
            else:
                print(f"OK rank={rank}/{total} rounds={args.rounds} "
                      f"now-rank={pg.rank}/{pg.world_size}", flush=True)
                print(f"EPOCH {pg.epoch}", flush=True)
                print(f"MEMBERS {pg.global_ranks}", flush=True)
            print(f"EVASTATE {json.dumps(pg.evasion_state())}", flush=True)
            if rank == 0:
                # phase walls: every pre-promote round ran against the
                # degraded victim; every post-promote round runs on the
                # promoted spare's fresh hardware
                byt = args.size * 8
                deg = [w for r, w in walls
                       if promote_round is None or r <= promote_round]
                rec = [w for r, w in walls
                       if promote_round is not None and r > promote_round]
                dbw = byt / (sum(deg) / len(deg)) / 1e6 if deg else 0.0
                rbw = byt / (sum(rec) / len(rec)) / 1e6 if rec else 0.0
                print(f"DEGRADED_ALGBW {dbw:.3f}", flush=True)
                print(f"RECOVERED_ALGBW {rbw:.3f}", flush=True)
                print(f"RECOVERY_RATIO "
                      f"{(rbw / dbw if dbw > 0 else 0.0):.2f}", flush=True)
            if not drained:
                pg.stop_watchdog()
                pg.destroy(graceful=True)
    except (TimeoutError, OSError, RuntimeError) as e:
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        print(f"EVASIONLOG {_event_log(('evade-',))}", flush=True)
        print(f"HEALLOG {_heal_log()}", flush=True)
        from rocnrdma_tpu_torch.obs import trace as _obs_trace
        print(f"TRACELOG {_obs_trace.digest(_obs_trace.TRACE.snapshot())}",
              flush=True)
        _print_fleet(pg)
        _print_ringfull()
        from rocnrdma_tpu_torch.obs import chrome
        chrome.dump_if_env(rank)
        if pg is not None:
            try:
                pg.destroy(graceful=False)
            except (OSError, TimeoutError):
                pass
        if server is not None:
            if status == 0:
                server.wait_idle(timeout_s=5.0)
            server.close()
    return status


def _conf_chaos_main(args) -> int:
    """The model-conformance acceptance task (module docstring:
    ``conformance-drift``)."""
    import hashlib
    import json

    import numpy as np

    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.metrics import CONF, ConformanceCounters
    from rocnrdma_tpu_torch.transport import bootstrap
    from rocnrdma_tpu_torch.transport.faults import FaultSchedule

    rank, n = args.process_id, args.num_processes
    # every op joins its predicted/measured pair — the drift estimator
    # must see the full round sequence, not a 1-in-8 sample
    os.environ["ROCNRDMA_TRACE_SAMPLE"] = "1"
    server = None
    if rank == 0:
        host, port = args.coordinator.rsplit(":", 1)
        server = bootstrap.BootstrapServer(n_ranks=n, port=int(port),
                                           host=host)
    # chronic slowness, not death: the victim's held receive completions
    # serialize the ring, so every rank's measured allreduce wall departs
    # the committed model's prediction by orders of magnitude while the
    # structural story (picks, sizes, versions) stays seed-pure
    sched = FaultSchedule(args.seed, rank)
    sched.degrade_rank(args.fault_rank, factor=1000, after_ops=0)
    status = 0
    pg = None
    try:
        pg = dist.init_process_group(
            rank=rank, world_size=n, store_handle=args.coordinator,
            timeout_s=20.0, group_name=f"conf{args.seed}", plane="shm",
            fault_schedule=sched)
        for rnd in range(args.rounds):
            local = _chaos_input(args.seed, rank, rnd, args.size)
            got = pg.all_reduce(local, timeout_s=60.0)
            want = _chaos_input(args.seed, 0, rnd, args.size)
            for r in range(1, n):
                want = want + _chaos_input(args.seed, r, rnd, args.size)
            if not np.array_equal(got, want):
                print(f"BAD-RESULT: round {rnd} not bitwise-correct",
                      flush=True)
                status = 5
                break
            pg.publish_telemetry()
            pg.barrier()
        if status == 0:
            # the closed loop's refit trigger: the drift table rides the
            # broadcast proposal, so every rank records the identical
            # tuner-drift events naming the drifted plane+bucket
            tuned = pg.tune_wire(timeout_s=60.0)
            view = pg.conformance_stats(timeout_s=10.0)
            print("CONFSTATS " + json.dumps(
                {"drift": view["drift"], "top": view["top"]},
                sort_keys=True), flush=True)
            if rank == 0:
                # the recorder's band material: the full fleet-merged
                # per-cell summary (ratios included — a recorded
                # measurement, like algbw; never digest material)
                print("CONFCELLS " + json.dumps(view["summary"],
                                                sort_keys=True),
                      flush=True)
            print("TUNED-DRIFT " + json.dumps(
                sorted(c for c, _ in tuned.get("drift", []))), flush=True)
            pg.destroy(graceful=True)
    except (TimeoutError, OSError, RuntimeError) as e:
        print(f"CLEAN-ABORT: {type(e).__name__}: {e}", flush=True)
        status = 4
    finally:
        # the replay half: the STRUCTURAL projection of this rank's own
        # cells (counts, picks, predicted cost, versions — never measured
        # walls or ratio histograms) digests equal across same-seed runs
        struct = ConformanceCounters.structural(CONF.snapshot())
        print("CONFLOG " + hashlib.sha256(json.dumps(
            struct, sort_keys=True).encode()).hexdigest(), flush=True)
        print(f"TUNERLOG {_tuner_log()}", flush=True)
        print(f"FAULTS {sched.counters.to_json()}", flush=True)
        print(f"FAULTLOG {sched.fingerprint()}", flush=True)
        from rocnrdma_tpu_torch.obs import trace as _obs_trace
        print(f"TRACELOG {_obs_trace.digest(_obs_trace.TRACE.snapshot())}",
              flush=True)
        _print_fleet(pg)
        _print_ringfull()
        if pg is not None:
            try:
                pg.destroy(graceful=False)
            except (OSError, TimeoutError):
                pass
        if server is not None:
            if status == 0:
                server.wait_idle(timeout_s=5.0)
            server.close()
    return status


def _witnessed(code: int) -> int:
    """Flush this worker's observed lock-acquisition edges the moment
    the chaos task's verdict is known (``ROCNRDMA_LOCK_WITNESS_OUT``;
    no-op when the witness is off). The atexit hook also dumps on clean
    exits, but a worker a kill hook tears down with ``os._exit`` right
    after the verdict would otherwise take its edges with it — and the
    survivors' dumps are exactly what the kill-and-heal witness test
    diffs against the static graph."""
    from rocnrdma_tpu_torch import lockwitness
    lockwitness.dump()
    return code


# tasks that build an NCCL communicator on the card (one process per GPU)
NCCL_TASKS = ("allreduce", "alltoall")
TASKS = (NCCL_TASKS + ("fault", "hierarchical", "rank-mesh") + CHAOS_TASKS
         + DEVICE_TASKS + AUX_TASKS)

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

    from rocnrdma_tpu_torch.runtime.mesh import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport

    elems = size or 8
    if task == "alltoall":
        elems = -(-elems // n) * n
    rows = _rows(n, elems, seed)
    t = Transport(rank_mesh(n, device, group=torch.distributed.group.WORLD))
    local = torch.from_numpy(rows[rank:rank + 1].copy()).to(device)
    if task == "allreduce":
        got, want = t.allreduce(local, "fused")[0].cpu().numpy(), rows.sum(0)
        # the constant rows sum exactly; seeded ones in the backend's order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        got = t.alltoall(local.reshape(1, n, -1), "fused")[0].cpu().numpy()
        # chunk j of the result is rank j's chunk for this rank
        np.testing.assert_array_equal(got, rows.reshape(n, n, -1)[:, rank])


HIER_SEED = 7  # the reference's default_rng(7)
HIER_REF_SIZE = 8  # the reference's last dim


def hier_rows(m: int, n: int, size: int, rows) -> "np.ndarray":
    """The ``hierarchical`` task's rank buffers ``(N, size)`` fp32, N = m *
    n, for the (slice, intra) pairs in ``rows``, stacked: at the
    reference's size the rows of its ``default_rng(7)`` draw of ``(m, n,
    N, 8)``, else each row from its own seed ``(7, s, i)``."""
    import numpy as np
    if size == HIER_REF_SIZE:
        full = np.random.default_rng(HIER_SEED).standard_normal(
            (m, n, m * n, size)).astype(np.float32)
        return np.stack([full[s, i] for s, i in rows])
    return np.stack([np.random.default_rng((HIER_SEED, s, i)).standard_normal(
        (m * n, size), dtype=np.float32) for s, i in rows])


# the calls the reference's own numpy checks read
_HIER_NUMPY_CHECKED = ("allreduce/ring", "alltoall/fused", "allreduce/bf16")
# the task's calls, in the order it runs them (``_hier_calls``' names)
HIER_CALLS = (
    "allreduce/ring", "allreduce/khd", "allreduce/bf16", "allreduce/avg",
    "allreduce/max", "allreduce/ragged", "allreduce/fused_cross", "allreduce/fused",
    "alltoall/fused", "alltoall/rotation", "alltoall/flat_fused", "alltoall/bruck_cross",
    "allreduce/khd2d", "reduce_scatter/fused", "reduce_scatter/khd2d",
    "allgather/fused", "allgather/khd2d", "broadcast/fused", "reduce/fused",
    "gather/fused", "scatter/fused", "group/khd2d_alltoall")


def _hier_calls(t, one, mesh, mine, full):
    """The ``hierarchical`` task's calls: name -> (the call on this
    process's rows, the one-process port's call on ``full``, tolerance or
    None for bitwise)."""
    from rocnrdma_tpu_torch import collectives as C

    m, n = mesh.shape
    last = m * n - 1
    flat = lambda v: v.reshape((-1,) + tuple(v.shape[2:]))  # noqa: E731
    tol = (1e-5, 1e-6)
    return {
        "allreduce/ring": (lambda: t.allreduce(mine, "hierarchical"),
                           lambda: one.allreduce(full, "hierarchical"), None),
        "allreduce/khd": (lambda: t.allreduce(mine, "hierarchical", intra_algo="khd"),
                          lambda: one.allreduce(full, "hierarchical", intra_algo="khd"),
                          None),
        "allreduce/bf16": (
            lambda: t.allreduce(mine, "hierarchical", cross_dtype="bfloat16"),
            lambda: one.allreduce(full, "hierarchical", cross_dtype="bfloat16"), None),
        "allreduce/avg": (lambda: t.allreduce(mine, "hierarchical", op="avg"),
                          lambda: one.allreduce(full, "hierarchical", op="avg"), None),
        "allreduce/max": (lambda: t.allreduce(mine, "hierarchical", op="max"),
                          lambda: one.allreduce(full, "hierarchical", op="max"), None),
        # one buffer of --size elements a rank: padded where n does not divide it
        "allreduce/ragged": (lambda: t.allreduce(mine[:, :, 0], "hierarchical"),
                             lambda: one.allreduce(full[:, :, 0], "hierarchical"), None),
        "allreduce/fused_cross": (
            lambda: C.hierarchical_allreduce(flat(mine), (m, n), cross_algo="fused",
                                             span=mesh.span).reshape(mine.shape),
            lambda: C.hierarchical_allreduce(flat(full), (m, n), cross_algo="fused")
            .reshape(full.shape), tol),
        "allreduce/fused": (lambda: t.allreduce(mine, "fused"),
                            lambda: one.allreduce(full, "fused"), tol),
        "alltoall/fused": (lambda: t.alltoall(mine, "hierarchical"),
                           lambda: one.alltoall(full, "hierarchical"), None),
        "alltoall/rotation": (
            lambda: C.hierarchical_alltoall(flat(mine), (m, n), intra_algo="rotation",
                                            cross_algo="rotation", span=mesh.span)
            .reshape(mine.shape),
            lambda: C.hierarchical_alltoall(flat(full), (m, n), intra_algo="rotation",
                                            cross_algo="rotation").reshape(full.shape),
            None),
        "alltoall/flat_fused": (lambda: t.alltoall(mine, "fused"),
                                lambda: one.alltoall(full, "fused"), None),
        "alltoall/bruck_cross": (
            lambda: C.hierarchical_alltoall(flat(mine), (m, n), cross_algo="bruck",
                                            span=mesh.span).reshape(mine.shape),
            lambda: C.hierarchical_alltoall(flat(full), (m, n), cross_algo="bruck")
            .reshape(full.shape), None),
        "allreduce/khd2d": (lambda: t.allreduce(mine, "khd2d"),
                            lambda: one.allreduce(full, "khd2d"), None),
        "reduce_scatter/fused": (lambda: t.reduce_scatter(mine, "fused"),
                                 lambda: one.reduce_scatter(full, "fused"), tol),
        "reduce_scatter/khd2d": (lambda: t.reduce_scatter(mine, "khd2d"),
                                 lambda: one.reduce_scatter(full, "khd2d"), None),
        # the gathering verbs on one buffer of --size elements a rank, so a
        # rank's gathered row is the N rows' --size elements
        "allgather/fused": (lambda: t.allgather(mine[:, :, 0], "fused"),
                            lambda: one.allgather(full[:, :, 0], "fused"), None),
        "allgather/khd2d": (lambda: t.allgather(mine[:, :, 0], "khd2d"),
                            lambda: one.allgather(full[:, :, 0], "khd2d"), None),
        # roots off process 0: the last rank, and the first of slice 1
        "broadcast/fused": (lambda: t.broadcast(mine, "fused", root=last),
                            lambda: one.broadcast(full, "fused", root=last), None),
        "reduce/fused": (lambda: t.reduce(mine, "fused", root=n),
                         lambda: one.reduce(full, "fused", root=n), tol),
        "gather/fused": (lambda: t.gather(mine[:, :, 0], "fused", root=last),
                         lambda: one.gather(full[:, :, 0], "fused", root=last), None),
        "scatter/fused": (lambda: t.scatter(mine, "fused", root=n),
                          lambda: one.scatter(full, "fused", root=n), None),
        # a group() scope: khd2d allreduce and fused alltoall, run at its
        # exit, their rows side by side
        "group/khd2d_alltoall": (lambda: _grouped(t, mine), lambda: _grouped(one, full),
                                 None),
    }


def _grouped(t, x):
    """The ``hierarchical`` task's ``group()`` call: a khd2d allreduce and a
    fused alltoall of ``x`` queued in one scope, their results' rows
    concatenated."""
    import torch

    with t.group() as g:
        ar, a2a = g.allreduce(x, "khd2d"), g.alltoall(x, "fused")
    lead = tuple(x.shape[:2])
    return torch.cat([ar.result().reshape(lead + (-1,)),
                      a2a.result().reshape(lead + (-1,))], dim=2)


def _hold_calls(calls: dict, rank: int, device, checked: tuple,
                plains: dict | None = None) -> dict:
    """Run each spanning call three times (the first result is the one
    checked) and hold it to row ``[rank:rank + 1]`` of the one-process
    port's call: bitwise where the call's tolerance is None, else within
    its (rtol, atol); a call named in ``plains`` also bitwise to that row
    of its plain version on every row. A call both meshes refuse with one
    ``ValueError`` is recorded as refused. Returns ``times`` (ms), ``errs``
    (max abs err), ``plain_errs`` (against the plain versions), ``digests``
    (sha256, on the CPU), ``got`` (the results named in ``checked``) and
    ``refused`` (the error of each refused call)."""
    import hashlib

    import numpy as np
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    plains = plains or {}
    res = {k: {} for k in ("times", "errs", "plain_errs", "digests", "got", "refused")}
    for name, (spanning, whole, tol) in calls.items():
        ms, first = [], None
        for _ in range(3):  # the first result is the one checked
            sync()
            t0 = time.perf_counter()
            try:
                out = spanning()
            except ValueError as e:
                res["refused"][name] = str(e)
                try:
                    whole()
                except ValueError as e1:
                    if str(e1) == str(e):
                        break
                raise AssertionError(f"{name}: refused here ({e}), not by the "
                                     f"one-process port the same way") from e
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            first = out if first is None else first
        if name in res["refused"]:
            continue
        res["times"][name] = [round(v, 3) for v in ms]
        out, want = first, whole()[rank:rank + 1]
        if name in checked:
            res["got"][name] = out
        if out.shape != want.shape or out.dtype != want.dtype:
            raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs the "
                                 f"one-process port's {tuple(want.shape)} {want.dtype}")
        err = res["errs"][name] = float((out.float() - want.float()).abs().max())
        if tol is None and not torch.equal(out, want):
            raise AssertionError(f"{name}: not bitwise the one-process port's "
                                 f"(max abs err {err})")
        if tol is not None:
            np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                       rtol=tol[0], atol=tol[1], err_msg=name)
        del want
        if name in plains:
            want = plains[name]()[rank:rank + 1]
            if out.shape != want.shape or out.dtype != want.dtype:
                raise AssertionError(f"{name}: {tuple(out.shape)} {out.dtype} vs the plain "
                                     f"version's {tuple(want.shape)} {want.dtype}")
            err = res["plain_errs"][name] = float((out.float() - want.float()).abs().max())
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: not bitwise the plain version's (max abs "
                                     f"err {err})")
            del want
        if device.type == "cpu":
            res["digests"][name] = hashlib.sha256(out.numpy().tobytes()).hexdigest()
    return res


def _cross_line(t, device, rows_bytes: int) -> dict:
    """The cross leg of ``t``'s spanning mesh: its ``stats()`` entry with
    the GB/s through the cross group and staged each way, the backend, the
    device and the bytes of this process's rows."""
    span = t.span
    cross = t.stats()[f"cross/{span.backend}"]
    for way, nbytes, secs in (("wire", "bytes", "wire_s"),
                              ("d2h", "d2h_bytes", "d2h_s"),
                              ("h2d", "h2d_bytes", "h2d_s")):
        # an NCCL leg's host seconds are its enqueue, not its transfer
        sec = cross[secs] if way != "wire" or span.backend == "gloo" else 0
        cross[f"{way}_GBps"] = round(cross[nbytes] / sec / 1e9, 3) if sec else None
    cross.update(backend=span.backend, device=str(device), rows_bytes=rows_bytes)
    return cross


def _print_held(prefix: str, res: dict, cross: dict) -> None:
    import json

    print(f"{prefix}TIMES " + json.dumps(res["times"]), flush=True)
    print(f"{prefix}ERRS " + json.dumps(res["errs"]), flush=True)
    print(f"{prefix}CROSS " + json.dumps(cross), flush=True)
    if res["digests"]:
        print(f"{prefix}DIGEST " + json.dumps(res["digests"]), flush=True)


def _hierarchical_main(args, rank: int, m: int, device) -> int:
    """The ``hierarchical`` task (module docstring)."""
    import numpy as np
    import torch

    from rocnrdma_tpu_torch.runtime.mesh import slice_mesh
    from rocnrdma_tpu_torch.transport import Transport

    n, size = args.per_slice, args.size or HIER_REF_SIZE
    mesh = slice_mesh(m, n, device, group=torch.distributed.group.WORLD)
    t = Transport(mesh)
    mine = torch.from_numpy(hier_rows(m, n, size, [(rank, i) for i in range(n)]))
    mine = mine.to(device)[None]
    full_np = hier_rows(m, n, size, [(s, i) for s in range(m) for i in range(n)])
    full_np = full_np.reshape(m, n, m * n, size)
    full = torch.from_numpy(full_np).to(device)
    one = Transport(slice_mesh(m, n, device))

    calls = _hier_calls(t, one, mesh, mine, full)
    if tuple(calls) != HIER_CALLS:
        raise AssertionError(f"the task's calls {tuple(calls)} != {HIER_CALLS}")
    res = _hold_calls(calls, rank, device, _HIER_NUMPY_CHECKED)
    got = res["got"]
    # the reference's own checks, against numpy; the sum in float64, whose
    # own rounding stays out of the tolerance at 16M elements a row
    mine_np = full_np[rank:rank + 1]
    total = np.broadcast_to(full_np.sum((0, 1), dtype=np.float64), mine_np.shape)
    np.testing.assert_allclose(got["allreduce/ring"].cpu().numpy(), total,
                               rtol=1e-5, atol=1e-6)
    transpose = full_np.reshape(m * n, m * n, size).transpose(1, 0, 2) \
        .reshape(full_np.shape)[rank:rank + 1]
    np.testing.assert_allclose(got["alltoall/fused"].cpu().numpy(), transpose,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["allreduce/bf16"].cpu().numpy(), total,
                               rtol=2e-2, atol=1e-1)
    _print_held("HIER", res, _cross_line(t, device, mine.numel() * mine.element_size()))
    print(f"OK rank={rank}/{m} hierarchical", flush=True)
    return 0


RANK_SEED = 7  # the seed of a rank's row where none is given
RANK_REF_SIZE = 8  # the reference's buffer (the allreduce task's rows)


def rank_rows(n: int, size: int, seed, ranks) -> "np.ndarray":
    """The ``rank-mesh`` task's rank buffers ``(len(ranks), size)`` fp32:
    at the reference's size with no seed rank r's row is ``r + 1``
    (``_rows``), else each row from its own seed ``(seed or RANK_SEED,
    r)``, so a process can draw its own."""
    import numpy as np
    if size == RANK_REF_SIZE and seed is None:
        return _rows(n, size, None)[list(ranks)]
    base = RANK_SEED if seed is None else seed
    return np.stack([np.random.default_rng((base, r)).standard_normal(
        size, dtype=np.float32) for r in ranks])


def prime_digits(n: int) -> tuple[int, ...]:
    """n's prime factors, smallest first: the explicit khd digits of the
    ``rank-mesh`` task, a pick other than the radix ladder's."""
    out, d = [], 2
    while n > 1:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    return tuple(out)


def rank_inputs(v, n: int) -> dict:
    """A rank-mesh call's inputs from rows ``v`` (rows, S) of an n-rank
    axis: ``row``; ``even``, its first multiple of n elements (the verbs
    that shard a buffer n ways); ``a2a``, ``even`` as (rows, n, S // n);
    ``part``, the first S // n elements (the gathering verbs, so a
    gathered row is about S); ``ragged``, a buffer n does not divide (the
    row, or all of it but its last element); and ``grain``, the row
    repeated up to the first multiple of n*128 elements at or above S (the
    reduce_scatter kernel's grain; the row itself where S is one)."""
    import numpy as np

    size = v.shape[1]
    even = v[:, :size - size % n]
    grain = -(-size // (n * 128)) * n * 128
    reps = [v] * -(-grain // size)
    if grain == size:
        tiled = v
    elif isinstance(v, np.ndarray):
        tiled = np.concatenate(reps, 1)
    else:
        import torch
        tiled = torch.cat(reps, 1)
    return {"row": v, "even": even, "a2a": even.reshape(v.shape[0], n, -1),
            "part": v[:, :size // n], "ragged": v if size % n else v[:, :size - 1],
            "grain": tiled[:, :grain]}


def rank_refused(n: int, size: int) -> set:
    """The calls of the ``rank-mesh`` task both meshes refuse at n ranks of
    ``size`` elements: ``tree`` where n is not a power of two, the
    reduce_scatter kernel where the ``even`` buffer is not whole
    n*128-element chunks."""
    out = set() if n & (n - 1) == 0 else {"allreduce/tree"}
    if (size - size % n) % (n * 128):
        out.add("reduce_scatter/cuda_ring_even")
    return out


def rank_counts(n: int, c: int):
    """The alltoallv count matrix of the ``rank-mesh`` task: rank r sends
    ``(3r + 5d + 1) mod (c + 1)`` of its c rows to rank d."""
    import numpy as np
    r = np.arange(n)
    return (3 * r[:, None] + 5 * r[None, :] + 1) % (c + 1)


# the calls the reference's own numpy checks read
_RANK_NUMPY_CHECKED = ("allreduce/ring", "alltoall/fused")
# the task's calls, in the order it runs them (``_rank_calls``' names)
RANK_CALLS = (
    "allreduce/fused", "allreduce/ring", "allreduce/ring_bidir", "allreduce/tree",
    "allreduce/khd", "allreduce/khd_digits", "allreduce/dtree", "allreduce/ptree",
    "allreduce/ktree", "allreduce/avg", "allreduce/max", "allreduce/ragged",
    "reduce_scatter/fused", "reduce_scatter/ring", "reduce_scatter/khd",
    "allgather/fused", "allgather/ring", "allgather/khd",
    "alltoall/fused", "alltoall/rotation", "alltoall/bruck", "alltoallv/fused",
    "broadcast/fused", "broadcast/binomial", "reduce/fused", "reduce/binomial",
    "gather/fused", "gather/binomial", "scatter/fused", "scatter/binomial",
    "sendrecv/shift3", "program/ring_allreduce", "group/khd_alltoall",
    "allreduce/cuda_ring", "allreduce/cuda_ring_tiled", "reduce_scatter/cuda_ring",
    "reduce_scatter/cuda_ring_even", "allgather/cuda_ring", "alltoall/cuda_ring",
    "alltoallv/cuda_ring", "group/cuda_ring")
# the fused reductions: torch's order of summation, rtol 1e-5, atol 1e-6
RANK_FUSED = ("allreduce/fused", "reduce_scatter/fused", "reduce/fused")
# the cuda_ring calls: the kernel wrappers (ops.launch_counts) each launches
# once a call across processes
RANK_KERNELS = {
    "allreduce/cuda_ring": ("ring_allreduce_across",),
    "allreduce/cuda_ring_tiled": ("hbm_ring_allreduce_across",),
    "reduce_scatter/cuda_ring": ("ring_reduce_scatter_across",),
    "reduce_scatter/cuda_ring_even": ("ring_reduce_scatter_across",),
    "allgather/cuda_ring": ("ring_allgather_across",),
    "alltoall/cuda_ring": ("alltoall_across",),
    "alltoallv/cuda_ring": ("alltoall_across",),
    "group/cuda_ring": ("ring_allreduce_across", "alltoall_across"),
}
# the tile_rows of "allreduce/cuda_ring_tiled": chunks padded to whole
# 3 x 128-element tiles, a geometry other than the one-tile tier's (whole
# 128-element rows) at every size the task runs (no power of two is whole
# tiles of 384)
TILED_ROWS = 3


def rank_launches(names, n: int, size: int) -> dict:
    """The launches across processes each kernel wrapper makes when the
    ``rank-mesh`` task runs the calls ``names`` (three times each) on the
    card, n ranks of ``size`` elements: the ``cuda_ring`` allreduce of a row
    whose chunk outgrows one tile takes the tiled tier."""
    import torch

    from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows

    row = torch.empty((1, size), device="meta")
    tiled = cuda_ring_tile_rows(row, "allreduce", n) is not None
    out = {k: 0 for ks in RANK_KERNELS.values() for k in ks}
    for name in names:
        for k in RANK_KERNELS.get(name, ()):
            if tiled and k == "ring_allreduce_across":
                k = "hbm_ring_allreduce_across"
            out[k] += 3
    return out


def _rank_calls(t, one, mesh, mine, full):
    """The ``rank-mesh`` task's calls: name -> (the call on this process's
    row, the one-process port's call on ``full``, tolerance or None for
    bitwise)."""
    import torch

    from rocnrdma_tpu_torch.collectives import prog_ring_allreduce
    from rocnrdma_tpu_torch.ops import ring_cuda

    n = mesh.n_ranks
    last = n - 1
    digits = prime_digits(n)

    def alltoallv(tr, a):
        out, rc = tr.alltoallv(a["a2a"], rank_counts(n, a["a2a"].shape[2]), "fused")
        return torch.cat([out.reshape(out.shape[0], -1), rc.to(out.dtype)], 1)

    def alltoallv_kernel(tr, a):
        out, rc = tr.alltoallv(a["a2a"], rank_counts(n, a["a2a"].shape[2]), "cuda_ring")
        return torch.cat([out.reshape(out.shape[0], -1), rc.to(out.dtype)], 1)

    def grouped(tr, a, algos=("khd", "fused")):
        with tr.group() as g:
            ar, a2a = g.allreduce(a["row"], algos[0]), g.alltoall(a["a2a"], algos[1])
        rows = a["row"].shape[0]
        return torch.cat([ar.result(), a2a.result().reshape(rows, -1)], 1)

    def tiled(tr, a):  # the in-place tiled kernel on a copy of the row
        x = a["row"].clone()
        if tr.span is None:
            return ring_cuda.hbm_ring_allreduce(x, TILED_ROWS)
        return ring_cuda.hbm_ring_allreduce_across(x, tr.span, TILED_ROWS)

    def call(verb, key, algo, **knobs):
        return lambda tr, a: getattr(tr, verb)(a[key], algo, **knobs)

    specs = {
        "allreduce/fused": call("allreduce", "row", "fused"),
        "allreduce/ring": call("allreduce", "row", "ring"),
        "allreduce/ring_bidir": call("allreduce", "row", "ring_bidir"),
        "allreduce/tree": call("allreduce", "row", "tree"),
        "allreduce/khd": call("allreduce", "row", "khd"),
        "allreduce/khd_digits": call("allreduce", "row", "khd", digits=digits),
        "allreduce/dtree": call("allreduce", "row", "dtree"),
        "allreduce/ptree": call("allreduce", "row", "ptree", chunks=4),
        "allreduce/ktree": call("allreduce", "row", "ktree"),
        "allreduce/avg": call("allreduce", "row", "khd", op="avg"),
        "allreduce/max": call("allreduce", "row", "dtree", op="max"),
        "allreduce/ragged": call("allreduce", "ragged", "ring"),
        "reduce_scatter/fused": call("reduce_scatter", "even", "fused"),
        "reduce_scatter/ring": call("reduce_scatter", "even", "ring"),
        "reduce_scatter/khd": call("reduce_scatter", "even", "khd"),
        "allgather/fused": call("allgather", "part", "fused"),
        "allgather/ring": call("allgather", "part", "ring"),
        "allgather/khd": call("allgather", "part", "khd"),
        "alltoall/fused": call("alltoall", "a2a", "fused"),
        "alltoall/rotation": call("alltoall", "a2a", "ring"),
        "alltoall/bruck": call("alltoall", "a2a", "bruck"),
        "alltoallv/fused": alltoallv,
        # roots off process 0: the last rank, and rank 1
        "broadcast/fused": call("broadcast", "row", "fused", root=last),
        "broadcast/binomial": call("broadcast", "row", "binomial", root=last),
        "reduce/fused": call("reduce", "row", "fused", root=1),
        "reduce/binomial": call("reduce", "row", "binomial", root=1),
        "gather/fused": call("gather", "part", "fused", root=last),
        "gather/binomial": call("gather", "part", "binomial", root=last),
        "scatter/fused": call("scatter", "even", "fused", root=1),
        "scatter/binomial": call("scatter", "even", "binomial", root=1),
        "sendrecv/shift3": call("sendrecv", "row", "fused", shift=3),
        "program/ring_allreduce": lambda tr, a: tr.program_fn(prog_ring_allreduce(n))(a["row"]),
        "group/khd_alltoall": grouped,
        "allreduce/cuda_ring": call("allreduce", "row", "cuda_ring"),
        "allreduce/cuda_ring_tiled": tiled,
        "reduce_scatter/cuda_ring": call("reduce_scatter", "grain", "cuda_ring"),
        "reduce_scatter/cuda_ring_even": call("reduce_scatter", "even", "cuda_ring"),
        "allgather/cuda_ring": call("allgather", "part", "cuda_ring"),
        "alltoall/cuda_ring": call("alltoall", "a2a", "cuda_ring"),
        "alltoallv/cuda_ring": alltoallv_kernel,
        "group/cuda_ring": lambda tr, a: grouped(tr, a, ("cuda_ring", "cuda_ring")),
    }
    tol = (1e-5, 1e-6)
    return {name: (lambda f=f: f(t, rank_inputs(mine, n)),
                   lambda f=f: f(one, rank_inputs(full, n)),
                   tol if name in RANK_FUSED else None)
            for name, f in specs.items()}


def _rank_plains(full, n: int) -> dict:
    """The plain PyTorch versions of the ``rank-mesh`` task's ``cuda_ring``
    calls on every rank's rows ``full``: name -> the call, rank-major like
    the one-process port's."""
    import torch

    from rocnrdma_tpu_torch.collectives.alltoall import ragged_mask
    from rocnrdma_tpu_torch.ops import alltoall_cuda, ring_cuda
    from rocnrdma_tpu_torch.transport.api import cuda_ring_tile_rows

    def allreduce(x):  # the arm's tier, as the Transport picks it
        tile_rows = cuda_ring_tile_rows(x, "allreduce")
        return (ring_cuda.ring_allreduce_plain(x) if tile_rows is None
                else ring_cuda.hbm_ring_allreduce_plain(x.clone(), tile_rows))

    def alltoallv(a):
        out, rc = ragged_mask(alltoall_cuda.alltoall_plain(a["a2a"]),
                              rank_counts(n, a["a2a"].shape[2]))
        return torch.cat([out.reshape(n, -1), rc.to(out.dtype)], 1)

    def grouped(a):
        return torch.cat([allreduce(a["row"]),
                          alltoall_cuda.alltoall_plain(a["a2a"]).reshape(n, -1)], 1)

    specs = {
        "allreduce/cuda_ring": lambda a: allreduce(a["row"]),
        "allreduce/cuda_ring_tiled":
            lambda a: ring_cuda.hbm_ring_allreduce_plain(a["row"].clone(), TILED_ROWS),
        "reduce_scatter/cuda_ring": lambda a: ring_cuda.ring_reduce_scatter_plain(a["grain"]),
        "reduce_scatter/cuda_ring_even":
            lambda a: ring_cuda.ring_reduce_scatter_plain(a["even"]),
        "allgather/cuda_ring": lambda a: ring_cuda.ring_allgather_plain(a["part"]),
        "alltoall/cuda_ring": lambda a: alltoall_cuda.alltoall_plain(a["a2a"]),
        "alltoallv/cuda_ring": alltoallv,
        "group/cuda_ring": grouped,
    }
    if set(specs) != set(RANK_KERNELS):
        raise AssertionError(f"plain versions of {sorted(specs)}, kernel calls "
                             f"{sorted(RANK_KERNELS)}")
    return {name: (lambda f=f: f(rank_inputs(full, n))) for name, f in specs.items()}


def _rank_mesh_main(args, rank: int, n: int, device) -> int:
    """The ``rank-mesh`` task (module docstring)."""
    import json

    import numpy as np
    import torch

    from rocnrdma_tpu_torch import ops
    from rocnrdma_tpu_torch.runtime.mesh import rank_mesh
    from rocnrdma_tpu_torch.transport import Transport

    size = args.size or RANK_REF_SIZE
    ops.reset_launch_counts()
    mesh = rank_mesh(n, device, group=torch.distributed.group.WORLD)
    t = Transport(mesh)
    mine = torch.from_numpy(rank_rows(n, size, args.seed, [rank])).to(device)
    full_np = rank_rows(n, size, args.seed, range(n))
    full = torch.from_numpy(full_np).to(device)
    one = Transport(rank_mesh(n, device))

    calls = _rank_calls(t, one, mesh, mine, full)
    if tuple(calls) != RANK_CALLS:
        raise AssertionError(f"the task's calls {tuple(calls)} != {RANK_CALLS}")
    if args.calls:
        only = args.calls.split(",")
        if not set(only) <= set(RANK_CALLS):
            raise ValueError(f"--calls {sorted(set(only) - set(RANK_CALLS))}: not calls "
                             f"of the task; know {RANK_CALLS}")
        calls = {k: v for k, v in calls.items() if k in only}
    res = _hold_calls(calls, rank, device, _RANK_NUMPY_CHECKED, _rank_plains(full, n))
    refused = rank_refused(n, size) & set(calls)
    if set(res["refused"]) != refused:
        raise AssertionError(f"refused {sorted(res['refused'])} on {n} ranks of {size}, "
                             f"want {sorted(refused)}")
    launched = {k: v for k, v in ops.launch_counts().items() if k.endswith("_across")}
    want = rank_launches(set(calls) - refused, n, size)
    if device.type == "cpu":  # the plain versions across processes: no kernel
        want = dict.fromkeys(want, 0)
    if launched != want:
        raise AssertionError(f"kernel launches across processes {launched}, want {want}")
    got = res["got"]
    # the reference's own checks, against numpy; the sum in float64
    if "allreduce/ring" in got:
        total = full_np.sum(0, dtype=np.float64)[None]
        np.testing.assert_allclose(got["allreduce/ring"].cpu().numpy(), total,
                                   rtol=1e-5, atol=1e-6)
    if "alltoall/fused" in got:
        a2a = rank_inputs(full_np, n)["a2a"]
        np.testing.assert_array_equal(got["alltoall/fused"].cpu().numpy(),
                                      a2a.transpose(1, 0, 2)[rank:rank + 1])
    _print_held("RANK", res, _cross_line(t, device, mine.numel() * mine.element_size()))
    print("RANKPLAINERRS " + json.dumps(res["plain_errs"]), flush=True)
    print("RANKLAUNCHES " + json.dumps(launched), flush=True)
    if res["refused"]:
        print("RANKREFUSED " + json.dumps(res["refused"]), flush=True)
    print(f"OK rank={rank}/{n} rank-mesh", flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mp_worker")
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--task", choices=TASKS, default="allreduce")
    p.add_argument("--device-coordinator", default=None,
                   help="kill-a-host: the DEVICE plane's first store "
                        "address (the host-plane store rides "
                        "--coordinator)")
    p.add_argument("--device-heal-fail", action="store_true",
                   help="kill-a-host: make the post-heal device re-init "
                        "deterministically fail (degraded-mode chaos: "
                        "survivors must raise named with the host plane "
                        "still serving)")
    p.add_argument("--fault-rank", type=int, default=1)
    p.add_argument("--seed", type=int, default=None,
                   help="the chaos tasks' seed (default 0); the collective "
                        "tasks' buffers are constant without one")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--size", type=int, default=None,
                   help="elements of each rank's buffer (default 8 for the "
                        "collective tasks, 2048 for the chaos tasks)")
    p.add_argument("--kill-ranks", default=None,
                   help="kill-and-heal: comma list of victim ranks")
    p.add_argument("--kill-ops", default=None,
                   help="kill-and-heal: per-victim op counts at which "
                        "the hard kill lands (paired with --kill-ranks)")
    p.add_argument("--spares", type=int, default=0,
                   help="kill-and-heal: trailing process ids that start "
                        "as WARM SPARES (world = num-processes - spares "
                        "- join); a heal promotes them instead of "
                        "shrinking")
    p.add_argument("--join", type=int, default=0,
                   help="kill-and-heal: trailing process ids (after the "
                        "spares) that register as grow() JOINERS")
    p.add_argument("--grow-round", type=int, default=None,
                   help="kill-and-heal: round at which every member "
                        "issues grow(), admitting the registered joiners")
    p.add_argument("--die-at-promotion", type=int, default=None,
                   help="kill-and-heal: process id of a spare that "
                        "hard-dies the moment its admit record lands "
                        "(the mid-promotion death case)")
    p.add_argument("--lanes", action="store_true",
                   help="kill-and-heal: run the round loop on the "
                        "multi-tenant lane surface — allreduces on a "
                        "high-priority 'latency' channel, a second ping "
                        "stream on a paced 'bulk' channel (the lane x "
                        "epoch chaos case; prints LANEFENCED)")
    p.add_argument("--codec", default=None,
                   help="kill-and-heal: run the round allreduces on a "
                        "'quant' lane with this wire codec (int8/fp8) "
                        "and float payloads — prints CODECLOG (result "
                        "+ error-feedback-residual digests, replay-"
                        "equal per seed)")
    p.add_argument("--hier", action="store_true",
                   help="kill-and-heal: run the round allreduces on the "
                        "node-aware HIERARCHICAL schedule (node map = "
                        "first half node 0, second half node 1); kill a "
                        "node leader and the healed retry must re-elect "
                        "by lowest surviving original rank in the node")
    p.add_argument("--store-death", default="host",
                   choices=("host", "server", "proxy"),
                   help="kill-the-store: what dies — the store-hosting "
                        "RANK (os._exit via --kill-ranks/--kill-ops; "
                        "survivors heal against the replica), the "
                        "primary SERVER in-process (every client "
                        "rotates, membership unchanged), or node 1's "
                        "PROXY (only that node's ranks re-point)")
    p.add_argument("--kill-store-op", type=int, default=6,
                   help="kill-the-store: the host rank's data-op index "
                        "at which the armed server/proxy close fires")
    p.add_argument("--coalesce", action="store_true",
                   help="kill-and-heal: issue each round's allreduces "
                        "ASYNC and flush them as one fused bucket (the "
                        "coalesce x heal case: a kill lands mid-bucket "
                        "and the whole bucket retries exactly-once, "
                        "bitwise; prints COALESCED + TRACELOG)")
    p.add_argument("--per-slice", type=int, default=2,
                   help="hierarchical: the ranks each process holds as rows "
                        "(its slice of the 2-D mesh)")
    p.add_argument("--calls", default=None,
                   help="rank-mesh: a comma list of RANK_CALLS to run "
                        "(default: every one)")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="the device plane: auto (NCCL on the card, "
                        "raising without one) or cpu (gloo)")
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
    if args.task in CHAOS_TASKS + DEVICE_TASKS:
        # the reference's defaults for the chaos tasks
        args.seed = 0 if args.seed is None else args.seed
        args.size = 2048 if args.size is None else args.size
    if args.task == "kill-a-host":
        return _witnessed(_device_chaos_main(args))  # both planes
    if args.task == "kill-and-heal":
        return _witnessed(_heal_chaos_main(args))  # host plane only: no torch
    if args.task == "kill-the-store":
        return _witnessed(_store_chaos_main(args))  # host plane only: no torch
    if args.task == "trace-delay":
        return _witnessed(_trace_chaos_main(args))  # host plane only: no torch
    if args.task == "evade-straggler":
        return _witnessed(_evade_chaos_main(args))  # host plane only: no torch
    if args.task == "conformance-drift":
        return _witnessed(_conf_chaos_main(args))  # host plane only: no torch
    if args.task in CHAOS_TASKS:
        return _witnessed(_chaos_main(args))  # host plane: no torch, no devices

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
    if args.task in ("hierarchical", "rank-mesh"):
        main_ = _hierarchical_main if args.task == "hierarchical" else _rank_mesh_main
        status = main_(args, rank, n, device)
        shutdown_runtime()
        return status
    _collective(args.task, rank, n, args.size, args.seed, device)
    print(f"OK rank={rank}/{n} backend={info.backend}", flush=True)
    shutdown_runtime()
    return 0


if __name__ == "__main__":
    code = main()
    init = sys.modules.get("rocnrdma_tpu_torch.runtime.init")
    if init is not None:  # a device task, its process group torn down
        init.leave(code)
    sys.exit(code)
