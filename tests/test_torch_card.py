"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device). This file imports nothing of JAX, so on a machine
with a card and no JAX it runs without the suite's conftest::

    python -m pytest --noconftest tests/test_torch_card.py -q

Each kernel is held bitwise to its plain PyTorch version, in float32 and
bfloat16, and a CUDA tensor never falls back to the plain version. The
explicit schedules, rooted verbs, sendrecv, the 2-D mesh schedules,
programs and groups (plain tensor code, no kernel) are held bitwise to
their result on the CPU; the fused arms that reduce to rtol = atol = 1e-5
(the card's order of summation is not the CPU's).
"""

import pytest
import torch

from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.bench import bench_allreduce, bench_alltoall
from rocnrdma_tpu_torch.collectives import program
from rocnrdma_tpu_torch.runtime import rank_mesh, slice_mesh
from rocnrdma_tpu_torch.transport import Transport, api

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(shape, dtype, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernels_bitwise_equal_plain(cuda_device, n, dtype):
    x = _randn((n, 3 * 128 * 8 + 37), dtype, n, cuda_device)
    before = T.launch_counts()
    assert torch.equal(T.ring_allreduce(x), T.ring_allreduce_plain(x))
    for tr in (8, 64):
        y = x.clone()
        assert T.hbm_ring_allreduce(y, tile_rows=tr) is y
        assert torch.equal(y, T.hbm_ring_allreduce_plain(x.clone(), tile_rows=tr))
    after = T.launch_counts()
    assert after["ring_allreduce"] == before["ring_allreduce"] + 1
    assert after["hbm_ring_allreduce"] == before["hbm_ring_allreduce"] + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernel_back_to_back_launches_on_cached_flags(cuda_device, dtype):
    # every mode, launched again and again on the flags cached per (n,
    # lanes), with launches of other n (n=12: the batched path) in between;
    # the flags are never reset, each launch waits for its own epoch
    from rocnrdma_tpu_torch.ops import ring_cuda
    xs = {n: _randn((n, n * 3 * 128), dtype, 70 + n, cuda_device) for n in (3, 8, 12)}
    for n in (8, 3, 8, 12, 8):
        x = xs[n]
        for _ in range(2):
            assert torch.equal(T.ring_allreduce(x), T.ring_allreduce_plain(x))
            y = x.clone()
            T.hbm_ring_allreduce(y, tile_rows=1)
            assert torch.equal(y, T.hbm_ring_allreduce_plain(x.clone(), tile_rows=1))
            assert torch.equal(T.ring_reduce_scatter(x), T.ring_reduce_scatter_plain(x))
            assert torch.equal(T.ring_allgather(x), T.ring_allgather_plain(x))
    torch.cuda.synchronize()
    for (_, _, n, _), (words, _, epoch) in ring_cuda._FLAGS.items():
        assert epoch > 0 and bool((words == epoch * (n - 1)).all())


@pytest.mark.parametrize("k", range(2, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel_bitwise_equals_plain(cuda_device, k, dtype):
    xs = [_randn((100003,), dtype, 10 * k + j, cuda_device) for j in range(k)]
    before = T.launch_counts()["hbm_combine"]
    assert torch.equal(T.hbm_combine(*xs), T.hbm_combine_plain(*xs))
    assert T.launch_counts()["hbm_combine"] == before + 1


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_rows", [None, 8])
def test_ring_reduce_scatter_kernel_bitwise_equals_plain(cuda_device, n, dtype,
                                                         tile_rows):
    # three 128-lane rows a chunk: 8-row tiles pad each chunk at its end
    x = _randn((n, n * 3 * 128), dtype, 20 + n, cuda_device)
    before = T.launch_counts()["ring_reduce_scatter"]
    got = T.ring_reduce_scatter(x, tile_rows=tile_rows)
    assert got.shape == (n, 3 * 128)
    assert torch.equal(got, T.ring_reduce_scatter_plain(x, tile_rows))
    assert T.launch_counts()["ring_reduce_scatter"] == before + 1
    with pytest.raises(ValueError, match="n\\*128"):
        T.ring_reduce_scatter(x[:, :-1])


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_rows", [None, 2])
def test_ring_allgather_kernel_bitwise_equals_plain(cuda_device, n, dtype, tile_rows):
    x = _randn((n, 700), dtype, 30 + n, cuda_device)  # unaligned chunk
    before = T.launch_counts()["ring_allgather"]
    got = T.ring_allgather(x, tile_rows=tile_rows)
    assert torch.equal(got, x.reshape(1, -1).expand(n, -1))
    assert torch.equal(got, T.ring_allgather_plain(x, tile_rows))
    assert T.launch_counts()["ring_allgather"] == before + 1


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alltoall_kernel_bitwise_equals_plain(cuda_device, n, dtype):
    x = _randn((n, n, 77), dtype, 40 + n, cuda_device)  # unaligned chunks
    before = T.launch_counts()["alltoall"]
    got = T.alltoall(x)
    assert torch.equal(got, T.alltoall_plain(x))
    assert torch.equal(got, x.transpose(0, 1))
    assert torch.equal(T.alltoall(got), x)  # an involution
    counts = torch.randint(0, 6, (n, n), generator=torch.Generator().manual_seed(n))
    y = _randn((n, n, 5, 4), dtype, 50 + n, cuda_device)
    out, rc = T.alltoallv(y, counts)
    want, want_rc = Transport(rank_mesh(n, cuda_device)).alltoallv(y, counts, "fused")
    assert torch.equal(out, want) and torch.equal(rc, want_rc)
    assert T.launch_counts()["alltoall"] == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_alltoall_kernel_back_to_back_launches_on_cached_flags(cuda_device, dtype):
    # alltoall and alltoallv share the kernel and its flags, cached per (n,
    # lanes): launched again and again with other n (n=12: the batched
    # path) in between; the flags are never reset, each launch waits for
    # its own epoch
    from rocnrdma_tpu_torch.ops import alltoall_cuda
    xs = {n: _randn((n, n, 3 * 128 + 5), dtype, 80 + n, cuda_device) for n in (3, 8, 12)}
    counts = torch.randint(0, 6, (8, 8), generator=torch.Generator().manual_seed(1))
    y = _randn((8, 8, 5, 4), dtype, 90, cuda_device)
    want_v = Transport(rank_mesh(8, cuda_device)).alltoallv(y, counts, "fused")[0]
    for n in (8, 3, 8, 12, 8):
        for _ in range(2):
            assert torch.equal(T.alltoall(xs[n]), T.alltoall_plain(xs[n]))
            assert torch.equal(T.alltoallv(y, counts)[0], want_v)
    torch.cuda.synchronize()
    assert alltoall_cuda._FLAGS
    for (_, _, n, _), (words, epoch) in alltoall_cuda._FLAGS.items():
        assert epoch > 0 and bool((words == epoch * (n - 1)).all())


@pytest.mark.parametrize("k", range(2, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("numel", [100, 1000, 128 * 4096, 128 * 4096 + 77])
def test_pipelined_combine_kernel_tail_bitwise_equals_plain(cuda_device, k, dtype, numel):
    # sizes with and without a ragged end (100: less than one 128-element
    # row, 128 * 4096 + 77: whole tiles and 77 more)
    xs = [_randn((numel,), dtype, 70 + k + j, cuda_device) for j in range(k)]
    before = T.launch_counts()["hbm_combine_pipelined"]
    assert torch.equal(T.hbm_combine_pipelined(*xs), T.hbm_combine_plain(*xs))
    assert T.launch_counts()["hbm_combine_pipelined"] == before + 1


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipelined_combine_kernel_bitwise_equals_plain(cuda_device, k, dtype):
    xs = [_randn((100003,), dtype, 60 + k + j, cuda_device) for j in range(k)]
    before = T.launch_counts()["hbm_combine_pipelined"]
    assert torch.equal(T.hbm_combine_pipelined(*xs), T.hbm_combine_plain(*xs))
    assert T.launch_counts()["hbm_combine_pipelined"] == before + 1


def test_kernels_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((2, 256), dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.ring_allreduce(x)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.hbm_combine(x[0], x[1])
    with pytest.raises(ValueError, match="<= 8 operands"):
        T.hbm_combine(*[torch.zeros(16, device=cuda_device)] * 9)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.ring_allgather(x)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.alltoall(x.reshape(2, 2, 128))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.hbm_combine_pipelined(x[0], x[1])


@pytest.mark.parametrize("tile_bytes, one_tile",
                         [(api.CUDA_RING_TILE_BYTES, True), (16384, False)])
def test_cuda_ring_arm_both_tiers(cuda_device, monkeypatch, tile_bytes, one_tile):
    # a 25000-element chunk: one 16 MiB tile, or seven 16 KiB tiles
    monkeypatch.setattr(api, "CUDA_RING_TILE_BYTES", tile_bytes)
    t = Transport(rank_mesh(4, cuda_device))
    x = _randn((4, 100000), torch.float32, 3, cuda_device)
    before = x.clone()
    got = t.allreduce(x, "cuda_ring")
    assert torch.equal(x, before)
    tile_rows = api.cuda_ring_tile_rows(x)
    assert tile_rows == (None if one_tile else 28)
    want = (T.ring_allreduce_plain(x) if tile_rows is None else
            T.hbm_ring_allreduce_plain(x.clone(), tile_rows=tile_rows))
    assert torch.equal(got, want)
    torch.testing.assert_close(t.allreduce(x, "fused"), want, rtol=1e-5, atol=1e-5)


def test_bench_allreduce_on_the_card(cuda_device):
    assert bench_allreduce.main(
        ["--fake-devices", "4", "--sizes", "4K,8M", "--dtypes", "float32,bfloat16",
         "--algos", "fused,ring,ring_bidir,cuda_ring", "--repeats", "1",
         "--iters", "1"]) == 0


def test_bench_alltoall_on_the_card(cuda_device):
    assert bench_alltoall.main(
        ["--fake-devices", "8", "--sizes", "4K,8M", "--dtypes", "float32,bfloat16",
         "--algos", "fused,ring,bruck,cuda_ring", "--repeats", "1",
         "--iters", "1"]) == 0


_ARMS = [("allreduce", "tree", {}), ("allreduce", "khd", {"digits": (4, 2)}),
         ("allreduce", "khd", {}), ("allreduce", "dtree", {}),
         ("allreduce", "ptree", {"chunks": 3}), ("allreduce", "ptree", {}),
         ("allreduce", "ktree", {}), ("allreduce", "ring", {"premul": 0.5}),
         ("reduce_scatter", "khd", {"digits": (2, 4)}), ("allgather", "khd", {}),
         ("broadcast", "binomial", {"root": 3}), ("reduce", "binomial", {"root": 3}),
         ("reduce", "binomial", {"root": 5, "op": "max"}),
         ("gather", "binomial", {"root": 3}), ("scatter", "binomial", {"root": 3}),
         ("broadcast", "fused", {"root": 3}), ("gather", "fused", {"root": 3}),
         ("scatter", "fused", {"root": 3}), ("sendrecv", "fused", {"shift": 3})]


@pytest.mark.parametrize("verb,algo,kw", _ARMS,
                         ids=[f"{v}-{a}-{'-'.join(map(str, kw.values()))}"
                              for v, a, kw in _ARMS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_schedules_on_the_card_equal_their_cpu_result(cuda_device, verb, algo, kw, dtype):
    x = _randn((8, 8 * 125), dtype, 7, "cpu")
    want = getattr(Transport(rank_mesh(8, "cpu")), verb)(x, algo, **kw)
    got = getattr(Transport(rank_mesh(8, cuda_device)), verb)(
        x.to(cuda_device), algo, **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("verb,algo,kw", [
    ("allreduce", "hierarchical", {}), ("allreduce", "hierarchical", {"intra_algo": "khd"}),
    ("allreduce", "hierarchical", {"cross_dtype": "bfloat16", "op": "avg"}),
    ("allreduce", "khd2d", {"op": "min"}), ("reduce_scatter", "khd2d", {}),
    ("allgather", "khd2d", {}), ("alltoall", "hierarchical", {}),
    ("allreduce", "fused", {}), ("reduce", "fused", {"root": 5})])
def test_2d_schedules_on_the_card_equal_their_cpu_result(cuda_device, verb, algo, kw):
    x = _randn((2, 4, 8, 125), torch.float32, 8, "cpu")
    if verb != "alltoall":
        x = x.reshape(2, 4, -1)
    want = getattr(Transport(slice_mesh(2, 4, "cpu")), verb)(x, algo, **kw)
    got = getattr(Transport(slice_mesh(2, 4, cuda_device)), verb)(
        x.to(cuda_device), algo, **kw).cpu()
    if algo == "fused" and verb != "alltoall":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)


def test_programs_and_groups_on_the_card(cuda_device):
    t = Transport(rank_mesh(8, cuda_device))
    x = _randn((8, 203), torch.float32, 9, cuda_device)
    want = program.sim_program(program.prog_ring_allreduce(8), x.cpu().numpy())
    assert torch.equal(t.program_fn(program.prog_ring_allreduce(8))(x).cpu(),
                       torch.from_numpy(want))
    with t.group() as g:
        h1 = g.allreduce(x, "dtree")
        h2 = g.gather(x, "binomial", root=3)
    assert torch.equal(h1.result(), t.allreduce(x, "dtree"))
    assert torch.equal(h2.result(), t.gather(x, "binomial", root=3))
    y = x.clone()
    assert t.allreduce(y, "khd", donate=True).data_ptr() == y.data_ptr()
    assert torch.equal(y, t.allreduce(x, "khd"))


@pytest.mark.parametrize("collective", ["broadcast", "reduce", "gather", "scatter",
                                        "sendrecv"])
def test_rooted_clis_on_the_card(cuda_device, collective):
    from importlib import import_module
    cli = import_module(f"rocnrdma_tpu_torch.bench.bench_{collective}")
    assert cli.main(["--fake-devices", "6", "--sizes", "4K,8M", "--root", "3",
                     "--shift", "3", "--dtypes", "float32,bfloat16", "--repeats", "1",
                     "--iters", "1"]) == 0


def test_tree64_and_multislice_presets_on_the_card(cuda_device):
    assert bench_allreduce.main(
        ["--preset", "tree64", "--fake-devices", "8", "--sizes", "4K,8M",
         "--algos", "tree,khd,dtree,ptree,ktree,fused", "--repeats", "1",
         "--iters", "1"]) == 0
    assert bench_allreduce.main(
        ["--preset", "multislice", "--fake-devices", "8", "--sizes", "4K,8M",
         "--algos", "hierarchical,khd2d,fused", "--cross-dtype", "bfloat16",
         "--repeats", "1", "--iters", "1"]) == 0
    assert bench_alltoall.main(
        ["--preset", "multislice", "--fake-devices", "8", "--sizes", "8M",
         "--repeats", "1", "--iters", "1"]) == 0


def test_tuner_policies_on_the_card(cuda_device):
    import os

    from rocnrdma_tpu_torch.transport import tuner
    table = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "rocnrdma_tpu_torch", "results", "tuning_h100_8x1.json")
    t = Transport(rank_mesh(8, cuda_device), tuning=table)
    assert (t.platform, t.ranks_per_card) == ("gpu", 8)
    x = _randn((8, 1024), torch.float32, 10, cuda_device)
    arm = tuner.TuningTable.load(table).lookup("allreduce", 4096, 8, 1, "gpu")
    t.allreduce(x)
    assert t.stats()[f"allreduce/{arm}"]["calls"] == 1
    # khd without digits runs the card's model digits, bitwise as on the CPU
    y = _randn((8, 1 << 20), torch.float32, 11, cuda_device)
    digits = t.khd_model_digits("allreduce", 4 << 20)
    want = Transport(rank_mesh(8, "cpu")).allreduce(y.cpu(), "khd", digits=digits)
    assert torch.equal(t.allreduce(y, "khd").cpu(), want)
    t.allreduce(y, "model")
    assert tuner.measure_alpha(k1=64, k2=512, repeats=2, trials=1) > 0


def test_moe_layer_on_the_card(cuda_device):
    # the alltoall kernel only moves data: the cuda_ring arm equals the
    # fused arm bitwise; the layer equals its CPU result within 1e-5 (the
    # card's matmul and softmax round in another order)
    from rocnrdma_tpu_torch.workloads import moe
    from rocnrdma_tpu_torch.workloads import routing as R
    n, tokens, d, k = 8, 256, 64, 2
    cap = R.expert_capacity(tokens, n, k, 1.25)
    tok = _randn((n, tokens, d), torch.float32, 90, cuda_device)
    logits = _randn((n, tokens, n), torch.float32, 91, cuda_device)
    w_in = _randn((n, d, 96), torch.float32, 92, cuda_device) / 8
    w_out = _randn((n, 96, d), torch.float32, 93, cuda_device) / 10
    outs = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = Transport(rank_mesh(n, dev))
        expert = moe.ffn_expert(w_in.to(dev), w_out.to(dev))
        for algo in ("cuda_ring", "fused"):
            before = T.launch_counts()["alltoall"]
            out, keep = moe.moe_topk_step(t, algo, True, n, cap, k, expert=expert)(
                tok.to(dev), logits.to(dev))
            launched = T.launch_counts()["alltoall"] - before
            assert launched == (2 if (algo, dev.type) == ("cuda_ring", "cuda") else 0)
            outs[(algo, dev.type)] = (out.cpu(), keep.cpu())
    assert torch.equal(outs[("cuda_ring", "cuda")][0], outs[("fused", "cuda")][0])
    assert torch.equal(outs[("fused", "cuda")][1], outs[("fused", "cpu")][1])
    torch.testing.assert_close(outs[("fused", "cuda")][0], outs[("fused", "cpu")][0],
                               rtol=1e-5, atol=1e-5)


def test_replays_on_the_card(cuda_device):
    # every bucket and unit through the kernel arms, bitwise to the plain
    # versions, in every mode
    from rocnrdma_tpu_torch.workloads import ddp_replay, fsdp_replay
    from rocnrdma_tpu_torch.workloads.llama_trace import LLAMA3_8B, generate_trace
    t = Transport(rank_mesh(8, cuda_device))
    bufs = ddp_replay._bucket_arrays(t, generate_trace(LLAMA3_8B, 1024.0), 1 << 12,
                                     "float32")
    units = fsdp_replay.flat_units(LLAMA3_8B)[:4]
    shards, fulls = fsdp_replay._unit_arrays(t, units, 1 << 12, "float32",
                                             grain=fsdp_replay.CUDA_RING_GRAIN)
    plan = fsdp_replay.step_plan(len(units))
    for mode in ddp_replay.MODES:
        out = []
        ddp_replay.replay(t, bufs, "cuda_ring", mode, repeats=1, out=out)
        for b, o in zip(bufs, out):
            tr = api.cuda_ring_tile_rows(b)
            want = (T.ring_allreduce_plain(b) if tr is None
                    else T.hbm_ring_allreduce_plain(b.clone(), tr))
            assert torch.equal(o, want)
        out = []
        fsdp_replay.replay(t, shards, fulls, "cuda_ring", mode, repeats=1, out=out)
        for (kind, i), o in zip(plan, out):
            want = (T.ring_allgather_plain(shards[i]) if kind == "ag"
                    else T.ring_reduce_scatter_plain(fulls[i]))
            assert torch.equal(o, want)


def test_overlap_on_two_streams_equals_its_parts(cuda_device):
    from rocnrdma_tpu_torch.workloads import overlap
    for algo in ("fused", "ring"):
        t = Transport(rank_mesh(8, cuda_device))
        compute, comm, both = overlap.build_fns(t, algo)
        y, Ws, grads = overlap.example_inputs(t, layers=4, dim=256, batch=64,
                                              grad_elems=1 << 16)
        yb, gb = both(y, Ws, grads)
        assert torch.equal(yb, compute(y, Ws)) and torch.equal(gb, comm(grads))


def test_graft_entry_on_the_card(cuda_device):
    from rocnrdma_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    assert args[0].device.type == "cuda"
    out, new = fn(*args)
    ref_fn, ref_args = graft_entry.entry("cpu")
    ref_out, ref_new = ref_fn(*ref_args)
    torch.testing.assert_close(out.cpu(), ref_out, rtol=1e-5, atol=1e-5)
    for p, r in zip(new, ref_new):
        torch.testing.assert_close(p.cpu(), r, rtol=1e-6, atol=1e-6)
    before = T.launch_counts()
    graft_entry.dryrun_multichip(8)
    after = T.launch_counts()
    assert after["ring_allreduce"] > before["ring_allreduce"]
    assert after["alltoall"] > before["alltoall"]


# ---------------------------------------------------------------------------
# The host plane's torch edges on the card: the tensor front door and
# DeviceMeshNet
# ---------------------------------------------------------------------------


def _host_group(n, fn):
    """n ranks of the port's ProcessGroup as threads over the shm plane."""
    import threading

    from rocnrdma_tpu_torch import distributed as dist
    from rocnrdma_tpu_torch.transport import bootstrap
    server = bootstrap.BootstrapServer(n_ranks=n)
    outs, errs = [None] * n, []

    def worker(rank):
        pg = None
        try:
            pg = dist.init_process_group(rank=rank, world_size=n,
                                         store_handle=server.handle,
                                         plane="shm", timeout_s=60.0)
            outs[rank] = fn(pg, rank)
        except Exception:  # surfaced by the assert below
            import traceback
            errs.append(traceback.format_exc())
        finally:
            if pg is not None:
                pg.destroy()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    server.close()
    assert not errs, errs[0]
    return outs


def test_front_door_cuda_tensors_come_back_on_the_card(cuda_device):
    from rocnrdma_tpu_torch import distributed as dist

    def drive(pg, r):
        x = _randn((3, 40000), torch.float32, 90 + r, cuda_device)
        n = pg.world_size
        res = {}
        for name, call in (
                ("all_reduce", lambda v: pg.all_reduce(v)),
                ("all_gather", lambda v: pg.all_gather(v)),
                ("all_to_all", lambda v: pg.all_to_all(v[:2].reshape(n, -1))),
                ("broadcast", lambda v: pg.broadcast(v, src=1)),
                ("reduce_scatter", lambda v: pg.reduce_scatter(v))):
            res[name] = (call(x), call(x.cpu().numpy()))
        hs = pg.batch_isend_irecv([("recv", torch.empty_like(x), (r - 1) % n),
                                   ("send", x, (r + 1) % n)])
        res["batch"] = (hs[0].wait(), _randn((3, 40000), torch.float32,
                                             90 + (r - 1) % n, cuda_device)
                        .cpu().numpy())
        hs[1].wait()
        ch = pg.channel("bulk", bucket_bytes=1 << 20)
        fut = ch.allreduce_async(x[0])
        ch.flush(timeout_s=30.0)
        res["async"] = (fut.wait(30.0), pg.all_reduce(x[0].cpu().numpy()))
        with pytest.raises(dist.HostPlaneDtypeError):
            pg.all_reduce(torch.zeros(4, dtype=torch.uint8, device=x.device).view(
                torch.float8_e4m3fnuz))
        with pytest.raises(ValueError, match="change device"):
            pg.batch_isend_irecv([("recv", torch.empty(4), (r - 1) % n),
                                  ("send", x, (r + 1) % n)])
        return res

    for res in _host_group(2, drive):
        for name, (got, want) in res.items():
            assert got.device.type == "cuda" and got.dtype == torch.float32, name
            assert got.cpu().numpy().tobytes() == want.tobytes(), name
    stats = dist.staging_stats()
    assert stats["d2h_bytes"] > 0 and stats["h2d_bytes"] > 0


def test_device_mesh_net_on_the_card(cuda_device):
    from rocnrdma_tpu_torch.transport.plugin import DeviceMeshNet
    n = 4
    net = DeviceMeshNet(rank_mesh(n, cuda_device))
    net.init()
    x = _randn((n, 1000), torch.float32, 7, cuda_device)
    mr = net.reg_mr((0, 1), x)
    assert mr is x
    for src in range(n):
        for dst in range(n):
            if src != dst:
                req = net.isend(net.connect(src, net.listen(dst)[0]), mr)
                out = req.wait()
                assert net.test(req)[0]
                want = torch.zeros_like(x)
                want[dst] = x[src]
                assert out.is_cuda and torch.equal(out, want)
    with pytest.raises(ValueError, match="reg_mr"):
        net.reg_mr((0, 1), x.cpu())


def _chaos_line(result, key):
    import re
    m = re.search(rf"^{key} (.+)$", result.stdout, re.M)
    assert m, f"rank {result.process_id} printed no {key} line:\n" \
              f"{result.stdout}\n{result.stderr}"
    return m.group(1)


def test_kill_a_host_heals_with_the_ring_kernel_on_the_card(cuda_device):
    """The kill-a-host fleet on the card: the device plane is an NCCL
    group (three processes on one GPU, so DEVICE-GLOBAL is named
    unsupported), and every survivor's DEVICE-LOCAL after the heal
    launches the ring kernel on the card, bitwise to the integer oracle."""
    import json
    import re

    from rocnrdma_tpu_torch.ops import _build
    from rocnrdma_tpu_torch.runtime.multiprocess import run_workers

    _build.build()
    rs = run_workers(3, "kill-a-host", timeout_s=240.0, platform="auto",
                     seed=11, rounds=4, kill_ranks="1", kill_ops="25",
                     size=2048)
    assert rs[1].returncode == 7, rs[1].stdout + rs[1].stderr
    gpus = torch.cuda.device_count()
    for r in (rs[0], rs[2]):
        assert r.returncode == 0, r.stdout + r.stderr
        assert _chaos_line(r, "MEMBERS") == "[0, 2]"
        assert "DEVICE-LOCAL ok epoch=1" in r.stdout
        m = re.search(r"^DEVICE-LAUNCHES epoch=1 on=cuda:\d+ (\{.*\})$",
                      r.stdout, re.M)
        assert m and sum(json.loads(m.group(1)).values()) >= 1, r.stdout
        if gpus < 2:
            assert f"DEVICE-GLOBAL unsupported-one-gpu epoch=1 gpus={gpus}" \
                in r.stdout
        heal = json.loads(_chaos_line(r, "DEVICEHEAL_MS"))
        assert len(heal) == 1 and heal[0] > 0.0


_NCCL_REINIT = """
import torch, torch.distributed as dist
from rocnrdma_tpu_torch.runtime import init as I
from rocnrdma_tpu_torch.runtime.multiprocess import free_port
I.init_runtime(coordinator="127.0.0.1:%d" % free_port(), num_processes=1,
               process_id=0, timeout_s=60, platform="auto")
x = torch.ones(1 << 16, device="cuda")
dist.all_reduce(x)
old = dist.group.WORLD
store = {}
agree = lambda k, v=None, t=30.0: store.setdefault(k, v) if v is not None else store[k]
info = I.reinit_runtime([0], 1, 0, agree=agree, timeout_s=60.0, platform="auto")
y = torch.full((1 << 16,), 2.0, device="cuda")
dist.all_reduce(y)
torch.cuda.synchronize()
assert dist.get_backend() == "nccl" and dist.group.WORLD is not old
assert torch.equal(x, torch.ones_like(x)) and torch.equal(y, torch.full_like(y, 2.0))
assert I.device_fence([0], 0, 1) == {0: "m0e1"}
I.shutdown_runtime()
print("REINIT-OK", info.reinit_s)
"""


def test_nccl_communicator_aborts_and_recreates_in_one_process(cuda_device):
    """A world of one on NCCL: an all_reduce, then ``reinit_runtime``
    aborts the communicator and joins a new group, and an all_reduce runs
    on it (a process of its own, so no NCCL state leaks into the suite)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _NCCL_REINIT], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "REINIT-OK" in r.stdout, r.stdout + r.stderr


def test_hierarchical_across_two_processes_on_one_card(cuda_device):
    """The reference's ``hierarchical`` task on the card: two processes,
    each holding its 2 x 1000-element-column rows on the card, every
    result bitwise the one-process port's (in the worker); with fewer GPUs
    than processes the cross leg runs on gloo, staged through pinned host
    memory each way."""
    import json
    import re

    from rocnrdma_tpu_torch.runtime.multiprocess import run_workers

    rs = run_workers(2, "hierarchical", timeout_s=240.0, platform="auto",
                     per_slice=2, size=1000)
    gpus = torch.cuda.device_count()
    for r in rs:
        assert r.returncode == 0, r.stdout + r.stderr
        assert f"OK rank={r.process_id}/2 hierarchical" in r.stdout
        cross = json.loads(re.search(r"^HIERCROSS (.*)$", r.stdout, re.M).group(1))
        assert cross["device"].startswith("cuda") and cross["calls"] > 0
        if gpus < 2:
            assert (cross["backend"], cross["staged"]) == ("gloo", True)
            assert cross["d2h_bytes"] > 0 and cross["h2d_bytes"] > 0


_ACROSS = """
import os, sys, time, numpy as np, torch, torch.distributed as dist
from rocnrdma_tpu_torch import ops
from rocnrdma_tpu_torch.ops import alltoall_cuda as A, ipc, push_cuda, ring_cuda as R
from rocnrdma_tpu_torch.runtime.mesh import rank_mesh
rank, world, port, case = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank)
span = rank_mesh(world, "cuda", group=dist.group.WORLD).span
n = world


def row(shape, dtype, seed):
    full = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(np.float32)).to(dtype)
    return full[rank:rank + 1].cuda()


def same(name, got, plain):
    assert got.is_cuda and torch.equal(got.cpu(), plain), name


def staged_by(call, wrapper, want_in, want_out):
    # the bytes a wrapper across processes staged in and out for call()
    before = ops.staged_bytes()
    call()
    after = ops.staged_bytes()
    got = tuple(after[f"{wrapper}_{k}"] - before[f"{wrapper}_{k}"] for k in ("in", "out"))
    assert got == (want_in, want_out), (wrapper, got, want_in, want_out)


if case == "parity":
    for dtype in (torch.float32, torch.bfloat16):
        isz = torch.empty((), dtype=dtype).element_size()
        counts = dict(ops.launch_counts())
        # the reduce kernel: a padded row (staged in; in place, the result
        # copied back) and an aligned one of whole 8-row tiles (read in place)
        for size, seed in ((3 * 128 * 8 + 37, 1), (n * 128 * 8, 9)):
            x = row((size,), dtype, seed)
            pad = 0 if size % (n * 128 * 8) == 0 else size * isz
            staged_by(lambda: same("allreduce", R.ring_allreduce_across(x, span),
                                   R.ring_allreduce_across_plain(x.cpu(), span)),
                      "ring_allreduce_across", pad, 0)
            staged_by(lambda: same("tiled", R._tiled_allreduce_across(x, span, 8),
                                   R._tiled_allreduce_across_plain(x.cpu(), span, 8)),
                      "hbm_ring_allreduce_across", pad, 0)
            y, got = x.clone(), []
            staged_by(lambda: got.append(R.hbm_ring_allreduce_across(y, span, 8)),
                      "hbm_ring_allreduce_across", pad, pad)
            assert got[0] is y
            same("in place", y, R._tiled_allreduce_across_plain(x.cpu(), span, 8))
        z = row((n * 2 * 128,), dtype, 2)
        staged_by(lambda: same("reduce_scatter", R.ring_reduce_scatter_across(z, span),
                               R.ring_reduce_scatter_across_plain(z.cpu(), span)),
                  "ring_reduce_scatter_across", 0, 0)
        z = row((2 * n * 2 * 128,), dtype, 10)[:, ::2]  # strided: staged in
        staged_by(lambda: same("reduce_scatter strided", R.ring_reduce_scatter_across(z, span),
                               R.ring_reduce_scatter_across_plain(z.cpu(), span)),
                  "ring_reduce_scatter_across", n * 2 * 128 * isz, 0)
        # the push kernel: 700 fp32 are whole 16-byte vectors (read in place),
        # 700 bf16 are not (staged, the result sliced); 704 are in both
        g = row((700,), dtype, 3)
        pad = 0 if dtype == torch.float32 else 700 * isz
        staged_by(lambda: same("allgather", R.ring_allgather_across(g, span),
                               R.ring_allgather_across_plain(g.cpu(), span)),
                  "ring_allgather_across", pad, n * pad)
        g = row((704,), dtype, 7)
        staged_by(lambda: same("allgather aligned", R.ring_allgather_across(g, span),
                               R.ring_allgather_across_plain(g.cpu(), span)),
                  "ring_allgather_across", 0, 0)
        a = row((n, 77), dtype, 4)  # chunks padded to 128
        staged_by(lambda: same("alltoall", A.alltoall_across(a, span),
                               A.alltoall_across_plain(a.cpu(), span)),
                  "alltoall_across", n * 77 * isz, n * 77 * isz)
        a = row((n, 256), dtype, 8)
        staged_by(lambda: same("alltoall aligned", A.alltoall_across(a, span),
                               A.alltoall_across_plain(a.cpu(), span)),
                  "alltoall_across", 0, 0)
        c = np.random.default_rng(5).integers(0, 6, size=(n, n))
        for shape in ((n, 5, 4), (n, 32, 4)):  # padded, whole chunks
            v = row(shape, dtype, 6)
            got, rc = A.alltoallv_across(v, c, span)
            want, want_rc = A.ragged_mask(A.alltoall_across_plain(v.cpu(), span), c,
                                          span=span)
            same("alltoallv", got, want)
            assert torch.equal(rc.cpu(), want_rc)
        after = ops.launch_counts()
        grew = {k: after[k] - counts[k] for k in after if after[k] != counts[k]}
        assert grew == {"ring_allreduce_across": 2, "hbm_ring_allreduce_across": 4,
                        "ring_reduce_scatter_across": 2, "ring_allgather_across": 2,
                        "alltoall_across": 4}, grew
        # a shared card runs one sub-step a lane: one lane of 8 sub-steps
        # here (the geometry of a card of its own, 1 SM), aligned rows
        base = push_cuda.geometry_for
        push_cuda.geometry_for = lambda dev, n, pv, pc, kernel="push", code=0: \
            push_cuda.geometry(n, pv, 1, 1, 2, step_bytes=512, kernel=kernel)
        try:
            x = row((n * 128 * 64,), dtype, 11)
            assert push_cuda.geometry_for(0, n, 128 * 64 * isz // 16, 2, "reduce").steps == 8
            staged_by(lambda: same("allreduce 8 sub-steps", R.ring_allreduce_across(x, span),
                                   R.ring_allreduce_across_plain(x.cpu(), span)),
                      "ring_allreduce_across", 0, 0)
            y = x.clone()
            R.hbm_ring_allreduce_across(y, span, 8)
            same("in place 8 sub-steps", y, R._tiled_allreduce_across_plain(x.cpu(), span, 8))
            same("reduce_scatter 8 sub-steps", R.ring_reduce_scatter_across(x, span),
                 R.ring_reduce_scatter_across_plain(x.cpu(), span))
        finally:
            push_cuda.geometry_for = base
    print(f"OK rank={rank} parity", flush=True)
    span.close()
    dist.destroy_process_group()
    os._exit(0)
# case "peer-exits-<kernel>": both make one call of the reduce kernel
# (allreduce; the case keeps its name "ring") or the push kernel (alltoall),
# so the workspace is exchanged, then the last rank exits before its next
# launch; the others' launch gives up
x = row((n, 4096), torch.float32, 7)
verb = ((lambda: R.ring_allreduce_across(x.reshape(1, -1), span))
        if case == "peer-exits-ring" else (lambda: A.alltoall_across(x, span)))
verb()
dist.barrier()
if rank == n - 1:
    os._exit(0)
ws = span.workspace(x.device)
ws.timeout_s = 2.0
t0 = time.perf_counter()
try:
    verb()
    print("NO-ERROR", flush=True)
except ipc.PeerWaitExpired as e:
    print(f"EXPIRED {time.perf_counter() - t0:.3f} {e}", flush=True)
os._exit(0)
"""


def _across(world: int, case: str) -> list:
    """Run ``_ACROSS``'s ``case`` in ``world`` processes on the card: each
    one's (returncode, stdout, stderr)."""
    import os
    import subprocess
    import sys

    from rocnrdma_tpu_torch.runtime.multiprocess import free_port
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _ACROSS, str(r), str(world), str(port),
                               case], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out, err))
    return outs


def test_kernels_across_two_processes_on_one_card_equal_their_plain_versions(cuda_device):
    """Rows 1-5 across processes: two processes on the one card, each
    launching its rank's blocks with the other's rows and flags mapped
    through CUDA IPC, every result bitwise the plain version across
    processes (gather, the one-process plain version, own row), fp32 and
    bf16, each wrapper counted once a call; the reduce kernel's allreduce
    (out of place, tiled, in place) and reduce_scatter and the push
    kernel's allgather, alltoall and alltoallv, on aligned rows (nothing
    staged) and padded or strided ones (staged and counted); the reduce
    kernel also at 8 sub-steps a lane, which a shared card never picks."""
    for rank, (rc, out, err) in enumerate(_across(2, "parity")):
        assert rc == 0 and f"OK rank={rank} parity" in out, out + err[-3000:]


@pytest.mark.parametrize("kernel", ["ring", "push"])
def test_a_peer_that_never_launches_expires_the_bounded_wait(cuda_device, kernel):
    """A peer that exits before its launch of the reduce kernel (allreduce,
    case "ring") or the push kernel (alltoall): the other process's launch
    gives up at its deadline (2 s here) with ``ipc.PeerWaitExpired``, naming
    the kernel, the lane and the flag word, never a hang."""
    import re

    (rc, out, err), _ = _across(2, f"peer-exits-{kernel}")
    assert rc == 0, out + err[-3000:]
    m = re.search(r"^EXPIRED (\S+) (.*)$", out, re.M)
    assert m, out + err[-3000:]
    assert 2.0 <= float(m.group(1)) < 2.0 + 5.0
    assert re.search(r"rank 0, lane \d+, flag word \d+ \(entry barrier\)", m.group(2))
    assert ("push (allgather, alltoall)" if kernel == "push" else "reduce (allreduce)") \
        in m.group(2)
