"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device). This file imports nothing of JAX, so on a machine
with a card and no JAX it runs without the suite's conftest::

    python -m pytest --noconftest tests/test_torch_card.py -q

Each kernel is held bitwise to its plain PyTorch version, in float32 and
bfloat16, and a CUDA tensor never falls back to the plain version.
"""

import pytest
import torch

from rocnrdma_tpu_torch import ops as T
from rocnrdma_tpu_torch.bench import bench_allreduce, bench_alltoall
from rocnrdma_tpu_torch.runtime import rank_mesh
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
