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
from rocnrdma_tpu_torch.bench import bench_allreduce
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


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel_bitwise_equals_plain(cuda_device, k, dtype):
    xs = [_randn((100003,), dtype, 10 * k + j, cuda_device) for j in range(k)]
    before = T.launch_counts()["hbm_combine"]
    assert torch.equal(T.hbm_combine(*xs), T.hbm_combine_plain(*xs))
    assert T.launch_counts()["hbm_combine"] == before + 1


def test_kernels_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros((2, 256), dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.ring_allreduce(x)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        T.hbm_combine(x[0], x[1])
    with pytest.raises(ValueError, match="<= 8 operands"):
        T.hbm_combine(*[torch.zeros(16, device=cuda_device)] * 9)


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
