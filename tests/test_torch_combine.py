"""The port's combine kernels: ``ops.local_cuda`` (CUDA, counterpart of
``pallas_hbm_combine``) and ``ops.local_triton`` (Triton, counterpart of
``pallas_hbm_combine_pipelined``).

Their plain version against ``pallas_hbm_combine`` run in TPU interpret
mode, as ``tests/test_pallas_local.py`` runs it: bitwise in float32, and
bitwise in bfloat16 too, because both fold left to right and round to
bfloat16 after every add. ``pallas_hbm_combine_pipelined`` has no
interpret path (Mosaic's pipeline emitter needs a real TPU); it computes
the same function as ``pallas_hbm_combine``, so the pipelined wrapper is
held to that. The kernels themselves run on the card:
``tests/test_torch_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu.ops import pallas_hbm_combine
from rocnrdma_tpu_torch import ops as T

from _marks import needs_tpu_interpret


def _operands(k, shape, seed, jdtype, tdtype):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]
    return ([jnp.asarray(x).astype(jdtype) for x in xs],
            [torch.from_numpy(x).to(tdtype) for x in xs])


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@needs_tpu_interpret
@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("size", [1000, 3 * 8 * 128 + 17])
def test_combine_plain_bitwise_equals_pallas_fp32(devices, k, size):
    xj, xt = _operands(k, (size,), k * 100 + size, jnp.float32, torch.float32)
    ref = pallas_hbm_combine(*xj, tile_rows=8, interpret=True)
    got = T.hbm_combine_plain(*xt, tile_rows=8)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(_bits(T.hbm_combine(*xt, tile_rows=8)), _bits(ref))


@needs_tpu_interpret
@pytest.mark.parametrize("k", [2, 3])
def test_combine_plain_bitwise_equals_pallas_bf16(devices, k):
    # per-add bf16 rounding on both sides: bitwise, no tolerance needed
    xj, xt = _operands(k, (33, 45), 7 + k, jnp.bfloat16, torch.bfloat16)
    ref = pallas_hbm_combine(*xj, tile_rows=8, interpret=True)
    got = T.hbm_combine_plain(*xt, tile_rows=8)
    assert got.shape == (33, 45)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@needs_tpu_interpret
@pytest.mark.parametrize("k", [2, 3, 5])
def test_pipelined_combine_on_cpu_bitwise_equals_pallas_combine(devices, k):
    xj, xt = _operands(k, (3 * 8 * 128 + 17,), 300 + k, jnp.float32, torch.float32)
    ref = pallas_hbm_combine(*xj, tile_rows=8, interpret=True)
    before = T.launch_counts()["hbm_combine_pipelined"]
    got = T.hbm_combine_pipelined(*xt, tile_rows=8)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # a CPU tensor takes the plain version: no launch is counted
    assert T.launch_counts()["hbm_combine_pipelined"] == before


def test_combine_validates_operands():
    a = torch.zeros(10)
    with pytest.raises(ValueError, match=">= 2 operands"):
        T.hbm_combine(a)
    with pytest.raises(ValueError, match="share shape"):
        T.hbm_combine(a, torch.zeros(11))
    with pytest.raises(ValueError, match="share shape"):
        T.hbm_combine(a, torch.zeros(10, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="n_slots"):
        T.hbm_combine(a, a, n_slots=1)
    with pytest.raises(ValueError, match=">= 2 operands"):
        T.hbm_combine_pipelined(a)
    with pytest.raises(ValueError, match="share shape"):
        T.hbm_combine_pipelined(a, torch.zeros(11))
    with pytest.raises(ValueError, match="tile_rows"):
        T.hbm_combine_pipelined(a, a, tile_rows=0)


def test_pipelined_combine_fits_its_pipeline_in_shared_memory():
    from rocnrdma_tpu_torch.ops import local_triton as LT
    # the load buffers of (stages - 1) tiles of every operand must fit
    for k in range(2, 9):
        for itemsize in (2, 4):
            st = LT.stages_for(k, LT.BLOCK, itemsize)
            assert 1 <= st <= LT.NUM_STAGES
            assert (st - 1) * k * LT.BLOCK * itemsize <= LT.SMEM_BYTES
    # k=8 fp32, BLOCK 4096, 3 stages asked for 262144 bytes on the H100
    assert LT.stages_for(8, 4096, 4, 3) == 2
