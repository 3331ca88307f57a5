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


# ---------------------------------------------------------------------------
# The Triton kernel's launch geometry, which the card's run depends on and
# the CPU can check, for the committed form (one tile of BLOCK elements a
# program, the ragged end masked) and for the TMA form that
# ``bench/bench_pipe_sweep.py`` holds beside it (rows of 128 for the
# descriptors and a tail outside them, the box, a pipeline that fits shared
# memory, a grid of exactly the programs resident at once). An emulation
# of each schedule over its geometry covers every element once and gives
# the plain version's bits.

_SIZES = [100, 1000, 128 * 4096, 128 * 4096 + 77, 3 * 8 * 128 + 17, (1 << 20) + 3]


def _fold_into(out, hits, xs, lo, hi):
    acc = xs[0][lo:hi].float()
    for x in xs[1:]:
        acc = (acc + x[lo:hi].float()).to(x.dtype).float()
    out[lo:hi] = acc.to(xs[0].dtype)
    hits[lo:hi] += 1


def _emulate_committed(xs, block, grid=None):
    """local_triton's kernel: programs walk tiles pid, pid + grid, ...;
    each tile's elements past the end are masked."""
    n = xs[0].numel()
    n_tiles = -(-n // block)
    grid = grid or n_tiles
    out, hits = torch.full_like(xs[0], float("nan")), torch.zeros(n, dtype=torch.int32)
    for pid in range(grid):
        for t in range(pid, n_tiles, grid):
            _fold_into(out, hits, xs, t * block, min((t + 1) * block, n))
    return out, hits


def _emulate_tma(xs, g):
    """bench_pipe_sweep's TMA form: tiles of rows over programs, TMA
    clipping the last tile at the last row, the tail summed by the last
    program."""
    out = torch.full_like(xs[0], float("nan"))
    hits = torch.zeros(xs[0].numel(), dtype=torch.int32)
    rows_a_tile, lanes = g.box
    for pid in range(g.grid):
        for t in range(pid, g.n_tiles, g.grid):
            r0, r1 = t * rows_a_tile, min((t + 1) * rows_a_tile, g.rows)
            _fold_into(out, hits, xs, r0 * lanes, r1 * lanes)
    if g.tail:
        _fold_into(out, hits, xs, g.rows * lanes, g.rows * lanes + g.tail)
    return out, hits


@pytest.mark.parametrize("k", range(2, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipelined_combine_launch_geometry(k, dtype):
    from rocnrdma_tpu_torch.bench import bench_pipe_sweep as PS
    from rocnrdma_tpu_torch.ops import local_triton as LT
    isz = torch.finfo(dtype).bits // 8
    # the committed form: no pipeline to fit, a power-of-two tile
    assert LT.stages_for(k, LT.BLOCK, isz) == LT.NUM_STAGES == 1
    assert LT.BLOCK & (LT.BLOCK - 1) == 0 and LT.BLOCK % 128 == 0
    for numel in _SIZES:
        g = PS.tma_geometry(numel, k, isz, 132, 32, 3, 4)
        assert g.rows * PS.LANES + g.tail == numel and 0 <= g.tail < PS.LANES
        assert (g.tail > 0) == (numel % 128 > 0)
        tr, lanes = g.box
        assert (tr, lanes) == (32, 128) and lanes * isz % 16 == 0  # a TMA box
        assert (g.n_tiles - 1) * tr < g.rows <= g.n_tiles * tr or g.rows == g.n_tiles == 0
        assert 1 <= g.stages <= 3
        assert g.smem == PS.tma_smem_bytes(k, tr * lanes, isz, g.stages) <= PS.SMEM_BYTES
        assert g.per_sm * (g.smem + PS.SMEM_RESERVED) <= PS.SMEM_PER_SM
        assert g.per_sm * 32 * 4 <= PS.THREADS_PER_SM
        assert g.grid == max(1, min(g.n_tiles, 132 * g.per_sm))
    # the model against the compiled footprints seen on the H100 (fp32, k=2
    # and 3, 32 x 128 tiles): with the TMA store 16392, 49160 and 81936 bytes
    # at 1, 2 and 3 stages; with st.global 16392 and 32776 at 1 and 2
    # stages; k=3, 2 stages, TMA store: 65560
    for k, stages, tma_store, seen in ((2, 1, True, 16392), (2, 2, True, 49160),
                                       (2, 3, True, 81936), (2, 1, False, 16392),
                                       (2, 2, False, 32776), (3, 2, True, 65560)):
        model = PS.tma_smem_bytes(k, 32 * 128, 4, stages, tma_store)
        assert 0 <= model - seen <= PS.SMEM_BARRIERS


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipelined_combine_schedule_covers_every_element_once(k, dtype):
    from rocnrdma_tpu_torch.bench import bench_pipe_sweep as PS
    rng = np.random.default_rng(k)
    isz = torch.finfo(dtype).bits // 8
    for numel in (100, 3 * 8 * 128 + 17, 128 * 4096 + 77):
        xs = [torch.from_numpy(rng.standard_normal(numel).astype(np.float32)).to(dtype)
              for _ in range(k)]
        want = _bits(T.hbm_combine_plain(*xs))
        # committed: a grid of every tile, and persistent as the sweep runs it;
        # TMA form on a small card, so programs walk several tiles each
        for got, hits in (_emulate_committed(xs, 1024), _emulate_committed(xs, 1024, 3),
                          _emulate_tma(xs, PS.tma_geometry(numel, k, isz, 2, 8, 2, 4))):
            assert bool((hits == 1).all())
            np.testing.assert_array_equal(_bits(got), want)


def test_pipelined_combine_geometry_rejects_a_box_tma_cannot_take():
    from rocnrdma_tpu_torch.bench import bench_pipe_sweep as PS
    for bad in (0, 3, 512):
        with pytest.raises(ValueError, match="tile_rows"):
            PS.tma_geometry(4096, 2, 4, 132, bad, 2, 4)
