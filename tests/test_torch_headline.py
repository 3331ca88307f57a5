"""The port's headline (``bench/headline.py``) and ``bench/mfu_profile.py``
against the repository's ``bench.py`` and ``rocnrdma_tpu/bench/mfu_profile.py``,
on the CPU.

- ``KERNELS``: bench.py's registry, names and operand counts, with its XLA
  adds (``xlaN``) as the port's ``torchN``.
- Both branches print one JSON line first, carrying every key of
  bench.py's line for that branch (read from its source).
- The MFU leg: the inputs bitwise (the same float64 draws, cast once), the
  forward within 1e-5 and one SGD step's gradients and weights within
  1e-5 relative of the reference's ``jax.grad`` in float32.
- ``mfu_profile``: each variant's chain within 1e-5 of the reference's.
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rocnrdma_tpu import runtime as rt
from rocnrdma_tpu.bench import mfu_profile as ref_mfu
from rocnrdma_tpu.transport import Transport as RefTransport
from rocnrdma_tpu.workloads.moe import ffn_expert as ref_ffn_expert
from rocnrdma_tpu.workloads.moe import moe_topk_step as ref_moe_topk_step
from rocnrdma_tpu_torch import metrics as M
from rocnrdma_tpu_torch.bench import headline, mfu_profile
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _dict_keys(path: str, var: str) -> dict:
    """{first value of "metric" or "bench": the keys} of every ``var = {...}``
    dict literal in the source file ``path``."""
    tree = ast.parse(open(path).read())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(tg, ast.Name) and tg.id == var for tg in node.targets)):
            keys = [k.value for k in node.value.keys if isinstance(k, ast.Constant)]
            vals = dict(zip(keys, node.value.values))
            tag = vals.get("metric", vals.get("bench"))
            found[tag.value] = set(keys)
    return found


def _json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_kernels_equal_bench_py_registry():
    src = open(os.path.join(REPO, "bench.py")).read()
    for name, kernel, n_ops, _why in headline.KERNELS:
        assert kernel == f"torch{n_ops}"
        assert f'("{name}", "xla{n_ops}", {n_ops},' in src, name
    tree = ast.parse(src)
    ref = next(node.value for node in ast.walk(tree)
               if isinstance(node, ast.Assign)
               and any(isinstance(tg, ast.Name) and tg.id == "KERNELS" for tg in node.targets))
    ref_rows = [(e.elts[0].value, e.elts[2].value) for e in ref.elts]
    assert [(nm, o) for nm, _, o, _ in headline.KERNELS] == ref_rows


def test_one_rank_branch_prints_the_reference_keys_first(monkeypatch, capsys):
    ref_keys = _dict_keys(os.path.join(REPO, "bench.py"), "out")["local_reduce_GBps"]
    monkeypatch.setattr(M, "MiB", 64 * 1024)  # 8 "MiB" operands -> 512 KiB
    assert headline.main(["--platform", "cpu"]) == 0
    cap = capsys.readouterr()
    rows = _json_lines(cap.out)
    assert len(rows) == 1 and cap.out.lstrip().startswith("{")
    row = rows[0]
    assert ref_keys <= set(row) and row["metric"] == "local_reduce_GBps"
    assert row["kernel"] in {k[0] for k in headline.KERNELS}
    assert row["value"] > 0 and row["spread"][0] <= row["value"] <= row["spread"][1]
    assert row["fold"] == "pairwise" and row["device"] == "cpu"
    # the extras follow on stderr: the pairwise bytes and the MFU leg
    assert "3(N-1)" in cap.err and "flagship TRAIN step" in cap.err
    assert "not an MFU" in cap.err  # no data-sheet peak on the CPU


def test_multi_rank_branch_prints_the_reference_keys_first(monkeypatch, capsys, tmp_path):
    ref_keys = _dict_keys(os.path.join(REPO, "bench.py"),
                          "out")["allreduce_busbw_GBps_per_chip"]
    monkeypatch.setattr(M, "MiB", 1024)  # 8 "MiB" per rank -> 8 KiB
    art = tmp_path / "a2a.json"
    assert headline.main(["--platform", "cpu", "--fake-devices", "4", "--out", str(art)]) == 0
    cap = capsys.readouterr()
    rows = _json_lines(cap.out)
    assert len(rows) == 1
    row = rows[0]
    assert ref_keys <= set(row)
    assert row["ranks_per_card"] == 4 and row["link"] == "hbm-loopback"
    assert row["algo"] in {"fused", "ring_bidir", "khd", "khd2d", "cuda_ring"}
    winner_line = next(line for line in cap.err.splitlines() if "winner" in line)
    for algo in ("fused=", "ring_bidir=", "khd=", "khd2d=", "cuda_ring="):
        assert algo in winner_line
    a2a = json.loads(art.read_text())
    assert a2a["metric"] == "alltoall_algbw_GBps_per_chip" and a2a["n_ranks"] == 4
    assert "flagship TRAIN step" in cap.err  # the MFU leg follows in both branches


def test_cuda_ring_candidate_is_the_allreduce_in_place():
    # one tile a chunk (the tile is the chunk) and several tiles
    for n, elems in ((4, 512), (3, 5000)):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal((n, elems))
                             .astype(np.float32))
        want = x.sum(0).expand(n, -1).numpy()
        y = x.clone()
        got = headline._cuda_ring_inplace(y)
        assert got.data_ptr() == y.data_ptr()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert headline._balanced_factor(8) == (2, 4)
    assert headline._balanced_factor(64) == (8, 8)
    assert headline._balanced_factor(7) is None


def _ref_mfu(T, d, ffn):
    """bench.py's MFU-leg inputs, one forward and one SGD step, float32."""
    rng = np.random.default_rng(7)
    t = RefTransport(rt.rank_mesh(1))
    w_in = jnp.asarray(rng.standard_normal((1, d, ffn)) / np.sqrt(d), jnp.float32)
    w_out = jnp.asarray(rng.standard_normal((1, ffn, d)) / np.sqrt(ffn), jnp.float32)
    tokens = jnp.asarray(rng.standard_normal((1, T, d)), jnp.float32)
    logits = jnp.asarray(rng.standard_normal((1, T, 1)), jnp.float32)

    def loss_fn(ws, tok, lg):
        step = ref_moe_topk_step(t, "auto", True, 1, T, 1, expert=ref_ffn_expert(*ws))
        out, _ = step(tok, lg)
        out = out.astype(jnp.float32)
        return (out * out).sum()
    fwd = ref_moe_topk_step(t, "auto", True, 1, T, 1,
                            expert=ref_ffn_expert(w_in, w_out))(tokens, logits)[0]
    g = jax.grad(loss_fn)((w_in, w_out), tokens, logits)
    new = tuple((w - 1e-4 * gg).astype(jnp.float32) for w, gg in zip((w_in, w_out), g))
    return (w_in, w_out, tokens, logits), fwd, g, new


@pytest.mark.parametrize("shape", [(64, 32, 64), (256, 256, 512)])
def test_mfu_leg_forward_and_sgd_step_equal_reference(shape):
    T, d, ffn = shape
    ref_in, ref_fwd, ref_g, ref_new = _ref_mfu(T, d, ffn)
    ins = headline.mfu_inputs(T, d, ffn, torch.float32, CPU)
    for g, r in zip(ins, ref_in):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    w_in, w_out, tokens, logits = ins
    t = Transport(rank_mesh(1, "cpu"))
    fwd = headline.one_expert_step(t, T, w_in, w_out)(tokens, logits)[0]
    np.testing.assert_allclose(fwd.numpy(), np.asarray(ref_fwd), rtol=1e-5, atol=1e-5)
    grads = headline.train_grads(t, T, (w_in, w_out), tokens, logits)
    for g, r in zip(grads, ref_g):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    new = headline.train_step(t, T, (w_in, w_out), tokens, logits)
    for g, r in zip(new, ref_new):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_mfu_shape_is_bench_py_shape():
    src = open(os.path.join(REPO, "bench.py")).read()
    assert "T, d, ffn = (256, 256, 512) if on_cpu else (4096, 2048, 8192)" in src
    assert headline.mfu_shape(True)[:3] == (256, 256, 512)
    assert headline.mfu_shape(False) == (4096, 2048, 8192, torch.bfloat16)


@pytest.mark.parametrize("variant", ["full", "einsum", "routing"])
def test_mfu_profile_variants_equal_reference(variant):
    T, d, ffn = 32, 16, 32
    mk_r, xs_r = ref_mfu.build_step(T, d, ffn, jnp.float32, variant)
    mk_p, xs_p = mfu_profile.build_step(T, d, ffn, torch.float32, variant, CPU)
    ref = float(mk_r(2)(*xs_r))
    with torch.no_grad():
        got = mk_p(2)(*xs_p)
    assert got.shape == (1, T, d)
    np.testing.assert_allclose(float(got.ravel()[0]), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown variant"):
        mfu_profile.build_step(T, d, ffn, torch.float32, "bogus", CPU)


def test_mfu_profile_cli_row_and_top_ops(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert mfu_profile.main(["--platform", "cpu", "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    ref_keys = _dict_keys(os.path.join(REPO, "rocnrdma_tpu", "bench", "mfu_profile.py"),
                          "row")["mfu_profile"]
    assert ref_keys <= set(row) and row["platform"] == "cpu"
    assert "attribution" in capsys.readouterr().out
    # the profile of a full chain, read by the CPU clock here (no card)
    mk, xs = mfu_profile.build_step(32, 16, 32, torch.float32, "full", CPU)
    prof = mfu_profile.profile_chain(mk, xs, str(tmp_path / "prof"), steps=2)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    ops = mfu_profile.top_ops(prof, n=5, clock="cpu")
    assert 0 < len(ops) <= 5 and ops == sorted(ops, key=lambda r: -r[1])
    assert all(ms > 0 and count >= 1 for _, ms, count in ops)
    assert mfu_profile.top_ops(prof, clock="device") == []


def test_mfu_profile_top_ops_clock(tmp_path):
    # the CLI's --profile on the CPU reads the host clock; on the card a
    # profile that recorded no device activity is an error, never host time
    out = tmp_path / "rows.jsonl"
    assert mfu_profile.main(["--platform", "cpu", "--profile", str(tmp_path / "p"),
                             "--out", str(out)]) == 0
    row = json.loads(out.read_text())
    assert row["top_ops_clock"] == "cpu" and row["top_ops"]
    mk, xs = mfu_profile.build_step(32, 16, 32, torch.float32, "full", CPU)
    prof = mfu_profile.profile_chain(mk, xs, str(tmp_path / "prof"), steps=2)
    clock, ops = mfu_profile.chain_top_ops(prof, on_card=False)
    assert clock == "cpu" and ops == mfu_profile.top_ops(prof, clock="cpu")
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        mfu_profile.chain_top_ops(prof, on_card=True)


def test_headline_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfu_profile.main([])
