"""The port's host plane is a copy of the JAX package's: pin every copy.

Each module of the host plane (``distributed.py``, ``transport/``'s host
modules, ``obs/``, ``native/``, ``lockwitness.py``, ``bench/bench_host.py``,
the host counters of ``metrics.py`` and the host half of ``tuner.py``) is
parsed with ``ast`` on both sides, docstrings stripped, the reference's
``rocnrdma_tpu.`` prefix rewritten to the port's, and every top-level
statement compared by name. The only definitions allowed to differ are
listed in ``REPLACED``, each with its reason; a listed definition that
is missing from the port, or no longer differs, fails too.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "rocnrdma_tpu")
PORT = os.path.join(REPO, "rocnrdma_tpu_torch")

_FRONT_DOOR = ("HostPlaneDtypeError", "_STAGING_KEEP", "_Staging.*", "_STAGING",
               "staging_stats", "_numpy_dtype", "_Door.*", "_TensorHandle.*",
               "_holds_tensor", "_front_door", "_front_door_batch",
               "_ARRAY_VERBS", "_TEMPLATE_VERBS", "_ASYNC_VERBS",
               "_install_front_door", "stmt _install_front_door()")
_SMOKE_FLOORS = ("SMOKE_FLOORS", "SMOKE_COALESCE_SPEEDUP", "SMOKE_CODEC_X",
                 "SMOKE_FLOORS_HIER", "SMOKE_LANES_P99_US",
                 "SMOKE_LANES_BULK_GBPS")

# (module, definition) -> why the port's differs from the reference's
REPLACED = {
    **{("distributed.py", d): "added: the tensor front door (CPU and CUDA "
       "tensors in, tensors out, pinned staging)" for d in _FRONT_DOOR},
    ("native/__init__.py", "_LIB_DIR"): "an explicit RQP_LIB_DIR nests under "
        "rocnrdma_tpu_torch/, so the port never loads the reference's library",
    ("transport/plugin.py", "DeviceMeshNet.*"): "one rank-major tensor on "
        "the mesh's device and a row copy, in place of jax's shard_map ppermute",
    ("transport/plugin.py", "_RingWire.exchange"): "consumes landed inbound "
        "frames while its send waits for arena credit; the reference's ring "
        "of waits can starve every rank (ROADMAP Queue 3)",
    ("distributed.py", "ProcessGroup.irecv"): "registers its posted receives "
        "for this thread's sends to test (the p2p arena-credit starvation, "
        "ROADMAP Queue 3)",
    ("distributed.py", "ProcessGroup._p2p_progress"): "tests this thread's "
        "posted receives, so a batch of sends cannot starve the ring",
    ("distributed.py", "import weakref"): "added with _P2P_POSTED",
    ("distributed.py", "_PostedRecv.*"): "added: one irecv's posted "
        "requests, tested by its poster's sends until a wait() claims them",
    ("distributed.py", "_P2P_POSTED"): "added: the posted receives by group "
        "(weakly keyed)",
    ("distributed.py", "_P2P_POSTED_LOCK"): "added with _P2P_POSTED",
    ("distributed.py", "_posted_p2p_recvs"): "added: a group's posted p2p "
        "receives, which its sends and waits on any thread test",
    ("transport/codec.py", "_F8_PIECE"): "added: torch converts fp8 in pieces "
        "at its parallel grain, on one thread",
    ("transport/codec.py", "Fp8E4M3Codec.*"): "torch.float8_e4m3fn in place "
        "of ml_dtypes, which the card's machine does not have",
    ("transport/codec.py", "get"): "the fp8 refusal names torch's dtype, "
        "not ml_dtypes",
    ("transport/codec.py", "COST_FACTOR"): "fp8's encode+decode cost over "
        "int8's, measured with torch's conversion on the card's host",
    ("transport/__init__.py", "_LAZY"): "the device plane's torch exports "
        "(Transport, ALGOS, SCHEDULES, supports, Group*) load lazily",
    ("transport/tuner.py", "COMMITTED_HOST_PLANES"): "the card machine's "
        "own host wire fit (rocnrdma_tpu_torch/results/host_tune_h100.json)",
    ("bench/bench_host.py", "import parse_size"): "the runner imports "
        "torch; bench_host keeps a torch-free parse_size",
    ("bench/bench_host.py", "import trimmed_mean"): "bench/timing.py imports "
        "torch; bench_host keeps a torch-free trimmed_mean",
    ("bench/bench_host.py", "_UNITS"): "added with parse_size",
    ("bench/bench_host.py", "parse_size"): "added: the runner's, torch-free",
    ("bench/bench_host.py", "trimmed_mean"): "added: timing's, torch-free",
    ("bench/bench_host.py", "main"): "prints metrics.format_host_table (the "
        "port's format_table is the device benches')",
    **{("bench/bench_host.py", d): "the --smoke gates' floors, from three "
       "runs on the card machine's host" for d in _SMOKE_FLOORS},
    ("runtime/mp_worker.py", "_verify_device_plane"): "the device plane is "
        "a torch process group: a cuda_ring allreduce of this process's two "
        "rows (the ring kernel on the card) and the group's own all_reduce, "
        "named unsupported on NCCL with fewer GPUs than members, in place of "
        "jax's shard_map and multiprocess computations",
    ("runtime/mp_worker.py", "_device_chaos_main"): "the device plane's "
        "first init and re-init are init_runtime/reinit_runtime on a torch "
        "process group (--device-coordinator, --platform) in place of the "
        "jax coordination service, its spans printed, and the group torn "
        "down bounded at the end",
    ("runtime/mp_worker.py", "_print_device_spans"): "added: the "
        "member-device-* spans of each device-plane restart, in ms",
}

# whole-module copies
MODULES = ("lockwitness.py", "distributed.py", "bench/bench_host.py",
           "obs/__init__.py", "obs/recorder.py", "obs/trace.py",
           "obs/chrome.py", "obs/conformance.py", "obs/fleet.py",
           "native/__init__.py", "transport/__init__.py",
           "transport/backoff.py", "transport/keyspace.py",
           "transport/bootstrap.py", "transport/lanes.py",
           "transport/coalesce.py", "transport/codec.py",
           "transport/plugin.py", "transport/faults.py",
           "transport/evasion.py")
# modules copied in part: the reference's statements from FIRST to LAST
PARTS = {"metrics.py": ("WireCounters", "FaultCounters"),
         "transport/tuner.py": ("HOST_ALPHA_S", "pick_algorithm"),
         "runtime/mp_worker.py": ("CHAOS_TASKS", "_witnessed")}


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _key(st) -> str:
    if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return st.name
    if isinstance(st, ast.Assign):
        return ",".join(ast.unparse(t) for t in st.targets)
    if isinstance(st, ast.AnnAssign):
        return ast.unparse(st.target)
    if isinstance(st, (ast.Import, ast.ImportFrom)):
        return "import " + ",".join(a.asname or a.name for a in st.names)
    return "stmt " + ast.unparse(st)


def _statements(src: str) -> list:
    """``(key, dump)`` per top-level statement; a class is split into its
    header (``Name``: bases, decorators and non-method statements) and one
    ``Name.method`` entry per method."""
    tree = _strip_docstrings(ast.parse(src))
    out = []
    for st in tree.body:
        if isinstance(st, ast.ClassDef):
            methods = [m for m in st.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
            for m in methods:
                out.append((f"{st.name}.{m.name}", ast.dump(m)))
            st.body = [m for m in st.body if m not in methods] or [ast.Pass()]
        out.append((_key(st), ast.dump(st)))
    return out


def _rewrite(src: str) -> str:
    src = re.sub(r"\brocnrdma_tpu\.", "rocnrdma_tpu_torch.", src)
    return src.replace("from rocnrdma_tpu import", "from rocnrdma_tpu_torch import")


def _defs(stmts) -> dict:
    out: dict = {}
    for k, dump in stmts:
        out.setdefault(k, []).append(dump)
    return out


def _declared(module: str, keys) -> set:
    """The declared entries of ``module``, a ``Class.*`` entry expanded to
    the class and each of its members among ``keys``."""
    out = set()
    for m, d in REPLACED:
        if m != module:
            continue
        if d.endswith(".*"):
            cls = d[:-2]
            out |= {k for k in keys if k == cls or k.startswith(cls + ".")}
        else:
            out.add(d)
    return out


def _differing(module: str, part=None) -> set:
    ref = _statements(_rewrite(open(os.path.join(REF, module)).read()))
    port = _statements(open(os.path.join(PORT, module)).read())
    if part is not None:
        keys = [k for k, _ in ref]
        first = keys.index(part[0])
        last = max(i for i, k in enumerate(keys)
                   if k == part[1] or k.startswith(part[1] + "."))
        ref = ref[first:last + 1]
        names = {k for k, _ in ref}
        names |= _declared(module, {k for k, _ in port})
        port = [(k, d) for k, d in port if k in names]
    a, b = _defs(ref), _defs(port)
    return {k for k in set(a) | set(b) if a.get(k) != b.get(k)}


@pytest.mark.parametrize("module", MODULES + tuple(PARTS))
def test_copy_equals_reference_but_the_declared(module):
    differ = _differing(module, PARTS.get(module))
    port_names = {k for k, _ in _statements(
        open(os.path.join(PORT, module)).read())}
    declared = _declared(module, port_names | differ)
    explicit = {d for m, d in REPLACED if m == module and not d.endswith(".*")}
    # a declared import may be a removal; every other explicit entry is a
    # definition the port must hold
    missing = {d for d in explicit - port_names if not d.startswith("import ")}
    assert not missing, f"declared but missing from the port: {missing}"
    assert not differ - declared, f"undeclared differences: {sorted(differ - declared)}"
    stale = explicit - differ
    for m, d in REPLACED:  # a Class.* entry must cover a difference
        if m == module and d.endswith(".*") and not _declared(module, differ) & {
                k for k in differ if k == d[:-2] or k.startswith(d[:-1])}:
            stale.add(d)
    assert not stale, f"declared but equal (stale entry): {sorted(stale)}"


def test_format_host_table_is_the_references_format_table():
    ref = _statements(_rewrite(open(os.path.join(REF, "metrics.py")).read()))
    port = _statements(open(os.path.join(PORT, "metrics.py")).read())
    want = dict(ref)["format_table"].replace("'format_table'", "'format_host_table'")
    assert dict(port)["format_host_table"] == want


def _code_lines(path: str) -> list:
    text = re.sub(r"//[^\n]*", "", open(path).read())
    return [line.rstrip() for line in text.splitlines() if line.strip()]


@pytest.mark.parametrize("name", ["rqp.cpp", "rtcp.cpp", "lsan.supp"])
def test_native_sources_equal_reference_but_comments(name):
    ref = os.path.join(REF, "native", name)
    port = os.path.join(PORT, "native", name)
    if name.endswith(".cpp"):
        assert _code_lines(port) == _code_lines(ref)
    else:
        assert open(port).read() == open(ref).read()


def _lib_paths(env_extra: dict) -> dict:
    code = ("import json, rocnrdma_tpu.native as r, rocnrdma_tpu_torch.native as p\n"
            "print(json.dumps({'ref': r._LIB, 'port': p._LIB}))")
    env = dict(os.environ, **env_extra)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    import json
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_native_library_lies_under_the_port(tmp_path):
    paths = _lib_paths({"RQP_LIB_DIR": ""})
    assert paths["port"].startswith(os.path.join(PORT, "native", "_build"))
    assert paths["port"] != paths["ref"]
    shared = _lib_paths({"RQP_LIB_DIR": str(tmp_path)})
    assert shared["ref"] == os.path.join(str(tmp_path), "librqp.so")
    assert shared["port"] == os.path.join(str(tmp_path), "rocnrdma_tpu_torch",
                                          "librqp.so")
    assert os.path.dirname(shared["port"]) != os.path.dirname(shared["ref"])


def test_the_port_builds_its_own_sources(tmp_path):
    """With RQP_LIB_DIR set, the port's library is built from the port's
    sources into its own directory and works (a queue pair round trip)."""
    code = (
        "import numpy as np\n"
        "from rocnrdma_tpu_torch import native\n"
        "import uuid\n"
        "assert native.build().startswith(%r)\n"
        "name = '/rqp_t_' + uuid.uuid4().hex[:12]\n"
        "a = native.QueuePair.listen(name, 1 << 16)\n"
        "b = native.QueuePair.connect(name)\n"
        "a.accept()\n"
        "b.send(b'hello')\n"
        "print(bytes(a.recv(timeout_s=5.0)))\n"
        "a.close(); b.close()\n") % str(tmp_path / "rocnrdma_tpu_torch")
    env = dict(os.environ, RQP_LIB_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "hello" in r.stdout
    assert os.listdir(tmp_path) == ["rocnrdma_tpu_torch"]


def test_host_plane_imports_load_no_torch_and_build_nothing(tmp_path):
    code = (
        "import sys\n"
        "import rocnrdma_tpu_torch.distributed\n"
        "import rocnrdma_tpu_torch.runtime.mp_worker\n"
        "import rocnrdma_tpu_torch.runtime.multiprocess\n"
        "import rocnrdma_tpu_torch.transport\n"
        "import rocnrdma_tpu_torch.transport.tuner\n"
        "import rocnrdma_tpu_torch.bench.bench_host\n"
        "import rocnrdma_tpu_torch.obs.fleet, rocnrdma_tpu_torch.obs.chrome\n"
        "import rocnrdma_tpu_torch.obs.conformance\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'rocnrdma_tpu', 'ml_dtypes', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RQP_LIB_DIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # and importing every module of the port compiles no native library
    walk = ("import importlib, pkgutil, rocnrdma_tpu_torch\n"
            "for m in pkgutil.walk_packages(rocnrdma_tpu_torch.__path__, "
            "'rocnrdma_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n")
    r = subprocess.run([sys.executable, "-c", walk], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.listdir(tmp_path) == []


def _modules_after(code: str, env: dict) -> list:
    probe = code + ("\nimport sys\nprint(sorted(m for m in sys.modules if "
                    "m.split('.')[0] in ('torch', 'jax', 'jaxlib', "
                    "'rocnrdma_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    return eval(r.stdout.strip().splitlines()[-1])


def test_runtime_loads_no_jax_and_a_host_chaos_task_no_torch(tmp_path):
    """``runtime.init`` and ``runtime.mp_worker`` import no jax and nothing
    of the reference; a host-plane chaos task (a whole ``chaos-allreduce``
    rank of a one-rank fleet, run through ``mp_worker.main``) runs without
    importing torch, as the reference's run without jax."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RQP_LIB_DIR"] = str(tmp_path)
    loaded = _modules_after("import rocnrdma_tpu_torch.runtime.init\n"
                            "import rocnrdma_tpu_torch.runtime.mp_worker\n"
                            "import rocnrdma_tpu_torch.runtime as rt\n"
                            "rt.reinit_runtime, rt.reprobe_topology", env)
    assert "torch" in loaded
    assert not [m for m in loaded if m.split(".")[0] != "torch"]
    from rocnrdma_tpu_torch.runtime.multiprocess import free_port
    task = ("from rocnrdma_tpu_torch.runtime import mp_worker\n"
            "rc = mp_worker.main(['--coordinator', '127.0.0.1:%d', "
            "'--num-processes', '1', '--process-id', '0', '--task', "
            "'chaos-allreduce', '--rounds', '2', '--size', '64'])\n"
            "assert rc == 0, rc\n" % free_port())
    assert _modules_after(task, env) == []


def test_transport_device_exports_resolve_lazily():
    from rocnrdma_tpu_torch import transport
    from rocnrdma_tpu_torch.transport import api, group
    assert transport.Transport is api.Transport
    assert transport.SCHEDULES is api.SCHEDULES
    assert transport.supports is api.supports
    assert transport.GroupHandle is group.GroupHandle
    assert {"Transport", "ALGOS", "HostQPNet"} <= set(dir(transport))
    with pytest.raises(AttributeError):
        transport.NoSuchThing  # noqa: B018


# ---------------------------------------------------------------------------
# The tuner's host half: the same rows and params give the same answers
# ---------------------------------------------------------------------------


def _corpus(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    rows = []
    for plane, beta, frame_a in (("shm", 1.5e-9, 1.7e-4), ("tcp", 2.1e-9, 5.8e-4)):
        for size in (1 << 18, 1 << 20, 1 << 22, 1 << 24):
            for frame in (131072, 524276, 1048576, 4194304):
                hop = size // 2
                nf = -(-hop // frame)
                t = 2 * (nf * frame_a + hop * beta) * (1 + 0.05 * rng.random())
                rows.append({"plane": plane, "size_bytes": size, "n_ranks": 2,
                             "mean_s": t, "algbw_GBps": size / t / 1e9,
                             "spread": [size / t / 1e9 * 0.97,
                                        size / t / 1e9 * 1.02],
                             "frame_bytes": frame, "pipeline_depth": 2})
    return rows


def test_tuner_host_half_equals_reference(tmp_path, monkeypatch):
    from rocnrdma_tpu.transport import tuner as RT
    from rocnrdma_tpu_torch.transport import tuner as PT

    rows = _corpus()
    ref_fit, port_fit = RT.fit_host_rows(rows), PT.fit_host_rows(rows)
    assert {k: v.to_dict() for k, v in ref_fit.items()} == \
        {k: v.to_dict() for k, v in port_fit.items()}
    assert RT.measured_winners(rows) == PT.measured_winners(rows)
    assert RT.fit_note(len(rows)) == PT.fit_note(len(rows))
    # one explicit model for both packages, loaded through the env knob
    path = tmp_path / "host.json"
    RT.save_host_model(str(path), ref_fit, tables=RT.measured_winners(rows))
    monkeypatch.setenv("ROCNRDMA_HOST_TUNING", str(path))
    RT._reset_host_models()
    PT._reset_host_models()
    try:
        for plane in ("shm", "tcp"):
            rm, pm = RT.host_wire_model(plane), PT.host_wire_model(plane)
            for n in (2, 3, 4, 8):
                for bucket in RT.BUCKET_CANDIDATES:
                    assert RT.coalesce_per_op_time(n, bucket, model=rm) == \
                        PT.coalesce_per_op_time(n, bucket, model=pm)
                assert RT.pick_bucket_bytes(n, model=rm) == \
                    PT.pick_bucket_bytes(n, model=pm)
            for nbytes in (4096, 1 << 16, 1 << 20, 1 << 24):
                assert dataclasses.astuple(rm.pick(nbytes, 4)) == \
                    dataclasses.astuple(pm.pick(nbytes, 4))
        flat_r, flat_p = RT.host_wire_model("tcp"), PT.host_wire_model("tcp")
        intra_r, intra_p = RT.host_wire_model("shm"), PT.host_wire_model("shm")
        for nbytes in (4096, 1 << 16, 1 << 20, 1 << 24):
            for sizes in ((2, 2), (4, 4), (1, 3), (2, 2, 2, 2)):
                for verb in ("allreduce", "reduce_scatter"):
                    assert RT.pick_algorithm(nbytes, sizes, flat_r, intra_r,
                                             verb=verb) == \
                        PT.pick_algorithm(nbytes, sizes, flat_p, intra_p,
                                          verb=verb)
    finally:
        RT._reset_host_models()
        PT._reset_host_models()


def test_fit_host_cli_writes_the_references_model(tmp_path):
    """``tuner --fit-host`` on a corpus writes the model the reference's
    CLI writes from the same corpus."""
    from rocnrdma_tpu.transport import tuner as RT
    from rocnrdma_tpu_torch.transport import tuner as PT
    import json
    corpus = tmp_path / "corpus.jsonl"
    with open(corpus, "w") as fp:
        for r in _corpus(1):
            fp.write(json.dumps({
                "platform": "host-" + r["plane"], "size_bytes": r["size_bytes"],
                "n_ranks": 2, "mean_s": r["mean_s"], "algbw_GBps": r["algbw_GBps"],
                "extra": {"spread": r["spread"],
                          "wire": {"frame_bytes": r["frame_bytes"]}}}) + "\n")
        fp.write('{"torn tail')
    ref_out, port_out = tmp_path / "ref.json", tmp_path / "port.json"
    assert RT.main(["--fit-host", str(corpus), "--out", str(ref_out)]) == 0
    assert PT.main(["--fit-host", str(corpus), "--out", str(port_out)]) == 0
    ref_doc, port_doc = json.loads(ref_out.read_text()), json.loads(port_out.read_text())
    assert ref_doc["planes"] == port_doc["planes"]
    assert ref_doc["tables"] == port_doc["tables"]
    assert PT.load_host_model(str(port_out)).keys() == {"shm", "tcp"}
