"""The tensor front door of the port's host plane (``distributed.py``)
leaves one ``front-door-abort`` flight event on each of its abort paths: a
refused dtype (``_numpy_dtype``), a failed staging copy or verb
(``_front_door``'s and ``_front_door_batch``'s wrappers) and a failed
handle (``_TensorHandle.wait``), each with the verb, the dtype and the
device. The reference's ``obs`` analyzer pass (every ``except`` that
re-raises records a flight event), run over the port's module as it
stands, finds no problem.
"""

import ast
import os
import time

import pytest
import torch

from rocnrdma_tpu_torch import distributed as D
from rocnrdma_tpu_torch.obs import FLIGHT
from tools.analyze import obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _aborts_since(mark: float) -> list:
    # by time, not by index: the ring may be full with earlier tests' events
    return [args for t, kind, args in FLIGHT.events()
            if t >= mark and kind == "front-door-abort"]


def _mark() -> float:
    time.sleep(0.001)
    return time.perf_counter()


def all_reduce(self, x):  # a verb the door wraps: returns its staged input
    return x


def batch_isend_irecv(self, ops):
    return [None for _ in ops]


def test_a_refused_bfloat16_tensor_leaves_exactly_one_event():
    # bf16, e4m3fn and e5m2 fold now (test_torch_distributed.py); the fnuz
    # fp8 dtypes are the refused ones
    fp8 = torch.float8_e4m3fnuz
    verb = D._front_door(all_reduce)
    mark = _mark()
    with pytest.raises(D.HostPlaneDtypeError, match="refused, not cast"):
        verb(None, torch.zeros(4, dtype=fp8))
    assert _aborts_since(mark) == [{"verb": "all_reduce", "dtype": "torch.float8_e4m3fnuz",
                                    "device": "cpu", "error": "HostPlaneDtypeError"}]
    batch = D._front_door_batch(batch_isend_irecv)
    mark = _mark()
    with pytest.raises(D.HostPlaneDtypeError):
        batch(None, [("send", torch.zeros(2), 1), ("recv", torch.zeros(2, dtype=fp8), 1)])
    assert _aborts_since(mark) == [{"verb": "batch_isend_irecv",
                                    "dtype": "torch.float8_e4m3fnuz", "device": "cpu",
                                    "error": "HostPlaneDtypeError"}]
    # a bf16 tensor is staged as its bits, no event
    mark = _mark()
    assert verb(None, torch.zeros(4, dtype=torch.bfloat16)).dtype == torch.bfloat16
    assert _aborts_since(mark) == []


def test_a_staging_failure_leaves_one_event_and_releases_the_leases(monkeypatch):
    done = []
    real_done = D._Door.done

    def stage(self, obj):
        if isinstance(obj, torch.Tensor):
            self._claim(obj)
            raise OSError("injected staging failure")
        if isinstance(obj, (list, tuple)):
            return type(obj)(stage(self, o) for o in obj)
        return obj

    monkeypatch.setattr(D._Door, "stage", stage)
    monkeypatch.setattr(D._Door, "done", lambda self: done.append(1) or real_done(self))
    mark = _mark()
    with pytest.raises(OSError, match="injected"):
        D._front_door(all_reduce)(None, torch.ones(3))
    assert _aborts_since(mark) == [{"verb": "all_reduce", "dtype": "torch.float32",
                                    "device": "cpu", "error": "OSError"}]
    assert done == [1]
    mark = _mark()
    with pytest.raises(OSError, match="injected"):
        D._front_door_batch(batch_isend_irecv)(None, [("send", torch.ones(3), 1)])
    assert [a["error"] for a in _aborts_since(mark)] == ["OSError"]


def test_a_failed_handle_wait_leaves_one_event():
    class Failing:
        verb = "irecv"

        def wait(self, timeout_s=None):
            raise TimeoutError("peer never sent")

    door = D._Door(torch, "irecv")
    door.template(torch.zeros(5, dtype=torch.float64))
    door.pending = 1
    handle = D._TensorHandle(Failing(), door, torch.device("cpu"))
    mark = _mark()
    with pytest.raises(TimeoutError, match="never sent"):
        handle.wait(timeout_s=1.0)
    assert _aborts_since(mark) == [{"verb": "irecv", "dtype": "torch.float64",
                                    "device": "cpu", "error": "TimeoutError"}]
    assert handle.done() and door.pending == 0


def test_the_references_obs_pass_finds_nothing_in_the_port_distributed():
    path = os.path.join(REPO, "rocnrdma_tpu_torch", "distributed.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    assert obs.abort_problems(tree, "rocnrdma_tpu_torch/distributed.py") == []
