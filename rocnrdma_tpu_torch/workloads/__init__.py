"""Workloads: realistic traffic driving the port's ``Transport``.

Counterpart of ``rocnrdma_tpu/workloads/``:

- ``llama_trace`` + ``ddp_replay``: the Llama-3-8B DDP gradient-bucket
  trace, generated from the public model shapes (no weights needed) and
  replayed through the allreduce;
- ``fsdp_replay``: the FSDP/ZeRO-3 sibling, per-wrap-unit parameter
  allgather and gradient reduce-scatter;
- ``moe`` (with ``routing``): expert-parallel dispatch/combine, the
  alltoall traffic of MoE training;
- ``overlap``: a matmul chain beside per-layer gradient allreduces.

``from_numpy`` carries the reference's numpy parameter trees (weights
included) onto a torch device.
"""

from __future__ import annotations

import numpy as np
import torch

from rocnrdma_tpu_torch.workloads.llama_trace import LLAMA3_8B, Trace, generate_trace  # noqa: F401


def _leaf_to_tensor(a, device, dtype):
    # a writable C-ordered copy: torch.from_numpy shares memory, and a JAX
    # array reaches numpy read-only
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) is a type torch.from_numpy refuses:
        # carry its bits through int16, bit for bit
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def from_numpy(tree, device, dtype=None):
    """The tree (nested dicts, lists and tuples) with every array leaf (a
    numpy array or scalar, or anything ``np.asarray`` takes, such as a JAX
    array) as a tensor on ``device``, cast to ``dtype`` when given. Other
    leaves (Python numbers, None, strings) pass unchanged."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to(device)
        return t if dtype is None else t.to(dtype)
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _leaf_to_tensor(tree, device, dtype)
    return tree
