"""PyTorch/CUDA port of ``rocnrdma_tpu`` (first slice: ``bench_allreduce``).

The package mirrors the JAX package's module names so each counterpart is
easy to find, and imports nothing of it: what it needs is copied here.

Layout contract (as in ``rocnrdma_tpu/transport/api.py``): collectives take
ONE rank-major tensor ``x`` of shape ``(n, ...)`` whose row ``x[r]`` is rank
r's buffer. In this slice every rank lives on one device: ``n`` ranks share
one GPU (or the CPU when the caller asks for it), and the hand-written ring
kernel's peer writes are stores into another rank's slot of the same
memory.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--platform cpu`` / ``device="cpu"``); with no GPU and no such request
they raise rather than fall back.
"""

__version__ = "0.1.0"
