"""Llama-3-8B DDP gradient-bucket trace generator (component C12).

A copy of ``rocnrdma_tpu/workloads/llama_trace.py``, which imports no JAX;
``tests/test_torch_workloads.py`` pins its buckets equal to the reference's.

The trace is derived entirely from the PUBLIC Llama-3-8B architecture
(SURVEY.md §7 step 5: 32 layers, d_model 4096, GQA 32/8 heads, ffn 14336,
vocab 128256) — no weights are needed, because DDP gradient traffic depends
only on parameter shapes and bucketing.

Bucketing follows data-parallel trainer semantics: gradients become ready in
REVERSE parameter order during the backward pass, and are grouped into
fixed-capacity buckets (default 25 MiB, the common DDP default) that are
allreduced as each fills. Replaying the bucket sequence therefore reproduces
a real training step's allreduce sizes, counts, and issue order.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    ffn: int
    vocab: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_shapes(self) -> list[tuple[str, tuple[int, ...]]]:
        """(name, shape) in FORWARD order, embeddings first."""
        d, kv = self.d_model, self.n_kv_heads * self.head_dim
        out = [("embed_tokens", (self.vocab, d))]
        for i in range(self.n_layers):
            p = f"layers.{i}."
            out += [
                (p + "input_layernorm", (d,)),
                (p + "self_attn.q_proj", (d, d)),
                (p + "self_attn.k_proj", (d, kv)),
                (p + "self_attn.v_proj", (d, kv)),
                (p + "self_attn.o_proj", (d, d)),
                (p + "post_attention_layernorm", (d,)),
                (p + "mlp.gate_proj", (d, self.ffn)),
                (p + "mlp.up_proj", (d, self.ffn)),
                (p + "mlp.down_proj", (self.ffn, d)),
            ]
        out += [("norm", (d,)), ("lm_head", (self.vocab, d))]
        return out

    def n_params(self) -> int:
        return sum(_numel(s) for _, s in self.param_shapes())


LLAMA3_8B = ModelSpec(name="llama3-8b", n_layers=32, d_model=4096, n_heads=32,
                      n_kv_heads=8, ffn=14336, vocab=128256)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int           # issue order: 0 is the FIRST bucket ready in backward
    params: tuple        # param names, reverse-forward order
    numel: int
    bytes: int


@dataclasses.dataclass(frozen=True)
class Trace:
    model: str
    dtype: str
    bucket_cap_bytes: int
    buckets: tuple

    @property
    def total_bytes(self) -> int:
        return sum(b.bytes for b in self.buckets)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        d = json.loads(s)
        d["buckets"] = tuple(
            Bucket(**{**b, "params": tuple(b["params"])}) for b in d["buckets"])
        return cls(**d)


def generate_trace(spec: ModelSpec = LLAMA3_8B, bucket_mb: float = 25.0,
                   dtype: str = "float32") -> Trace:
    """Bucket the model's gradients the way a DDP trainer would.

    Greedy fill in reverse-forward order; a bucket closes when adding the
    next gradient would exceed the cap (a single oversized tensor gets its
    own bucket, like DDP's handling of e.g. the embedding gradient).
    """
    itemsize = {"float32": 4, "bfloat16": 2, "float16": 2}[dtype]
    cap = int(bucket_mb * 1024 * 1024)
    buckets, cur, cur_bytes = [], [], 0
    for name, shape in reversed(spec.param_shapes()):
        nbytes = _numel(shape) * itemsize
        if cur and cur_bytes + nbytes > cap:
            buckets.append((tuple(cur), cur_bytes))
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
    if cur:
        buckets.append((tuple(cur), cur_bytes))
    return Trace(
        model=spec.name, dtype=dtype, bucket_cap_bytes=cap,
        buckets=tuple(
            Bucket(index=i, params=ps, numel=b // itemsize, bytes=b)
            for i, (ps, b) in enumerate(buckets)),
    )
