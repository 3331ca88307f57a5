"""``mfu_profile`` - attribute the flagship MoE-FFN step's MFU residual.

Counterpart of ``rocnrdma_tpu/bench/mfu_profile.py``. The headline's MFU
leg (``bench/headline.py``) counts only the two expert matmuls
(4 T d ffn flops); this CLI says where the rest of the step goes, two ways:

1. Ablation timing, by the same two-depth chained marginal: the FULL step,
   the EXPERT EINSUMS alone (the two matmuls and the gelu the MFU counts),
   and the ROUTING-only step (router -> dispatch -> alltoall -> combine
   with an identity expert). full ~= einsum + routing, less what the card
   overlaps. On the card each variant's step is also split into its host
   enqueue time and its device time (``timing.enqueue_s`` / ``device_s``),
   which says whether the step waits on the host.
2. ``--profile DIR``: a ``torch.profiler`` trace (CPU and CUDA activity) of
   an 8-step full chain, written as ``DIR/trace.json``, and the top ops by
   device time from ``key_averages()`` (a trace with no device activity
   fails the run; on the CPU the ops go by host time).

    python -m rocnrdma_tpu_torch.bench.mfu_profile [--profile DIR] [--out rows.jsonl]
    python -m rocnrdma_tpu_torch.bench.mfu_profile --platform cpu   # plumbing only
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

from rocnrdma_tpu_torch import hw
from rocnrdma_tpu_torch.bench import cli_common
from rocnrdma_tpu_torch.bench.headline import mfu_inputs, mfu_shape, one_expert_step
from rocnrdma_tpu_torch.bench.timing import device_s, enqueue_s, marginal_trials
from rocnrdma_tpu_torch.runtime import rank_mesh
from rocnrdma_tpu_torch.transport import Transport

VARIANTS = ("full", "einsum", "routing")


def build_step(T: int, d: int, ffn: int, dtype: torch.dtype, variant: str,
               device: torch.device):
    """(chain builder, args) for one step variant, built as the headline's
    MFU leg builds the step (same draws, same ``moe_topk_step`` wiring).

    ``full``: router + dispatch + FFN + combine; ``einsum``: the expert FFN
    alone on the ``(1, T, d)`` tokens as one expert's slots; ``routing``:
    the full step with an identity expert."""
    from rocnrdma_tpu_torch.workloads.moe import ffn_expert, moe_topk_step
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; know {VARIANTS}")
    w_in, w_out, tokens, logits = mfu_inputs(T, d, ffn, dtype, device)
    t = Transport(rank_mesh(1, device))
    if variant == "einsum":
        exp = ffn_expert(w_in, w_out)

        def body(y, lg):
            # (1, T, d) -> one expert's (..., E, cap, d) slots and back
            return exp(y[None]).reshape(y.shape).to(dtype)
    else:
        step = (one_expert_step(t, T, w_in, w_out) if variant == "full"
                else moe_topk_step(t, "auto", False, 1, T, 1))

        def body(y, lg):
            return step(y, lg)[0].to(dtype)

    def make_chain(k):
        def chain(tok, lg):
            y = tok
            for _ in range(k):
                y = body(y, lg)
            return y
        return chain
    return make_chain, (tokens, logits)


NAME_CHARS = 120  # a kernel's name is cut to this many characters


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def top_ops(prof, n: int = 20, clock: str = "device") -> list[tuple[str, float, int]]:
    """[(name, total ms, count)] of a finished ``torch.profiler.profile``,
    heaviest first: with ``clock="device"`` the kernels the card ran (each
    kernel once: the host ops that launched them are left out, their
    device time is the kernels'), with ``"cpu"`` the host ops by their own
    CPU time. Names are cut to ``NAME_CHARS``."""
    rows = []
    for evt in prof.key_averages():
        on_card = evt.device_type != torch.autograd.DeviceType.CPU
        if clock == "device":
            us = _device_us(evt) if on_card else 0.0
        else:
            us = 0.0 if on_card else float(evt.self_cpu_time_total)
        if us > 0:
            rows.append((evt.key[:NAME_CHARS], us / 1e3, int(evt.count)))
    rows.sort(key=lambda r: -r[1])
    return rows[:n]


def chain_top_ops(prof, on_card: bool) -> tuple[str, list]:
    """``(clock, top_ops(prof, clock=clock))``: the device clock on the
    card, the host clock on the CPU. On the card a profile with no device
    activity is an error: its host times would pass for the card's."""
    clock = "device" if on_card else "cpu"
    ops = top_ops(prof, clock=clock)
    if on_card and not ops:
        raise RuntimeError("torch.profiler recorded no CUDA activity in the chain")
    return clock, ops


def profile_chain(make_chain, xs, out_dir: str, steps: int = 8):
    """Run a ``steps``-deep chain once under ``torch.profiler`` (CPU and,
    on the card, CUDA activity) after a warm run; writes
    ``out_dir/trace.json`` and returns the profiler."""
    device = xs[0].device
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    f = make_chain(steps)
    with torch.no_grad():
        f(*xs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=acts) as prof:
            f(*xs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return prof


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mfu_profile", description=__doc__.split("\n\n")[0])
    p.add_argument("--tokens", type=int, default=4096)
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--ffn", type=int, default=8192)
    p.add_argument("--k1", type=int, default=4)
    p.add_argument("--k2", type=int, default=48)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="also profile the full chain and print its top ops "
                        "(by device time on the card)")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    p.add_argument("--out", default=None, help="append one JSON row here")
    args = p.parse_args(argv)

    topo = cli_common.setup_backend(1, args.platform)
    device, kind, on_cpu = topo.device, topo.device_name, topo.is_oracle
    if on_cpu:  # the CPU checks the plumbing at the headline's CPU shape
        T, d, ffn, dtype = mfu_shape(True)
        k1, k2, reps, trials = 2, 8, 3, 1
    else:
        T, d, ffn, dtype = args.tokens, args.d_model, args.ffn, torch.bfloat16
        k1, k2, reps, trials = args.k1, args.k2, args.repeats, args.trials
    flops = 4 * T * d * ffn
    chip = hw.chip_for(kind)
    peak = chip.bf16_tflops * 1e12 if chip else 1e12

    res, split = {}, {}
    with torch.no_grad():
        for variant in VARIANTS:
            mk, xs = build_step(T, d, ffn, dtype, variant, device)
            res[variant] = statistics.median(
                marginal_trials(mk, xs, k1=k1, k2=k2, repeats=reps, trials=trials))
            line = f"# {variant:8s} {res[variant] * 1e6:8.0f} us/step"
            if variant in ("full", "einsum"):
                line += (f"  ({flops / res[variant] / 1e12:6.1f} TFLOP/s, "
                         f"MFU {flops / res[variant] / peak:.2f})")
            if not on_cpu:  # is the step host-bound? one step, host vs card
                one = mk(1)
                h = enqueue_s(lambda: one(*xs), 20)
                split[variant] = (h, device_s(lambda: one(*xs), 20, h))
                line += (f"; host enqueue {split[variant][0] * 1e6:.0f} us, device "
                         f"{split[variant][1] * 1e6:.0f} us a step")
            print(line, flush=True)

    full, einsum, routing = res["full"], res["einsum"], res["routing"]
    row = {"bench": "mfu_profile", "T": T, "d": d, "ffn": ffn,
           "dtype": str(dtype).removeprefix("torch."),
           "full_us": round(full * 1e6, 1), "einsum_us": round(einsum * 1e6, 1),
           "routing_us": round(routing * 1e6, 1),
           "overlap_us": round((einsum + routing - full) * 1e6, 1),
           "mfu_full": round(flops / full / peak, 3),
           "mfu_einsum_only": round(flops / einsum / peak, 3),
           "device_kind": kind, "platform": topo.platform}
    for variant, (h, dv) in split.items():
        row[f"{variant}_host_us"] = round(h * 1e6, 1)
        row[f"{variant}_device_us"] = round(dv * 1e6, 1)
    print(f"# attribution: full = einsum ({einsum / full:.0%}) + routing "
          f"({routing / full:.0%}) - overlap ({(einsum + routing - full) / full:.0%}); "
          f"einsum-only MFU {row['mfu_einsum_only']:.2f} bounds any dispatch "
          f"restructuring", flush=True)

    if args.profile:
        mk, xs = build_step(T, d, ffn, dtype, "full", device)
        clock, ops = chain_top_ops(profile_chain(mk, xs, args.profile), not on_cpu)
        row["top_ops_clock"] = clock
        row["top_ops"] = [[nm, round(ms, 3), ct] for nm, ms, ct in ops]
        print(f"# top ops by {clock} time (total ms over an 8-step chain):")
        for nm, ms, ct in row["top_ops"]:
            print(f"#   {ms:9.3f} ms  x{ct:<4d} {nm}")

    if args.out:
        with open(args.out, "a") as fp:
            fp.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
