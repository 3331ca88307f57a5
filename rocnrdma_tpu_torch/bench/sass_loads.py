"""``sass_loads`` - how many global loads each kernel of a CUDA source has
in flight before it adds: compile the source for ``sm_90a`` with ``nvcc
-cubin -Xptxas -v``, disassemble it with ``cuobjdump -sass`` and print, per
kernel, its registers and spill bytes (ptxas), its loads from global or
generic addresses (``LDG``, ``LD``; not shared, constant or local ones),
and ``loads_before_add``: the most such loads in one stretch of the
instruction stream with no floating-point add (``FADD``) between them. A
kernel whose loop loads an operand, then adds it, then loads the next,
shows 1 or 2; one that issues every operand's loads first shows their
count. Needs ``nvcc`` and ``cuobjdump`` (the machine with the card).

    python -m rocnrdma_tpu_torch.bench.sass_loads \\
        rocnrdma_tpu_torch/ops/csrc/combine.cu rocnrdma_tpu_torch/ops/csrc/ring.cu \\
        --out chiprun_out/sass.jsonl
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from rocnrdma_tpu_torch.ops import _build

_FUNC = re.compile(r"^\s*Function : (\S+)")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cu++filt")
    if not os.access(tool, os.X_OK):
        return {n: n for n in names}
    out = subprocess.run([tool, *names], capture_output=True, text=True,
                         check=True).stdout.split("\n")
    return dict(zip(names, out))


def _ptxas(log: str) -> dict[str, dict]:
    """Registers and spill bytes per mangled kernel from ``-Xptxas -v``."""
    info, fn = {}, None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            fn = m.group(1)
            info[fn] = {}
        elif fn and (m := _SPILL.search(line)):
            info[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif fn and (m := _REGS.search(line)):
            info[fn]["registers"] = int(m.group(1))
    return info


def _loads(sass: str) -> dict[str, dict]:
    """Global/generic load count and the longest run of them between FADDs
    per kernel."""
    out, fn = {}, None
    for line in sass.splitlines():
        if m := _FUNC.match(line):
            fn = m.group(1)
            out[fn] = {"ldg": 0, "loads_before_add": 0, "_run": 0}
            continue
        if fn is None or "/*" not in line:
            continue
        op = line.split("*/", 1)[-1].strip().split(" ")
        op = next((w for w in op if w and not w.startswith("@")), "")
        rec = out[fn]
        if op.startswith(("LDG", "LD.")):
            rec["ldg"] += 1
            rec["_run"] += 1
            rec["loads_before_add"] = max(rec["loads_before_add"], rec["_run"])
        elif op.startswith("FADD"):
            rec["_run"] = 0
    for rec in out.values():
        del rec["_run"]
    return out


def probe(src: str) -> list[dict]:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tag = hashlib.sha256(os.path.abspath(src).encode()).hexdigest()[:8]
    cubin = os.path.join(_build.BUILD_DIR, f"sass_{tag}.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_build.nvcc_path(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin, src]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    regs, loads = _ptxas(log), _loads(sass)
    names = _demangle(sorted(loads))
    return [{"source": src, "kernel": names[fn], **regs.get(fn, {}), **loads[fn]}
            for fn in sorted(loads)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sass_loads", description=__doc__.split("\n")[0])
    p.add_argument("sources", nargs="+")
    p.add_argument("--out", default=None, help="append JSONL rows here")
    args = p.parse_args(argv)
    rows = [r for src in args.sources for r in probe(src)]
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "a") as fp:
            for r in rows:
                fp.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
