#!/usr/bin/env python3
"""Static SASS instruction counts of CUDA kernel sources, per kernel.

    python3 scripts/sass_count.py SRC.cu [SRC.cu ...] [--out counts.json]
    python3 scripts/sass_count.py --k3-probe OLD/approx_mul_eltwise.cu NEW/approx_mul_eltwise.cu

Each source is compiled by ``nvcc`` for ``sm_90a`` (the flags of
``repro_torch.kernels._build``) to a cubin, disassembled by ``cuobjdump
-sass``, and the instructions of each kernel function counted (NOPs
excluded), with the registers and spills that ``ptxas -v`` reports.  Runs
where the CUDA toolkit is (the machine with the card); compares, for
example, two versions of one kernel source.

``--k3-probe`` measures what a static count of K3's grid-stride loop hides
(a version that takes 16 codes per pass unrolls more than one that takes
4): each source is included in a probe that evaluates its ``mul8x8`` once
per thread for each multiplier, beside a probe of the exact ``a * b``, and
the difference is the instructions per element of the bit logic.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels._build import ARCH_FLAGS, _nvcc  # noqa: E402

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([A-Z][A-Z0-9_.]*|@!?U?P\w+\s+[A-Z][A-Z0-9_.]*)")


def count(src: Path) -> dict:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        ptxas = subprocess.run([nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
                                "-cubin", "-o", str(cubin), str(src)],
                               capture_output=True, text=True, check=True).stderr
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = {"instructions": 0}
        elif name and _INSN.search(line) and " NOP" not in line:
            kernels[name]["instructions"] += 1
    # ptxas: "Compiling entry function 'X'" then "Used N registers ... "
    entry = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in kernels:
            kernels[entry]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry in kernels:
            kernels[entry]["spill_store_bytes"] = int(m.group(1))
    return kernels


_PROBE = """#include "{src}"
#define PROBE(name, expr) \\
  __global__ void name(const int* a, const int* b, int* o) {{ \\
    const int i = threadIdx.x; const int x = a[i], y = b[i]; o[i] = (expr); }}
PROBE(probe_exact, x * y)
PROBE(probe_mul8x8_1, (mul8x8<1, false>(x, y)))
PROBE(probe_mul8x8_2, (mul8x8<2, false>(x, y)))
PROBE(probe_mul8x8_3, (mul8x8<2, true>(x, y)))
"""


def k3_probe(src: Path) -> dict:
    """Instructions per element of ``mul8x8`` for mul8x8_1/2/3: each probe
    kernel's count minus the exact-product probe's."""
    with tempfile.TemporaryDirectory() as tmp:
        probe = Path(tmp) / "probe.cu"
        probe.write_text(_PROBE.format(src=src.resolve()))
        counts = count(probe)
    by = {}
    for k, v in counts.items():
        m = re.search(r"probe_(exact|mul8x8_[123])", k)
        if m:
            by[m.group(1)] = v["instructions"]
    if "exact" not in by:
        return {"error": "no probe kernels found", "functions": counts}
    return {k: by[k] - by["exact"] for k in by if k != "exact"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--k3-probe", action="store_true",
                    help="instructions per element of each source's mul8x8")
    args = ap.parse_args(argv)
    fn = k3_probe if args.k3_probe else count
    report = {src: fn(Path(src)) for src in args.sources}
    text = json.dumps(report, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
