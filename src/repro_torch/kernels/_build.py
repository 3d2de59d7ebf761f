"""Build the CUDA kernels under ``csrc/`` and bind them through ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), all sources in parallel, the first time any kernel is
needed.  Libraries land in ``kernels/build/`` (listed in ``.gitignore``),
named by the hash of their source, so an edited source is rebuilt and an
unchanged one is reused within a checkout.

Nothing here runs at import: the CPU tests import every module of the
package, and that machine has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

__all__ = ["KernelBuildError", "KernelLaunchError", "build_all", "library",
           "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error (``cudaGetLastError``)."""


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels are built on the machine with the card"
    )


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel, and
    load every library.  Returns ``{name: seconds}`` for the sources built
    by this call (0.0 for one that was already built)."""
    srcs = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in srcs:
        out = _target(src)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    secs = {src.stem: 0.0 for src in srcs}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(log)
    if errors:
        raise KernelBuildError("\n".join(errors))
    for src in srcs:
        if src.stem not in _LIBS:
            _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    kernel on first use)."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]
