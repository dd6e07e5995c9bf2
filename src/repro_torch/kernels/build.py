"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`.  Libraries are
built at first use into ``src/repro_torch/_build/`` (ignored by git), named by
a hash of the source and the flags so an edited source is never served from
a stale library.  Several sources build in parallel, one ``nvcc`` each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_NVCC_TIMEOUT_S = 900


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels can only be built where the CUDA toolkit is")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that has no current library, all ``nvcc``
    processes started together.  Returns ``{name: compiler report}`` (the
    ``-Xptxas -v`` register and shared-memory lines; empty for a library
    that was already built).  Raises on the first failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports: Dict[str, str] = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                reports[name] = ""
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ), tmp, out)
        for name, (proc, tmp, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=_NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
                    f"{stdout}{stderr}"
                )
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
            reports[name] = stdout + stderr
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(_target(name)))
