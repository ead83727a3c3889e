"""Build and load the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface.
``build(name)`` compiles it with ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<hash>.so`` at first use; the hash covers the
source, every ``csrc/*.cuh`` header it includes, and the flags, so an edit
to a header shared by two kernels rebuilds both.  ``library(name)`` loads
the result through ``ctypes``.  Nothing here runs at import time: the CPU
tests import every module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("the port's CUDA kernels need nvcc, which is not "
                           "installed")
    return path


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, transitively."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def target(name: str) -> Path:
    """Where the library of ``name`` built from the present sources and
    flags lives: ``build/kernels/<name>-<hash>.so``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` into ``build/kernels/`` unless a library
    built from the same sources and flags is already there; returns its
    path.  ``verbose`` prints ``ptxas``'s register and memory use."""
    out = target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stderr}")
    if verbose:
        print(res.stderr, end="")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it (each kernel module keeps the
    handle it binds)."""
    return ctypes.CDLL(str(build(name)))
