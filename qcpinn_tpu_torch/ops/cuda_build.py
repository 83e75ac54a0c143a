"""nvcc builds of the port's CUDA sources (``ops/csrc/*.cu``).

Each source compiles on its own into a shared library with a plain C
interface (loaded with ctypes), for ``sm_90a``, at first use. Outputs land
in the git-ignored ``csrc/_build/``, keyed by a hash of the source and the
flags, so a changed source rebuilds and an unchanged one is reused.
:func:`build_all` starts one nvcc per source, all together.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

Built = Tuple[str, float, str]  # (library path, seconds compiling, ptxas report)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    """Build output of ``csrc/<name>.cu``, keyed by a hash of the source
    and the flags."""
    with open(source(name), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{key.hexdigest()[:16]}.so")


def build_all(names: Sequence[str]) -> Dict[str, Built]:
    """Compile every named source that has no hashed output yet, one nvcc
    process per source, all started together. Raises on the first failure
    (after every process has ended)."""
    out: Dict[str, Built] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            out[name] = (path, 0.0, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (path, tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
            continue
        os.replace(tmp, path)
        out[name] = (path, seconds, stderr)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless its hashed output exists."""
    return build_all([name])[name]
