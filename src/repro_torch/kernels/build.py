"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). Libraries go to ``_build/`` beside this file, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. Builds happen at first use, or up front through
:func:`build`. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

KERNELS = ("paged_attention",)
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries, by kernel name (a library never changes once loaded)
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing. Returns, per
    kernel, the build's seconds (0 for a reused library) and ``ptxas``'s
    register, shared memory and spill lines. Raises with the compiler's
    output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info: Dict[str, dict] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "reused": True, "ptxas": []}
            continue
        # compiled beside its final name and renamed, so an interrupted
        # build never leaves a library that a later call would reuse
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(CSRC / f"{name}.cu")],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        info[name] = {
            "seconds": time.perf_counter() - t0, "reused": False,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "ptxas info" in ln or "spill" in ln]}
    return info


def load(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built first if it is missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
