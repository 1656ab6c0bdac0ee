"""Build the CUDA C++ kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each source under ``csrc/`` has a plain C interface and compiles on its own
into a shared library for ``sm_90a`` (the H100's full feature set)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

Libraries go to ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of their source so an edited kernel is rebuilt. Each lands
through a temporary file and ``os.replace``, so processes that build at
the same time never load a half-written library. Nothing here runs at
import time; a failed or impossible build raises.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = {"vtrace": CSRC / "vtrace.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> dict:
    """Compile kernel ``name`` unless it is built already. Returns its
    library path, build seconds (0.0 when it was already built) and the
    compiler's output (``ptxas`` registers and spills). Raises if the build
    fails."""
    out = library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *NVCC_FLAGS, "-o", tmp,
                           str(SOURCES[name])], capture_output=True,
                          text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build(name)["path"]
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
