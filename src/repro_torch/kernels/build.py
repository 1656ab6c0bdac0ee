"""Build the CUDA C++ kernels with ``nvcc`` at first use and load them with
``ctypes``.

Each source under ``csrc/`` has a plain C interface and compiles on its own
into a shared library for ``sm_90a`` (the H100's full feature set)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

Libraries go to ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of their source and the shared headers (``csrc/*.cuh``)
so an edited kernel is rebuilt; the compiler's output is kept beside each
library (``<lib>.log``), so a cached build still reports its registers. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them. Each lands
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
SOURCES = {"vtrace": CSRC / "vtrace.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "decode_attention": CSRC / "decode_attention.cu",
           "ssd_chunk": CSRC / "ssd_chunk.cu"}
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
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, dict]:
    """Compile every kernel in ``names`` (default: all) that is not built
    yet, one ``nvcc`` process per source, all started together. Returns
    each kernel's library path, build seconds (0.0 when it was already
    built) and the compiler's output (``ptxas`` registers and spills) from
    the build that made the library. Raises if any build fails."""
    names = list(SOURCES if names is None else names)
    results: Dict[str, dict] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            results[name] = {"path": str(out), "seconds": 0.0,
                             "log": log.read_text() if log.exists() else ""}
            continue
        compiler = nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        results[name] = {"path": str(out), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return results


def build(name: str) -> dict:
    """``build_all`` of the one kernel ``name``."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build(name)["path"]
        lib = _loaded[name] = ctypes.CDLL(path)
    return lib
