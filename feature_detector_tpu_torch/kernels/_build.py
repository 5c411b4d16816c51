"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled,
at first use, into ``build/fd_torch_kernels/lib<name>-<hash>.so`` at the root
of the checkout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The file name carries a hash of the source and the flags, so an edited
source is never served by a stale library.  Nothing is compiled or loaded
when this module is imported.
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

from ..utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fd_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
KERNELS = ("greedy", "lsd_flood", "fixed_order", "fast")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS, ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compiles every named kernel that is not built yet, one nvcc per
    source, all started together.  Returns, per name, the library path, the
    seconds its nvcc took (0 when it was already built) and the compiler's
    output.  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    report = {}
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            report[name] = {"path": str(lib), "seconds": 0.0, "log": ""}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        report[name] = {"path": str(lib), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with trace.setup_span("setup.kernel_load"):
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
