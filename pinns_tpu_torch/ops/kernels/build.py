"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each source in ``pinns_tpu_torch/csrc/`` exposes a plain ``extern "C"``
interface, so it compiles in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/pinns_tpu_torch/lib<name>-<hash>.so <name>.cu

The library goes to ``build/pinns_tpu_torch/`` at the repository root, named
by a hash of its source, so an edited source rebuilds and an unchanged one
loads the existing library. The compiler's output (ptxas register and
shared-memory report included) is kept beside it as ``.log``. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pinns_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}  # name -> nvcc wall time in this process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(candidate):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
            "are built from source at first use and need the CUDA toolkit"
        )
    return candidate


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # build into a private temp file, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, str(CSRC / f"{name}.cu"),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)


def load_library(name: str) -> ctypes.CDLL:
    """The compiled library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def build_log(name: str) -> str:
    """The compiler output of the current build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
