"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` under the
repository root (listed in ``.gitignore``), then loaded with ``ctypes``.
The library's file name carries a hash of the source and the flags, so
a process builds a source at most once and an edited source is rebuilt.
Building happens at first use, never at import.  A failed build raises
with nvcc's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float        # nvcc wall time in this process (0 if cached)
    log: str              # nvcc's output, incl. the ptxas -v lines


_LOADED: Dict[str, Built] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def build(name: str) -> Built:
    """Compile (or reuse) ``csrc/<name>.cu`` and return the loaded
    library with its build record."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}-{digest}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                               f"{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, so)          # atomic: concurrent builders agree
    log = log_path.read_text() if log_path.exists() else ""
    built = Built(lib=ctypes.CDLL(str(so)), path=so, seconds=seconds, log=log)
    _LOADED[name] = built
    return built
