"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface.  ``nvcc`` compiles it for
Hopper (``sm_90a``) into ``build/torch_kernels/<name>-<hash>.so`` beside the
package, where ``<hash>`` covers the source and the flags, so an edited
source is rebuilt and an unchanged one is reused.  The library is loaded
with ``ctypes``.  Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# every kernel source of the port, built together by build_all()
SOURCES = ("esp_block", "esp_block_dma", "nms")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc output) for the sources built by this process
build_log: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, starting one
    ``nvcc`` per source at once; raise with the compiler's output if any
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out, time.perf_counter()))
    failed = []
    for name, proc, tmp, out, t0 in running:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        build_log[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all() -> None:
    build(SOURCES)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
