"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and may include the
``csrc/*.cuh`` headers.  ``nvcc`` compiles it for Hopper (``sm_90a``) into
``build/torch_kernels/<name>-<hash>.so`` beside the package, where
``<hash>`` covers the source, the headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  The library is loaded
with ``ctypes``.  Nothing is built or loaded when this module is imported.
The processes of a host (the ranks of a data-parallel trainer) build under
one ``flock`` on ``build/torch_kernels/lock``, so a host runs each ``nvcc``
once and the others load what it built.
"""
from __future__ import annotations

import ctypes
import fcntl
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
    """The library's path; its hash covers the source, every header under
    ``csrc/`` (an edited header rebuilds each source) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source whose library is missing, starting one
    ``nvcc`` per source at once, under the host's build lock; raise with
    the compiler's output if any fails."""
    names = [n for n in names if not library_path(n).exists()]
    if not names:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_locked(names)


def _build_locked(names: Iterable[str]) -> None:
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():  # another process built it while this one waited
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
            tmp.unlink(missing_ok=True)
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
