"""Build the native slide reader (``ndpi_reader.cc``) at first use.

The host compiler's counterpart of ``ops/_build.py``: ::

    g++ -O3 -fPIC -shared -std=c++17 -I include ndpi_reader.cc \\
        LIBJPEG LIBZ -Wl,-rpath,DIR... -lpthread

into ``build/native_reader/_ndpi_reader-<hash>.so`` beside the package,
where ``<hash>`` covers the source, the headers, the flags and the two
libraries' paths, so an edited source or another library is rebuilt and an
unchanged one is reused.  The compiler writes a temporary file that is
renamed into place, and an ``flock`` on ``build/native_reader/lock``
serialises the builds of several processes (pytest workers, the server
and its warm-up), so no process loads a half-written library and a build
is not repeated; the kernel holds the lock only while its process lives.

Headers: ``include/`` holds the libjpeg-turbo 2.1.5 headers
(``JPEG_LIB_VERSION 62``; ``jconfig.h`` is the x86_64 one) and zlib
1.2.13's, with their licences, so the build needs no ``-dev`` package.
Libraries are linked by path, with an rpath to their directory, so the
loader finds the same file the build linked:

- libjpeg: a ``libjpeg.so.62`` that the system loader knows
  (``ldconfig -p``) where there is one, else the ``libjpeg-*.so.62*`` that
  PIL's wheel ships in ``pillow.libs`` (the same ABI, version 62);
- zlib: the system's ``libz.so.1`` (PIL 12's wheel ships no zlib).

The GPU host the port runs on (an H100 machine: x86_64, so the x86_64
``jconfig.h`` holds; g++ 13.3.0; PIL 12.2.0) has no ``jpeglib.h`` and no
``libjpeg.so.62`` known to ``ldconfig``; PIL's ``pillow.libs`` there holds
``libjpeg-8296d2fa.so.62.4.0`` (soname the same; it needs only libc),
which exports 89 ``jpeg_*`` entry points at symbol version
``LIBJPEG_6.2``; ``zlib.h`` and the system ``libz.so.1`` (zlib 1.3) are
present.  So there the reader links PIL's libjpeg, the same library PIL
decodes the Python reader's tiles with, and the system zlib.

Nothing is built when this module is imported.
"""
from __future__ import annotations

import fcntl
import glob
import hashlib
import importlib.util
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional, Tuple

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "ndpi_reader.cc"
INCLUDE = HERE / "include"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native_reader"
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
# (the system soname, the pattern of PIL's bundled copy, if it has one)
LIBRARIES = (("libjpeg.so.62", "libjpeg-*.so.62*"), ("libz.so.1", None))
# ldconfig's tag for this machine's word size and architecture
_LDCONFIG_ARCH = {"x86_64": "x86-64", "aarch64": "AArch64"}

# seconds and compiler output of the build this process ran, if any
build_log: Optional[Tuple[float, str]] = None


def _system_library(soname: str) -> Optional[str]:
    """The path ``ldconfig -p`` gives for ``soname`` on this architecture."""
    ldconfig = shutil.which("ldconfig") or next(
        (p for p in ("/sbin/ldconfig", "/usr/sbin/ldconfig")
         if os.path.isfile(p)), None)
    if ldconfig is None:
        return None
    try:
        listing = subprocess.run([ldconfig, "-p"], capture_output=True,
                                 text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    arch = _LDCONFIG_ARCH.get(platform.machine(), "")
    for line in listing.splitlines():
        name, _, rest = line.strip().partition(" ")
        if name == soname and arch in rest and "=>" in rest:
            path = rest.split("=>", 1)[1].strip()
            if os.path.isfile(path):
                return path
    return None


def _pillow_library(pattern: str) -> Optional[str]:
    """The library matching ``pattern`` in PIL's ``pillow.libs``, found
    without importing PIL."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    libs = Path(list(spec.submodule_search_locations)[0]).parent \
        / "pillow.libs"
    found = sorted(glob.glob(str(libs / pattern)))
    return found[0] if found else None


def libraries() -> List[str]:
    """The libjpeg and zlib files the reader links; raise ``OSError`` when
    one is missing."""
    paths = []
    for soname, pattern in LIBRARIES:
        path = _system_library(soname) or (
            pattern and _pillow_library(pattern))
        if not path:
            raise OSError(f"no {soname}: the system loader has none" + (
                f", nor PIL's pillow.libs ({pattern})" if pattern else ""))
        paths.append(path)
    return paths


def _command(out: Path, libs: List[str]) -> List[str]:
    rpaths = sorted({os.path.dirname(p) for p in libs})
    return [CXX, *CXX_FLAGS, "-I", str(INCLUDE), "-o", str(out), str(SOURCE),
            *libs, *(f"-Wl,-rpath,{d}" for d in rpaths), "-lpthread"]


def library_path(libs: List[str]) -> Path:
    """The library's path; its hash covers the source, every header under
    ``include/``, the flags and the linked libraries' paths."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    for header in sorted(INCLUDE.glob("*.h")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_command(Path("out"), libs)).encode())
    return BUILD_DIR / f"_ndpi_reader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The path of the built reader, compiling it first if it is missing;
    raise ``OSError`` with the compiler's output if that fails."""
    global build_log
    libs = libraries()
    out = library_path(libs)
    if out.exists():
        return out
    if shutil.which(CXX) is None:
        raise OSError(f"{CXX} not found: the native slide reader needs a "
                      "C++17 compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(_command(tmp, libs), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise OSError(f"{CXX} failed on {SOURCE.name} "
                          f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)
        build_log = (time.perf_counter() - t0, proc.stdout)
    return out
