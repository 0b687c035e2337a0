"""ctypes wrapper over the C++ slide reader (``wsi/native/ndpi_reader.cc``).

Same surface as :class:`.tiff_reader.Slide`; :func:`..wsi.open_slide`
prefers this reader.  The port's counterpart of
``glomeruli_segmentation_tpu/wsi/native_reader.py``: the library is the
port's own, compiled from the port's copy of the source at first use by
:mod:`.native._build` (``g++`` into ``build/native_reader/``), never when
this module is imported.  Each ``read_region_array`` is one ctypes call,
which releases the GIL while the reader decodes tiles on its thread pool.

Where the library cannot be built or loaded, :data:`unavailable_reason`
holds why (the compiler's output, or the ``OSError``), and every later
:class:`NativeSlide` raises ``OSError`` with it without trying again.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .native import _build

_lock = threading.Lock()
_lib = None
# why the library could not be built or loaded; None until that happens
unavailable_reason: Optional[str] = None


def _load_lib():
    global _lib, unavailable_reason
    with _lock:
        if _lib is not None:
            return _lib
        if unavailable_reason is not None:
            raise OSError(unavailable_reason)
        try:
            lib = ctypes.CDLL(str(_build.build()))
        except OSError as e:
            unavailable_reason = str(e)
            raise
        lib.gs_open.restype = ctypes.c_void_p
        lib.gs_open.argtypes = [ctypes.c_char_p]
        lib.gs_close.argtypes = [ctypes.c_void_p]
        lib.gs_level_count.restype = ctypes.c_int
        lib.gs_level_count.argtypes = [ctypes.c_void_p]
        lib.gs_level_dimensions.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        for name in ("gs_mpp_x", "gs_mpp_y", "gs_objective_power"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_double
            fn.argtypes = [ctypes.c_void_p]
        lib.gs_chunk_decodes.restype = ctypes.c_int64
        lib.gs_chunk_decodes.argtypes = [ctypes.c_void_p]
        lib.gs_ndpi_index_mode.restype = ctypes.c_int
        lib.gs_ndpi_index_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gs_read_region.restype = ctypes.c_int
        lib.gs_read_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return lib


class NativeSlide:
    def __init__(self, path: str):
        lib = _load_lib()
        self._lib = lib
        self._handle = lib.gs_open(path.encode())
        if not self._handle:
            raise OSError(f"native reader could not open {path}")
        self.path = path
        self.properties = self._build_properties()

    # ---------------- openslide-compatible surface ----------------
    @property
    def level_count(self) -> int:
        return self._lib.gs_level_count(self._handle)

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        dims = []
        for level in range(self.level_count):
            w = ctypes.c_int64()
            h = ctypes.c_int64()
            self._lib.gs_level_dimensions(self._handle, level,
                                          ctypes.byref(w), ctypes.byref(h))
            dims.append((w.value, h.value))
        return dims

    @property
    def dimensions(self) -> Tuple[int, int]:
        return self.level_dimensions[0]

    @property
    def level_downsamples(self) -> List[float]:
        dims = self.level_dimensions
        return [dims[0][0] / w for w, _ in dims]

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, d in enumerate(self.level_downsamples):
            if d <= downsample + 1e-6:
                best = i
        return best

    def _build_properties(self) -> Dict[str, str]:
        props = {}
        mpp_x = self._lib.gs_mpp_x(self._handle)
        mpp_y = self._lib.gs_mpp_y(self._handle)
        if mpp_x > 0:
            props["openslide.mpp-x"] = str(mpp_x)
            props["openslide.mpp-y"] = str(mpp_y or mpp_x)
        objective = self._lib.gs_objective_power(self._handle)
        if objective > 0:
            props["openslide.objective-power"] = str(int(objective))
        props["openslide.level-count"] = str(self.level_count)
        for i, (w, h) in enumerate(self.level_dimensions):
            props[f"openslide.level[{i}].width"] = str(w)
            props[f"openslide.level[{i}].height"] = str(h)
            props[f"openslide.level[{i}].downsample"] = str(
                self.level_downsamples[i])
        return props

    @property
    def chunk_decodes(self) -> int:
        """Restart-chunk decodes since open (single-strip JPEG levels)."""
        return self._lib.gs_chunk_decodes(self._handle)

    def ndpi_index_mode(self, level: int) -> int:
        """0 = no virtual-tile index, 1 = entropy-stream marker scan,
        2 = indexed from the NDPI McuStarts tag (65426)."""
        return self._lib.gs_ndpi_index_mode(self._handle, level)

    def read_region_array(self, location, level, size) -> np.ndarray:
        x, y = location
        w, h = size
        out = np.empty((h, w, 3), np.uint8)
        rc = self._lib.gs_read_region(
            self._handle, level, int(x), int(y), int(w), int(h),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            raise IOError(f"native read_region failed ({rc}) on {self.path}")
        return out

    def read_region(self, location, level, size):
        from PIL import Image

        rgb = self.read_region_array(location, level, size)
        rgba = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
        return Image.fromarray(rgba, mode="RGBA")

    def close(self):
        if self._handle:
            self._lib.gs_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
