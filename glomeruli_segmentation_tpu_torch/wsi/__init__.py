"""Whole-slide I/O with an OpenSlide-compatible surface: the port's copies
of the JAX package's C++ reader (:mod:`.native_reader`) and pure-Python
reader (:mod:`.tiff_reader`), the slide property names, and
:func:`open_slide`."""
import sys
import threading

from . import native_reader
from .native_reader import NativeSlide
from .tiff_reader import Slide, TiffParseError  # noqa: F401

# OpenSlide's property names, as the JAX package's ``wsi`` names them
PROPERTY_NAME_MPP_X = "openslide.mpp-x"
PROPERTY_NAME_MPP_Y = "openslide.mpp-y"
PROPERTY_NAME_OBJECTIVE_POWER = "openslide.objective-power"

_fallback_lock = threading.Lock()
_warned_unavailable = False
# slides this process opened with the pure-Python reader because the native
# one could not open them
python_fallbacks = 0


def open_slide(path: str):
    """Open a pyramidal slide (TIFF/BigTIFF/NDPI).  API mirrors
    ``openslide.open_slide``.

    Prefers the C++ :class:`.native_reader.NativeSlide`, as the JAX
    package's ``open_slide`` does, and falls back to the pure-Python
    :class:`.tiff_reader.Slide` where the native reader cannot open the
    file: both read the same pixels, and a host without a C++ compiler
    still reads slides.  The fallback is not silent: it counts in
    :data:`python_fallbacks` and says why on stderr, once per process when
    the library is unavailable (the reason stays in
    ``native_reader.unavailable_reason``), and for each file the library
    refused."""
    global python_fallbacks, _warned_unavailable
    try:
        return NativeSlide(path)
    except OSError as e:
        native_error = e
    slide = Slide(path)  # raises where the file is bad for both readers
    with _fallback_lock:
        python_fallbacks += 1
        reason = native_reader.unavailable_reason
        if reason is None:
            print(f"open_slide: the native reader refused {path} "
                  f"({native_error}); reading it with the Python reader",
                  file=sys.stderr)
        elif not _warned_unavailable:
            _warned_unavailable = True
            print("open_slide: the native slide reader is unavailable; "
                  "reading slides with the Python reader. Reason:\n"
                  + reason, file=sys.stderr)
    return slide
