"""Whole-slide I/O with an OpenSlide-compatible surface: the port's copy of
the JAX package's pure-Python reader (:mod:`.tiff_reader`), the slide
property names, and :func:`open_slide`."""
from .tiff_reader import Slide, TiffParseError  # noqa: F401

# OpenSlide's property names, as the JAX package's ``wsi`` names them
PROPERTY_NAME_MPP_X = "openslide.mpp-x"
PROPERTY_NAME_MPP_Y = "openslide.mpp-y"
PROPERTY_NAME_OBJECTIVE_POWER = "openslide.objective-power"


def open_slide(path: str) -> Slide:
    """Open a pyramidal slide (TIFF/BigTIFF/NDPI) with the pure-Python
    :class:`.tiff_reader.Slide`.  API mirrors ``openslide.open_slide``.

    The JAX package's ``open_slide`` prefers its C++ reader
    (``wsi/native``) when that library loads; the port has no native
    reader yet, so every slide goes through the pure-Python one.  Both
    read the same pixels."""
    return Slide(path)
