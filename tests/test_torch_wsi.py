"""The port's slide readers and synthetic slide writer (``wsi/``) against
the JAX package's: the same geometry, properties and pixels from JPEG and
uncompressed tiled pyramids and from an NDPI-like strip file, the same
parse errors, and byte-identical files from both writers."""
import sys

import numpy as np
import pytest

from glomeruli_segmentation_tpu import wsi as jax_wsi
from glomeruli_segmentation_tpu.wsi import synthetic as jax_synthetic
from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide as JaxSlide
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.wsi import synthetic as port_synthetic
from glomeruli_segmentation_tpu_torch.wsi.native_reader import NativeSlide
from glomeruli_segmentation_tpu_torch.wsi.tiff_reader import (
    Slide,
    TiffParseError,
)

# (location at level 0, level, size): inside, across tiles, overhanging the
# right and bottom edges, and wholly outside the image
REGIONS = [((0, 0), 0, (300, 200)), ((250, 130), 0, (77, 301)),
           ((900, 700), 0, (300, 200)), ((64, 32), 1, (200, 150)),
           ((400, 300), 2, (100, 90)), ((5000, 5000), 0, (16, 8))]


def _image(seed=7, h=768, w=1024):
    img, _ = port_synthetic.pas_like_image(h, w, seed=seed, n_glomeruli=3)
    return img


def _write(kind, path):
    img = _image()
    if kind == "ndpi":
        jax_synthetic.write_ndpi_like_tiff(str(path), img, mpp=0.2265,
                                           levels=3, mcu_starts=True)
    else:
        jax_synthetic.write_pyramidal_tiff(str(path), img, mpp=0.2265,
                                           objective_power=40.0, levels=3,
                                           compression=kind)
    return str(path)


@pytest.mark.parametrize("kind", ["jpeg", "none", "ndpi"])
def test_slide_matches_jax(tmp_path, kind):
    path = _write(kind, tmp_path / f"s_{kind}.tiff")
    # the port's open_slide gives its native reader (as the JAX package's
    # does where its library is built); its Python reader reads the same
    with port_wsi.open_slide(path) as opened, Slide(path) as python, \
            JaxSlide(path) as want, jax_wsi.open_slide(path) as native:
        assert isinstance(opened, NativeSlide)
        for got in (opened, python):
            for ref in (want, native):
                assert got.dimensions == ref.dimensions == (1024, 768)
                assert got.level_count == ref.level_count == 3
                assert got.level_dimensions == ref.level_dimensions
                assert got.level_downsamples == ref.level_downsamples
                assert got.properties == ref.properties
                assert got.get_best_level_for_downsample(8) == \
                    ref.get_best_level_for_downsample(8)
            assert got.properties[port_wsi.PROPERTY_NAME_OBJECTIVE_POWER] \
                == "40"
            for location, level, size in REGIONS:
                a = got.read_region_array(location, level, size)
                assert a.shape == (size[1], size[0], 3) and a.dtype == np.uint8
                assert a.tobytes() == want.read_region_array(
                    location, level, size).tobytes()
                assert a.tobytes() == native.read_region_array(
                    location, level, size).tobytes()
            if kind == "ndpi":
                assert got.chunk_decodes > 0
            rgba = got.read_region((64, 32), 0, (40, 30))
            assert rgba.mode == "RGBA" and rgba.size == (40, 30)


def test_truncated_and_foreign_files_raise(tmp_path):
    path = _write("none", tmp_path / "s.tiff")
    data = open(path, "rb").read()
    truncated = tmp_path / "truncated.tiff"
    truncated.write_bytes(data[:6])
    for bad in (truncated, tmp_path / "foreign.tiff"):
        if bad.name == "foreign.tiff":
            bad.write_bytes(b"PK\x03\x04 not a tiff")
        with pytest.raises(Exception) as got:
            Slide(str(bad))
        with pytest.raises(Exception) as want:
            JaxSlide(str(bad))
        assert type(got.value).__name__ == type(want.value).__name__
    with pytest.raises(TiffParseError, match="not a TIFF"):
        Slide(str(tmp_path / "foreign.tiff"))
    assert port_wsi.TiffParseError is TiffParseError


def test_jpeg_slide_without_pil_raises(tmp_path, monkeypatch):
    """Where PIL is missing a JPEG tile read raises ImportError; no other
    decoder takes its place."""
    path = _write("jpeg", tmp_path / "s.tiff")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with Slide(path) as slide:
        assert slide.dimensions == (1024, 768)
        with pytest.raises(ImportError):
            slide.read_region_array((0, 0), 0, (64, 64))


@pytest.mark.parametrize("writer,kw", [
    ("write_pyramidal_tiff", dict(compression="jpeg", levels=3)),
    ("write_pyramidal_tiff", dict(compression="none", tile_size=128)),
    ("write_ndpi_like_tiff", dict(levels=2, mcu_starts=True)),
    ("write_ndpi_like_tiff", dict(chunk_mcus_w=4, zero_sof_dims=True)),
])
def test_synthetic_writer_matches_jax(tmp_path, writer, kw):
    img = _image(seed=3, h=384, w=512)
    want_img, want_centers = jax_synthetic.pas_like_image(384, 512, seed=3,
                                                          n_glomeruli=3)
    np.testing.assert_array_equal(img, want_img)
    getattr(port_synthetic, writer)(str(tmp_path / "port.tiff"), img,
                                    mpp=0.25, **kw)
    getattr(jax_synthetic, writer)(str(tmp_path / "jax.tiff"), img,
                                   mpp=0.25, **kw)
    assert (tmp_path / "port.tiff").read_bytes() == \
        (tmp_path / "jax.tiff").read_bytes()


def test_pas_like_image_options_match_jax():
    kw = dict(background=(220, 200, 210), blob_color=(160, 100, 140),
              radius_frac=(1 / 30, 1 / 15),
              centers=[(40, 50, 20), (200, 100, 35)])
    got, got_c = port_synthetic.pas_like_image(160, 256, seed=9, **kw)
    want, want_c = jax_synthetic.pas_like_image(160, 256, seed=9, **kw)
    np.testing.assert_array_equal(got, want)
    assert got_c == want_c
