"""The port's native slide reader (``wsi/native_reader.py`` over its own
copy of ``ndpi_reader.cc``, built at first use by ``wsi/native/_build.py``)
against the port's pure-Python ``Slide`` and the JAX package's
``NativeSlide``, byte for byte: the tiled pyramids of
``tests/test_native_reader.py``, the NDPI-like layouts of
``tests/test_ndpi_layout.py``, zero-size regions, ``open_slide``'s
preference and its fallback's recorded reason, the build itself (PIL's
libjpeg, concurrent builds), and the byte-corruption fuzz of
``tests/test_reader_fuzz.py`` in one subprocess with a timeout.

The JAX package's library is compiled from its own source with the command
of its ``build.sh``, into a temporary directory: its tree is not touched.
"""
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from glomeruli_segmentation_tpu.wsi import native_reader as jax_native_reader
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_ndpi_like_tiff,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.wsi import native_reader
from glomeruli_segmentation_tpu_torch.wsi.native import _build
from glomeruli_segmentation_tpu_torch.wsi.native_reader import NativeSlide
from glomeruli_segmentation_tpu_torch.wsi.tiff_reader import Slide

ROOT = Path(__file__).resolve().parent.parent
JAX_SOURCE = ROOT / "glomeruli_segmentation_tpu" / "wsi" / "native" \
    / "ndpi_reader.cc"
# glomeruli_segmentation_tpu/wsi/native/build.sh, with another output path
JAX_BUILD = ("g++", "-O3", "-fPIC", "-shared", "-std=c++17")
JAX_LIBS = ("-ljpeg", "-lz", "-lpthread")


def compile_jax_reader(out: Path) -> str:
    subprocess.run([*JAX_BUILD, "-o", str(out), str(JAX_SOURCE), *JAX_LIBS],
                   check=True, capture_output=True, timeout=300)
    return str(out)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``NativeSlide`` over a library compiled from its
    source into a temporary directory."""
    if jax_native_reader._lib is None:
        path = compile_jax_reader(
            tmp_path_factory.mktemp("jax_native") / "_ndpi_reader.so")
        saved = jax_native_reader._LIB_PATH
        jax_native_reader._LIB_PATH = path
        try:
            jax_native_reader._load_lib()
        finally:
            jax_native_reader._LIB_PATH = saved
    return jax_native_reader.NativeSlide


def assert_same_reads(cases, *slides):
    """Every slide reads every (location, level, size) to the same bytes."""
    for location, level, size in cases:
        want = slides[0].read_region_array(location, level, size)
        assert want.shape == (size[1], size[0], 3)
        for slide in slides[1:]:
            got = slide.read_region_array(location, level, size)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (location, level, size)


def assert_same_geometry(native, *others):
    for other in others:
        assert native.dimensions == other.dimensions
        assert native.level_count == other.level_count
        assert native.level_dimensions == other.level_dimensions
        assert native.level_downsamples == other.level_downsamples
        assert native.get_best_level_for_downsample(8) == \
            other.get_best_level_for_downsample(8)


# ---------------- tiled and striped pyramids ----------------
def _tiled(path, compression):
    img, _ = pas_like_image(1100, 1700, seed=9)
    write_pyramidal_tiff(str(path), img, mpp=0.23, objective_power=40.0,
                         levels=3, compression=compression)


def _deflate_strips(path):
    """A striped deflate TIFF as PIL writes it (the synthetic writer has no
    deflate): the reader's zlib path."""
    from PIL import Image

    img, _ = pas_like_image(300, 400, seed=1)
    Image.fromarray(img).save(str(path), compression="tiff_adobe_deflate",
                              dpi=(2540 / 0.25, 2540 / 0.25))


WRITERS = {"jpeg": lambda p: _tiled(p, "jpeg"),
           "none": lambda p: _tiled(p, "none"),
           "deflate": _deflate_strips}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_native_matches_python_and_jax(tmp_path, jax_native, kind):
    path = str(tmp_path / f"{kind}.tiff")
    WRITERS[kind](path)
    with NativeSlide(path) as ns, Slide(path) as ps, jax_native(path) as js:
        assert_same_geometry(ns, ps, js)
        assert ns.properties == js.properties == ps.properties
        w, h = ns.dimensions
        rng = np.random.RandomState(0)
        cases = [((int(rng.randint(0, w - 100)), int(rng.randint(0, h - 80))),
                  0, (300, 200)) for _ in range(5)]
        cases += [((w - 10, h - 10), 0, (32, 32)),       # edge straddle
                  ((10 ** 7, 10 ** 7), 0, (16, 16)),     # out of bounds
                  ((-40, -30), 0, (64, 48))]             # before the origin
        cases += [((64, 64), level, (96, 80))
                  for level in range(1, ns.level_count)]
        assert_same_reads(cases, ps, ns, js)
        assert (ns.read_region_array((10 ** 7, 10 ** 7), 0, (16, 16))
                == 255).all()
        rgba = ns.read_region((0, 0), 0, (64, 48))
        assert rgba.mode == "RGBA" and rgba.size == (64, 48)
        assert np.asarray(rgba)[..., :3].tobytes() == \
            ps.read_region_array((0, 0), 0, (64, 48)).tobytes()
        assert ns.ndpi_index_mode(0) == js.ndpi_index_mode(0) == 0
        assert ns.chunk_decodes == 0


@pytest.mark.parametrize("size", [(0, 16), (16, 0), (0, 0)])
def test_zero_size_regions(tmp_path, jax_native, size):
    """A zero-width or zero-height region gives the Python reader's
    result: an empty array of that shape."""
    path = str(tmp_path / "s.tiff")
    _tiled(path, "jpeg")
    with NativeSlide(path) as ns, Slide(path) as ps, jax_native(path) as js:
        outcomes = []
        for slide in (ps, ns, js):
            try:
                a = slide.read_region_array((100, 100), 0, size)
                outcomes.append((a.shape, a.tobytes()))
            except Exception as e:  # the same class from every reader
                outcomes.append(type(e).__name__)
        assert outcomes[0] == outcomes[1] == outcomes[2]
        assert outcomes[0][0] == (size[1], size[0], 3)


# ---------------- NDPI-like single-strip levels ----------------
@pytest.fixture(scope="module")
def ndpi_path(tmp_path_factory):
    img, _ = pas_like_image(530, 700, seed=3, n_glomeruli=4)
    path = str(tmp_path_factory.mktemp("ndpi") / "s.ndpi.tiff")
    write_ndpi_like_tiff(path, img, mpp=0.228, objective_power=40.0,
                         levels=2, rows_per_chunk=1)
    return path


def test_ndpi_virtual_tiling_and_o_window_counter(ndpi_path, jax_native):
    with NativeSlide(ndpi_path) as ns, Slide(ndpi_path) as ps, \
            jax_native(ndpi_path) as js:
        assert_same_geometry(ns, ps, js)
        assert ns.dimensions == (700, 530)
        assert ns.properties == js.properties
        assert ns.properties["openslide.objective-power"] == "40"
        assert ns.ndpi_index_mode(0) == js.ndpi_index_mode(0) == 1
        for slide in (ns, js):
            win = slide.read_region_array((100, 96), 0, (256, 192))
            # 192 rows / 16-px restart chunks: 12 decodes, not the level's 34
            assert slide.chunk_decodes == 12
            full = slide.read_region_array((0, 0), 0, (700, 530))
            assert win.tobytes() == full[96:288, 100:356].tobytes()
            # the window's 12 chunks are cached: 22 more make the level
            assert slide.chunk_decodes == 34
        assert_same_reads([((0, 0), 0, (700, 530)),
                           ((233, 177), 0, (333, 111)),
                           ((-50, 490), 0, (200, 100)),
                           ((64, 64), 1, (256, 200))], ps, ns, js)


def test_ndpi_decode_count_independent_of_height(tmp_path):
    counts = []
    for height in (256, 2048):
        img, _ = pas_like_image(height, 512, seed=1, n_glomeruli=2)
        path = str(tmp_path / f"h{height}.tiff")
        write_ndpi_like_tiff(path, img, levels=1)
        with NativeSlide(path) as ns:
            ns.read_region_array((128, height // 2), 0, (128, 64))
            counts.append(ns.chunk_decodes)
    assert counts[0] == counts[1] <= 6


def _gap1(starts):
    assert len(starts) > 5 and len(starts) // 2 != 2
    starts[2] = starts[1] + 1
    return starts


# (name, writer keywords, the native index mode of level 0): a valid
# McuStarts tag; a sub-RST gap at an index the RST probe does not sample;
# entries off by one (the probe fails); one restart chunk for the level;
# two MCU rows a chunk; a level wider than JPEG's 65,500 px with 0x0 in its
# SOF; every structure past 4 GiB (offsets wrapped mod 2^32, a sparse hole)
NDPI_LAYOUTS = [
    ("mcu-starts", dict(levels=2, mcu_starts=True), 2),
    ("mcu-starts-gap", dict(levels=1, mcu_starts=True,
                            mcu_starts_transform=_gap1), 1),
    ("mcu-starts-invalid", dict(levels=1, mcu_starts=True,
                                mcu_starts_transform=lambda s: [
                                    v + 1 for v in s]), 1),
    ("single-chunk", dict(levels=1, rows_per_chunk=8, mcu_starts=True), 2),
    ("two-row-chunks", dict(levels=1, rows_per_chunk=2), 1),
    ("zero-sof-wide", dict(levels=1, chunk_mcus_w=260,
                           zero_sof_dims=True), 1),
    ("wrapped-4gib", dict(levels=2, mcu_starts=True,
                          offset_pad=(1 << 32) + 12345), 2),
]


def _layout_image(name):
    if name == "zero-sof-wide":
        cols = (np.arange(66560, dtype=np.int64) % 251).astype(np.uint8)
        return np.tile(cols[None, :, None], (48, 1, 3))
    if name == "single-chunk":
        return pas_like_image(64, 96, seed=7, n_glomeruli=1)[0]
    return pas_like_image(530, 700, seed=3, n_glomeruli=4)[0]


@pytest.mark.parametrize("name,kwargs,mode", NDPI_LAYOUTS,
                         ids=[c[0] for c in NDPI_LAYOUTS])
def test_ndpi_layouts(tmp_path, jax_native, name, kwargs, mode):
    path = str(tmp_path / f"{name}.ndpi.tiff")
    write_ndpi_like_tiff(path, _layout_image(name), **kwargs)
    with NativeSlide(path) as ns, Slide(path) as ps, jax_native(path) as js:
        assert_same_geometry(ns, ps, js)
        assert ns.properties == js.properties
        assert ns.ndpi_index_mode(0) == js.ndpi_index_mode(0) == mode
        w, h = ns.dimensions
        cases = [((0, 0), 0, (min(w, 2000), h)),
                 ((w // 3, h // 3), 0, (min(333, w), min(111, h))),
                 ((-50, h - 40), 0, (200, 100))]
        if ns.level_count > 1:
            cases.append(((64, 64), 1, (256, 200)))
        assert_same_reads(cases, ps, ns, js)


def test_cyclic_ifd_chain_raises(tmp_path, jax_native):
    img, _ = pas_like_image(64, 64, seed=0, n_glomeruli=1)
    path = str(tmp_path / "cyclic.tiff")
    write_ndpi_like_tiff(path, img, levels=1)
    data = bytearray(open(path, "rb").read())
    (first_ifd,) = struct.unpack("<I", data[4:8])
    (n_entries,) = struct.unpack("<H", data[first_ifd: first_ifd + 2])
    struct.pack_into("<I", data, first_ifd + 2 + 12 * n_entries, first_ifd)
    open(path, "wb").write(bytes(data))
    for opener in (NativeSlide, jax_native):
        with pytest.raises(OSError, match="could not open"):
            opener(path)
    with pytest.raises(Exception):
        Slide(path)


def test_truncated_strip_fails_like_jax(tmp_path, jax_native):
    """A strip whose byte count overstates the file: the port's reader does
    what the JAX package's does (the same bytes or the same exception),
    and neither hangs nor crashes."""
    img, _ = pas_like_image(256, 384, seed=9, n_glomeruli=2)
    path = str(tmp_path / "trunc.ndpi.tiff")
    write_ndpi_like_tiff(path, img, levels=1, rows_per_chunk=1)
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) - len(data) // 4])
    outcomes = []
    for opener in (NativeSlide, jax_native):
        try:
            with opener(path) as s:
                outcomes.append(s.read_region_array(
                    (0, 0), 0, (384, 256)).tobytes())
        except Exception as e:
            outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1]


# ---------------- open_slide and the build ----------------
def test_open_slide_prefers_native(ndpi_path, tmp_path):
    path = str(tmp_path / "s.tiff")
    _tiled(path, "jpeg")
    before = port_wsi.python_fallbacks
    for p in (path, ndpi_path):
        with port_wsi.open_slide(p) as slide:
            assert isinstance(slide, NativeSlide)
            region = np.asarray(slide.read_region((32, 32), 0, (64, 64)))
            assert region.shape == (64, 64, 4)
            assert (region[..., 3] == 255).all()
    assert port_wsi.python_fallbacks == before
    assert native_reader.unavailable_reason is None


def _broken_source(tmp_path):
    bad = tmp_path / "ndpi_reader.cc"
    bad.write_text("#include <jpeglib.h>\nint broken( {\n")
    return {"SOURCE": bad}


# how the library fails to come: (the _build attributes to set, what the
# recorded reason says)
UNAVAILABLE = {
    "no-compiler": (lambda tmp: {"CXX": "no-such-compiler-for-the-test"},
                    "no-such-compiler-for-the-test not found"),
    "compile-error": (_broken_source, "failed on ndpi_reader.cc"),
}


@pytest.mark.parametrize("case", sorted(UNAVAILABLE))
def test_fallback_records_its_reason(tmp_path, monkeypatch, capsys, case):
    """Without the library ``open_slide`` reads with the Python reader, as
    the JAX package's does, keeps why in ``unavailable_reason``, warns once
    on stderr and counts every such slide."""
    attrs, says = UNAVAILABLE[case]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    for name, value in attrs(tmp_path).items():
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setattr(native_reader, "_lib", None)
    monkeypatch.setattr(native_reader, "unavailable_reason", None)
    monkeypatch.setattr(port_wsi, "_warned_unavailable", False)
    monkeypatch.setattr(port_wsi, "python_fallbacks", 0)
    path = str(tmp_path / "s.tiff")
    _tiled(path, "none")
    capsys.readouterr()
    slides = [port_wsi.open_slide(path) for _ in range(2)]
    assert all(type(s) is Slide for s in slides)
    assert says in native_reader.unavailable_reason
    if case == "compile-error":
        assert "error" in native_reader.unavailable_reason  # g++'s output
    err = capsys.readouterr().err
    assert err.count("native slide reader is unavailable") == 1
    assert says in err
    assert port_wsi.python_fallbacks == 2
    with pytest.raises(OSError, match=says):
        NativeSlide(path)  # no second build attempt
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_links_pillow_libjpeg(tmp_path, monkeypatch):
    """Where the system loader knows no libjpeg.so.62 (the GPU host), the
    reader links the libjpeg in PIL's wheel and reads the same bytes."""
    pillow = _build._pillow_library("libjpeg-*.so.62*")
    if pillow is None:
        pytest.skip("this PIL wheel bundles no libjpeg")
    system = _build._system_library
    monkeypatch.setattr(_build, "_system_library", lambda soname: None
                        if soname == "libjpeg.so.62" else system(soname))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_reader, "_lib", None)
    monkeypatch.setattr(native_reader, "unavailable_reason", None)
    libs = _build.libraries()
    assert libs[0] == pillow
    assert _build.build().parent == tmp_path / "build"
    path = str(tmp_path / "s.tiff")
    _tiled(path, "jpeg")
    with NativeSlide(path) as ns, Slide(path) as ps:
        assert ns._lib._name.startswith(str(tmp_path))
        assert_same_reads([((0, 0), 0, (700, 500)),
                           ((1500, 900), 0, (300, 300)),
                           ((64, 64), 2, (200, 120))], ps, ns)


_BUILDER = r"""
import sys
from pathlib import Path
from glomeruli_segmentation_tpu_torch.wsi.native import _build
_build.BUILD_DIR = Path(sys.argv[1])
print(_build.build())
"""


def test_concurrent_builds_give_one_library(tmp_path):
    """Four processes building at once: each gets the same complete
    library; one compiles, the others wait on the lock; no temporary file
    is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                               str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["lock", Path(paths.pop()).name])


# ---------------- byte-corruption fuzz ----------------
_FUZZ_DRIVER = r"""
import hashlib
import sys

from glomeruli_segmentation_tpu.wsi import native_reader as jax_native_reader
from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide as JaxSlide
from glomeruli_segmentation_tpu_torch.wsi import native_reader
from glomeruli_segmentation_tpu_torch.wsi.tiff_reader import Slide

native_reader._load_lib()  # a build failure fails the run
jax_native_reader._LIB_PATH = sys.argv[1]
jax_native_reader._load_lib()
readers = (("port-native", native_reader.NativeSlide), ("port-py", Slide),
           ("jax-native", jax_native_reader.NativeSlide), ("jax-py", JaxSlide))
for path in sys.argv[2:]:
    for label, cls in readers:
        # flushed BEFORE the attempt: if it crashes the process, the parent
        # sees which (file, reader) died
        print(f"TRY {label} {path}", flush=True)
        digest = hashlib.sha256()
        try:
            s = cls(path)
            dims = s.level_dimensions
            digest.update(repr((dims, sorted(s.properties.items()))).encode())
            if dims and dims[0][0] > 0 and dims[0][1] > 0:
                digest.update(s.read_region_array(
                    (0, 0), 0, (min(48, dims[0][0]),
                                min(48, dims[0][1]))).tobytes())
                lv = len(dims) - 1
                digest.update(s.read_region_array(
                    (0, 0), lv, (min(16, dims[lv][0]),
                                 min(16, dims[lv][1]))).tobytes())
            s.close()
        except Exception as e:
            print(f"RES {label} {path} ERR:{type(e).__name__}", flush=True)
        else:
            print(f"RES {label} {path} {digest.hexdigest()}", flush=True)
print("DONE", flush=True)
"""


def _mutations(base: bytes, rng, n_random: int):
    """tests/test_reader_fuzz.py's damage: structured first, then seeded
    random byte flips, half of them in the structural head."""
    n = len(base)
    yield "trunc-header", base[:6]
    yield "trunc-quarter", base[: n // 4]
    yield "trunc-3quarter", base[: 3 * n // 4]
    wild = bytearray(base)
    wild[4:8] = b"\xff\xff\xff\x7f"
    yield "wild-ifd-ptr", bytes(wild)
    ff = bytearray(base)
    ff[8:256] = b"\xff" * 248
    yield "ifd-ff-fill", bytes(ff)
    for k in range(n_random):
        buf = bytearray(base)
        hi = 4096 if k % 2 == 0 else n
        for _ in range(rng.randint(1, 5)):
            buf[rng.randint(0, min(hi, n))] = rng.randint(0, 256)
        yield f"rand{k}", bytes(buf)


def test_corrupt_slides_fail_cleanly_and_like_jax(tmp_path):
    """Every mutated file: no reader crashes or hangs, and the port's
    native and Python readers each end as the JAX package's twin does (the
    same geometry, properties and bytes, or the same exception class)."""
    img, _ = pas_like_image(96, 128, seed=7, n_glomeruli=2)
    bases = {}
    write_ndpi_like_tiff(str(tmp_path / "strip"), img, levels=2,
                         rows_per_chunk=1, mcu_starts=True)
    bases["strip"] = (tmp_path / "strip").read_bytes()
    write_pyramidal_tiff(str(tmp_path / "tiled"), img, levels=2)
    bases["tiled"] = (tmp_path / "tiled").read_bytes()
    rng = np.random.RandomState(0)
    paths = []
    for kind, base in bases.items():
        for name, data in _mutations(base, rng, n_random=24):
            path = tmp_path / f"{kind}-{name}"
            path.write_bytes(data)
            paths.append(str(path))
    jax_lib = compile_jax_reader(tmp_path / "_ndpi_reader.so")
    proc = subprocess.run(
        [sys.executable, "-c", _FUZZ_DRIVER, jax_lib, *paths],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    lines = proc.stdout.splitlines()
    tail = "\n".join(lines[-8:])
    assert proc.returncode == 0, (
        f"a reader crashed on a corrupt slide (exit {proc.returncode}):\n"
        f"{tail}\n{proc.stderr[-2000:]}")
    assert lines[-1] == "DONE", tail
    results = {}
    for line in lines:
        if line.startswith("RES "):
            _, label, path, outcome = line.split(" ", 3)
            results[label, path] = outcome
    assert len(results) == 4 * len(paths)
    for path in paths:
        assert results["port-native", path] == results["jax-native", path], \
            path
        assert results["port-py", path] == results["jax-py", path], path
    # the fuzz reached the decoders, not only the parsers
    assert sum(not v.startswith("ERR") for v in results.values()) >= len(
        paths)
