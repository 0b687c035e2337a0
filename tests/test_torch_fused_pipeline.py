"""The port's fold ensemble and slide segmenter against the JAX package's
``EnsembleSegmenter(engine="fused")`` (Pallas interpret) in f32/highest."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.espnet_fused import FusedESPNet
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(folds=(1, 2), p=1, q=2, in_height=64, in_width=128,
             batch_size=2, compute_dtype="float32", precision="highest")
# ragged boxes, one overhanging the slide's bottom edge and one past it
DETECTIONS = [[256, 256, 480, 470, 0.9], [640, 384, 861, 563, 0.9],
              [100, 700, 330, 930, 0.9], [900, 880, 1100, 1100, 0.9],
              [300, 1050, 420, 1160, 0.9]]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two fold checkpoints with calibrated BN statistics, so the summed
    softmax is far from uniform and the argmax is not decided by ties."""
    d = tmp_path_factory.mktemp("folds")
    paths = []
    for fold in (1, 2):
        path = d / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, 5, p=1, q=2), path)
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def port(checkpoints):
    return port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        engine="fused", device="cpu")


@pytest.fixture(scope="module")
def jax_ensemble(checkpoints):
    return jax_fused.EnsembleSegmenter(
        jax_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
        engine="fused")


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    img, _ = pas_like_image(1024, 1536, seed=21, n_glomeruli=4)
    path = str(tmp_path_factory.mktemp("slide") / "s.tiff")
    write_pyramidal_tiff(path, img, mpp=0.25, levels=3)
    return Slide(path)


def _batch():
    rng = np.random.RandomState(0)
    img, _ = pas_like_image(96, 160, seed=3, n_glomeruli=2)
    padded = np.stack([img, img[::-1]])[..., ::-1].copy()  # BGR
    padded[1, :, :40] = rng.randint(0, 255, (96, 40, 3))
    hs = np.asarray([96, 71], np.int32)
    ws = np.asarray([160, 133], np.int32)
    return padded, hs, ws


def test_segment_batch_padded_matches_jax(port, jax_ensemble):
    padded, hs, ws = _batch()
    want = jax_ensemble.segment_batch_padded(padded, hs, ws)
    got = port.segment_batch_padded(padded, hs, ws)
    assert got.dtype == np.uint8 and got.shape == (2, 64, 128)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_segment_batch_gather_matches_jax(port, jax_ensemble):
    padded, hs, ws = _batch()
    ys = np.stack([np.arange(12) * 5, np.arange(12) * 3]).astype(np.int32)
    xs = np.stack([np.arange(20) * 6, np.arange(20) * 2]).astype(np.int32)
    want = jax_ensemble.segment_batch_gather(padded, hs, ws, ys, xs)
    got = port.segment_batch_gather(padded, hs, ws, ys, xs)
    assert got.shape == (2, 12, 20)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_slide(jax_ensemble, slide):
    """The JAX package's /8 canvas (device gather) and its full-resolution
    path's canvas and per-crop maps."""
    seg = jax_fused.FusedSlideSegmenter(jax_ensemble, transfer="padded")
    maps = []
    full = seg.segment_slide(slide, DETECTIONS,
                             on_crop=lambda box, m: maps.append((box, m)))
    return seg.segment_slide(slide, DETECTIONS), full, maps


@pytest.mark.parametrize("transfer", ["flat", "padded"])
def test_segment_slide_matches_jax(port, slide, jax_slide, transfer):
    want_ds8, want_full, want_maps = jax_slide
    seg = port_fused.FusedSlideSegmenter(port, transfer=transfer)
    assert seg.transfer == transfer
    ds8 = seg.segment_slide(slide, DETECTIONS)
    assert ds8.shape == (1024 // 8, 1536 // 8) and ds8.dtype == np.uint8
    assert ds8.max() > 0
    np.testing.assert_array_equal(ds8, want_ds8)
    maps = []
    full = seg.segment_slide(slide, DETECTIONS,
                             on_crop=lambda box, m: maps.append((box, m)))
    np.testing.assert_array_equal(full, want_full)
    np.testing.assert_array_equal(full, ds8)
    assert [b for b, _ in maps] == [b for b, _ in want_maps]
    for (_, a), (_, b) in zip(maps, want_maps):
        np.testing.assert_array_equal(a, b)


def test_segment_slide_flat_falls_back_padded(port, slide, jax_slide,
                                              monkeypatch):
    """A batch whose flat buffer would pass the offset limit is staged in
    the padded layout, with the same canvas."""
    calls = []
    orig = port_fused.pack_crops_flat
    monkeypatch.setattr(port_fused, "pack_crops_flat",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    monkeypatch.setattr(port_fused, "FLAT_OFFSET_LIMIT", 1024)
    seg = port_fused.FusedSlideSegmenter(port)
    np.testing.assert_array_equal(seg.segment_slide(slide, DETECTIONS),
                                  jax_slide[0])
    assert not calls


class _FailingSlide:
    """Slide proxy whose reads fail after ``fail_after`` of them."""

    def __init__(self, inner, fail_after: int):
        self._inner = inner
        self._reads = 0
        self._fail_after = fail_after
        self.dimensions = inner.dimensions

    def read_region_array(self, *a, **k):
        self._reads += 1
        if self._reads > self._fail_after:
            raise IOError("corrupt tile")
        return self._inner.read_region_array(*a, **k)


def test_producer_failure_propagates(port, slide):
    detections = [[64 * (i % 4), 64, 64 * (i % 4) + 128, 192, 0.9]
                  for i in range(8)]
    seg = port_fused.FusedSlideSegmenter(port)
    with pytest.raises(IOError, match="corrupt tile"):
        seg.segment_slide(_FailingSlide(slide, fail_after=3), detections)


def test_entry_points_default_to_cuda(checkpoints):
    """Without ``device=`` an entry point runs on the card; with no card it
    raises instead of falling back to the CPU."""
    cfg = port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL)
    sd = random_state_dict(0, 5, p=1, q=2)
    if torch.cuda.is_available():
        assert port_fused.EnsembleSegmenter(cfg).device.type == "cuda"
        assert FusedESPNet(sd).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_fused.EnsembleSegmenter(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedESPNet(sd)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import neither JAX nor
    the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import glomeruli_segmentation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'glomeruli_segmentation_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 9 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("change,match", [
    (dict(folds=(1,)), "checkpoints for folds"),
    (dict(pack_output=True), None),
    (dict(precision="high"), "precision"),
    ("xla", None),
])
def test_ensemble_rejects_unsupported_config(checkpoints, port, change,
                                             match):
    """The configs the port refuses raise; ``pack_output`` and the ``xla``
    engine run as in the JAX package: the packed readback unpacks to the
    fused engine's maps, and the xla engine's maps equal the JAX xla
    engine's."""
    cfg = port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL)
    engine = "fused"
    if isinstance(change, str):
        engine = change
    else:
        cfg = port_fused.EnsembleConfig(
            checkpoints=checkpoints, **{**SMALL, **change})
    if match is not None:
        with pytest.raises(ValueError, match=match):
            port_fused.EnsembleSegmenter(cfg, engine=engine, device="cpu")
        return
    padded, hs, ws = _batch()
    got = port_fused.EnsembleSegmenter(
        cfg, engine=engine, device="cpu").segment_batch_padded(
        padded, hs, ws)
    if engine == "xla":
        want = jax_fused.EnsembleSegmenter(
            jax_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
            engine="xla").segment_batch_padded(padded, hs, ws)
    else:
        want = port.segment_batch_padded(padded, hs, ws)
    np.testing.assert_array_equal(got, want)


def test_bf16_path_tracks_jax(checkpoints, port):
    """The default bf16 path, where rounding points differ between the two
    frameworks (XLA's bf16 convs, pooling and casts against PyTorch's):
    class maps agree with the JAX package's bf16 fused engine and with the
    port's own f32 maps on nearly every pixel.  Measured at these seeds:
    0.9967 against JAX bf16, 0.99 against f32."""
    cfg = dict(SMALL, compute_dtype="bfloat16", precision="default")
    padded, hs, ws = _batch()
    want = jax_fused.EnsembleSegmenter(
        jax_fused.EnsembleConfig(checkpoints=checkpoints, **cfg),
        engine="fused").segment_batch_padded(padded, hs, ws)
    bf16 = port_fused.EnsembleSegmenter(
        port_fused.EnsembleConfig(checkpoints=checkpoints, **cfg),
        engine="fused", device="cpu")
    assert bf16.nets[0].enc["level3"][0]["wd"].dtype == torch.bfloat16
    got = bf16.segment_batch_padded(padded, hs, ws)
    f32 = port.segment_batch_padded(padded, hs, ws)
    assert (got == want).mean() >= 0.99
    assert (got == f32).mean() >= 0.98


def test_upload_tables_round_trip():
    """The int32 tables a batch uploads as one buffer on a card (offsets,
    heights, widths, ys, xs) split back into the same arrays."""
    rng = np.random.RandomState(0)
    tables = [rng.randint(0, 2**31 - 1, 8).astype(np.int32),
              rng.randint(1, 1200, 8).astype(np.int32),
              np.ones(8, np.int32),
              rng.randint(0, 512, (8, 96)).astype(np.int32),
              rng.randint(0, 1024, (8, 160)).astype(np.int32)]
    buf, shapes = port_fused.pack_tables(tables)
    assert buf.dtype == np.int32 and buf.ndim == 1
    assert buf.size == sum(t.size for t in tables)
    got = port_fused.unpack_tables(torch.from_numpy(buf), shapes)
    assert len(got) == len(tables)
    for g, t in zip(got, tables):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), t)
