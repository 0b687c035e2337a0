"""The port's detector backend and slide scan against the JAX package's:
``TorchDetectorBackend`` against ``JaxDetectorBackend`` in float32, the
sliding-window CSV rows of both ``GlomusDetector``s over one in-memory
pyramid, and a ``detector.ckpt.pth`` written as the JAX trainer writes it."""
import dataclasses
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu import wsi as jax_wsi
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu.utils import glomus_handler as jax_handler
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    load_detector_checkpoint,
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models.faster_rcnn import (
    FasterRCNNConfig,
)
from glomeruli_segmentation_tpu_torch import wsi as torch_wsi
from glomeruli_segmentation_tpu_torch.pipeline import detect as torch_detect
from glomeruli_segmentation_tpu_torch.utils import glomus_handler

from test_torch_faster_rcnn import DETECT, DETECT_SEED, _setup

MPP = 0.25


class PyramidStub:
    """A slide whose pyramid holds only level 3 (downsample 8), an RGB
    uint8 array; level 0 is 8x its size.  Pixels outside read white."""

    def __init__(self, level3: np.ndarray, mpp: float = MPP,
                 objective: float = 40.0):
        self.level3 = level3
        self.level_count = 4
        self.level_downsamples = (1.0, 2.0, 4.0, 8.0)
        self.dimensions = (level3.shape[1] * 8, level3.shape[0] * 8)
        self.properties = {"openslide.mpp-x": str(mpp),
                           "openslide.mpp-y": str(mpp),
                           "openslide.objective-power": str(objective)}

    def read_region_array(self, location, level, size):
        assert level == 3
        x0, y0 = int(location[0] / 8), int(location[1] / 8)
        (w, h), img = size, self.level3
        out = np.full((h, w, 3), 255, np.uint8)
        xs, ys = max(x0, 0), max(y0, 0)
        xe, ye = min(x0 + w, img.shape[1]), min(y0 + h, img.shape[0])
        if xe > xs and ye > ys:
            out[ys - y0: ye - y0, xs - x0: xe - x0] = img[ys:ye, xs:xe]
        return out


def _level3(seed, h=256, w=384):
    rng = np.random.RandomState(seed)
    img = np.clip(rng.randint(-12, 12, (h, w, 3))
                  + np.asarray((225, 195, 210)), 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, 24)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = (150, 80, 130)
    return img


@pytest.fixture(scope="module")
def detector_setup():
    _, variables, _, _, images, _, _ = _setup("detect", DETECT_SEED)
    return variables, images


def _port_backend(variables, **kw):
    return torch_detect.TorchDetectorBackend(
        state_dict_from_flax(variables), FasterRCNNConfig(**DETECT),
        compute_dtype="float32", device="cpu", **kw)


def test_backend_matches_jax_backend(detector_setup):
    variables, images = detector_setup
    want = jax_detect.JaxDetectorBackend(
        variables, jax_frcnn.FasterRCNNConfig(**DETECT), batch_size=2,
        compute_dtype="float32").detect_batch(images)
    backend = _port_backend(variables, batch_size=2)
    got = backend.detect_batch(images)
    boxes, scores, classes, num = got
    assert boxes.shape == want[0].shape and boxes.dtype == np.float32
    np.testing.assert_array_equal(num, want[3])
    np.testing.assert_array_equal(classes, want[2])
    # the same detections (see test_torch_faster_rcnn's precondition);
    # values through f32 convs summed in another order
    np.testing.assert_allclose(scores, want[1], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(boxes, want[0], atol=1e-4, rtol=1e-4)
    # the async pair reads the same packed result
    again = backend.read_detections(backend.detect_batch_submit(images))
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


def test_pack_detections_round_trip():
    rng = np.random.RandomState(0)
    out = {"detection_boxes": torch.from_numpy(
               rng.rand(3, 5, 4).astype(np.float32)),
           "detection_scores": torch.from_numpy(
               rng.rand(3, 5).astype(np.float32)),
           "detection_classes": torch.ones(3, 5),
           "num_detections": torch.tensor([5.0, 2.0, 0.0])}
    packed = torch_detect.pack_detections(out).numpy()
    assert packed.shape == (3, 31)
    for got, key in zip(torch_detect.unpack_detections(packed),
                        ("detection_boxes", "detection_scores",
                         "detection_classes", "num_detections")):
        np.testing.assert_array_equal(got, out[key].numpy())


def _mask_time(rows):
    return [re.sub(r",new,[^,]+,", ",new,T,", r) for r in rows]


@pytest.mark.parametrize("overlap,batch", [(0.5, 8), (0.1, 3)])
def test_scan_region_rows_match_jax(detector_setup, tmp_path, overlap,
                                    batch):
    """Both packages' scans over one pyramid stub, with one backend: the
    same windows, batches, thresholds and CSV rows."""
    variables, _ = detector_setup
    backend = _port_backend(variables, batch_size=batch)
    slide = PyramidStub(_level3(1))
    args = ("OPT_PAS", "targets.txt", str(tmp_path / "data"))
    kw = dict(window_size=256, overlap_ratio=overlap, conf_threshold=0.3,
              batch_size=batch)
    jax_det = jax_detect.GlomusDetector(*args, str(tmp_path / "jax"), "_t",
                                        **kw)
    # the JAX package's ``split`` sets the slide metadata before scanning
    jax_det.org_slide_width, jax_det.org_slide_height = slide.dimensions
    jax_det.mpp_x = jax_det.mpp_y = MPP
    jax_det.org_slide_objective_power = 40
    want = io.StringIO()
    jax_det.scan_region(backend, slide, "site", "H1", "H1.ndpi", want)
    port_det = torch_detect.GlomusDetector(*args, str(tmp_path / "port"),
                                           "_t", **kw)
    got = io.StringIO()
    port_det.scan_slide(backend, slide, "site", "H1", "H1.ndpi", got)
    want_rows = want.getvalue().splitlines()
    assert len(want_rows) > 10
    assert _mask_time(got.getvalue().splitlines()) == _mask_time(want_rows)
    assert port_det.calc_window_size() == jax_det.calc_window_size()
    assert port_det.slide_downsample == jax_det.slide_downsample == 8.0


def test_scan_region_raises_a_read_failure(detector_setup, tmp_path):
    variables, _ = detector_setup

    class Broken(PyramidStub):
        def read_region_array(self, location, level, size):
            if location[0] > 0:
                raise OSError("tile decode failed")
            return super().read_region_array(location, level, size)

    det = torch_detect.GlomusDetector(
        "OPT_PAS", "t.txt", str(tmp_path), str(tmp_path / "o"), "_t",
        window_size=256, overlap_ratio=0.5, conf_threshold=0.3, batch_size=4)
    with pytest.raises(OSError, match="tile decode failed"):
        det.scan_slide(_port_backend(variables, batch_size=4),
                       Broken(_level3(2)), "s", "p", "f", io.StringIO())


def test_detector_checkpoint_written_by_jax_trainer_loads(detector_setup,
                                                          tmp_path):
    """``detector.ckpt.pth`` laid out as the JAX detector trainer writes
    it: the legacy torch pickle of the Flax variables and the config."""
    variables, images = detector_setup
    jcfg = jax_frcnn.FasterRCNNConfig(**DETECT)
    path = tmp_path / "detector.ckpt.pth"
    save_torch_legacy({
        "variables": jax.tree.map(np.asarray, {
            "params": variables["params"],
            "batch_stats": variables["batch_stats"]}),
        "config": dataclasses.asdict(jcfg),
    }, str(path))
    state, config = load_detector_checkpoint(str(path))
    assert config == FasterRCNNConfig(**DETECT)
    want = state_dict_from_flax(variables)
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    backend = torch_detect.TorchDetectorBackend(
        state, config, batch_size=2, compute_dtype="float32", device="cpu")
    got = backend.detect_batch(images)
    ref = _port_backend(variables, batch_size=2).detect_batch(images)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_threshold_boxes_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.rand(10, 4).astype(np.float32)
    scores = np.sort(rng.rand(10).astype(np.float32))[::-1]
    for thr in (0.0, 0.5, 0.99):
        assert torch_detect.threshold_boxes(boxes, scores, 1104, 900, thr) \
            == jax_detect.threshold_boxes(boxes, scores, 1104, 900, thr)


def test_glomus_handler_copy_matches_jax():
    assert glomus_handler._PATTERNS == jax_handler._PATTERNS
    assert glomus_handler._STAINING_DIRS == jax_handler._STAINING_DIRS
    for name in ("PROPERTY_NAME_MPP_X", "PROPERTY_NAME_MPP_Y",
                 "PROPERTY_NAME_OBJECTIVE_POWER"):
        assert getattr(torch_wsi, name) == getattr(jax_wsi, name)
    with pytest.raises(glomus_handler.GlomusHandlerException):
        glomus_handler.GlomusHandler().set_type("OPT_NONE")


def test_backend_defaults_to_cuda():
    """Without a card the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_detect.TorchDetectorBackend({}, FasterRCNNConfig(**DETECT))
