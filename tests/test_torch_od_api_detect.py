"""The port's frozen-graph backend against the JAX package's: the window
resizes, ``ODAPIDetectorBackend`` from a ``.pb`` on disk, from ``consts=``
and from ``params=`` (float32, the 64/96 resizer bounds of the JAX
package's own backend test), and the sliding-window CSV rows of both
packages' ``GlomusDetector`` over one pyramid stub."""
import io
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_graph_writer import write_graph
from test_od_api_import import build_od_api_consts
from test_torch_detect import MPP, PyramidStub, _level3

from glomeruli_segmentation_tpu.convert.pb_import import (
    assemble_od_api_params,
)
from glomeruli_segmentation_tpu.ops import resize as jax_resize
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu_torch.ops import nms as port_nms
from glomeruli_segmentation_tpu_torch.ops import resize as port_resize
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect

# the JAX package's test_detect_contract_from_pb settings
SETTINGS = dict(compute_dtype="float32", min_dimension=64, max_dimension=96,
                pre_nms_top_n=200, max_proposals=20, max_detections=10)


@pytest.mark.parametrize("src,dst", [((1104, 1104, 3), (600, 600)),
                                     ((66, 97, 3), (40, 150)),
                                     ((66, 97), (97, 66)),
                                     ((128, 96, 3), (64, 48))])
def test_host_tf1_resize_is_byte_identical(src, dst):
    rng = np.random.RandomState(sum(src))
    img = rng.randint(0, 256, src).astype(np.uint8)
    got = port_resize.resize_bilinear_tf1_np(img, *dst)
    want = jax_resize.resize_bilinear_tf1_np(img, *dst)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["resize_bilinear_tf1", "resize_bilinear"])
@pytest.mark.parametrize("src,dst", [((66, 97), (40, 150)),
                                     ((128, 128), (64, 64)),
                                     ((45, 30), (90, 61))])
def test_device_resizes_match_jax(name, src, dst):
    rng = np.random.RandomState(sum(src) + len(name))
    batch = rng.randint(0, 256, (2,) + src + (3,)).astype(np.uint8)
    got = getattr(port_resize, name)(torch.from_numpy(batch), *dst)
    assert got.dtype == torch.float32 and got.shape == (2,) + dst + (3,)
    for b in range(2):
        want = np.asarray(getattr(jax_resize, name)(
            jnp.asarray(batch[b], jnp.float32), *dst))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    if name == "resize_bilinear_tf1":
        np.testing.assert_array_equal(
            got[0].numpy(),
            port_resize.resize_bilinear_tf1_np(batch[0], *dst))


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    consts, _, _ = build_od_api_consts(seed=5)
    pb = tmp_path_factory.mktemp("model") / "frozen_inference_graph.pb"
    write_graph(consts, str(pb))
    return consts, str(pb)


def _windows(seed, n=2, size=128):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 255, (n, size, size, 3), np.uint8)


def _same(got, want):
    boxes, scores, classes, num = got
    np.testing.assert_array_equal(num, want[3])
    np.testing.assert_array_equal(classes, want[2])
    np.testing.assert_allclose(scores, want[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(boxes, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("source", ["pb", "consts", "params"])
def test_backend_matches_jax_backend(graph, source):
    consts, pb = graph
    images = _windows(0)
    want = jax_detect.ODAPIDetectorBackend(pb, batch_size=2, **SETTINGS) \
        .detect_batch(images)
    if source == "pb":
        kw = dict(pb_path=pb)
    elif source == "consts":
        kw = dict(consts=consts)
    else:
        kw = dict(params=assemble_od_api_params(consts)[0], num_classes=1)
    backend = port_detect.ODAPIDetectorBackend(batch_size=2, device="cpu",
                                               **kw, **SETTINGS)
    assert backend.num_classes == 1
    got = backend.detect_batch(images)
    assert got[0].shape == (2, 10, 4) and got[0].dtype == np.float32
    _same(got, want)
    assert (got[3] > 0).all()
    # the async pair reads the same packed result
    again = backend.read_detections(backend.detect_batch_submit(images))
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    (rh, rw), model, anchors = backend._model_for(128, 128)
    assert (rh, rw) == (64, 64) and model.config.image_size == (64, 64)
    assert anchors.shape == (4 * 4 * 12, 4)


@pytest.mark.parametrize("device_resize,compat", [(True, True),
                                                  (True, False),
                                                  (False, False)])
def test_resize_options_match_jax(graph, device_resize, compat):
    _, pb = graph
    images = _windows(1, size=112)
    kw = dict(device_resize=device_resize, compat_tf1_resize=compat,
              **SETTINGS)
    want = jax_detect.ODAPIDetectorBackend(pb, batch_size=2, **kw) \
        .detect_batch(images)
    got = port_detect.ODAPIDetectorBackend(
        pb, batch_size=2, device="cpu", **kw).detect_batch(images)
    _same(got, want)


def test_cv2_resize_raises_without_cv2(graph, monkeypatch):
    """The host ``compat_tf1_resize=False`` path needs cv2 and takes no
    other resize where it is missing."""
    _, pb = graph
    backend = port_detect.ODAPIDetectorBackend(
        pb, batch_size=2, device="cpu", compat_tf1_resize=False, **SETTINGS)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        backend.detect_batch(_windows(2))


def test_bf16_host_resize_is_cast_before_the_upload(graph):
    _, pb = graph
    backend = port_detect.ODAPIDetectorBackend(
        pb, batch_size=2, device="cpu",
        **dict(SETTINGS, compute_dtype="bfloat16"))
    images = _windows(3)
    x = backend.resize_host(images, 64, 64)
    assert x.dtype == torch.bfloat16
    want = np.stack([port_resize.resize_bilinear_tf1_np(im, 64, 64)
                     for im in images])
    assert torch.equal(x, torch.from_numpy(want).to(torch.bfloat16))
    boxes, scores, _, num = backend.detect_batch(images)
    assert np.isfinite(scores).all() and (boxes >= 0).all()
    assert (boxes <= 1).all() and (num > 0).all()


def _mask_time(rows):
    return [re.sub(r",new,[^,]+,", ",new,T,", r) for r in rows]


@pytest.mark.parametrize("overlap,batch", [(0.5, 4), (0.1, 3)])
def test_scan_region_rows_match_jax(graph, tmp_path, overlap, batch):
    """The JAX detector with the JAX backend and the port's with the port's
    over one pyramid stub: the same windows, batches and CSV rows."""
    _, pb = graph
    slide = PyramidStub(_level3(1))
    args = ("OPT_PAS", "targets.txt", str(tmp_path / "data"))
    kw = dict(window_size=256, overlap_ratio=overlap, conf_threshold=0.3,
              batch_size=batch)
    jax_det = jax_detect.GlomusDetector(*args, str(tmp_path / "jax"), "_t",
                                        **kw)
    jax_det.org_slide_width, jax_det.org_slide_height = slide.dimensions
    jax_det.mpp_x = jax_det.mpp_y = MPP
    jax_det.org_slide_objective_power = 40
    want = io.StringIO()
    jax_det.scan_region(
        jax_detect.ODAPIDetectorBackend(pb, batch_size=batch, **SETTINGS),
        slide, "site", "H1", "H1.ndpi", want)
    port_det = port_detect.GlomusDetector(*args, str(tmp_path / "port"),
                                          "_t", **kw)
    got = io.StringIO()
    before = port_nms.nms.launches
    port_det.scan_slide(
        port_detect.ODAPIDetectorBackend(pb, batch_size=batch, device="cpu",
                                         **SETTINGS),
        slide, "site", "H1", "H1.ndpi", got)
    assert port_nms.nms.launches == before  # CPU: the plain NMS
    want_rows = want.getvalue().splitlines()
    assert len(want_rows) > 10
    assert _mask_time(got.getvalue().splitlines()) == _mask_time(want_rows)


def test_backend_defaults_to_cuda(graph):
    """Without a card the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    consts, _ = graph
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_detect.ODAPIDetectorBackend(consts=consts)
    with pytest.raises(ValueError, match="num_classes"):
        port_detect.ODAPIDetectorBackend(params={}, device="cpu")
