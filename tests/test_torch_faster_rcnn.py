"""The port's Faster R-CNN against the JAX package's, stage by stage, on the
tiny backbone at 128x128 (the JAX package's own test configuration), in
float32, with the Flax weights carried across by ``state_dict_from_flax``."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    random_detector_state,
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models import faster_rcnn as torch_frcnn
from glomeruli_segmentation_tpu_torch.ops import nms as torch_nms

TINY = dict(num_classes=1, image_size=(128, 128), stride=16,
            anchor_scales=(0.25, 0.5), anchor_aspects=(1.0,),
            anchor_base=128.0, pre_nms_top_n=128, post_nms_top_n=16,
            crop_size=8, max_detections=8, backbone="tiny")
# two foreground classes and 4 anchors per cell: the RPN layout and the
# per-class NMS batching have more than one slot to get wrong
TINY2 = dict(TINY, num_classes=2, anchor_aspects=(0.5, 2.0),
             pre_nms_top_n=200, post_nms_top_n=24, max_detections=10)
# the whole detector: 32 of the 128 RPN scores go to the NMS, so the
# pre-NMS scores are far enough apart to hold the port to the same choices
DETECT = dict(TINY, pre_nms_top_n=32)
CONFIGS = {"tiny": TINY, "tiny2": TINY2, "detect": DETECT}
SEED = 4
DETECT_SEED = 27  # its pre-NMS score gaps exceed 100x the logit error


def _images(seed, n=2, size=128):
    """PAS-like windows: noisy pink background, dark round blobs."""
    rng = np.random.RandomState(seed)
    img = np.clip(rng.randint(-12, 12, (n, size, size, 3))
                  + np.asarray((220, 190, 205)), 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for b in range(n):
        for _ in range(3):
            cy, cx, r = rng.uniform(16, size - 16, 3)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < (r / 4) ** 2] = \
                (120, 60, 100)
    return img


def _calibrated(model, variables, x, anchors, rng):
    """Random BN affines near identity, and BN statistics set to the batch
    statistics each BN sees in one train-mode forward over ``x`` (the way
    training leaves them), so activations stay unit-scale and the scores
    spread out instead of saturating."""
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(
            rng.uniform(0.8, 1.2, a.shape) if path[-1].key == "scale"
            else rng.randn(*a.shape) * 0.1 if path[-2].key.endswith("bn")
            and path[-1].key == "bias" else a, np.float32),
        jax.tree.map(np.asarray, variables["params"]))
    zeros = jax.tree.map(np.zeros_like, variables["batch_stats"])
    # running = 0.997 * 0 + 0.003 * batch statistic
    _, upd = model.apply({"params": params, "batch_stats": zeros}, x,
                         anchors, train=True, mutable=["batch_stats"])
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32) / 0.003,
                         upd["batch_stats"])
    return {"params": params, "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def _setup(name, seed):
    """(JAX model, variables, port model, anchors, images, JAX outputs)."""
    kw = CONFIGS[name]
    jcfg = jax_frcnn.FasterRCNNConfig(**kw)
    model = jax_frcnn.FasterRCNN(jcfg)
    anchors = jax_frcnn.build_anchors(jcfg)
    images = _images(seed)
    variables = model.init(jax.random.key(seed), jnp.asarray(images,
                                                             jnp.float32),
                           anchors)
    variables = _calibrated(model, variables, jnp.asarray(images), anchors,
                            np.random.RandomState(seed))
    x = jnp.asarray(images)
    out = jax.tree.map(np.asarray, model.apply(variables, x, anchors))
    det = jax.tree.map(np.asarray, model.apply(
        variables, x, anchors, method=jax_frcnn.FasterRCNN.detect))
    port = torch_frcnn.FasterRCNN(torch_frcnn.FasterRCNNConfig(**kw))
    port.load_state(state_dict_from_flax(variables)).eval()
    return (model, variables, port, torch.from_numpy(np.array(anchors)),
            images, out, det)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-4, rtol=1e-4):
    # f32 convs summed in another order, BN folded into the weights
    got = np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_config_defaults_match_jax():
    import dataclasses

    want = dataclasses.asdict(jax_frcnn.FasterRCNNConfig())
    got = dataclasses.asdict(torch_frcnn.FasterRCNNConfig())
    assert got == want
    assert torch_frcnn.NEG_PAD == jax_frcnn.NEG_PAD
    cfg = torch_frcnn.FasterRCNNConfig(image_size=(1104, 1104))
    np.testing.assert_array_equal(
        torch_frcnn.build_anchors(cfg).numpy(),
        np.asarray(jax_frcnn.build_anchors(jax_frcnn.FasterRCNNConfig(
            image_size=(1104, 1104)))))


@pytest.mark.parametrize("name", ["tiny", "tiny2"])
def test_stage_outputs_match_jax(name):
    _, _, port, anchors, images, out, _ = _setup(name, SEED)
    with torch.no_grad():
        feats = port.features(_t(images))
        _close(feats.permute(0, 2, 3, 1).numpy(), out["features"])
        obj, deltas = port.rpn_outputs(feats)
        _close(obj.numpy(), out["rpn_objectness"])
        _close(deltas.numpy(), out["rpn_deltas"])
        # the second stage on the JAX proposals
        roi = port.roi_features(feats, _t(out["proposals"]))
        scores, box = port.box_head(roi)
    n, p = out["proposals"].shape[:2]
    _close(scores.reshape(n, p, -1).numpy(), out["class_scores"])
    _close(box.reshape(out["box_deltas"].shape).numpy(), out["box_deltas"])


@pytest.mark.parametrize("name", ["tiny", "tiny2"])
def test_propose_on_jax_rpn_outputs_matches(name):
    _, _, port, anchors, _, out, _ = _setup(name, SEED)
    boxes, scores = port.propose(_t(out["rpn_objectness"]),
                                 _t(out["rpn_deltas"]), anchors)
    # the same proposals in the same order: XLA's and PyTorch's exp may
    # differ by one float32 ulp, so boxes and scores are held to 1e-6
    # relative (1e-4 px near zero) and the choice itself exactly
    np.testing.assert_array_equal(scores.numpy() == torch_frcnn.NEG_PAD,
                                  out["proposal_scores"] == jax_frcnn.NEG_PAD)
    np.testing.assert_allclose(scores.numpy(), out["proposal_scores"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(boxes.numpy(), out["proposals"], rtol=1e-6,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "tiny2"])
def test_postprocess_on_jax_stage_outputs_matches(name):
    _, _, port, _, _, out, det = _setup(name, SEED)
    got = port.postprocess(_t(out["proposals"]), _t(out["class_scores"]),
                           _t(out["box_deltas"]))
    np.testing.assert_array_equal(got["num_detections"].numpy(),
                                  det["num_detections"])
    np.testing.assert_array_equal(got["detection_classes"].numpy(),
                                  det["detection_classes"])
    np.testing.assert_allclose(got["detection_scores"].numpy(),
                               det["detection_scores"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["detection_boxes"].numpy(),
                               det["detection_boxes"], rtol=1e-6, atol=1e-6)


def _min_gap(x):
    s = np.sort(np.asarray(x, np.float64).ravel())
    return float(np.diff(s).min())


def test_detect_matches_jax():
    _, _, port, anchors, images, out, det = _setup("detect", DETECT_SEED)
    with torch.no_grad():
        stages = port(_t(images), anchors)
    # precondition: the smallest gap between the sorted pre-NMS scores of
    # either stage (the RPN's top pre_nms_top_n + 1, the boundary of the
    # selection included; every class probability of the second stage)
    # exceeds 100x the largest logit difference, so no near-tie can flip
    logit_err = max(
        np.abs(stages["rpn_objectness"].numpy()
               - out["rpn_objectness"]).max(),
        np.abs(stages["class_scores"].numpy() - out["class_scores"]).max())
    k = DETECT["pre_nms_top_n"]
    for b in range(images.shape[0]):
        rpn = np.sort(np.asarray(
            jax.nn.softmax(out["rpn_objectness"][b], -1)[:, 1]))[::-1]
        assert _min_gap(rpn[: k + 1]) > 100 * logit_err, (b, logit_err)
        probs = jax.nn.softmax(out["class_scores"][b], -1)[:, 1:]
        assert _min_gap(probs) > 100 * logit_err, (b, logit_err)
    before = torch_nms.nms.launches
    got = port.detect(_t(images), anchors)
    assert torch_nms.nms.launches == before  # CPU: the plain NMS
    np.testing.assert_array_equal(got["num_detections"].numpy(),
                                  det["num_detections"])
    np.testing.assert_array_equal(got["detection_classes"].numpy(),
                                  det["detection_classes"])
    _close(got["detection_scores"].numpy(), det["detection_scores"])
    _close(got["detection_boxes"].numpy(), det["detection_boxes"])
    assert (got["num_detections"].numpy() > 0).all()


def test_kernel_nms_switch_gives_the_same_detections():
    _, _, port, anchors, images, _, _ = _setup("tiny", SEED)
    got = port.detect(_t(images), anchors)
    port.kernel_nms = False
    try:
        plain = port.detect(_t(images), anchors)
    finally:
        port.kernel_nms = True
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), plain[k].numpy())


def test_with_image_size_shares_the_weights():
    _, _, port, _, _, _, _ = _setup("tiny", SEED)
    view = port.with_image_size(96, 160)
    assert view.config.image_size == (96, 160)
    assert port.config.image_size == (128, 128)
    assert view.backbone is port.backbone
    assert next(view.parameters()) is next(port.parameters())


def test_stable_top_k_puts_the_lower_index_first():
    x = np.asarray([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    values, idx = torch_frcnn.top_k(torch.from_numpy(x), 4)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v))


def test_random_detector_state_is_calibrated_and_seeded():
    cfg = torch_frcnn.FasterRCNNConfig(**TINY)
    state = random_detector_state(3, cfg, device="cpu", calib_size=(128, 128))
    again = random_detector_state(3, cfg, device="cpu",
                                  calib_size=(128, 128))
    assert set(state) == set(again)
    for k in state:
        assert torch.equal(state[k], again[k]), k
    # the same keys as a Flax tree carried across
    _, variables, _, _, _, _, _ = _setup("tiny", SEED)
    assert set(state) == set(state_dict_from_flax(variables))
    model = torch_frcnn.FasterRCNN(cfg).load_state(state).eval()
    images = _t(_images(7))
    with torch.no_grad():
        feats = model.features(images)
        det = model.detect(images, torch_frcnn.build_anchors(cfg))
    # calibrated BN: unit-scale features, finite and varied scores
    assert 0.1 < float(feats.std()) < 10
    scores = det["detection_scores"].numpy()
    assert np.isfinite(scores).all() and len(np.unique(scores)) > 4
