"""The port's OD-API inception_v2 Faster R-CNN against the JAX package's,
stage by stage, on the tiny-width trees of ``build_od_api_consts`` in
float32: anchors, the first stage, the proposals and the whole ``detect``
at one and two classes."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_od_api_import import build_od_api_consts

from glomeruli_segmentation_tpu.convert.pb_import import (
    assemble_od_api_params,
)
from glomeruli_segmentation_tpu.models import od_api_frcnn as jax_od
from glomeruli_segmentation_tpu.ops.boxes import clip_boxes, decode_boxes
from glomeruli_segmentation_tpu.ops.nms import nms as jax_nms
from glomeruli_segmentation_tpu_torch.models import od_api_frcnn as port_od
from glomeruli_segmentation_tpu_torch.ops import nms as port_nms

# a 64x96 window: 4 x 6 cells x 12 anchors = 288 RPN scores
SMALL = dict(image_size=(64, 96), pre_nms_top_n=200, max_proposals=20,
             max_detections=10)


def _images(seed, n=2, h=64, w=96):
    """PAS-like windows: noisy pink background, dark round blobs."""
    rng = np.random.RandomState(seed)
    img = np.clip(rng.randint(-20, 20, (n, h, w, 3))
                  + np.asarray((220, 190, 205)), 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for b in range(n):
        for _ in range(3):
            cy, cx, r = rng.uniform(8, h - 8), rng.uniform(8, w - 8), \
                rng.uniform(4, 16)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = (120, 60, 100)
    return img


def _models(seed, num_classes=1, **overrides):
    tree, n = assemble_od_api_params(
        build_od_api_consts(seed=seed, num_classes=num_classes)[0])
    assert n == num_classes
    kw = dict(SMALL, num_classes=num_classes, **overrides)
    jm = jax_od.ODAPIFasterRCNN(tree, jax_od.ODAPIConfig(**kw), "float32")
    pm = port_od.ODAPIFasterRCNN(tree, port_od.ODAPIConfig(**kw), "float32")
    return jm, pm.eval()


def test_config_and_constants_match_jax():
    assert dataclasses.asdict(port_od.ODAPIConfig()) == \
        dataclasses.asdict(jax_od.ODAPIConfig())
    assert port_od.NEG_PAD == jax_od.NEG_PAD


@pytest.mark.parametrize("h,w", [(64, 64), (66, 97), (600, 800)])
def test_anchors_equal_jax(h, w):
    cfg = dict(image_size=(h, w))
    got = port_od.build_anchors(port_od.ODAPIConfig(**cfg)).numpy()
    want = np.asarray(jax_od.ODAPIFasterRCNN(
        {}, jax_od.ODAPIConfig(**cfg), "float32").anchors)
    assert got.dtype == np.float32
    assert got.shape == (-(-h // 16) * -(-w // 16) * 12, 4)
    np.testing.assert_array_equal(got, want)


def test_600_window_has_17328_anchors_aspect_major():
    a = port_od.build_anchors(port_od.ODAPIConfig()).numpy()
    assert a.shape == (38 * 38 * 12, 4) == (17328, 4)
    # cell (0, 0): the first three anchors have aspect 0.5 (taller than
    # wide: height = scale / sqrt(aspect) * base), centred at (0, 0) and
    # clipped to the image
    hw = a[:12, 2:] - a[:12, :2]
    assert (hw[:4, 0] >= hw[:4, 1]).all() and (a[:12, :2] == 0).all()


@pytest.mark.parametrize("h,w,want", [
    (874, 874, (600, 600)), (1200, 600, (1024, 512)),
    (300, 400, (600, 800)), (300, 600, (512, 1024)),
    (1104, 1104, (600, 600)), (1104, 900, (736, 600))])
def test_keep_aspect_resize_shape_matches_jax(h, w, want):
    got = port_od.keep_aspect_resize_shape(h, w, 600, 1024)
    assert got == jax_od.keep_aspect_resize_shape(h, w, 600, 1024) == want


@pytest.mark.parametrize("num_classes", [1, 2])
def test_first_stage_matches_jax(num_classes):
    jm, pm = _models(3, num_classes)
    images = _images(1)
    feats, obj, deltas = (np.asarray(a) for a in
                          jm._first_stage(jnp.asarray(images)))
    with torch.no_grad():
        got = pm.first_stage(torch.from_numpy(images))
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), feats,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), obj, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), deltas, rtol=1e-4, atol=1e-4)


def _jax_proposal_indices(jm, obj, deltas):
    """The JAX model's _propose, stopping at the indices: the top-k
    selection and the NMS survivors of each window."""
    cfg = jm.config
    h, w = cfg.image_size
    out = []
    for obj_i, deltas_i in zip(obj, deltas):
        scores = jax.nn.softmax(jnp.asarray(obj_i), axis=-1)[:, 1]
        top_scores, top_idx = jax.lax.top_k(
            scores, min(cfg.pre_nms_top_n, scores.shape[0]))
        boxes = clip_boxes(decode_boxes(jnp.asarray(deltas_i)[top_idx],
                                        jm.anchors[top_idx]), h, w)
        keep, _ = jax_nms(boxes, top_scores, cfg.max_proposals,
                          cfg.rpn_nms_threshold)
        out.append((np.asarray(top_idx), np.asarray(keep)))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_proposals_match_jax(seed):
    jm, pm = _models(seed)
    images = _images(seed)
    _, obj, deltas = jm._first_stage(jnp.asarray(images))
    obj, deltas = np.array(obj), np.array(deltas)
    want_boxes, want_scores = (np.asarray(a) for a in jm._propose(
        jnp.asarray(obj), jnp.asarray(deltas)))
    anchors = port_od.build_anchors(pm.config)
    # on the JAX stage outputs: the same top-k and NMS indices
    boxes, scores = pm.rpn_candidates(torch.from_numpy(obj),
                                      torch.from_numpy(deltas), anchors)
    keep, _ = port_nms.nms(boxes, scores, pm.config.max_proposals,
                           pm.config.rpn_nms_threshold)
    top_idx = port_od.top_k(port_od.softmax(torch.from_numpy(obj))[..., 1],
                            pm.config.pre_nms_top_n)[1]
    for b, (want_top, want_keep) in enumerate(
            _jax_proposal_indices(jm, obj, deltas)):
        np.testing.assert_array_equal(top_idx[b].numpy(), want_top)
        np.testing.assert_array_equal(keep[b].numpy(), want_keep)
    # and from the port's own first stage: the same proposals
    with torch.no_grad():
        _, pobj, pdeltas = pm.first_stage(torch.from_numpy(images))
        got_boxes, got_scores = pm.propose(pobj, pdeltas, anchors)
    np.testing.assert_array_equal(got_scores.numpy() == port_od.NEG_PAD,
                                  want_scores == jax_od.NEG_PAD)
    np.testing.assert_allclose(got_boxes.numpy(), want_boxes, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, rtol=1e-4,
                               atol=1e-4)


def test_box_classifier_on_jax_proposals_matches():
    jm, pm = _models(5, 2)
    images = _images(5)
    feats, obj, deltas = jm._first_stage(jnp.asarray(images))
    proposals, _ = jm._propose(obj, deltas)
    want_cls, want_enc = (np.asarray(a) for a in
                          jm._box_classifier(feats, proposals))
    with torch.no_grad():
        got_cls, got_enc = pm.box_classifier(
            torch.from_numpy(np.array(feats)).permute(0, 3, 1, 2),
            torch.from_numpy(np.array(proposals)))
    assert got_enc.shape == want_enc.shape == (2, 20, 2, 4)
    np.testing.assert_allclose(got_cls.numpy(), want_cls, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_enc.numpy(), want_enc, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("num_classes,seed", [(1, 3), (2, 9)])
def test_detect_matches_jax(num_classes, seed):
    jm, pm = _models(seed, num_classes)
    images = _images(seed)
    want = jax.tree.map(np.asarray, jm.detect(jnp.asarray(images)))
    before = port_nms.nms.launches
    got = pm.detect(torch.from_numpy(images),
                    port_od.build_anchors(pm.config))
    assert port_nms.nms.launches == before  # CPU: the plain NMS
    np.testing.assert_array_equal(got["num_detections"].numpy(),
                                  want["num_detections"])
    np.testing.assert_array_equal(got["detection_classes"].numpy(),
                                  want["detection_classes"])
    for key in ("detection_scores", "detection_boxes"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-4)
    assert (got["num_detections"].numpy() > 0).all()


def test_padded_proposals_give_no_detections():
    """Fewer NMS survivors than max_proposals: the padded proposals are
    masked out of the second stage's scores."""
    jm, pm = _models(3, max_proposals=150, rpn_nms_threshold=0.3)
    images = _images(3)
    want = jax.tree.map(np.asarray, jm.detect(jnp.asarray(images)))
    with torch.no_grad():
        _, obj, deltas = pm.first_stage(torch.from_numpy(images))
        _, prop_scores = pm.propose(obj, deltas,
                                    port_od.build_anchors(pm.config))
    assert (prop_scores == port_od.NEG_PAD).any()
    got = pm.detect(torch.from_numpy(images),
                    port_od.build_anchors(pm.config))
    np.testing.assert_array_equal(got["num_detections"].numpy(),
                                  want["num_detections"])
    np.testing.assert_allclose(got["detection_scores"].numpy(),
                               want["detection_scores"], rtol=1e-4,
                               atol=1e-4)


def test_kernel_nms_switch_and_views_share_weights():
    _, pm = _models(3)
    images = torch.from_numpy(_images(3))
    anchors = port_od.build_anchors(pm.config)
    got = pm.detect(images, anchors)
    pm.kernel_nms = False
    try:
        plain = pm.detect(images, anchors)
    finally:
        pm.kernel_nms = True
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), plain[k].numpy())
    view = pm.with_image_size(600, 736)
    assert view.config.image_size == (600, 736)
    assert pm.config.image_size == (64, 96)
    assert view.first is pm.first and view.fc_cls is pm.fc_cls


def test_compute_dtype_keeps_the_heads_float32():
    tree, _ = assemble_od_api_params(build_od_api_consts(seed=3)[0])
    pm = port_od.ODAPIFasterRCNN(tree, port_od.ODAPIConfig(**SMALL))
    assert pm.dtype == torch.bfloat16
    assert pm.first.Conv2d_2b_1x1.weight.dtype == torch.bfloat16
    assert pm.fc_cls.weight.dtype == torch.float32
    det = pm.detect(torch.from_numpy(_images(3)),
                    port_od.build_anchors(pm.config))
    assert det["detection_boxes"].dtype == torch.float32
    assert np.isfinite(det["detection_scores"].numpy()).all()
