"""The port's detector training losses (``train/detector_train.py``,
``ops/boxes.py`` ``encode_boxes``) against the JAX package's on the CPU.

Inputs are made from a numpy seed: anchors of a small grid, padded GT
(some windows with padded rows, one with none valid), network outputs, and
proposals with degenerate rows (the padded NMS slots).  Tolerance: every
loss within 1e-6 relative, every gradient with respect to the four network
outputs within 1e-6 of the largest gradient of its tensor (float32 sums
taken in another order); masks and matched indices equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.ops import boxes as jax_boxes
from glomeruli_segmentation_tpu.train import detector_train as jax_dt
from glomeruli_segmentation_tpu_torch.ops import boxes as port_boxes
from glomeruli_segmentation_tpu_torch.train import detector_train as port_dt

RTOL = 1e-6
N, G, P, C = 3, 5, 24, 2
OUTPUTS = ("rpn_objectness", "rpn_deltas", "class_scores", "box_deltas")


def _boxes(rng, shape, size=128.0, lo=6.0, hi=70.0):
    yx = rng.uniform(0, size - lo, shape + (2,))
    hw = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([yx, np.minimum(yx + hw, size)], -1).astype(
        np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    anchors = np.asarray(jax_boxes.generate_anchors(
        8, 8, 16, (0.25, 0.5), (0.5, 1.0, 2.0), 128.0))
    a = anchors.shape[0]
    gt_boxes = _boxes(rng, (N, G))
    # one GT equal to an anchor: a positive at the 0.7 threshold for sure
    gt_boxes[0, 0] = anchors[37]
    gt_valid = np.ones((N, G), bool)
    gt_valid[0, 3:] = False          # padded rows after valid ones
    gt_valid[1, :] = False           # a window without GT
    gt_boxes[~gt_valid] = 0.0
    gt_classes = rng.randint(1, C + 1, (N, G)).astype(np.int32)
    gt_classes[~gt_valid] = 0
    proposals = _boxes(rng, (N, P), lo=1.0)
    # near the GT, and ordered as decoded, clipped NMS survivors are
    near = np.clip(gt_boxes[:, :4] + rng.uniform(-6, 6, (N, 4, 4)), 0, 128)
    proposals[:, :4] = np.concatenate([np.minimum(near[..., :2],
                                                  near[..., 2:]),
                                       np.maximum(near[..., :2],
                                                  near[..., 2:])], -1)
    proposals[:, -5:] = 0.0          # the padded NMS slots
    proposals[2, -6] = [40, 40, 40, 80]     # zero height
    outputs = {
        "rpn_objectness": rng.randn(N, a, 2).astype(np.float32),
        "rpn_deltas": (rng.randn(N, a, 4) * 0.5).astype(np.float32),
        "proposals": proposals,
        "class_scores": rng.randn(N, P, C + 1).astype(np.float32),
        "box_deltas": (rng.randn(N, P, C, 4) * 0.5).astype(np.float32),
    }
    return anchors, outputs, gt_boxes, gt_classes, gt_valid


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=err_msg)


@pytest.mark.parametrize("batched", [False, True])
def test_encode_boxes_matches_jax(batched):
    rng = np.random.RandomState(1)
    shape = (3, 40) if batched else (40,)
    boxes, anchors = _boxes(rng, shape), _boxes(rng, (40,))
    boxes[..., 3, :] = 0.0           # a padded GT row
    want = np.asarray(jax_boxes.encode_boxes(jnp.asarray(boxes),
                                             jnp.asarray(anchors)))
    got = port_boxes.encode_boxes(_t(boxes), _t(anchors)).numpy()
    assert got.dtype == np.float32 and got.shape == shape + (4,)
    _close(got, want)
    assert np.isfinite(got).all()


def test_smooth_l1_and_its_gradient_match_jax():
    x = np.linspace(-0.5, 0.5, 201).astype(np.float32)
    x = np.concatenate([x, np.float32([1 / 9, -1 / 9, 0.0, 3.0])])
    want = np.asarray(jax_dt.smooth_l1(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(
        lambda v: jax_dt.smooth_l1(v).sum())(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = port_dt.smooth_l1(xt)
    got.sum().backward()
    _close(got.detach().numpy(), want)
    _close(xt.grad.numpy(), want_g)


@pytest.mark.parametrize("force_best", [True, False])
@pytest.mark.parametrize("thresholds", [(0.7, 0.3), (0.5, 0.4)])
def test_assign_matches_jax(case, force_best, thresholds):
    anchors, _, gt_boxes, _, gt_valid = case
    pos_iou, neg_iou = thresholds
    want = jax.vmap(lambda b, v: jax_dt._assign(
        jnp.asarray(anchors), b, v, pos_iou, neg_iou, force_best))(
        jnp.asarray(gt_boxes), jnp.asarray(gt_valid))
    got = port_dt._assign(_t(anchors), _t(gt_boxes), _t(gt_valid), pos_iou,
                          neg_iou, force_best)
    for g, w, name in zip(got, want, ("best_gt", "pos", "neg")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    # the window without GT: every anchor negative, none positive
    assert not got[1][1].any() and got[2][1].all()


@pytest.mark.parametrize("padded_last", [True, False])
def test_assign_collision_at_anchor_zero_matches_jax(padded_last):
    """A valid GT whose best anchor is anchor 0 and a padded GT row (IoU -1
    everywhere, so its best anchor is anchor 0 too) write the same anchor.
    On the CPU the JAX package's scatter keeps the later row's flag: with
    the padded row last, anchor 0 is not forced positive."""
    anchors = np.float32([[0, 0, 10, 10], [0, 0, 5, 5], [20, 20, 30, 30]])
    gt = np.float32([[0, 0, 12, 12], [0, 0, 0, 0]])
    valid = np.asarray([True, False])
    if not padded_last:
        gt, valid = gt[::-1].copy(), valid[::-1].copy()
    # pos_iou above 1: only the forced anchor can be positive
    want = jax_dt._assign(jnp.asarray(anchors), jnp.asarray(gt),
                          jnp.asarray(valid), 1.5, 0.3)
    got = port_dt._assign(_t(anchors), _t(gt[None]), _t(valid[None]), 1.5,
                          0.3)
    assert bool(want[1][0]) is (not padded_last)
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))


def _jax_losses(fn, case, names, **kw):
    anchors, outputs, gt_boxes, gt_classes, gt_valid = case
    outs = {k: jnp.asarray(v) for k, v in outputs.items()}

    def total(diff):
        losses = fn(anchors, {**outs, **diff}, gt_boxes, gt_classes,
                    gt_valid, **kw)
        return sum(losses.values()), losses

    (_, losses), grads = jax.value_and_grad(total, has_aux=True)(
        {k: outs[k] for k in names})
    return ({k: float(v) for k, v in losses.items()},
            {k: np.asarray(v) for k, v in grads.items()})


def _port_losses(fn, case, names, **kw):
    anchors, outputs, gt_boxes, gt_classes, gt_valid = case
    outs = {k: _t(v).clone() for k, v in outputs.items()}
    for k in names:
        outs[k].requires_grad_(True)
    losses = fn(_t(anchors), outs, _t(gt_boxes), _t(gt_classes),
                _t(gt_valid), **kw)
    sum(losses.values()).backward()
    return ({k: float(v) for k, v in losses.items()},
            {k: outs[k].grad.numpy() for k in names}, outs)


def _rpn(fn_mod):
    def fn(anchors, o, gb, gc, gv, **kw):
        return fn_mod.rpn_loss(anchors, o["rpn_objectness"], o["rpn_deltas"],
                               gb, gc, gv, **kw)
    return fn


def _head(fn_mod):
    def fn(anchors, o, gb, gc, gv, **kw):
        return fn_mod.box_head_loss(o["proposals"], o["class_scores"],
                                    o["box_deltas"], gb, gc, gv, **kw)
    return fn


def _detector(fn_mod):
    def fn(anchors, o, gb, gc, gv):
        return fn_mod.detector_loss(anchors, o, gb, gc, gv)
    return fn


LOSSES = {
    "rpn": (_rpn, ("rpn_objectness", "rpn_deltas"), {}),
    "rpn_thresholds": (_rpn, ("rpn_objectness", "rpn_deltas"),
                       {"pos_iou": 0.5, "neg_iou": 0.4}),
    "box_head": (_head, ("class_scores", "box_deltas"), {}),
    "box_head_iou_0.3": (_head, ("class_scores", "box_deltas"),
                         {"pos_iou": 0.3}),
    "detector": (_detector, OUTPUTS, {}),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_and_gradients_match_jax(case, name):
    make, names, kw = LOSSES[name]
    want, want_g = _jax_losses(make(jax_dt), case, names, **kw)
    got, got_g, _ = _port_losses(make(port_dt), case, names, **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= RTOL * abs(w), (k, got[k], w)
        assert np.isfinite(got[k])
    for k in names:
        _close(got_g[k], want_g[k], err_msg=k)
        assert np.abs(want_g[k]).max() > 0, k


def test_detector_loss_sends_no_gradient_to_the_proposals(case):
    make, names, _ = LOSSES["detector"]
    anchors, outputs, gt_boxes, gt_classes, gt_valid = case
    outs = {k: _t(v).clone().requires_grad_(True) for k, v in outputs.items()}
    losses = port_dt.detector_loss(_t(anchors), outs, _t(gt_boxes),
                                   _t(gt_classes), _t(gt_valid))
    losses["total"].backward()
    assert outs["proposals"].grad is None
    assert list(losses) == ["rpn_cls", "rpn_reg", "roi_cls", "roi_reg",
                            "total"]
    assert all(v.dtype == torch.float32 and v.dim() == 0
               for v in losses.values())


def test_degenerate_proposals_are_left_out(case):
    """The padded (all-zero) and zero-height proposals carry no loss: their
    logits and deltas get no gradient, in both packages."""
    _, _, outs = _port_losses(_head(port_dt), case,
                              ("class_scores", "box_deltas"))
    g = outs["class_scores"].grad.numpy()
    assert np.all(g[:, -5:] == 0) and np.all(g[2, -6] == 0)
    assert np.abs(g[:, :4]).max() > 0
