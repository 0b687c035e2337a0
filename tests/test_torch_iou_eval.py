"""The port's evaluator (``eval/iou_eval.py``) against the JAX package's
on the CPU: ``IouEval``'s histograms and metrics, and the torch
``confusion_matrix`` against the JAX one."""
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.eval import iou_eval as jax_iou
from glomeruli_segmentation_tpu_torch.eval import iou_eval


def _batches(seed, n=4, classes=5, shape=(3, 40, 50)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        gt = rng.randint(0, classes, shape)
        pred = np.where(rng.rand(*shape) < 0.6, gt,
                        rng.randint(0, classes, shape))
        out.append((pred.astype(np.uint8), gt.astype(np.uint8)))
    # a class absent from a batch, and one never predicted
    out.append((np.zeros(shape, np.uint8), np.ones(shape, np.uint8)))
    return out


@pytest.mark.parametrize("classes", [4, 5])
def test_iou_eval_matches_jax(classes):
    ours, theirs = iou_eval.IouEval(classes), jax_iou.IouEval(classes)
    for pred, gt in _batches(classes, classes=classes):
        # the port's evaluator also takes torch tensors
        h1 = ours.add_batch(torch.from_numpy(pred), torch.from_numpy(gt))
        h2 = theirs.add_batch(pred, gt)
        np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(ours.hist, theirs.hist)
    assert ours.batch_count == theirs.batch_count
    for method in ("get_metric", "get_metric_right", "get_metric_micro",
                   "getMetric", "getMetricRight", "getMetricMicro"):
        for a, b in zip(getattr(ours, method)(), getattr(theirs, method)()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert iou_eval.iouEval is iou_eval.IouEval
    assert iou_eval.IouEval.addBatch is iou_eval.IouEval.add_batch
    ours.add_hist(theirs.hist)
    np.testing.assert_array_equal(ours.hist, 2 * theirs.hist)
    ours.reset()
    assert ours.batch_count == 0 and not ours.hist.any()
    gt = np.array([0, 1, 7, 4, -1, 2])
    pred = np.array([0, 1, 2, 3, 1, 2])
    np.testing.assert_array_equal(iou_eval.fast_hist(gt, pred, 5),
                                  jax_iou.fast_hist(gt, pred, 5))


CONFUSION = {
    # uint8 palettes: n * gt overflows uint8 unless widened first
    "uint8": lambda rng: (rng.randint(0, 60, (2, 16, 16)).astype(np.uint8)
                          % 60, rng.randint(0, 60, (2, 16, 16))
                          .astype(np.uint8), None, 60),
    # ground truth outside [0, n) is dropped
    "out_of_range_gt": lambda rng: (rng.randint(0, 5, (3, 8, 8)),
                                    rng.randint(-2, 8, (3, 8, 8)), None, 5),
    # whole samples dropped
    "sample_valid": lambda rng: (rng.randint(0, 5, (4, 8, 8)),
                                 rng.randint(0, 5, (4, 8, 8)),
                                 np.array([True, False, True, False]), 5),
}


@pytest.mark.parametrize("case", list(CONFUSION))
def test_confusion_matrix_matches_jax(case):
    pred, gt, valid, n = CONFUSION[case](np.random.RandomState(1))
    got = iou_eval.confusion_matrix(
        torch.from_numpy(pred), torch.from_numpy(gt), n,
        None if valid is None else torch.from_numpy(valid))
    want = np.asarray(jax_iou.confusion_matrix(pred, gt, n, valid))
    assert got.dtype == torch.int32 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), want)
    keep = np.ones(len(gt), bool) if valid is None else valid
    np.testing.assert_array_equal(
        got.numpy(), iou_eval.fast_hist(gt[keep].ravel(),
                                        pred[keep].ravel(), n))
    np.testing.assert_array_equal(
        iou_eval.device_confusion(torch.from_numpy(pred),
                                  torch.from_numpy(gt), n).numpy(),
        np.asarray(jax_iou.device_confusion(pred, gt, n)))
