"""Confusion-matrix segmentation metrics (IoU / accuracy / Dice).

Counterpart of ``glomeruli_segmentation_tpu/eval/iou_eval.py``, which
replicates the reference evaluator (``module/common/IOUEval.py``):

- ``add_batch`` accumulates a KxK confusion matrix via the bincount trick
  (``IOUEval.py:19-21``; rows = ground truth, cols = prediction) *and*
  per-batch metric running means.
- ``get_metric``       — mean of per-batch metrics (biased; used only in the
  reference training logs, ``IOUEval.py:55-61``).
- ``get_metric_right`` — metrics from the summed histogram (the reported
  numbers, ``IOUEval.py:63-69``).
- ``get_metric_micro`` — micro metrics plus per-class Dice / mean Dice, the
  method the GTCS evaluator expects
  (``module/SegFormer/test/eval_wsi_segmentation_gtcs.py:116-118``).

Snake_case is canonical; the reference camelCase methods are aliases.  The
numpy part is the port's own copy of the JAX module's; a test holds the two
equal.  :func:`confusion_matrix` is the histogram in torch ops on the
tensors' device (the JAX package computes it in XLA ops, outside any
Pallas kernel).
"""
from __future__ import annotations

import numpy as np
import torch

EPSILON = 1e-8


def fast_hist(gt: np.ndarray, pred: np.ndarray, n_classes: int) -> np.ndarray:
    """KxK confusion matrix; rows = gt, cols = pred (IOUEval.py:19-21)."""
    k = (gt >= 0) & (gt < n_classes)
    return np.bincount(
        n_classes * gt[k].astype(int) + pred[k], minlength=n_classes**2
    ).reshape(n_classes, n_classes)


def _metrics_from_hist(hist: np.ndarray):
    diag = np.diag(hist)
    overall_acc = diag.sum() / (hist.sum() + EPSILON)
    per_class_acc = diag / (hist.sum(1) + EPSILON)
    per_class_iou = diag / (hist.sum(1) + hist.sum(0) - diag + EPSILON)
    miou = np.nanmean(per_class_iou)
    return overall_acc, per_class_acc, per_class_iou, miou


class IouEval:
    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self.reset()

    def reset(self):
        self.overall_acc = 0.0
        self.per_class_acc = np.zeros(self.n_classes, dtype=np.float64)
        self.per_class_iou = np.zeros(self.n_classes, dtype=np.float64)
        self.miou = 0.0
        self.batch_count = 0
        self.hist = np.zeros((self.n_classes, self.n_classes), dtype=np.int64)

    @staticmethod
    def _to_numpy(a) -> np.ndarray:
        if hasattr(a, "detach"):  # torch tensor from ported user code
            a = a.detach().cpu().numpy()
        return np.asarray(a).reshape(-1)

    def add_batch(self, predict, gt) -> np.ndarray:
        predict = self._to_numpy(predict)
        gt = self._to_numpy(gt)
        hist = fast_hist(gt, predict, self.n_classes)
        return self.add_hist(hist)

    def add_hist(self, hist) -> np.ndarray:
        """Accumulate a precomputed KxK batch histogram.

        Semantically identical to :meth:`add_batch` given the same batch
        (both the summed histogram and the per-batch metric running means
        derive from the batch hist alone); used when the histogram is
        computed on device inside the training step (:func:`confusion_matrix`)
        so only KxK ints cross device->host instead of the full argmax map —
        and, under a multi-process mesh, so no process needs the other
        processes' prediction shards."""
        hist = np.asarray(hist).astype(np.int64)
        self.hist += hist

        overall_acc, per_class_acc, per_class_iou, miou = _metrics_from_hist(hist)
        self.overall_acc += overall_acc
        self.per_class_acc += per_class_acc
        self.per_class_iou += per_class_iou
        self.miou += miou
        self.batch_count += 1
        return hist

    def get_metric(self):
        """Mean of per-batch metrics (biased; training-log flavour)."""
        n = self.batch_count
        return (
            self.overall_acc / n,
            self.per_class_acc / n,
            self.per_class_iou / n,
            self.miou / n,
        )

    def get_metric_right(self):
        """True micro metrics from the accumulated histogram."""
        return _metrics_from_hist(self.hist)

    def get_metric_micro(self):
        """Micro metrics + per-class Dice and mean Dice (GTCS evaluator)."""
        overall_acc, per_class_acc, per_class_iou, miou = _metrics_from_hist(self.hist)
        diag = np.diag(self.hist)
        per_class_dice = 2.0 * diag / (self.hist.sum(1) + self.hist.sum(0) + EPSILON)
        mdice = np.nanmean(per_class_dice)
        return overall_acc, per_class_acc, per_class_iou, miou, per_class_dice, mdice

    # Reference-compatible aliases (module/common/IOUEval.py API)
    addBatch = add_batch
    getMetric = get_metric
    getMetricRight = get_metric_right
    getMetricMicro = get_metric_micro


# reference alias
iouEval = IouEval


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, n_classes: int,
                     sample_valid: torch.Tensor = None) -> torch.Tensor:
    """KxK int32 confusion matrix on the tensors' device.

    ``pred``/``gt`` are integer tensors of any (matching) shape.
    Out-of-range gt pixels are dropped, matching :func:`fast_hist`.
    ``sample_valid`` (bool, the leading batch axis) additionally drops
    whole samples, the rows a trainer appends to keep per-device shards
    even.  ``pred`` is non-negative; a bin past the histogram is dropped,
    as the JAX scatter drops it.
    """
    # int32 up front: narrow label dtypes (uint8 palettes) would overflow
    # in n_classes * gt
    pred = pred.to(torch.int32)
    gt = gt.to(torch.int32)
    if sample_valid is not None:
        shape = (-1,) + (1,) * (gt.dim() - 1)
        gt = torch.where(sample_valid.to(gt.device).reshape(shape), gt,
                         n_classes)
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    size = n_classes * n_classes + 1
    valid = (gt >= 0) & (gt < n_classes)
    idx = torch.where(valid, n_classes * gt + pred, size - 1)
    counts = torch.bincount(idx.clamp(max=size - 1), minlength=size)
    return counts[:-1].to(torch.int32).reshape(n_classes, n_classes)


def device_confusion(pred: torch.Tensor, gt: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """:func:`confusion_matrix` without ``sample_valid`` (the JAX package's
    jitted entry point of the same name)."""
    return confusion_matrix(pred, gt, n_classes)
