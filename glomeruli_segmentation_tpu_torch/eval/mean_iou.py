"""mean-IoU metric with the HuggingFace ``evaluate``/mmseg semantics.

The reference imports ``SegFormer.common.mean_iou`` (absent from the tree,
``module/SegFormer/test/test.py:14,57-60``) as a drop-in for the HF
``load_metric("mean_iou")``; its result keys are consumed at
``test.py:245-309``: ``mean_iou``, ``mean_accuracy``, ``overall_accuracy``,
``per_category_iou``, ``per_category_accuracy``, plus the raw
``total_area_intersect/union/label/pred_label`` arrays.

The port's own copy of ``glomeruli_segmentation_tpu/eval/mean_iou.py``
(numpy only); a test holds the two equal.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def intersect_and_union(pred: np.ndarray, label: np.ndarray, num_labels: int,
                        ignore_index: int, reduce_labels: bool = False):
    pred = np.asarray(pred)
    label = np.asarray(label)
    if reduce_labels:
        label = label.copy()
        label[label == 0] = 255
        label = label - 1
        label[label == 254] = 255
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    intersect = pred[pred == label]
    area_intersect = np.histogram(intersect, bins=num_labels,
                                  range=(0, num_labels - 1))[0]
    area_pred = np.histogram(pred, bins=num_labels,
                             range=(0, num_labels - 1))[0]
    area_label = np.histogram(label, bins=num_labels,
                              range=(0, num_labels - 1))[0]
    area_union = area_pred + area_label - area_intersect
    return area_intersect, area_union, area_label, area_pred


def mean_iou(results: Sequence[np.ndarray], gt_seg_maps: Sequence[np.ndarray],
             num_labels: int, ignore_index: int,
             reduce_labels: bool = False,
             nan_to_num: Optional[int] = None) -> Dict:
    total_intersect = np.zeros(num_labels, np.float64)
    total_union = np.zeros(num_labels, np.float64)
    total_label = np.zeros(num_labels, np.float64)
    total_pred = np.zeros(num_labels, np.float64)
    results = np.asarray(results)
    gt_seg_maps = np.asarray(gt_seg_maps)
    if results.ndim == 2:
        results = results[None]
        gt_seg_maps = gt_seg_maps[None]
    for pred, label in zip(results, gt_seg_maps):
        ai, au, al, ap = intersect_and_union(pred, label, num_labels,
                                             ignore_index, reduce_labels)
        total_intersect += ai
        total_union += au
        total_label += al
        total_pred += ap

    with np.errstate(divide="ignore", invalid="ignore"):
        iou = total_intersect / total_union
        acc = total_intersect / total_label
    metrics = {
        "mean_iou": np.nanmean(iou),
        "mean_accuracy": np.nanmean(acc),
        "overall_accuracy": total_intersect.sum() / total_label.sum()
        if total_label.sum() else float("nan"),
        "per_category_iou": iou,
        "per_category_accuracy": acc,
        "total_area_intersect": total_intersect,
        "total_area_union": total_union,
        "total_area_label": total_label,
        "total_area_pred_label": total_pred,
    }
    if nan_to_num is not None:
        metrics = {k: (np.nan_to_num(v, nan=nan_to_num)
                       if isinstance(v, np.ndarray) else v)
                   for k, v in metrics.items()}
    return metrics
