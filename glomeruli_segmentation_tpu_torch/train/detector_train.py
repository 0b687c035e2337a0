"""Faster R-CNN training losses (static-shape target assignment).

Counterpart of ``glomeruli_segmentation_tpu/train/detector_train.py``, the
standard two-stage losses:

- RPN: anchors with IoU >= ``pos_iou`` to any GT (plus the best anchor per
  GT) are positive, IoU < ``neg_iou`` negative; softmax CE + smooth-L1 on
  the encoded deltas.
- Box head: proposals with IoU >= ``pos_iou`` are positive; softmax CE over
  C+1 classes + smooth-L1 on the matched class's deltas.

GT is passed padded: ``gt_boxes`` (N, G, 4) pixel [ymin, xmin, ymax, xmax],
``gt_classes`` (N, G) int 1-based, ``gt_valid`` (N, G) bool.

The JAX package maps a per-window function over the batch; here every
function works on the whole batch at once, with the same operations in the
same order, in float32.  In a rank of a data axis (``global_batch``) the
batch means become the rank's sums over the global batch size, so that the
ranks' losses sum to the global batch's.  Ties in every argmax go to the
lowest index, as ``jnp.argmax``.  Where two GT rows name the same best
anchor (a padded row, IoU -1 everywhere, names anchor 0), the later row's
flag wins, as the JAX package's scatter gives on the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.boxes import boxes_iou, encode_boxes


def smooth_l1(x: torch.Tensor, delta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < delta, 0.5 * x * x / delta, ax - 0.5 * delta)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Log-softmax over the last axis as ``jax.nn.log_softmax`` computes it:
    ``x - max`` (the max without gradient) less the log of its exp-sum."""
    shifted = x - x.detach().max(dim=-1, keepdim=True).values
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _masked_iou(boxes: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor) -> torch.Tensor:
    """(N, K, 4) or (K, 4) boxes against (N, G, 4) GT -> (N, K, G) IoU,
    -1 against padded GT rows."""
    iou = boxes_iou(boxes, gt_boxes)
    return torch.where(gt_valid[:, None, :], iou, -1.0)


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``values[n, index[n, k]]`` for (N, G, ...) values and (N, K)
    indices -> (N, K, ...)."""
    rows = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[rows, index]


def _assign(anchors: torch.Tensor, gt_boxes: torch.Tensor,
            gt_valid: torch.Tensor, pos_iou: float, neg_iou: float,
            force_best: bool = True):
    """Per-anchor match of every window: anchors (A, 4), GT (N, G, 4) ->
    (matched GT index (N, A), positive mask (N, A), negative mask (N, A))."""
    iou = _masked_iou(anchors, gt_boxes, gt_valid)         # (N, A, G)
    best_iou, _ = iou.max(dim=2)
    best_gt = iou.argmax(dim=2)
    pos = best_iou >= pos_iou
    neg = best_iou < neg_iou
    if force_best:
        # the highest-IoU anchor of each valid GT is positive
        n, a, g = iou.shape
        best_anchor = iou.argmax(dim=1)                    # (N, G)
        flag = gt_valid & (iou.max(dim=1).values > 0)      # (N, G)
        # the scatter's last write wins: per anchor, the last GT row that
        # names it sets its flag
        names = best_anchor[:, :, None] == torch.arange(
            a, device=iou.device)                          # (N, G, A)
        rows = torch.arange(g, device=iou.device)[None, :, None]
        last = torch.where(names, rows, -1).max(dim=1).values   # (N, A)
        force = (last >= 0) & torch.gather(flag, 1, last.clamp_min(0))
        pos = pos | force
        neg = neg & ~force
    return best_gt, pos, neg


def _mean_over(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / max(count, 1) over the last axis.  A masked-out
    entry adds exactly 0 even where it is not finite, as the JAX package's
    product with a boolean mask gives on the CPU."""
    return (torch.where(mask, values, 0.0).sum(dim=-1)
            / mask.sum(dim=-1).clamp_min(1))


def _batch_mean(values: torch.Tensor, global_batch: Optional[int]
                ) -> torch.Tensor:
    """The mean over the windows, or this rank's share of the global
    batch's mean: the sum over ``global_batch``."""
    if global_batch is None:
        return values.mean()
    return values.sum() / global_batch


def rpn_loss(anchors, rpn_obj, rpn_deltas, gt_boxes, gt_classes, gt_valid,
             pos_iou: float = 0.7, neg_iou: float = 0.3,
             global_batch: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
    """Batched RPN loss. rpn_obj: (N, A, 2), rpn_deltas: (N, A, 4)."""
    best_gt, pos, neg = _assign(anchors, gt_boxes, gt_valid, pos_iou,
                                neg_iou)
    labels = pos.long()
    sample = pos | neg
    logp = log_softmax(rpn_obj)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    cls_loss = _mean_over(ce, sample)
    targets = encode_boxes(_take(gt_boxes, best_gt), anchors)
    reg = smooth_l1(rpn_deltas - targets).sum(-1)
    reg_loss = _mean_over(reg, pos)
    return {"rpn_cls": _batch_mean(cls_loss, global_batch),
            "rpn_reg": _batch_mean(reg_loss, global_batch)}


def box_head_loss(proposals, class_scores, box_deltas, gt_boxes, gt_classes,
                  gt_valid, pos_iou: float = 0.5,
                  global_batch: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Second-stage loss. proposals: (N, P, 4), class_scores: (N, P, C+1),
    box_deltas: (N, P, C, 4)."""
    iou = _masked_iou(proposals, gt_boxes, gt_valid)       # (N, P, G)
    best_iou, _ = iou.max(dim=2)
    best_gt = iou.argmax(dim=2)
    pos = best_iou >= pos_iou
    # degenerate (all-pad NMS slots) proposals are ignored entirely
    live = (proposals[..., 2] > proposals[..., 0]) & \
        (proposals[..., 3] > proposals[..., 1])
    labels = torch.where(pos, _take(gt_classes, best_gt).long(), 0)
    logp = log_softmax(class_scores)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    cls_loss = _mean_over(ce, live)
    targets = encode_boxes(_take(gt_boxes, best_gt), proposals)
    cls_idx = torch.clamp_min(labels - 1, 0)
    chosen = torch.gather(box_deltas, 2, cls_idx[..., None, None].expand(
        *cls_idx.shape, 1, 4))[..., 0, :]
    reg = smooth_l1(chosen - targets).sum(-1)
    reg_loss = _mean_over(reg, pos & live)
    return {"roi_cls": _batch_mean(cls_loss, global_batch),
            "roi_reg": _batch_mean(reg_loss, global_batch)}


def detector_loss(anchors, outputs, gt_boxes, gt_classes, gt_valid,
                  global_batch: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """The four losses and their sum, ``total``; no gradient reaches the
    proposals.  With ``global_batch``, this rank's shares of them."""
    losses = rpn_loss(anchors, outputs["rpn_objectness"],
                      outputs["rpn_deltas"], gt_boxes, gt_classes, gt_valid,
                      global_batch=global_batch)
    losses.update(box_head_loss(
        outputs["proposals"].detach(), outputs["class_scores"],
        outputs["box_deltas"], gt_boxes, gt_classes, gt_valid,
        global_batch=global_batch))
    losses["total"] = (losses["rpn_cls"] + losses["rpn_reg"]
                       + losses["roi_cls"] + losses["roi_reg"])
    return losses
