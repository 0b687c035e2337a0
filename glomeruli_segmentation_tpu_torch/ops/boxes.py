"""Box utilities of the detector: boxes are ``[ymin, xmin, ymax, xmax]``,
anchor deltas the Faster R-CNN ``(ty, tx, th, tw)`` with scale factors
(10, 10, 5, 5), as in the TF Object Detection API.

Counterpart of ``glomeruli_segmentation_tpu/ops/boxes.py``; every function
does its arithmetic in the same order, in the boxes' type (float32 on the
detector's path).  :func:`encode_boxes` gives the detector trainers their
regression targets; :func:`boxes_iou` also takes batches of boxes.
"""
from __future__ import annotations

import numpy as np
import torch

BBOX_XFORM_CLIP = 4.135166556742356  # log(1000/16): clamp dh/dw like the OD API


def boxes_area(boxes: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * \
        torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0)


def boxes_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) -> (..., N, M); the
    leading axes broadcast."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = boxes_area(a)[..., :, None] + boxes_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 scales=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """Ground-truth boxes -> anchor-relative deltas (ty, tx, th, tw); the
    leading axes broadcast."""
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    acy = anchors[..., 0] + 0.5 * ah
    acx = anchors[..., 1] + 0.5 * aw
    bh = boxes[..., 2] - boxes[..., 0]
    bw = boxes[..., 3] - boxes[..., 1]
    bcy = boxes[..., 0] + 0.5 * bh
    bcx = boxes[..., 1] + 0.5 * bw
    eps = 1e-8
    ty = (bcy - acy) / (ah + eps) * scales[0]
    tx = (bcx - acx) / (aw + eps) * scales[1]
    th = torch.log((bh + eps) / (ah + eps)) * scales[2]
    tw = torch.log((bw + eps) / (aw + eps)) * scales[3]
    return torch.stack([ty, tx, th, tw], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 scales=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """Anchor deltas -> boxes [ymin, xmin, ymax, xmax]."""
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    acy = anchors[..., 0] + 0.5 * ah
    acx = anchors[..., 1] + 0.5 * aw
    ty = deltas[..., 0] / scales[0]
    tx = deltas[..., 1] / scales[1]
    th = torch.clamp(deltas[..., 2] / scales[2], max=BBOX_XFORM_CLIP)
    tw = torch.clamp(deltas[..., 3] / scales[3], max=BBOX_XFORM_CLIP)
    cy = ty * ah + acy
    cx = tx * aw + acx
    h = torch.exp(th) * ah
    w = torch.exp(tw) * aw
    return torch.stack([cy - 0.5 * h, cx - 0.5 * w, cy + 0.5 * h,
                        cx + 0.5 * w], dim=-1)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    ymin = torch.clamp(boxes[..., 0], 0, height)
    xmin = torch.clamp(boxes[..., 1], 0, width)
    ymax = torch.clamp(boxes[..., 2], 0, height)
    xmax = torch.clamp(boxes[..., 3], 0, width)
    return torch.stack([ymin, xmin, ymax, xmax], dim=-1)


def generate_anchors(feat_h: int, feat_w: int, stride: int,
                     scales=(0.25, 0.5, 1.0, 2.0),
                     aspect_ratios=(0.5, 1.0, 2.0),
                     base_size: float = 256.0) -> torch.Tensor:
    """Grid anchors in pixel coords, OD API style: center-anchored boxes of
    ``base_size * scale`` area at every feature-map cell.

    Returns (feat_h * feat_w * A, 4) float32 on the CPU, with
    A = len(scales)*len(aspect_ratios), cell-major: the order fixes which
    RPN output channel pairs with which anchor.
    """
    scales_grid, aspects_grid = np.meshgrid(scales, aspect_ratios)
    scales_grid = scales_grid.reshape(-1)
    aspects_grid = aspects_grid.reshape(-1)
    heights = scales_grid * np.sqrt(aspects_grid) * base_size
    widths = scales_grid / np.sqrt(aspects_grid) * base_size

    ys = (np.arange(feat_h) + 0.5) * stride
    xs = (np.arange(feat_w) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)
    cy = cy.reshape(-1, 1)
    cx = cx.reshape(-1, 1)
    anchors = np.stack([
        np.broadcast_to(cy - heights / 2, (feat_h * feat_w, len(heights))),
        np.broadcast_to(cx - widths / 2, (feat_h * feat_w, len(widths))),
        np.broadcast_to(cy + heights / 2, (feat_h * feat_w, len(heights))),
        np.broadcast_to(cx + widths / 2, (feat_h * feat_w, len(widths))),
    ], axis=-1)
    return torch.from_numpy(anchors.reshape(-1, 4).astype(np.float32))
