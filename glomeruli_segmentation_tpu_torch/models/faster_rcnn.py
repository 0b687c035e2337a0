"""Faster R-CNN window detector, ResNet-50-C4 or a tiny test backbone: the
folded inference form, and with ``train_form=True`` the training form of
the JAX package's ``FasterRCNN(train=True)``.

Counterpart of ``glomeruli_segmentation_tpu/models/faster_rcnn.py``, with
the same stages and output contract (normalized ``[ymin, xmin, ymax, xmax]``
boxes, scores, 1-based float classes, ``num_detections``).  What differs:

- Activations are NCHW in ``channels_last`` memory; the RPN head's
  outputs are permuted to NHWC before they are flattened, so anchor
  ``(y, x, a)`` pairs with the logits the JAX package pairs it with.
- Every top-k is a stable descending sort (``jax.lax.top_k`` puts the
  lower index first on ties; ``torch.topk`` on CUDA promises no order).
- Both NMS stages run batched: the RPN NMS of all B windows is one call of
  :func:`..ops.nms.nms` (one K3 launch on the GPU), and the per-class
  second-stage NMS of all B x classes problems is one more.
- Box math, softmax and NMS stay float32 whatever the compute type.
- The proposals are made without a graph (``torch.no_grad``, the JAX
  package's ``stop_gradient``), so training launches K3 once a step and
  differentiates no NMS.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.boxes import clip_boxes, decode_boxes, generate_anchors
from ..ops.nms import gather_padded, nms, nms_plain, premask
from ..ops.roi_align import crop_and_resize
from .resnet import (ResNetBlock4, ResNetC4, TinyBackbone, TinyHead,
                     detector_state, fold_batchnorm, train_state_dict)

NEG_PAD = -1e10


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    num_classes: int = 1  # foreground classes ('glomerulus')
    image_size: Tuple[int, int] = (512, 512)
    stride: int = 16
    anchor_scales: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
    anchor_aspects: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_base: float = 256.0
    pre_nms_top_n: int = 2000
    post_nms_top_n: int = 300
    rpn_nms_threshold: float = 0.7
    crop_size: int = 14
    max_detections: int = 100
    second_nms_threshold: float = 0.6
    score_threshold: float = 0.0
    backbone: str = "resnet50"  # or "tiny"
    # image-net channel means for the resnet preprocessing (RGB)
    pixel_means: Tuple[float, float, float] = (123.68, 116.779, 103.939)
    # proposals per second-stage step; 0 = the largest chunk with
    # B * chunk <= 1024.  Chunking bounds the live ROI crops.  At inference
    # it changes no value; in training each chunk's BatchNorms normalise
    # with that chunk's statistics and update the running statistics once
    # per chunk, as the JAX package's chunks do.
    roi_chunk: int = 0

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.anchor_scales) * len(self.anchor_aspects)

    @property
    def feature_shape(self) -> Tuple[int, int]:
        return (self.image_size[0] // self.stride,
                self.image_size[1] // self.stride)


def build_anchors(config: FasterRCNNConfig) -> torch.Tensor:
    fh, fw = config.feature_shape
    return generate_anchors(fh, fw, config.stride, config.anchor_scales,
                            config.anchor_aspects, config.anchor_base)


def normalize_boxes(boxes: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """Pixel boxes / [h, w, h, w] in float32; the divisors are Python
    scalars, so no value is copied to the device."""
    y1, x1, y2, x2 = boxes.unbind(-1)
    return torch.stack([y1 / height, x1 / width, y2 / height, x2 / width],
                       dim=-1)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, written as ``jax.nn.softmax`` computes
    it: exp(x - max) / sum."""
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first on ties, as ``jax.lax.top_k``."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def stage_nms(boxes: torch.Tensor, scores: torch.Tensor, k: int,
              iou_threshold: float, score_threshold: float,
              kernel_nms: bool = True):
    """One batched NMS stage: :func:`..ops.nms.nms` (the K3 kernel on a
    CUDA tensor), or with ``kernel_nms=False`` :func:`..ops.nms.nms_plain`
    on any device (the GPU's reference path)."""
    if kernel_nms:
        return nms(boxes, scores, k, iou_threshold, score_threshold)
    return nms_plain(boxes, premask(scores, score_threshold), k,
                     iou_threshold)


def select_detections(boxes: torch.Tensor, scores: torch.Tensor,
                      keep: torch.Tensor, windows: int, height: int,
                      width: int) -> Dict[str, torch.Tensor]:
    """The per-class NMS survivors -> the frozen-graph output contract.

    ``boxes`` (N * C, P, 4) and ``scores`` (N * C, P) are the second
    stage's NMS problems, window-major, and ``keep`` (N * C, M) their
    survivors.  Per window the C x M kept slots (class-major, padded slots
    scored ``NEG_PAD``) go through a stable top-M; slots past the last
    detection get zero boxes and scores, and their classes are kept."""
    m = keep.shape[1]
    classes_n = boxes.shape[0] // windows
    boxes = gather_padded(boxes, keep).reshape(windows, classes_n * m, 4)
    scores = gather_padded(scores, keep, NEG_PAD).reshape(
        windows, classes_n * m)
    classes = torch.arange(1, classes_n + 1, dtype=torch.float32,
                           device=boxes.device).repeat_interleave(m)
    top_scores, top_idx = top_k(scores, m)
    rows = torch.arange(windows, device=boxes.device)[:, None]
    boxes = boxes[rows, top_idx]
    classes = classes[top_idx]
    valid = top_scores > NEG_PAD / 2
    norm = normalize_boxes(boxes, height, width)
    return {"detection_boxes": torch.where(valid[..., None], norm, 0.0),
            "detection_scores": torch.where(valid, top_scores, 0.0),
            "detection_classes": classes,
            "num_detections": valid.sum(dim=1).float()}


class RPNHead(nn.Module):
    def __init__(self, in_ch: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, 512, 3, padding=1)
        self.cls = nn.Conv2d(512, num_anchors * 2, 1)
        self.box = nn.Conv2d(512, num_anchors * 4, 1)

    def forward(self, feat):
        """NCHW features -> (N, H, W, A*2) logits, (N, H, W, A*4) deltas,
        float32."""
        x = F.relu(self.conv(feat))
        return (self.cls(x).permute(0, 2, 3, 1).float(),
                self.box(x).permute(0, 2, 3, 1).float())


class BoxHead(nn.Module):
    """Second stage: ROI crops -> class logits and box refinements."""

    def __init__(self, in_ch: int, num_classes: int, backbone: str,
                 train_form: bool = False):
        super().__init__()
        if backbone == "resnet50":
            self.trunk_name, trunk = "block4", ResNetBlock4(
                in_ch, train_form=train_form)
        else:
            self.trunk_name, trunk = "tiny_head", TinyHead(
                in_ch, train_form=train_form)
        self.add_module(self.trunk_name, trunk)
        self.cls = nn.Linear(trunk.out_channels, num_classes + 1)
        self.box = nn.Linear(trunk.out_channels, num_classes * 4)

    def forward(self, roi_feats):
        trunk = getattr(self, self.trunk_name)
        x = trunk(roi_feats).mean(dim=(2, 3))  # global average pool
        return self.cls(x).float(), self.box(x).float()


class FasterRCNN(nn.Module):
    """The detector.  ``forward`` returns the raw stage outputs;
    :meth:`detect` adds the inference post-processing.

    ``kernel_nms=False`` runs both NMS stages through
    :func:`..ops.nms.nms_plain` on any device (the GPU's reference path);
    by default they go through :func:`..ops.nms.nms`, which launches the
    K3 kernel on a CUDA tensor.  The compute type is the parameters' type
    (``model.to(torch.bfloat16)``); box math stays float32.

    ``train_form=True`` keeps every BatchNorm unfolded
    (:class:`.resnet.ConvBN`): in train mode ``forward`` gives the JAX
    package's ``FasterRCNN.__call__(train=True)``, batch statistics and
    running-statistics updates included; train it in float32 (bf16 through
    autocast).
    """

    def __init__(self, config: FasterRCNNConfig = FasterRCNNConfig(),
                 kernel_nms: bool = True, train_form: bool = False):
        super().__init__()
        self.config = config
        self.kernel_nms = kernel_nms
        self.train_form = train_form
        if config.backbone == "resnet50":
            self.backbone = ResNetC4(train_form=train_form)
        else:
            self.backbone = TinyBackbone(train_form=train_form)
        feat_ch = self.backbone.out_channels
        self.rpn = RPNHead(feat_ch, config.num_anchors_per_cell)
        self.box_head = BoxHead(feat_ch, config.num_classes, config.backbone,
                                train_form=train_form)

    def load_state(self, state: Mapping[str, torch.Tensor]) -> "FasterRCNN":
        """Load a state from ``convert/detector_import``: the inference form
        folds every BN into its conv, the training form keeps them."""
        if self.train_form:
            self.load_state_dict(train_state_dict(state), strict=True)
        else:
            self.load_state_dict(fold_batchnorm(state), strict=True)
        return self

    def detector_state(self) -> Dict[str, torch.Tensor]:
        """The training form's weights and BN statistics as a detector state
        (float32, on the CPU), the layout :meth:`load_state` reads."""
        if not self.train_form:
            raise ValueError("the inference form holds folded BatchNorms")
        return detector_state(self.state_dict())

    def with_image_size(self, height: int, width: int) -> "FasterRCNN":
        """A view of this model for another window geometry: it shares
        every parameter and differs only in ``config.image_size``."""
        view = copy.copy(self)
        view.config = dataclasses.replace(self.config,
                                          image_size=(height, width))
        return view

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def _nms(self, boxes, scores, k, iou_threshold, score_threshold):
        return stage_nms(boxes, scores, k, iou_threshold, score_threshold,
                         self.kernel_nms)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) RGB -> (N, 3, H, W) in the compute type, channels_last
        memory.  The pixel means are subtracted in float32 (or the images'
        float type) before the cast, one channel at a time with Python
        scalars."""
        dtype = images.dtype if images.is_floating_point() else torch.float32
        x = images.to(dtype)
        x = torch.stack([x[..., c] - m for c, m in
                         enumerate(self.config.pixel_means)], dim=1)
        return x.to(self.dtype).contiguous(memory_format=torch.channels_last)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """Stride-16 features, (N, C, H/16, W/16)."""
        return self.backbone(self.preprocess(images))

    def rpn_outputs(self, feats: torch.Tensor):
        """(N, H*W*A, 2) objectness logits and (N, H*W*A, 4) deltas, in the
        JAX package's anchor order (cell-major, then anchor)."""
        obj, deltas = self.rpn(feats)
        n = feats.shape[0]
        return obj.reshape(n, -1, 2), deltas.reshape(n, -1, 4)

    def rpn_candidates(self, rpn_obj: torch.Tensor, rpn_deltas: torch.Tensor,
                       anchors: torch.Tensor):
        """The RPN's NMS problems, one per window: the top ``pre_nms_top_n``
        decoded, clipped boxes (N, K, 4) and their scores (N, K)."""
        cfg = self.config
        h, w = cfg.image_size
        scores = softmax(rpn_obj)[..., 1]
        k = min(cfg.pre_nms_top_n, scores.shape[1])
        top_scores, top_idx = top_k(scores, k)
        rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
        boxes = decode_boxes(rpn_deltas[rows, top_idx], anchors[top_idx])
        return clip_boxes(boxes, h, w), top_scores

    def propose(self, rpn_obj: torch.Tensor, rpn_deltas: torch.Tensor,
                anchors: torch.Tensor):
        """RPN outputs -> (N, post_nms_top_n, 4) pixel-coord proposals and
        their scores (``NEG_PAD`` in the padded slots)."""
        cfg = self.config
        boxes, top_scores = self.rpn_candidates(rpn_obj, rpn_deltas, anchors)
        keep, _ = self._nms(boxes, top_scores, cfg.post_nms_top_n,
                            cfg.rpn_nms_threshold, float("-inf"))
        return (gather_padded(boxes, keep),
                gather_padded(top_scores, keep, NEG_PAD))

    def roi_features(self, feats: torch.Tensor, proposals: torch.Tensor):
        """Crop proposals (pixel coords, (N, P, 4)) from the features ->
        (N * P, C, S, S), channels_last memory."""
        cfg = self.config
        h, w = cfg.image_size
        crops = crop_and_resize(feats.permute(0, 2, 3, 1),
                                normalize_boxes(proposals, h, w),
                                cfg.crop_size)
        n, p, s, _, c = crops.shape
        return crops.reshape(n * p, s, s, c).permute(0, 3, 1, 2)

    def forward(self, images: torch.Tensor, anchors: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        cfg = self.config
        feats = self.features(images)
        rpn_obj, rpn_deltas = self.rpn_outputs(feats)
        # two-stage convention: no gradient through proposal generation
        with torch.no_grad():
            proposals, prop_scores = self.propose(rpn_obj, rpn_deltas,
                                                  anchors)
        n, p = proposals.shape[:2]
        chunk = min(cfg.roi_chunk or max(1, 1024 // n), p)
        scores_parts, deltas_parts = [], []
        for start in range(0, p, chunk):
            roi = self.roi_features(feats, proposals[:, start: start + chunk])
            pc = roi.shape[0] // n
            s_c, d_c = self.box_head(roi)
            scores_parts.append(s_c.reshape(n, pc, -1))
            deltas_parts.append(d_c.reshape(n, pc, cfg.num_classes, 4))
        return {
            "features": feats,
            "rpn_objectness": rpn_obj,
            "rpn_deltas": rpn_deltas,
            "proposals": proposals,
            "proposal_scores": prop_scores,
            "class_scores": torch.cat(scores_parts, dim=1),
            "box_deltas": torch.cat(deltas_parts, dim=1),
        }

    def detection_candidates(self, proposals: torch.Tensor,
                             class_scores: torch.Tensor,
                             box_deltas: torch.Tensor):
        """The second stage's NMS problems, one per window and class
        (window-major): refined, clipped boxes (N * C, P, 4) and the class
        probabilities (N * C, P)."""
        cfg = self.config
        h, w = cfg.image_size
        n, p = proposals.shape[:2]
        classes_n = cfg.num_classes
        probs = softmax(class_scores)                        # (N, P, C+1)
        boxes = clip_boxes(decode_boxes(
            box_deltas, proposals[:, :, None, :]), h, w)     # (N, P, C, 4)
        boxes = boxes.permute(0, 2, 1, 3).reshape(n * classes_n, p, 4)
        scores = probs[..., 1:].permute(0, 2, 1).reshape(n * classes_n, p)
        return boxes, scores

    def postprocess(self, proposals: torch.Tensor, class_scores: torch.Tensor,
                    box_deltas: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Second-stage outputs -> the frozen-graph output contract; the
        per-class NMS of every window and class is one batched call."""
        cfg = self.config
        boxes, scores = self.detection_candidates(proposals, class_scores,
                                                  box_deltas)
        keep, _ = self._nms(boxes, scores, cfg.max_detections,
                            cfg.second_nms_threshold, cfg.score_threshold)
        return select_detections(boxes, scores, keep, proposals.shape[0],
                                 *cfg.image_size)

    @torch.no_grad()
    def detect(self, images: torch.Tensor, anchors: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        out = self(images, anchors)
        return self.postprocess(out["proposals"], out["class_scores"],
                                out["box_deltas"])
