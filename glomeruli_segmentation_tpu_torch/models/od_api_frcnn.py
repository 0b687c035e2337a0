"""Faster R-CNN with the TF OD-API inception_v2 architecture: the
reference's ``frozen_inference_graph.pb`` detector, over the parameter tree
of :func:`..convert.pb_import.load_od_api_detector_params`.

Counterpart of ``glomeruli_segmentation_tpu/models/od_api_frcnn.py``:

- the inception_v2 trunk through ``Mixed_4e`` (stride 16, BN folded,
  :mod:`.inception_v2`);
- RPN: 3x3 conv with ReLU6 (``Conv/*``), 1x1 box and class heads
  (``FirstStageBoxPredictor``), flattened as NHWC; OD-API grid anchors
  (:func:`od_api_anchors`);
- proposals: softmax objectness, stable top ``pre_nms_top_n``, decode
  with scales (10, 10, 5, 5), clip, greedy NMS (IoU 0.7), top
  ``max_proposals``;
- ROI features: ``crop_and_resize`` to 14, a 2x2/2 max pool, ``Mixed_5a..
  Mixed_5c``, a global mean pool, the FC heads (``SecondStageBoxPredictor``);
- per-class NMS (IoU 0.6, score threshold 0.0) and a stable cross-class
  top-k, in the frozen graph's output contract.

What differs from the JAX package: activations are NCHW in ``channels_last``
memory; both NMS stages run batched, one :func:`..ops.nms.nms` call for the
RPN problems of all windows and one for the second stage's windows x
classes (two K3 launches a batch on the GPU).  Box math, softmax and NMS
stay float32 whatever the compute type, and so do the FC heads, as in the
JAX package.  For fine-tuning (``train/od_api_finetune.py``),
:meth:`ODAPIFasterRCNN.train_outputs` gives both stages' raw outputs (one
K3 launch, no graph through the proposals) and :meth:`ODAPIFasterRCNN.
params_tree` the parameters back in the JAX package's tree.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.boxes import clip_boxes, decode_boxes
from ..ops.nms import gather_padded
from ..ops.roi_align import crop_and_resize
from .faster_rcnn import (normalize_boxes, select_detections, softmax,
                          stage_nms, top_k)
from .inception_v2 import (ClassifierFeatures, ProposalFeatures, as_numpy,
                           conv_like, load_tree, max_pool_same, tree_of)

NEG_PAD = -1e10

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ODAPIConfig:
    num_classes: int = 1
    image_size: Tuple[int, int] = (600, 600)
    # keep_aspect_ratio_resizer bounds (applied by the backend)
    min_dimension: int = 600
    max_dimension: int = 1024
    stride: int = 16
    anchor_scales: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
    anchor_aspects: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_base: float = 256.0
    pre_nms_top_n: int = 6000
    max_proposals: int = 300
    rpn_nms_threshold: float = 0.7
    initial_crop_size: int = 14
    second_nms_threshold: float = 0.6
    second_score_threshold: float = 0.0
    max_detections: int = 100


def od_api_anchors(feat_h: int, feat_w: int,
                   config: ODAPIConfig) -> torch.Tensor:
    """OD-API GridAnchorGenerator, (feat_h * feat_w * A, 4) float32 on the
    CPU: centres at ``(y * stride, x * stride)`` (offset 0), heights
    ``scale / sqrt(aspect) * base``, per cell aspect-major / scale-minor,
    clipped to the image (inference mode)."""
    scales = np.asarray(config.anchor_scales, np.float32)
    aspects = np.asarray(config.anchor_aspects, np.float32)
    scales_grid, aspects_grid = np.meshgrid(scales, aspects)  # (A_a, A_s)
    scales_grid = scales_grid.reshape(-1)
    aspects_grid = aspects_grid.reshape(-1)
    ratio_sqrt = np.sqrt(aspects_grid)
    heights = scales_grid / ratio_sqrt * config.anchor_base
    widths = scales_grid * ratio_sqrt * config.anchor_base

    ys = np.arange(feat_h, dtype=np.float32) * config.stride
    xs = np.arange(feat_w, dtype=np.float32) * config.stride
    cx, cy = np.meshgrid(xs, ys)
    cy = cy.reshape(-1, 1)
    cx = cx.reshape(-1, 1)
    n = feat_h * feat_w
    a = len(heights)
    anchors = np.stack([
        np.broadcast_to(cy - heights / 2, (n, a)),
        np.broadcast_to(cx - widths / 2, (n, a)),
        np.broadcast_to(cy + heights / 2, (n, a)),
        np.broadcast_to(cx + widths / 2, (n, a)),
    ], axis=-1).reshape(-1, 4).astype(np.float32)
    h, w = config.image_size
    anchors[:, 0::2] = anchors[:, 0::2].clip(0, h)
    anchors[:, 1::2] = anchors[:, 1::2].clip(0, w)
    return torch.from_numpy(anchors)


def build_anchors(config: ODAPIConfig) -> torch.Tensor:
    """The anchors of ``config.image_size``: a ``ceil(h / stride)`` x
    ``ceil(w / stride)`` grid (38 x 38 x 12 = 17,328 at 600x600)."""
    h, w = config.image_size
    return od_api_anchors(-(-h // config.stride), -(-w // config.stride),
                          config)


def keep_aspect_resize_shape(height: int, width: int, min_dimension: int,
                             max_dimension: int) -> Tuple[int, int]:
    """The graph's keep_aspect_ratio_resizer target shape (rounded like
    TF: int(round(dim * scale)))."""
    scale = min_dimension / min(height, width)
    if round(max(height, width) * scale) > max_dimension:
        scale = max_dimension / max(height, width)
    return (int(round(height * scale)), int(round(width * scale)))


class ODAPIFasterRCNN(nn.Module):
    """Inference-only detector, built from a parameter tree and loaded by
    :meth:`load_params`.

    The trunks and the RPN run in ``compute_dtype``; the FC heads, box math,
    softmax and NMS in float32.  ``kernel_nms=False`` runs both NMS stages
    through :func:`..ops.nms.nms_plain` on any device; by default they go
    through :func:`..ops.nms.nms`, which launches K3 on a CUDA tensor.
    """

    def __init__(self, params: Mapping, config: ODAPIConfig = ODAPIConfig(),
                 compute_dtype: str = "bfloat16", kernel_nms: bool = True):
        super().__init__()
        self.config = config
        self.kernel_nms = kernel_nms
        self.first = ProposalFeatures(params["first"])
        self.second = ClassifierFeatures(params["second"])
        self.rpn_conv = conv_like(params["rpn_conv"])
        self.rpn_cls = conv_like(params["rpn_cls"])
        self.rpn_box = conv_like(params["rpn_box"])
        self.fc_cls = nn.Linear(*params["fc_cls"]["w"].shape)
        self.fc_box = nn.Linear(*params["fc_box"]["w"].shape)
        self.load_params(params)
        dtype = _DTYPES[compute_dtype]
        for m in (self.first, self.second, self.rpn_conv, self.rpn_cls,
                  self.rpn_box):
            m.to(dtype)

    def load_params(self, tree: Mapping) -> "ODAPIFasterRCNN":
        """Copy the tree of :func:`..convert.pb_import.
        assemble_od_api_params` into the modules: HWIO kernels -> OIHW, the
        stem's depthwise ``(H, W, IC, M)`` -> ``(IC * M, 1, H, W)`` (groups
        IC), the FC heads ``(C, K)`` -> ``nn.Linear`` ``(K, C)``."""
        load_tree(self.first, tree["first"])
        load_tree(self.second, tree["second"])
        for name in ("rpn_conv", "rpn_cls", "rpn_box"):
            getattr(self, name).load(tree[name])
        with torch.no_grad():
            for name in ("fc_cls", "fc_box"):
                fc = getattr(self, name)
                fc.weight.copy_(torch.from_numpy(
                    np.asarray(tree[name]["w"])).t())
                fc.bias.copy_(torch.from_numpy(np.asarray(tree[name]["b"])))
        return self

    def params_tree(self) -> Dict:
        """The parameters as the tree :meth:`load_params` reads (the JAX
        package's layout: HWIO kernels, the stem's depthwise ``(H, W, IC,
        M)``, FC ``w`` as ``(C, K)``), float32 numpy leaves."""
        tree = {"first": tree_of(self.first), "second": tree_of(self.second)}
        for name in ("rpn_conv", "rpn_cls", "rpn_box"):
            tree[name] = getattr(self, name).tree()
        for name in ("fc_cls", "fc_box"):
            fc = getattr(self, name)
            tree[name] = {"w": as_numpy(fc.weight.t()),
                          "b": as_numpy(fc.bias)}
        return tree

    def with_image_size(self, height: int, width: int) -> "ODAPIFasterRCNN":
        """A view of this model for another resized window shape: it shares
        every parameter and differs only in ``config.image_size``."""
        view = copy.copy(self)
        view.config = dataclasses.replace(self.config,
                                          image_size=(height, width))
        return view

    @property
    def dtype(self) -> torch.dtype:
        return self.rpn_conv.weight.dtype

    # ------------- stages -------------
    def first_stage(self, images: torch.Tensor):
        """(N, H, W, 3) RGB, uint8 or float -> (features (N, C, h, w),
        objectness (N, h*w*A, 2), deltas (N, h*w*A, 4)), the last two
        float32 in the JAX package's anchor order.  The input is cast to
        the compute type before ``* (2/255) - 1``."""
        x = images.to(self.dtype) * (2.0 / 255.0) - 1.0
        feats = self.first(
            x.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))
        rpn = torch.clamp(self.rpn_conv(feats), 0.0, 6.0)  # relu6
        n = feats.shape[0]
        # (N, A*k, h, w) -> NHWC -> (N, h*w*A, k): the OD-API box
        # predictor's reshape
        obj = self.rpn_cls(rpn).permute(0, 2, 3, 1).reshape(n, -1, 2)
        deltas = self.rpn_box(rpn).permute(0, 2, 3, 1).reshape(n, -1, 4)
        return feats, obj.float(), deltas.float()

    def _nms(self, boxes, scores, k, iou_threshold, score_threshold):
        return stage_nms(boxes, scores, k, iou_threshold, score_threshold,
                         self.kernel_nms)

    def rpn_candidates(self, obj: torch.Tensor, deltas: torch.Tensor,
                       anchors: torch.Tensor):
        """The RPN's NMS problems, one per window: the top
        ``pre_nms_top_n`` decoded, clipped boxes (N, K, 4) and their
        scores (N, K)."""
        cfg = self.config
        h, w = cfg.image_size
        scores = softmax(obj)[..., 1]
        k = min(cfg.pre_nms_top_n, scores.shape[1])
        top_scores, top_idx = top_k(scores, k)
        rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
        boxes = decode_boxes(deltas[rows, top_idx], anchors[top_idx])
        return clip_boxes(boxes, h, w), top_scores

    def propose(self, obj: torch.Tensor, deltas: torch.Tensor,
                anchors: torch.Tensor):
        """-> (N, max_proposals, 4) pixel-coord proposals and their scores
        (``NEG_PAD`` in the padded slots)."""
        cfg = self.config
        boxes, scores = self.rpn_candidates(obj, deltas, anchors)
        keep, _ = self._nms(boxes, scores, cfg.max_proposals,
                            cfg.rpn_nms_threshold, float("-inf"))
        return (gather_padded(boxes, keep),
                gather_padded(scores, keep, NEG_PAD))

    def roi_features(self, feats: torch.Tensor, proposals: torch.Tensor):
        """Crop the proposals (pixel coords, padded rows zero) to
        ``initial_crop_size``, then a 2x2/2 SAME max pool -> (N * P, C,
        S/2, S/2)."""
        cfg = self.config
        h, w = cfg.image_size
        s = cfg.initial_crop_size
        crops = crop_and_resize(feats.permute(0, 2, 3, 1),
                                normalize_boxes(proposals, h, w), s)
        n, p = crops.shape[:2]
        x = crops.reshape((n * p,) + crops.shape[2:]).permute(0, 3, 1, 2)
        return max_pool_same(x, 2, 2)[:, :, : s // 2, : s // 2]

    def box_classifier(self, feats: torch.Tensor, proposals: torch.Tensor):
        """-> class logits (N, P, C+1) and box encodings (N, P, C, 4),
        float32."""
        n, p = proposals.shape[:2]
        head = self.second(self.roi_features(feats, proposals))
        pooled = head.mean(dim=(2, 3)).float()  # (N * P, C)
        return (self.fc_cls(pooled).reshape(n, p, -1),
                self.fc_box(pooled).reshape(n, p, self.config.num_classes,
                                            4))

    def detection_candidates(self, proposals: torch.Tensor,
                             prop_scores: torch.Tensor,
                             cls_logits: torch.Tensor,
                             box_enc: torch.Tensor):
        """The second stage's NMS problems, one per window and class
        (window-major): refined, clipped boxes (N * C, P, 4) and the class
        probabilities (N * C, P), zero on the padded proposals."""
        cfg = self.config
        h, w = cfg.image_size
        n, p = proposals.shape[:2]
        c = cfg.num_classes
        probs = softmax(cls_logits)                          # (N, P, C+1)
        valid = (prop_scores > NEG_PAD / 2).float()          # (N, P)
        boxes = clip_boxes(decode_boxes(
            box_enc, proposals[:, :, None, :]), h, w)        # (N, P, C, 4)
        boxes = boxes.permute(0, 2, 1, 3).reshape(n * c, p, 4)
        scores = (probs[..., 1:] * valid[..., None]).permute(0, 2, 1)
        return boxes, scores.reshape(n * c, p)

    def postprocess(self, proposals: torch.Tensor, prop_scores: torch.Tensor,
                    cls_logits: torch.Tensor, box_enc: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """Second-stage outputs -> the frozen-graph output contract; the
        per-class NMS of every window and class is one batched call."""
        cfg = self.config
        boxes, scores = self.detection_candidates(proposals, prop_scores,
                                                  cls_logits, box_enc)
        keep, _ = self._nms(boxes, scores, cfg.max_detections,
                            cfg.second_nms_threshold,
                            cfg.second_score_threshold)
        return select_detections(boxes, scores, keep, proposals.shape[0],
                                 *cfg.image_size)

    def train_outputs(self, images: torch.Tensor, anchors: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Both stages' raw outputs in the contract of
        :func:`..train.detector_train.detector_loss`: ``rpn_objectness``,
        ``rpn_deltas``, ``proposals`` and ``proposal_scores`` (made without
        a graph: no gradient through proposal generation), ``class_scores``,
        ``box_deltas``.  BN is folded at import, so fine-tuning updates the
        folded conv scale and shift with frozen normalisation
        statistics."""
        feats, obj, deltas = self.first_stage(images)
        with torch.no_grad():
            proposals, prop_scores = self.propose(obj, deltas, anchors)
        cls_logits, box_enc = self.box_classifier(feats, proposals)
        return {"rpn_objectness": obj, "rpn_deltas": deltas,
                "proposals": proposals, "proposal_scores": prop_scores,
                "class_scores": cls_logits, "box_deltas": box_enc}

    @torch.no_grad()
    def detect(self, images: torch.Tensor, anchors: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """(N, H, W, 3) windows at ``config.image_size`` and the anchors of
        :func:`build_anchors` -> ``detection_boxes`` (N, M, 4) normalized,
        ``detection_scores``, ``detection_classes`` (1-based floats),
        ``num_detections``."""
        feats, obj, deltas = self.first_stage(images)
        proposals, prop_scores = self.propose(obj, deltas, anchors)
        cls_logits, box_enc = self.box_classifier(feats, proposals)
        return self.postprocess(proposals, prop_scores, cls_logits, box_enc)
