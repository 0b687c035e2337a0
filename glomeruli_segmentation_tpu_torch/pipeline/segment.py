"""Per-crop ESPNet segmentation stage: the labelme document of one crop.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/segment.py``.  Only
:func:`build_labelme_doc`, which the end-to-end pipeline writes per crop,
is ported so far; the ``gseg-segment`` stage itself (crop PNGs in, overlays,
pixel-count CSVs and IoU reports out) comes with the CLI slice.
"""
from __future__ import annotations

import numpy as np

from ..eval.boundary import bound2line
from ..palette import PRED_LABEL_IDX
from ..utils.labelme_io import img_arr_to_b64


def build_labelme_doc(class_map: np.ndarray, json_image: np.ndarray,
                      name: str) -> dict:
    """labelme-style JSON document with polygon boundaries + b64 image
    (VisualizeResults_iou.py:161-182).  ``class_map`` must already be in
    the cityscapes relabeling when that is the output convention."""
    boundary_lines = bound2line(class_map, max_classes=4)
    shapes = []
    for idx, label in PRED_LABEL_IDX.items():
        for poly in boundary_lines.get(idx, []):
            shapes.append({
                "line_color": None,
                "points": poly.tolist(),
                "fill_color": None,
                "label": label,
            })
    return {
        "shapes": shapes,
        "lineColor": [0, 0, 0, 255],
        "imagePath": name,
        "flags": {},
        "fillColor": [0, 0, 0, 255],
        "imageData": img_arr_to_b64(json_image),
    }
