"""Mask -> polygon boundary extraction (ref ``module/common/boundary_extractor.py``).

Class 1 (glomerulus) uses the union of all foreground (``>= 1``,
``boundary_extractor.py:26-27``); other classes use exact equality.
Contours below the point-count threshold are dropped as noise and remaining
contours are simplified with approxPolyDP using an epsilon proportional to
arc length (``:36-48``).  This is host-side geometry (OpenCV), downstream of
the device compute.

The port's own copy of ``glomeruli_segmentation_tpu/eval/boundary.py`` (the
port imports nothing of the JAX package); a test holds the two equal.  cv2
is imported at the first call, so this module imports where cv2 is missing
and :func:`bound2line` raises ``ImportError`` there.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def bound2line(class_map: np.ndarray, max_classes: int = -1,
               g_min_point: int = 200, o_min_points: int = 50,
               g_epsilon: float = 0.003, o_epsilon: float = 0.002,
               ) -> Dict[int, List[np.ndarray]]:
    import cv2

    if max_classes < 0:
        num_class = int(class_map.max()) + 1
    else:
        num_class = min(max_classes, int(class_map.max()) + 1)
    approx_list: Dict[int, List[np.ndarray]] = {}
    for cls in range(1, num_class):
        if cls == 1:
            mask = (class_map >= cls).astype(np.uint8) * 255
        else:
            mask = (class_map == cls).astype(np.uint8) * 255
        _, thresh = cv2.threshold(mask, 1, 255, 0)
        contours, _ = cv2.findContours(thresh, cv2.RETR_LIST,
                                       cv2.CHAIN_APPROX_SIMPLE)
        if cls == 1:
            min_points, epsilon = g_min_point, g_epsilon
        else:
            min_points, epsilon = o_min_points, o_epsilon
        contours = [c for c in contours if len(c) >= min_points]
        if contours:
            approx_list[cls] = []
            for cnt in contours:
                arc_length = cv2.arcLength(cnt, True)
                approx = cv2.approxPolyDP(cnt, epsilon * arc_length, True).squeeze()
                approx_list[cls].append(approx)
    return approx_list
