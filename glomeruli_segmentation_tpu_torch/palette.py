"""Color palettes and label maps used across the pipeline.

Sources in the reference:
- 25-entry drawing palette: ``module/espnet/test/VisualizeResults_iou.py:20-44``
  (index 2 is (0,184,0); the training script variant uses (0,255,0),
  ``module/espnet/train/main.py:21-45``).
- GTCS palette: ``module/SegFormer/test/test.py:24-28``.
- Label names: ``module/common/utils/my_lblsave.py:81-83`` and the GTCS
  columns at ``module/SegFormer/test/test.py:247``.
- labelme/VOC colormap used for palette PNGs: ``my_lblsave.py:12-32``.

The port's own copy of ``glomeruli_segmentation_tpu/palette.py`` (the port
imports nothing of the JAX package); a test holds the two equal.
"""
from __future__ import annotations

import numpy as np

ESPNET_PALETTE = [
    [0, 0, 0], [255, 0, 0], [0, 184, 0], [255, 255, 0], [0, 0, 255],
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32], [0, 0, 0],
]

TRAIN_PALETTE = [row[:] for row in ESPNET_PALETTE]
TRAIN_PALETTE[2] = [0, 255, 0]

# slightly enhanced colors to preserve tones after overlay (GTCS)
GTCS_PALETTE = [
    [0, 0, 0], [120, 120, 120], [250, 47, 0], [0, 220, 58],
    [43, 90, 250], [255, 255, 100],
]

LABEL_NAMES = ["background", "glomerulus", "crescent", "collapsing/sclerosis",
               "mesangium"]

# polygon label -> class id for the 5-class scheme (make_seg_data.py:272-279)
LABEL_NAME_TO_VALUE = {
    "glomerulus": 1,
    "crescent": 2,
    "collapsing": 3,
    "sclerosis": 3,
    "mesangium": 4,
    "poler_mesangium": 4,
}

# GTCS scheme (eval_wsi_segmentation_gtcs.py:59-67)
GTCS_LABEL_NAME_TO_VALUE = {
    "glomerulus": 1,
    "tuft": 2,
    "crescent": 3,
    "collapsing": 4,
    "sclerosis": 4,
}

GTCS_LABEL_NAMES = ["background", "glomerulus", "tuft", "crescent", "sclerosis"]

# class id -> polygon label written to prediction JSON
# (VisualizeResults_iou.py:47-52)
PRED_LABEL_IDX = {1: "glomerulus", 2: "crescent", 3: "sclerosis", 4: "mesangium"}


def label_colormap(n_labels: int = 256) -> np.ndarray:
    """VOC/labelme colormap as uint8 (N, 3)."""
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    cmap = np.zeros((n_labels, 3), dtype=np.uint8)
    for i in range(n_labels):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def colorize(label: np.ndarray, palette=ESPNET_PALETTE, bgr: bool = True) -> np.ndarray:
    """Class-id map -> color image (BGR by default, as cv2 expects)."""
    pal = np.asarray(palette, dtype=np.uint8)
    if bgr:
        pal = pal[:, ::-1]
    out = np.zeros((*label.shape, 3), dtype=np.uint8)
    valid = label < len(pal)
    out[valid] = pal[label[valid]]
    return out


def relabel_to_cityscapes(img: np.ndarray) -> np.ndarray:
    """5-class ids -> cityscapes train ids (VisualizeResults_iou.py:54-81)."""
    mapping = {19: 255, 18: 33, 17: 32, 16: 31, 15: 28, 14: 27, 13: 26,
               12: 25, 11: 24, 10: 23, 9: 22, 8: 21, 7: 20, 6: 19, 5: 17,
               4: 13, 3: 12, 2: 11, 1: 8, 0: 7}
    # one table lookup, not a pass over the image per class: the ids are
    # non-negative, and every id the mapping leaves alone maps to itself
    lut = np.arange(max(256, int(img.max()) + 1 if img.size else 0))
    for src, dst in mapping.items():
        lut[src] = dst
    lut[lut == 255] = 0
    return lut.astype(img.dtype)[img]


def relabel_from_cityscapes(img: np.ndarray) -> np.ndarray:
    """Inverse used when stitching (eval_wsi_segmentation.py:49-55)."""
    out = img.copy()
    for src, dst in ((13, 4), (12, 3), (11, 2), (8, 1), (7, 0)):
        out[img == src] = dst
    return out


def relabel_4cls(img: np.ndarray) -> np.ndarray:
    """Merge mesangium into glomerulus (eval_wsi_segmentation.py:57-59)."""
    out = img.copy()
    out[img == 4] = 1
    return out
