"""Labelme-compatible JSON/PNG codecs, implemented natively (no labelme dep).

Replicates the behaviours the reference pulls from the ``labelme`` package
and its small wrappers:

- ``img_arr_to_b64`` / ``img_b64_to_arr`` (labelme.utils, used at
  ``VisualizeResults_iou.py:179`` and ``eval_wsi_segmentation.py:287``)
- ``shapes_to_label`` / ``polygons_to_mask``
  (``module/common/utils/shape.py:8-47``) — ordered label painting so later
  classes overwrite earlier ones
- ``lblsave`` palette-PNG writer (``module/common/utils/my_lblsave.py:12-32``)

The port's own copy of ``glomeruli_segmentation_tpu/utils/labelme_io.py``
(the port imports nothing of the JAX package); a test holds the two equal.
PIL is imported inside the functions, so this module imports where PIL is
missing and a function that needs it raises ``ImportError``.
"""
from __future__ import annotations

import base64
import io
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np

from ..palette import label_colormap


def img_arr_to_b64(img_arr: np.ndarray) -> str:
    import PIL.Image

    img = PIL.Image.fromarray(img_arr)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def img_b64_to_arr(img_b64: str) -> np.ndarray:
    import PIL.Image

    data = base64.b64decode(img_b64)
    return np.array(PIL.Image.open(io.BytesIO(data)))


def polygons_to_mask(img_shape, polygons) -> np.ndarray:
    import PIL.Image
    import PIL.ImageDraw

    mask = PIL.Image.fromarray(np.zeros(img_shape[:2], dtype=np.uint8))
    xy = [tuple(pt) for pt in polygons]
    PIL.ImageDraw.Draw(mask).polygon(xy=xy, outline=1, fill=1)
    return np.array(mask, dtype=bool)


def shapes_to_label(img_shape, shapes: Iterable[Mapping],
                    label_name_to_value: Mapping[str, int],
                    label_name_list: Sequence[str]) -> np.ndarray:
    """Paint polygons in ``label_name_list`` order (later names overwrite)."""
    cls = np.zeros(img_shape[:2], dtype=np.int32)
    shapes = list(shapes)
    for label_name in label_name_list:
        for shape in (s for s in shapes if s["label"] == label_name):
            mask = polygons_to_mask(img_shape[:2], shape["points"])
            cls[mask] = label_name_to_value[shape["label"]]
    return cls


def lblsave(filename: str, lbl: np.ndarray, size=None) -> None:
    """Save a class-id mask as a palette-mode PNG with the VOC colormap."""
    import os

    import PIL.Image

    if os.path.splitext(filename)[1] not in [".png", ".PNG"]:
        filename += ".png"
    if not (lbl.min() >= -1 and lbl.max() < 255):
        raise ValueError(
            f"cannot save {filename}: labels outside [-1, 254]"
        )
    lbl_pil = PIL.Image.fromarray(lbl.astype(np.uint8), mode="P")
    if size is not None:
        if not isinstance(size, tuple):
            raise AttributeError(f"size is not set properly. given size:{size}")
        lbl_pil = lbl_pil.resize(size)
    # labelme colormap: label_colormap(255) scaled to 0..255
    colormap = label_colormap(255)
    lbl_pil.putpalette(colormap.flatten())
    lbl_pil.save(filename)


def org_lbl_save(filename: str, org: np.ndarray, label: np.ndarray) -> None:
    """Debug figure: original + palette label + legend strip
    (ref ``module/common/utils/my_lblsave.py:35-77``)."""
    import os

    import matplotlib
    import PIL.Image

    matplotlib.use("Agg")
    from matplotlib import gridspec
    from matplotlib import pyplot as plt

    from ..palette import LABEL_NAMES

    if os.path.splitext(filename)[1] not in [".png", ".PNG"]:
        filename += ".png"
    if not (label.min() >= -1 and label.max() < 255):
        raise ValueError(f"cannot save {filename}: labels outside [-1, 254]")
    colormap = label_colormap(255)
    org_img = PIL.Image.fromarray(org.astype(np.uint8), mode="RGB")
    lbl_pil = PIL.Image.fromarray(label.astype(np.uint8), mode="P")
    lbl_pil.putpalette(colormap.flatten())

    plt.figure(figsize=(13, 10))
    grid_spec = gridspec.GridSpec(2, 2, width_ratios=[5, 5],
                                  height_ratios=[8, 2])
    plt.subplot(grid_spec[0])
    plt.imshow(org_img)
    plt.axis("off")
    plt.title("input image")
    plt.subplot(grid_spec[1])
    plt.imshow(lbl_pil)
    plt.axis("off")
    plt.title("GT(label image)")
    label_names = np.array(LABEL_NAMES)
    full_map = colormap[np.arange(len(label_names)).reshape(-1, 1)]
    ax = plt.subplot(grid_spec[3])
    plt.imshow(full_map.astype(np.uint8), interpolation="nearest")
    ax.yaxis.tick_right()
    plt.yticks(range(len(label_names)), label_names)
    plt.xticks([], [])
    ax.tick_params(width=0.0)
    plt.savefig(filename)
    plt.close()


def load_labelme_json(path: str) -> Dict:
    import json
    from collections import OrderedDict

    with open(path) as f:
        return json.load(f, object_pairs_hook=OrderedDict)


def labelme_image_array(data: Mapping, json_path: str) -> np.ndarray:
    """Decode the image referenced by a labelme JSON document."""
    import os

    import PIL.Image

    if data.get("imageData"):
        return img_b64_to_arr(data["imageData"])
    image_path = os.path.join(os.path.dirname(json_path), data["imagePath"])
    with open(image_path, "rb") as f:
        return np.array(PIL.Image.open(io.BytesIO(f.read())))
