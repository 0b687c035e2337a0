"""Pascal-VOC bounding-box annotation reader and rectangle IoU.

Ref ``module/common/annotation_handler.py``: XML ``object/bndbox`` reading
(:13-56), slide filename pattern ``(.*)_pw(\\d{2})_ds(\\d{1,2})`` (:26-27),
rectangle IoU ``check_overlap`` (:74-105).

The port's own copy of ``glomeruli_segmentation_tpu/utils/annotation.py``
(the port imports nothing of the JAX package); a test holds the two equal.
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ElementTree
from typing import List, Sequence

from .glomus_handler import GlomusHandler


class AnnotationHandlerException(BaseException):
    pass


ANNOTATION_FILE_PATTERN = r"(.*)_pw(\d{2})_ds(\d{1,2})"


def rect_iou(gt: Sequence[float], ca: Sequence[float]) -> float:
    """IoU of two [xmin, ymin, xmax, ymax] rectangles (check_overlap)."""
    dx = min(ca[2], gt[2]) - max(ca[0], gt[0])
    dy = min(ca[3], gt[3]) - max(ca[1], gt[1])
    overlap = dx * dy if (dx > 0 and dy > 0) else 0.0
    if overlap <= 0:
        return 0.0
    area_ca = (ca[2] - ca[0]) * (ca[3] - ca[1])
    area_gt = (gt[2] - gt[0]) * (gt[3] - gt[1])
    assert area_ca > 0 and area_gt > 0, "rect has invalid extent"
    return overlap / (area_ca + area_gt - overlap)


class AnnotationHandler:
    """Reads GT boxes from Pascal-VOC XML annotation files."""

    def __init__(self, annotation_dir: str, staining_type: str):
        self.gt_list: List[List[float]] = []
        self.gt_name_list: List[str] = []
        self.annotation_dir = annotation_dir
        self.staining_type = staining_type
        self.staining_dir = GlomusHandler.get_staining_type(staining_type)
        if self.staining_dir is None:
            raise AnnotationHandlerException(
                "Unknown Argument is given.:" + staining_type)
        self.repattern = re.compile(ANNOTATION_FILE_PATTERN, re.IGNORECASE)

    def clear_annotation(self) -> None:
        del self.gt_list[:]
        del self.gt_name_list[:]

    def read_annotation(self, dir_path: str, file_name: str) -> None:
        tree = ElementTree.parse(os.path.join(dir_path, file_name))
        for obj in tree.findall("object"):
            name = obj.find("name").text
            bbox = obj.find("bndbox")
            if bbox is None:
                raise AnnotationHandlerException(
                    "Unknown object is found in:" + file_name)
            self.gt_list.append([
                float(bbox.find("xmin").text),
                float(bbox.find("ymin").text),
                float(bbox.find("xmax").text),
                float(bbox.find("ymax").text),
            ])
            self.gt_name_list.append(name)

    # reference-compatible alias
    @staticmethod
    def check_overlap(gt, ca) -> float:
        return rect_iou(gt, ca)
