"""Detect -> segment handoff: crop detected regions and build GT label PNGs.

Replicates ``module/faster-rcnn/make_seg_data.py``: reads the merged
detection CSV and GT annotation XMLs, matches GT boxes to detections by
rectangle IoU (max-IoU wins), crops every detected region from the slide at
level 0 into ``org_image/<patient>/xmin{X}_ymin{Y}_xmax{X}_ymax{Y}.PNG``
(name coordinates are level-0/8, ``make_seg_data.py:193-197``), and paints
GT polygons into the detected rect's frame as palette label PNGs
(``:270-336``).  False positives get all-background labels.  A merged
box of zero width or height (:func:`.merge.has_pixels`) gets no crop and
no label, where the JAX package stops; a warning counts such boxes.

The port's own copy of ``glomeruli_segmentation_tpu/pipeline/seg_data.py``
(numpy and PIL only; slides are read through the port's
:func:`..wsi.open_slide`).  Tests hold its crops, labels and ``scan_files``
rows to the JAX package's.
"""
from __future__ import annotations

import glob
import logging
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import wsi
from ..utils.annotation import AnnotationHandler
from ..utils.labelme_io import (
    labelme_image_array,
    lblsave,
    load_labelme_json,
    shapes_to_label,
)
from .merge import has_pixels

log = logging.getLogger(__name__)

MAGNIFICATION = 8
MARGIN_UM = 20.0  # make_seg_data.py:39

LABEL_NAME_TO_VALUE = OrderedDict([
    ("glomerulus", 1),
    ("crescent", 2),
    ("collapsing", 3),
    ("sclerosis", 3),
    ("mesangium", 4),
    ("poler_mesangium", 4),
])

GLOMUS_CATEGORIES = ["glomerulus", "glomerulus-kana"]
ANNOTATION_DATE_PATTERN = re.compile(r"^\d{8}_(.+)")
SLIDE_EXTENSIONS = ("*ndpi", "*.tiff", "*.tif", "*.svs")


def read_detected_glomus_list(detect_list_file: str) -> Dict[str, List[List]]:
    """Merged CSV -> {patient: [[x1, y1, x2, y2, conf], ...]}
    (make_seg_data.py:248-260)."""
    import csv

    detected: Dict[str, List[List]] = {}
    with open(detect_list_file) as f:
        file_body = ""
        for row in csv.reader(f):
            body = row[1].replace(" ", "")
            if file_body != body:
                file_body = body
                detected[file_body] = []
            detected[file_body].append([int(row[3]), int(row[4]), int(row[5]),
                                        int(row[6]), float(row[7])])
    return detected


def find_slide(wsi_dir: str, file_key: str) -> str:
    for pattern in SLIDE_EXTENSIONS:
        matches = glob.glob(os.path.join(wsi_dir, file_key, pattern))
        if matches:
            assert len(matches) == 1, f"expected one slide for {file_key}"
            return matches[0]
    raise FileNotFoundError(f"no slide found under {wsi_dir}/{file_key}")


def slide_margins(slide) -> tuple:
    mpp_x = float(slide.properties[wsi.PROPERTY_NAME_MPP_X])
    mpp_y = float(slide.properties[wsi.PROPERTY_NAME_MPP_Y])
    return (int(round(MARGIN_UM / mpp_x)), int(round(MARGIN_UM / mpp_y)))


def crop_name(rect) -> str:
    return "xmin{}_ymin{}_xmax{}_ymax{}".format(
        int(rect[0] / MAGNIFICATION), int(rect[1] / MAGNIFICATION),
        int(rect[2] / MAGNIFICATION), int(rect[3] / MAGNIFICATION))


class SegDataGenerator(AnnotationHandler):
    """Crop + GT generation over all slides in a target list."""

    def __init__(self, staining_type: str, annotation_dir: str,
                 target_list: str, detect_list_file: str,
                 iou_threshold: float, output_dir: str, wsi_dir: str,
                 gt_png_dir: Optional[str], seg_gt_json_dir: Optional[str],
                 no_save: bool = False, start: int = 0, end: int = 0):
        super().__init__(annotation_dir, staining_type)
        self.iou_threshold = iou_threshold
        self.detect_list_file = detect_list_file
        self.output_dir = output_dir
        self.seg_gt_json_dir = seg_gt_json_dir
        self.wsi_dir = wsi_dir
        self.no_save = no_save
        self.target_list = target_list
        self.start = start
        self.end = end
        self.detected_glomus_list: Dict[str, List[List]] = {}
        self.overlap_d: Dict[str, List[dict]] = {}
        self.slide = None
        os.makedirs(self.output_dir, exist_ok=True)

    def read_detected_glomus_list(self):
        self.detected_glomus_list = read_detected_glomus_list(
            self.detect_list_file)

    # ---------------- with ground truth ----------------
    def scan_files(self) -> List[tuple]:
        """Process annotated slides; returns [(name, recall, hits, gts, dets)]."""
        results = []
        print("data,recall,recall_hit_num,gt_num,detect_num")
        with open(self.target_list) as f:
            lines = f.readlines()
        end = len(lines) if (self.end == 0 or self.end > len(lines)) else self.end
        for i in range(self.start, end):
            patient_id = lines[i].split(os.sep)[0].strip()
            dir_path = os.path.join(self.annotation_dir, self.staining_dir,
                                    patient_id)
            if not os.path.isdir(dir_path):
                continue
            ann_dir = os.path.join(dir_path, "annotations")
            for file_name in sorted(os.listdir(ann_dir)):
                if not os.path.isfile(os.path.join(ann_dir, file_name)):
                    continue
                body, ext = os.path.splitext(file_name)
                if ext != ".xml" or not file_name.startswith(self.staining_type):
                    continue
                body_list = self.repattern.findall(body)
                slide_name_body = body_list[0][0].replace(
                    self.staining_type + "_" + patient_id + "_", "")
                date_match = ANNOTATION_DATE_PATTERN.findall(slide_name_body)
                slide_name_body = slide_name_body[:9]
                if len(date_match) == 1:
                    slide_name_body = date_match[0]
                if slide_name_body not in self.detected_glomus_list:
                    continue
                self.clear_annotation()
                try:
                    self.read_annotation(ann_dir, file_name)
                except Exception as e:  # tolerate malformed XML
                    print(f"{file_name} is not well-formed:{e}")
                    continue
                recall, hits = self.calculate_overlap_and_save_images(
                    slide_name_body, int(body_list[0][2]))
                row = (body.replace(",", ""), recall, hits,
                       str(len(self.gt_list)),
                       str(len(self.detected_glomus_list[slide_name_body])))
                print('"{}",{},{},{},{}'.format(*row))
                results.append(row)
        return results

    def calculate_overlap_and_save_images(self, file_key: str, times: int):
        gt_num = len(self.gt_list)
        recall_hit_num = 0
        overlap_l: List[dict] = []
        detected_ind_l: List[int] = []
        seg_gt_json_l = glob.glob(
            os.path.join(self.seg_gt_json_dir, file_key, "*.json"))
        slide_path = find_slide(self.wsi_dir, file_key)
        self.slide = wsi.open_slide(slide_path)
        margin_x, margin_y = slide_margins(self.slide)
        output_org_dir = os.path.join(self.output_dir, "org_image", file_key)
        os.makedirs(output_org_dir, exist_ok=True)

        detections = self.detected_glomus_list[file_key]
        for index, gt in enumerate(self.gt_list):
            if self.gt_name_list[index] not in GLOMUS_CATEGORIES:
                continue
            gt_l = [v * times for v in gt]
            gt_margin_l = [int(gt_l[0] - margin_x), int(gt_l[1] - margin_y),
                           int(gt_l[2] + 2 * margin_x),
                           int(gt_l[3] + 2 * margin_y)]
            for cor in gt_margin_l:
                assert cor >= 0, "margin box escapes the slide"
            search_name = crop_name(gt_l)
            json_matches = [j for j in seg_gt_json_l
                            if re.search(search_name, j)]
            assert len(json_matches) <= 1
            if not json_matches:
                # glomerulus not annotated for segmentation (e.g. blurred)
                continue
            iou_list = []
            overlap_d: dict = {}
            detected_ind = -1
            for ind, found_rect in enumerate(detections):
                iou = self.check_overlap(gt_l, found_rect)
                if iou < self.iou_threshold or not has_pixels(found_rect):
                    continue
                iou_list.append(iou)
                if not overlap_d or iou >= overlap_d["iou"]:
                    detected_ind = ind
                    name = crop_name(found_rect)
                    overlap_d = {"org_gt": gt_l, "margin_gt": gt_margin_l,
                                 "pred": found_rect, "iou": iou,
                                 "json": json_matches[0],
                                 "file_key": file_key, "name": name}
                    self._save_crop(found_rect, output_org_dir, name)
            if iou_list:
                overlap_l.append(overlap_d)
                recall_hit_num += 1
                detected_ind_l.append(detected_ind)
            else:  # FN
                overlap_l.append({"org_gt": gt_l, "margin_gt": gt_margin_l,
                                  "pred": [], "iou": 0,
                                  "json": json_matches[0],
                                  "file_key": file_key})

        # FP: detections that matched no GT still get crops + empty labels;
        # a box without pixels gets neither
        skipped = 0
        for ind in (x for x in range(len(detections))
                    if x not in detected_ind_l):
            found_rect = detections[ind]
            if not has_pixels(found_rect):
                skipped += 1
                continue
            name = crop_name(found_rect)
            overlap_l.append({"org_gt": [], "margin_gt": [],
                              "pred": found_rect, "iou": 0, "json": "",
                              "file_key": file_key, "name": name})
            self._save_crop(found_rect, output_org_dir, name)

        self._log_skipped(file_key, skipped)
        self.overlap_d = {file_key: overlap_l}
        self.generate_org_gt_png()
        if gt_num != 0:
            return float(recall_hit_num) / float(gt_num), recall_hit_num
        return 0, recall_hit_num

    def _save_crop(self, rect, output_dir: str, name: str) -> None:
        region = self.slide.read_region(
            (int(rect[0]), int(rect[1])), 0,
            (int(rect[2] - rect[0]), int(rect[3] - rect[1])))
        region.save(os.path.join(output_dir, name + ".PNG"), format="PNG",
                    quality=100)

    def generate_org_gt_png(self) -> None:
        """Paint GT polygons into each detected rect's frame
        (make_seg_data.py:270-336)."""
        label_name_to_value = {"_background_": 0, **LABEL_NAME_TO_VALUE}
        for _, glomus_l in self.overlap_d.items():
            for glomus_d in glomus_l:
                output_label_dir = os.path.join(
                    self.output_dir, "label", "all", glomus_d["file_key"])
                os.makedirs(output_label_dir, exist_ok=True)
                if glomus_d["json"]:
                    data = load_labelme_json(glomus_d["json"])
                    img = labelme_image_array(data, glomus_d["json"])
                    lbl = shapes_to_label(img.shape, data["shapes"],
                                          label_name_to_value,
                                          list(LABEL_NAME_TO_VALUE))
                    mg = glomus_d["margin_gt"]
                    assert lbl.shape[1] == mg[2] - mg[0]
                    assert lbl.shape[0] == mg[3] - mg[1]
                    if glomus_d["pred"]:
                        # TP: paste the margin-GT frame into the union rect,
                        # then crop the predicted rect out of it
                        pred = glomus_d["pred"]
                        ux0 = min(pred[0], mg[0])
                        uy0 = min(pred[1], mg[1])
                        ux1 = max(pred[2], mg[2])
                        uy1 = max(pred[3], mg[3])
                        union = np.zeros((int(uy1 - uy0), int(ux1 - ux0)))
                        union[mg[1] - uy0: mg[3] - uy0,
                              mg[0] - ux0: mg[2] - ux0] = lbl
                        lbl_pred = union[pred[1] - uy0: pred[3] - uy0,
                                         pred[0] - ux0: pred[2] - ux0]
                        lblsave(os.path.join(output_label_dir,
                                             glomus_d["name"] + ".PNG"),
                                lbl_pred)
                    # FN: nothing to draw
                elif glomus_d["pred"] and "name" in glomus_d:
                    # FP: all-background label so WSI evaluation sees it
                    pred = glomus_d["pred"]
                    empty = np.zeros((int(pred[3] - pred[1]),
                                      int(pred[2] - pred[0])))
                    lblsave(os.path.join(output_label_dir,
                                         glomus_d["name"] + ".PNG"), empty)

    # ---------------- without ground truth ----------------
    def output_org_files(self) -> None:
        """No-GT mode: crop every detection (make_seg_data.py:347-361)."""
        for file_key in self.detected_glomus_list:
            slide_path = find_slide(self.wsi_dir, file_key)
            self.slide = wsi.open_slide(slide_path)
            output_org_dir = os.path.join(self.output_dir, "org_image",
                                          file_key)
            os.makedirs(output_org_dir, exist_ok=True)
            skipped = 0
            for found_rect in self.detected_glomus_list[file_key]:
                if not has_pixels(found_rect):
                    skipped += 1
                    continue
                self._save_crop(found_rect, output_org_dir,
                                crop_name(found_rect))
            self._log_skipped(file_key, skipped)

    @staticmethod
    def _log_skipped(file_key: str, skipped: int) -> None:
        if skipped:
            log.warning("%s: %d merged box(es) of zero width or height "
                        "not cropped", file_key, skipped)
