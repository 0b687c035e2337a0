"""WSI stitching and evaluation.

Replicates ``module/espnet/test/eval_wsi_segmentation.py``: walks each slide
in non-overlapping windows, rasterizes the GT (labelme polygons) and the
prediction (per-crop JSONs from the segment stage) into each window with
margin-aware pasting and pixelwise-max combination, accumulates per-slide
and global confusion matrices, and writes overlay JPEGs plus a TSV report.

Known reference quirk: the y-loop bound compares ``ymax`` against
``slide_width`` instead of ``slide_height``
(``eval_wsi_segmentation.py:193-194,386-387``), silently dropping bottom
windows on slides taller than wide.  ``compat_window_bug=True`` (default)
mirrors it for output parity; ``False`` fixes it.

The port's own copy of ``glomeruli_segmentation_tpu/pipeline/eval_wsi.py``
(numpy and cv2; slides are read through the port's :func:`..wsi.open_slide`).
Tests hold its TSV and overlays to the JAX package's.
"""
from __future__ import annotations

import glob
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import wsi
from ..eval.iou_eval import IouEval
from ..palette import (
    ESPNET_PALETTE,
    colorize,
    relabel_4cls,
    relabel_from_cityscapes,
)
from ..utils.annotation import AnnotationHandler
from ..utils.labelme_io import (
    labelme_image_array,
    load_labelme_json,
    shapes_to_label,
)
from .seg_data import (
    ANNOTATION_DATE_PATTERN,
    LABEL_NAME_TO_VALUE,
    MAGNIFICATION,
    find_slide,
    read_detected_glomus_list,
)

MARGIN_UM = 20.0


def iter_windows(slide_width: int, slide_height: int, window_size: int,
                 compat_window_bug: bool = True):
    """Yield (xmin, ymin, xmax, ymax) evaluation windows
    (eval_wsi_segmentation.py:180-194)."""
    y_limit = slide_width if compat_window_bug else slide_height
    for x_ind in range(slide_width // window_size + 1):
        xmin = x_ind * window_size
        xmax = (slide_width if x_ind == slide_width // window_size
                else (x_ind + 1) * window_size)
        if xmax > slide_width:
            continue
        for y_ind in range(slide_height // window_size + 1):
            ymin = y_ind * window_size
            ymax = (slide_height if y_ind == slide_height // window_size
                    else (y_ind + 1) * window_size)
            if ymax > y_limit:
                continue
            yield xmin, ymin, xmax, ymax


class WsiEvaluator(AnnotationHandler):
    """Stitch per-crop predictions back onto slides and evaluate mIoU."""

    def __init__(self, staining_type: str, annotation_dir: Optional[str],
                 target_list: str, detect_list_file: str,
                 iou_threshold: float, output_file: str, output_dir: str,
                 wsi_dir: str, gt_png_dir: Optional[str],
                 seg_gt_json_dir: Optional[str], window_size: int,
                 seg_pred_json_dir: str, nclasses: int,
                 no_save: bool = False, start: int = 0, end: int = 0,
                 compat_window_bug: bool = True):
        super().__init__(annotation_dir, staining_type)
        self.iou_threshold = iou_threshold
        self.detect_list_file = detect_list_file
        self.output_file = output_file
        self.output_dir = output_dir
        self.seg_gt_json_dir = seg_gt_json_dir
        self.seg_pred_json_dir = seg_pred_json_dir
        self.wsi_dir = wsi_dir
        self.window_size = window_size
        self.no_save = no_save
        self.target_list = target_list
        self.start = start
        self.end = end
        self.compat_window_bug = compat_window_bug
        self.nclasses = nclasses
        self.iou_eval_val = IouEval(nclasses)
        self.detected_glomus_list: Dict[str, List[List]] = {}
        self.slide = None
        os.makedirs(self.output_dir, exist_ok=True)

    def read_detected_glomus_list(self):
        self.detected_glomus_list = read_detected_glomus_list(
            self.detect_list_file)

    def read_slide_and_cal_margin(self, slide_path: str):
        self.slide = wsi.open_slide(slide_path)
        slide_width, slide_height = self.slide.dimensions
        mpp_x = float(self.slide.properties[wsi.PROPERTY_NAME_MPP_X])
        mpp_y = float(self.slide.properties[wsi.PROPERTY_NAME_MPP_Y])
        margin_x = int(round(MARGIN_UM / mpp_x))
        margin_y = int(round(MARGIN_UM / mpp_y))
        return margin_x, margin_y, slide_width, slide_height

    # ---------------- window rasterization ----------------
    def overlay(self, bbox_list, times, margin_x, margin_y, seg_json_list,
                xmin, ymin, xmax, ymax, data_type: str) -> np.ndarray:
        """Rasterize every crop intersecting the window; pixelwise max
        combine (eval_wsi_segmentation.py:243-316)."""
        window_np = np.zeros((ymax - ymin, xmax - xmin), dtype=int)
        for gt in bbox_list:
            gt_l = [v * times for v in gt]
            gt_margin_l = [int(gt_l[0] - margin_x), int(gt_l[1] - margin_y),
                           int(gt_l[2] + 2 * margin_x),
                           int(gt_l[3] + 2 * margin_y)]
            iou = self.check_overlap([xmin, ymin, xmax, ymax], gt_l)
            if iou <= 0.0:
                continue
            search_name = "xmin{}_ymin{}_xmax{}_ymax{}".format(
                int(gt_l[0] / 8), int(gt_l[1] / 8), int(gt_l[2] / 8),
                int(gt_l[3] / 8))
            matches = [j for j in seg_json_list if re.search(search_name, j)]
            assert len(matches) <= 1
            if not matches:
                continue  # crop not annotated / not produced
            data = load_labelme_json(matches[0])
            img = labelme_image_array(data, matches[0])
            if data_type == "gt":
                label_name_to_value = {"_background_": 0,
                                       **LABEL_NAME_TO_VALUE}
                img = shapes_to_label(img.shape, data["shapes"],
                                      label_name_to_value,
                                      list(LABEL_NAME_TO_VALUE))
            else:
                img = relabel_from_cityscapes(img)
            if self.nclasses == 4:
                img = relabel_4cls(img)
            # paste through the union of window and margin-GT frames
            ux0 = min(xmin, gt_margin_l[0])
            uy0 = min(ymin, gt_margin_l[1])
            ux1 = max(xmax, gt_margin_l[2])
            uy1 = max(ymax, gt_margin_l[3])
            union = np.zeros((int(uy1 - uy0), int(ux1 - ux0)), dtype=int)
            union[gt_margin_l[1] - uy0: gt_margin_l[3] - uy0,
                  gt_margin_l[0] - ux0: gt_margin_l[2] - ux0] = img
            window_np = np.maximum(
                window_np,
                union[ymin - uy0: ymax - uy0, xmin - ux0: xmax - ux0])
            assert window_np.shape == (ymax - ymin, xmax - xmin)
            assert window_np.max() < self.nclasses
        return window_np

    def generate_whole_img(self, bbox, whole_img_np, label_img_np):
        """Downsampled overlay of window labels on slide pixels
        (eval_wsi_segmentation.py:215-241)."""
        import cv2

        xmin, ymin, xmax, ymax = bbox
        w, h = xmax - xmin, ymax - ymin
        region = self.slide.read_region((xmin, ymin), 0, (w, h))
        region = np.asarray(region.convert("RGB"))
        region = cv2.resize(region, (int(w / MAGNIFICATION),
                                     int(h / MAGNIFICATION)),
                            interpolation=cv2.INTER_NEAREST)
        label = cv2.resize(label_img_np, (int(w / MAGNIFICATION),
                                          int(h / MAGNIFICATION)),
                           interpolation=cv2.INTER_NEAREST)
        color = colorize(label, ESPNET_PALETTE, bgr=True)
        overlayed = cv2.addWeighted(region, 0.4, color, 0.6, 0)
        whole_img_np[ymin // MAGNIFICATION: ymax // MAGNIFICATION,
                     xmin // MAGNIFICATION: xmax // MAGNIFICATION] = overlayed
        return whole_img_np

    # ---------------- per-slide evaluation ----------------
    def generate_wsi_pred_gt_and_eval(self, file_key: str, times: int):
        import cv2

        seg_gt_json_l = glob.glob(
            os.path.join(self.seg_gt_json_dir, file_key, "*.json"))
        seg_pred_json_l = glob.glob(
            os.path.join(self.seg_pred_json_dir, file_key, "*.json"))
        slide_path = find_slide(self.wsi_dir, file_key)
        margin_x, margin_y, slide_width, slide_height = \
            self.read_slide_and_cal_margin(slide_path)
        iou_eval = IouEval(self.nclasses)
        whole_gt = np.zeros((slide_height // MAGNIFICATION,
                             slide_width // MAGNIFICATION, 3), dtype=int)
        whole_pred = np.zeros_like(whole_gt)
        for xmin, ymin, xmax, ymax in iter_windows(
                slide_width, slide_height, self.window_size,
                self.compat_window_bug):
            gt_np = self.overlay(self.gt_list, times, margin_x, margin_y,
                                 seg_gt_json_l, xmin, ymin, xmax, ymax, "gt")
            pred_np = self.overlay(self.detected_glomus_list[file_key], 1, 0,
                                   0, seg_pred_json_l, xmin, ymin, xmax, ymax,
                                   "pred")
            iou_eval.add_batch(pred_np, gt_np)
            self.iou_eval_val.add_batch(pred_np, gt_np)
            whole_gt = self.generate_whole_img([xmin, ymin, xmax, ymax],
                                               whole_gt, gt_np)
            whole_pred = self.generate_whole_img([xmin, ymin, xmax, ymax],
                                                 whole_pred, pred_np)
        if not self.no_save:
            cv2.imwrite(os.path.join(self.output_dir, file_key + "_gt.jpg"),
                        whole_gt)
            cv2.imwrite(os.path.join(self.output_dir, file_key + "_pred.jpg"),
                        whole_pred)
        return iou_eval.get_metric_right()

    def scan_files(self) -> None:
        """GT mode: evaluate every annotated slide, write the TSV report
        (eval_wsi_segmentation.py:102-149)."""
        with open(self.target_list) as f:
            lines = f.readlines()
        end = len(lines) if (self.end == 0 or self.end > len(lines)) else self.end
        with open(self.output_file, "w") as out_f:
            for i in range(self.start, end):
                patient_id = lines[i].split(os.sep)[0].strip()
                dir_path = os.path.join(self.annotation_dir,
                                        self.staining_dir, patient_id)
                print("Analyzing :{}".format(patient_id))
                if not os.path.isdir(dir_path):
                    continue
                ann_dir = os.path.join(dir_path, "annotations")
                for file_name in sorted(os.listdir(ann_dir)):
                    if not os.path.isfile(os.path.join(ann_dir, file_name)):
                        continue
                    body, ext = os.path.splitext(file_name)
                    if ext != ".xml" or not file_name.startswith(
                            self.staining_type):
                        continue
                    body_list = self.repattern.findall(body)
                    slide_name_body = body_list[0][0].replace(
                        self.staining_type + "_" + patient_id + "_", "")
                    date_match = ANNOTATION_DATE_PATTERN.findall(
                        slide_name_body)
                    slide_name_body = slide_name_body[:9]
                    if len(date_match) == 1:
                        slide_name_body = date_match[0]
                    if slide_name_body not in self.detected_glomus_list:
                        continue
                    self.clear_annotation()
                    try:
                        self.read_annotation(ann_dir, file_name)
                    except Exception as e:
                        print(f"{file_name} is not well-formed:{e}")
                        continue
                    overall_acc, per_class_acc, per_class_iou, miou = \
                        self.generate_wsi_pred_gt_and_eval(
                            slide_name_body, int(body_list[0][2]))
                    out_f.write("{}\t{}\t{}\t{}\t{}\n".format(
                        patient_id, overall_acc, per_class_acc,
                        per_class_iou, miou))
                    print("{}\t{}\t{}\t{}\t{}".format(
                        patient_id, overall_acc, per_class_acc,
                        per_class_iou, miou))
            overall_acc, per_class_acc, per_class_iou, miou = \
                self.iou_eval_val.get_metric_right()
            out_f.write("total\t{}\t{}\t{}\t{}".format(
                overall_acc, per_class_acc, per_class_iou, miou))

    def generate_pred_wsi(self) -> None:
        """No-GT mode: stitched prediction overlays only
        (eval_wsi_segmentation.py:359-394)."""
        import cv2

        for file_key in self.detected_glomus_list:
            seg_pred_json_l = glob.glob(
                os.path.join(self.seg_pred_json_dir, file_key, "*.json"))
            slide_path = find_slide(self.wsi_dir, file_key)
            _, _, slide_width, slide_height = \
                self.read_slide_and_cal_margin(slide_path)
            whole_pred = np.zeros((slide_height // MAGNIFICATION,
                                   slide_width // MAGNIFICATION, 3), dtype=int)
            for xmin, ymin, xmax, ymax in iter_windows(
                    slide_width, slide_height, self.window_size,
                    self.compat_window_bug):
                pred_np = self.overlay(self.detected_glomus_list[file_key], 1,
                                       0, 0, seg_pred_json_l, xmin, ymin,
                                       xmax, ymax, "pred")
                whole_pred = self.generate_whole_img(
                    [xmin, ymin, xmax, ymax], whole_pred, pred_np)
            cv2.imwrite(os.path.join(self.output_dir, file_key + "_pred.jpg"),
                        whole_pred)
