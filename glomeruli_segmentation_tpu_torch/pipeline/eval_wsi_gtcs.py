"""GTCS WSI stitch + evaluation (ref ``module/SegFormer/test/eval_wsi_segmentation_gtcs.py``).

Same windowed architecture as :mod:`.eval_wsi` but reads **label PNGs**
instead of labelme JSONs (``overlay`` at ``eval_wsi_segmentation_gtcs.py:
221-308``): the prediction/GT images are pasted directly with margin-aware
cropping and ``np.maximum`` combine; GT box coordinates are parsed from the
crop filenames (``read_gt_list``, ``:331-337``); metrics are micro IoU
**and Dice** via ``getMetricMicro`` (``:116-118``).

The port's own copy of ``glomeruli_segmentation_tpu/pipeline/
eval_wsi_gtcs.py`` (numpy, PIL and cv2; slides are read through the port's
:func:`..wsi.open_slide`).  Tests hold its TSV and overlays to the JAX
package's.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List

import numpy as np
from PIL import Image

from .. import wsi
from ..eval.iou_eval import IouEval
from ..palette import GTCS_PALETTE, colorize
from ..utils.annotation import AnnotationHandler
from .eval_wsi import iter_windows
from .seg_data import find_slide

MAGNIFICATION = 8
MARGIN_UM = 20.0


class GtcsWsiEvaluator(AnnotationHandler):
    def __init__(self, staining_type, annotation_dir, target_list,
                 detect_list_file, iou_threshold, output_file, output_dir,
                 wsi_dir, seg_gt_image_dir, window_size, seg_pred_image_dir,
                 nclasses, no_save=False, start=0, end=0,
                 compat_window_bug: bool = True):
        super().__init__(annotation_dir, staining_type)
        self.detect_list_file = detect_list_file
        self.output_file = output_file
        self.output_dir = output_dir
        self.seg_gt_image_dir = seg_gt_image_dir
        self.seg_pred_image_dir = seg_pred_image_dir
        self.wsi_dir = wsi_dir
        self.window_size = window_size
        self.no_save = no_save
        self.target_list = target_list
        self.start = start
        self.end = end
        self.nclasses = nclasses
        self.compat_window_bug = compat_window_bug
        self.iou_eval_val = IouEval(nclasses)
        self.detected_glomus_list: Dict[str, List[List]] = {}
        self.slide = None
        os.makedirs(self.output_dir, exist_ok=True)

    def read_detected_glomus_list(self):
        """Only specimens that have prediction images are kept
        (eval_wsi_segmentation_gtcs.py:310-329)."""
        import csv

        detected_files = glob.glob(
            os.path.join(self.seg_pred_image_dir, "*", "*.PNG"))
        specimen_ids = {f.split(os.path.sep)[-2] for f in detected_files}
        with open(self.detect_list_file) as f:
            file_body = ""
            for row in csv.reader(f):
                body = row[1].replace(" ", "")
                if body not in specimen_ids:
                    continue
                if file_body != body:
                    file_body = body
                    self.detected_glomus_list[file_body] = []
                self.detected_glomus_list[file_body].append(
                    [int(row[3]), int(row[4]), int(row[5]), int(row[6]),
                     float(row[7])])

    def read_gt_list(self, files: List[str], times: int = 1):
        gt = []
        for file_name in files:
            parts = os.path.splitext(os.path.basename(file_name))[0].split("_")
            gt.append([int(parts[-4].lstrip("xmin")) * times,
                       int(parts[-3].lstrip("ymin")) * times,
                       int(parts[-2].lstrip("xmax")) * times,
                       int(parts[-1].lstrip("ymax")) * times, 1.0])
        return gt

    def read_slide_and_cal_margin(self, slide_path: str):
        self.slide = wsi.open_slide(slide_path)
        slide_width, slide_height = self.slide.dimensions
        mpp_x = float(self.slide.properties[wsi.PROPERTY_NAME_MPP_X])
        mpp_y = float(self.slide.properties[wsi.PROPERTY_NAME_MPP_Y])
        return (int(round(MARGIN_UM / mpp_x)), int(round(MARGIN_UM / mpp_y)),
                slide_width, slide_height)

    def overlay(self, bbox_list, times, margin_x, margin_y, seg_img_list,
                xmin, ymin, xmax, ymax, data_type: str) -> np.ndarray:
        window_np = np.zeros((ymax - ymin, xmax - xmin), dtype=int)
        for seg in bbox_list:
            tmp_seg = [int(round(seg[i] / times)) for i in range(4)]
            iou = self.check_overlap([xmin, ymin, xmax, ymax], seg)
            if iou <= 0.0:
                continue
            search_name = "xmin{}_ymin{}_xmax{}_ymax{}".format(*tmp_seg)
            matches = [s for s in seg_img_list if re.search(search_name, s)]
            assert len(matches) <= 1
            if not matches:
                continue
            seg_margin = [int(seg[0] - margin_x), int(seg[1] - margin_y),
                          int(seg[2] + margin_x), int(seg[3] + margin_y)]
            ov = [max(xmin, seg_margin[0]), max(ymin, seg_margin[1]),
                  min(xmax, seg_margin[2]), min(ymax, seg_margin[3])]
            r_ov = [ov[0] - xmin, ov[1] - ymin, ov[2] - xmin, ov[3] - ymin]
            seg_img = np.asarray(Image.open(matches[0]), dtype=int)
            if (seg_img.shape[0] != ov[3] - ov[1]
                    or seg_img.shape[1] != ov[2] - ov[0]):
                seg_img = seg_img[ov[1] - seg_margin[1]: ov[3] - seg_margin[1],
                                  ov[0] - seg_margin[0]: ov[2] - seg_margin[0]]
            window_np[r_ov[1]: r_ov[3], r_ov[0]: r_ov[2]] = np.maximum(
                window_np[r_ov[1]: r_ov[3], r_ov[0]: r_ov[2]], seg_img)
            assert window_np.shape == (ymax - ymin, xmax - xmin)
            assert window_np.max() < self.nclasses
        return window_np

    def generate_whole_img(self, bbox, whole_img_np, label_img_np):
        import cv2

        xmin, ymin, xmax, ymax = bbox
        w, h = xmax - xmin, ymax - ymin
        region = np.asarray(self.slide.read_region((xmin, ymin), 0,
                                                   (w, h)).convert("RGB"))
        region = cv2.resize(region, (int(w / MAGNIFICATION),
                                     int(h / MAGNIFICATION)),
                            interpolation=cv2.INTER_NEAREST)
        label = cv2.resize(label_img_np, (int(w / MAGNIFICATION),
                                          int(h / MAGNIFICATION)),
                           interpolation=cv2.INTER_NEAREST)
        color = colorize(label, GTCS_PALETTE, bgr=True)
        overlayed = cv2.addWeighted(region, 0.4, color, 0.6, 0)
        whole_img_np[ymin // MAGNIFICATION: ymax // MAGNIFICATION,
                     xmin // MAGNIFICATION: xmax // MAGNIFICATION] = overlayed
        return whole_img_np

    def generate_wsi_pred_gt_and_eval(self, file_key: str):
        """Per-slide stitch + micro metrics, GT boxes at level-0 names
        (eval_wsi_segmentation_gtcs.py:132-191)."""
        import cv2

        seg_gt_l = glob.glob(
            os.path.join(self.seg_gt_image_dir, file_key, "*.PNG"))
        gt_list = self.read_gt_list(seg_gt_l)
        seg_pred_l = glob.glob(
            os.path.join(self.seg_pred_image_dir, file_key, "*.PNG"))
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
            if ((xmax - xmin) // MAGNIFICATION <= 0
                    or (ymax - ymin) // MAGNIFICATION <= 0):
                continue
            gt_np = self.overlay(gt_list, 1, margin_x, margin_y, seg_gt_l,
                                 xmin, ymin, xmax, ymax, "gt")
            pred_np = self.overlay(self.detected_glomus_list[file_key], 1,
                                   margin_x, margin_y, seg_pred_l, xmin,
                                   ymin, xmax, ymax, "pred")
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
        return iou_eval.get_metric_micro()

    def scan_files(self) -> None:
        """GT-eval mode over the target list
        (eval_wsi_segmentation_gtcs.py:71-120)."""
        with open(self.target_list) as f:
            lines = f.readlines()
        end = len(lines) if (self.end == 0 or self.end > len(lines)) else self.end
        with open(os.path.join(self.output_dir, self.output_file),
                  "w") as out_f:
            for i in range(self.start, end):
                patient_id = lines[i].strip().split(",")[0].split(os.sep)[0]
                if patient_id not in self.detected_glomus_list:
                    continue
                print("Analyzing :{}".format(patient_id))
                row = self.generate_wsi_pred_gt_and_eval(patient_id)
                out_f.write("{}\t{}\t{}\t{}\t{}\t{}\t{}\n".format(patient_id,
                                                                  *row))
                print("{}\t{}\t{}\t{}\t{}\t{}\t{}".format(patient_id, *row))
            total = self.iou_eval_val.get_metric_micro()
            out_f.write("total\t{}\t{}\t{}\t{}\t{}\t{}".format(*total))

    def generate_pred_wsi(self) -> None:
        """Evaluate + stitch every detected specimen
        (eval_wsi_segmentation_gtcs.py:359-436; GT coords parsed at 1/8
        scale from the GT image names)."""
        import cv2

        with open(os.path.join(self.output_dir, self.output_file),
                  "w") as out_f:
            for file_key in self.detected_glomus_list:
                seg_pred_l = glob.glob(
                    os.path.join(self.seg_pred_image_dir, file_key, "*.PNG"))
                seg_gt_l = glob.glob(
                    os.path.join(self.seg_gt_image_dir, file_key, "*.PNG"))
                slide_path = find_slide(self.wsi_dir, file_key)
                margin_x, margin_y, slide_width, slide_height = \
                    self.read_slide_and_cal_margin(slide_path)
                whole_gt = np.zeros((slide_height // MAGNIFICATION,
                                     slide_width // MAGNIFICATION, 3),
                                    dtype=int)
                whole_pred = np.zeros_like(whole_gt)
                iou_eval = IouEval(self.nclasses)
                gt_list = self.read_gt_list(seg_gt_l, times=8)
                for xmin, ymin, xmax, ymax in iter_windows(
                        slide_width, slide_height, self.window_size,
                        self.compat_window_bug):
                    if ((xmax - xmin) // MAGNIFICATION <= 0
                            or (ymax - ymin) // MAGNIFICATION <= 0):
                        continue
                    gt_np = self.overlay(gt_list, 8, margin_x, margin_y,
                                         seg_gt_l, xmin, ymin, xmax, ymax,
                                         "gt")
                    pred_np = self.overlay(
                        self.detected_glomus_list[file_key], 1, margin_x,
                        margin_y, seg_pred_l, xmin, ymin, xmax, ymax, "pred")
                    whole_gt = self.generate_whole_img(
                        [xmin, ymin, xmax, ymax], whole_gt, gt_np)
                    whole_pred = self.generate_whole_img(
                        [xmin, ymin, xmax, ymax], whole_pred, pred_np)
                    iou_eval.add_batch(pred_np, gt_np)
                    self.iou_eval_val.add_batch(pred_np, gt_np)
                if not self.no_save:
                    cv2.imwrite(os.path.join(self.output_dir,
                                             file_key + "_gt.jpg"), whole_gt)
                    cv2.imwrite(os.path.join(self.output_dir,
                                             file_key + "_pred.jpg"),
                                whole_pred)
                row = iou_eval.get_metric_micro()
                out_f.write("{}\t{}\t{}\t{}\t{}\t{}\t{}\n".format(file_key,
                                                                  *row))
                print("{}\t{}\t{}\t{}\t{}\t{}\t{}".format(file_key, *row))
            total = self.iou_eval_val.get_metric_micro()
            out_f.write("total\t{}\t{}\t{}\t{}\t{}\t{}".format(*total))
