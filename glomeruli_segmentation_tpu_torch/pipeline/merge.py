"""Cross-window detection box merging.

Host-side geometry stage replicating
``module/faster-rcnn/merge_overlaped_glomus.py``: detections from
overlapping sliding windows are greedily merged into whole-glomerulus
boxes using overlap ratios and physical-size limits (µm via slide mpp).

Rect format throughout: ``[x1, y1, x2, y2, conf, area, overlap]``
(level-0 pixels; ``merge_overlaped_glomus.py:144-150``).

The port's own copy of ``glomeruli_segmentation_tpu/pipeline/merge.py`` (the
port imports nothing of the JAX package); a test holds the two equal.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional, Sequence

from ..utils.glomus_handler import GlomusHandler
from ..utils.target_list import metadata_by_file_id


class MergeOverlappedGlomeruliError(Exception):
    pass


def overlap_area(rect1: Sequence[float], rect2: Sequence[float]) -> float:
    """Intersection area; 0 when disjoint (merge_overlaped_glomus.py:292-302)."""
    if (rect1[2] >= rect2[0] and rect1[0] <= rect2[2]
            and rect1[3] >= rect2[1] and rect1[1] <= rect2[3]):
        x1 = max(rect1[0], rect2[0])
        y1 = max(rect1[1], rect2[1])
        x2 = min(rect1[2], rect2[2])
        y2 = min(rect1[3], rect2[3])
        return (x2 - x1) * (y2 - y1)
    return 0.0


class BoxMerger:
    """Greedy whole-slide box merger.

    Thresholds (merge_overlaped_glomus.py:27-38): merge when the mutual
    overlap ratio exceeds ``UNCONDITIONAL_MERGE_THRESHOLD`` for both boxes,
    or when one side is nearly equal (< ``SIDE_LENGTH_MERGE_THRESHOLD`` µm);
    refuse when either box exceeds the maximum plausible glomerulus size;
    otherwise merge when overlap/min-area >= ``overlap_threshold``.
    """

    UNCONDITIONAL_MERGE_THRESHOLD = 0.6
    SIDE_LENGTH_MERGE_THRESHOLD = 30.0  # micrometres
    MAX_GLOMUS_SIZE = 350.0  # micrometres
    MAX_GLOMUS_AREA = 300.0 * 300.0  # square micrometres

    def __init__(self, overlap_threshold: float):
        self.overlap_threshold = overlap_threshold
        self.rect_list: List[List[float]] = []

    def merge_decision(self, rect1, rect2, area1, area2, overlap,
                       mpp_x: float, mpp_y: float) -> bool:
        if (overlap >= area1 * self.UNCONDITIONAL_MERGE_THRESHOLD
                and overlap >= area2 * self.UNCONDITIONAL_MERGE_THRESHOLD):
            return True

        t = self.SIDE_LENGTH_MERGE_THRESHOLD
        if (abs(rect1[0] - rect2[0]) * mpp_x < t
                and abs(rect1[2] - rect2[2]) * mpp_x < t
                and (abs(rect1[1] - rect2[1]) * mpp_y < t
                     or abs(rect1[3] - rect2[3]) * mpp_y < t)):
            return True
        elif (abs(rect1[1] - rect2[1]) * mpp_y < t
                and abs(rect1[3] - rect2[3]) * mpp_y < t
                and (abs(rect1[0] - rect2[0]) * mpp_x < t
                     or abs(rect1[2] - rect2[2]) * mpp_x < t)):
            return True

        if (max(rect1[2] - rect1[0], rect2[2] - rect2[0])
                > self.MAX_GLOMUS_SIZE / mpp_x
                or max(rect1[3] - rect1[1], rect2[3] - rect2[1])
                > self.MAX_GLOMUS_SIZE / mpp_y):
            return False
        if max(area1, area2) > self.MAX_GLOMUS_AREA / mpp_x / mpp_y:
            return False

        return max(overlap / area1, overlap / area2) >= self.overlap_threshold

    def merge_rect(self, rect, new_rect, mpp_x, mpp_y) -> Optional[List[float]]:
        overlap = overlap_area(new_rect, rect)
        if overlap <= 0.0:
            return None
        area1 = (rect[2] - rect[0]) * (rect[3] - rect[1])
        area2 = (new_rect[2] - new_rect[0]) * (new_rect[3] - new_rect[1])
        if not self.merge_decision(rect, new_rect, area1, area2, overlap,
                                   mpp_x, mpp_y):
            return None
        x1 = min(new_rect[0], rect[0])
        y1 = min(new_rect[1], rect[1])
        x2 = max(new_rect[2], rect[2])
        y2 = max(new_rect[3], rect[3])
        return [x1, y1, x2, y2, max(new_rect[4], rect[4]),
                (x2 - x1) * (y2 - y1), 0.0]

    def _recheck_overlap(self, new_rect_list, new_rect, mpp_x, mpp_y):
        """Chain merges: a freshly merged rect may now swallow earlier kept
        rects (merge_overlaped_glomus.py:239-261)."""
        merged_rect = None
        remove_index = []
        for i, rect in enumerate(new_rect_list):
            merged_rect = self.merge_rect(rect, new_rect, mpp_x, mpp_y)
            if merged_rect is not None:
                remove_index.append(i)
        for i in reversed(remove_index):
            new_rect_list.pop(i)
        return merged_rect

    def add_rect(self, new_rect: List[float], mpp_x: float, mpp_y: float) -> bool:
        """Insert one candidate, merging into the kept set where decided."""
        new_rect_list: List[List[float]] = []
        merged_flag = False

        for rect in self.rect_list:
            rect[6] = overlap_area(new_rect, rect)
        self.rect_list.sort(key=lambda r: float(r[6]), reverse=True)

        for rect in self.rect_list:
            merged_rect = self.merge_rect(rect, new_rect, mpp_x, mpp_y)
            if merged_rect is not None:
                chained = self._recheck_overlap(new_rect_list, merged_rect,
                                                mpp_x, mpp_y)
                if chained is not None:
                    merged_rect = chained
                new_rect_list.append(merged_rect)
                merged_flag = True
                new_rect = merged_rect
            else:
                new_rect_list.append(rect)

        if not merged_flag:
            new_rect_list.append(new_rect)
        self.rect_list = new_rect_list
        return merged_flag

    def merge_all(self, candidates: List[List[float]], mpp_x: float,
                  mpp_y: float) -> List[List[float]]:
        """Merge a slide's candidate set; processes by area descending
        (larger boxes are likelier to capture the whole glomerulus,
        merge_overlaped_glomus.py:176-183)."""
        self.rect_list = []
        for rect in sorted(candidates, key=lambda r: float(r[5]),
                           reverse=True):
            self.add_rect(rect, mpp_x, mpp_y)
        return self.rect_list


def _slide_mpp(annotation_dir: str, staining_dir: str, patient_id: str,
               file_name: str, target_metadata) -> tuple:
    body, ext = os.path.splitext(file_name)
    if ext not in (".png", ".PNG"):
        from .. import wsi

        path = os.path.join(annotation_dir, staining_dir, patient_id, file_name)
        with wsi.open_slide(path) as slide:
            return (float(slide.properties[wsi.PROPERTY_NAME_MPP_X]),
                    float(slide.properties[wsi.PROPERTY_NAME_MPP_Y]))
    meta = target_metadata.get(body)
    if meta is None:
        raise MergeOverlappedGlomeruliError("unknown target file name is given.")
    return meta.mpp_x, meta.mpp_y


def run_merge(staining_type: str, input_file: str, output_dir: str,
              training_type: str, conf_threshold: float,
              annotation_dir: str, overlap_threshold: float,
              target_list: Optional[str] = None) -> str:
    """Stream the detect CSV grouped by slide, merge, and write the
    ``<staining>_GlomusMergedList_<ext>.csv`` + timing log.

    Returns the merged CSV path.
    """
    target_metadata: Dict = {}
    if target_list and os.path.isfile(target_list):
        target_metadata = metadata_by_file_id(target_list)
    staining_dir = GlomusHandler.get_staining_type(staining_type)

    file_body = staining_type + "_GlomusMergedList_" + training_type
    os.makedirs(output_dir, exist_ok=True)
    merged_path = os.path.join(output_dir, file_body + ".csv")
    log_path = os.path.join(output_dir, file_body + "_log.csv")

    merger = BoxMerger(overlap_threshold)

    def flush_group(merged_file, site, patient, fname, rects, mpp_x, mpp_y):
        merged = merger.merge_all(rects, mpp_x, mpp_y)
        for rect in merged:
            merged_file.write(
                site + "," + patient + ',"' + fname + '",'
                + str(int(rect[0])) + "," + str(int(rect[1])) + ","
                + str(int(rect[2])) + "," + str(int(rect[3])) + ","
                + str(rect[4]) + "\n")
            merged_file.flush()

    with open(input_file) as list_file, open(merged_path, "w") as merged_file, \
            open(log_path, "w") as log_file:
        reader = csv.reader(list_file)
        site = patient = prev_file = ""
        tmp_rects: List[List[float]] = []
        start_time = time.time()
        for row in reader:
            if prev_file == "" or prev_file != row[2]:
                if prev_file != "":
                    mpp_x, mpp_y = _slide_mpp(annotation_dir, staining_dir,
                                              patient, prev_file,
                                              target_metadata)
                    flush_group(merged_file, site, patient, prev_file,
                                tmp_rects, mpp_x, mpp_y)
                    duration = time.time() - start_time
                    log_file.write('"{}",{}\n'.format(prev_file, duration))
                    log_file.flush()
                    start_time = time.time()
                site, patient, prev_file = row[0], row[1], row[2]
                tmp_rects = []
            if float(row[9]) >= conf_threshold:
                x1, y1, x2, y2, conf = map(float, row[5:10])
                tmp_rects.append([x1, y1, x2, y2, conf,
                                  (x2 - x1) * (y2 - y1), 0.0])
        if prev_file != "":
            mpp_x, mpp_y = _slide_mpp(annotation_dir, staining_dir, patient,
                                      prev_file, target_metadata)
            flush_group(merged_file, site, patient, prev_file, tmp_rects,
                        mpp_x, mpp_y)
            log_file.write('"{}",{}\n'.format(prev_file,
                                              time.time() - start_time))
    return merged_path
