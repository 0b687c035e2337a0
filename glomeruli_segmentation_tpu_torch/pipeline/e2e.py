"""Fused end-to-end slide pipeline: detect -> merge -> segment -> stitch
in one process, no intermediate CSV round-trips.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/e2e.py``.  The
reference runs five separate OS processes communicating through files
(detect CSV -> merge CSV -> crop PNGs -> labelme JSONs -> stitch); this
stage keeps the slide resident: windows stream through the detector
backend, boxes merge in memory (:class:`.merge.BoxMerger`), crops stream
through the 5-fold ensemble (:class:`.fused.FusedSlideSegmenter`), and the
/8 class canvas accumulates on the fly.  The reference's file artifacts
are still written at the end -- they are the public API:

- ``<staining>_GlomusMergedList_<ext>.csv`` (merge_overlaped_glomus.py:102-124)
- per-crop labelme JSONs named ``xmin{}_ymin{}_xmax{}_ymax{}.json`` in
  level-0/8 coords (make_seg_data.py:193-197, VisualizeResults_iou.py:161-182)
- ``{patient}_pred.jpg`` stitched overlay (eval_wsi_segmentation.py:359-394)

PIL (the labelme PNGs) and cv2 (contours, the overlay) are imported where
they are used, so a missing one raises there.
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from .. import wsi
from ..palette import ESPNET_PALETTE, colorize, relabel_to_cityscapes
from .detect import DetectorBackend, GlomusDetector
from .fused import EnsembleSegmenter, FusedSlideSegmenter
from .merge import BoxMerger, has_pixels
from .seg_data import MAGNIFICATION
from .segment import build_labelme_doc

log = logging.getLogger(__name__)


class _CollectingDetector(GlomusDetector):
    """Sliding-window detector that collects level-0 boxes in memory
    instead of streaming CSV rows (geometry identical to the staged
    detect stage -- same class, overridden sink)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.collected: List[List[float]] = []

    def write_detected_result(self, bs, i, j, x_start, y_start, output_file,
                              site_name, specimen_id, file_name, scale):
        for box in bs:
            if box[4] > 0:
                self.collected.append([
                    x_start + box[0] * scale, y_start + box[1] * scale,
                    x_start + box[2] * scale, y_start + box[3] * scale,
                    box[4]])


class FusedEndToEnd:
    """One-command slide -> boxes -> crops -> canvas pipeline."""

    def __init__(self, backend: DetectorBackend,
                 ensemble: Optional[EnsembleSegmenter] = None,
                 data_category: str = "OPT_PAS",
                 window_size: int = 2000, overlap_ratio: float = 0.1,
                 detect_conf: float = 0.2, merge_conf: float = 0.9,
                 merge_overlap: float = 0.35, host_resize: bool = False,
                 transfer: str = "auto", segmenter=None,
                 palette=None, crop_artifact: str = "labelme"):
        """Either pass ``ensemble`` (5-fold ESPNet; per-crop artifacts are
        labelme JSONs) or ``segmenter`` -- any object with the
        ``segment_slide(slide, detections, progress, on_crop)`` surface
        (``crop_artifact="png"`` then emits mode-'L' grayscale label PNGs,
        the GTCS stitcher's input).

        ``host_resize`` and ``transfer`` go to the ensemble's
        :class:`.fused.FusedSlideSegmenter` (``"auto"``: flat on one
        device, padded with ``host_resize`` or under a mesh)."""
        # reference operating points: example/README.md:34-37,48-49
        self.backend = backend
        if segmenter is not None:
            if ensemble is not None:
                raise ValueError("pass ensemble OR segmenter, not both")
            self.segmenter = segmenter
        else:
            self.segmenter = FusedSlideSegmenter(
                ensemble, host_resize=host_resize, transfer=transfer)
        self.palette = ESPNET_PALETTE if palette is None else palette
        if crop_artifact not in ("labelme", "png"):
            raise ValueError(f"unknown crop_artifact {crop_artifact!r}")
        self.crop_artifact = crop_artifact
        self.data_category = data_category
        self.window_size = window_size
        self.overlap_ratio = overlap_ratio
        self.detect_conf = detect_conf
        self.merge_conf = merge_conf
        self.merge_overlap = merge_overlap
        # patient -> merged boxes of zero width or height that the
        # segmenter left out (:func:`.merge.has_pixels`), per segmented slide
        self.degenerate_boxes: Dict[str, int] = {}

    def detect_slide(self, slide, data_dir: str, patient_id: str,
                     file_name: str) -> List[List[float]]:
        with tempfile.TemporaryDirectory(prefix="gseg_e2e_") as scratch:
            det = _CollectingDetector(
                self.data_category, target_list="", data_dir=data_dir,
                output_dir=scratch, output_file_ext="_e2e",
                window_size=self.window_size,
                overlap_ratio=self.overlap_ratio,
                conf_threshold=self.detect_conf,
                batch_size=self.backend.batch_size)
            det.scan_slide(self.backend, slide, "", patient_id, file_name,
                           output_file=None)
        return det.collected

    def merge_boxes(self, detections: List[List[float]], mpp_x: float,
                    mpp_y: float) -> List[List[float]]:
        """conf filter + area-descending greedy merge, the staged merger's
        rule set (merge_overlaped_glomus.py:142-204)."""
        candidates = []
        for x1, y1, x2, y2, conf in detections:
            if conf >= self.merge_conf:
                area = (x2 - x1) * (y2 - y1)
                candidates.append([x1, y1, x2, y2, conf, area, 0.0])
        merger = BoxMerger(self.merge_overlap)
        return merger.merge_all(candidates, mpp_x, mpp_y)

    @staticmethod
    def prepare_output(output_dir: str, data_category: str,
                       output_file_ext: str = "_GlomusMergedList_",
                       resume: bool = False) -> set:
        """Start-of-run bookkeeping for a multi-slide target list.

        Fresh run: truncate the accumulated merged CSV + timing log.
        Resume (the detect stage's ``--resume`` contract): keep both and
        return the patient ids already present in the timing log so the
        caller can skip them."""
        os.makedirs(output_dir, exist_ok=True)
        csv_path = os.path.join(
            output_dir, f"{data_category}{output_file_ext}.csv")
        log_path = os.path.join(
            output_dir, f"{data_category}{output_file_ext}_log.csv")
        done: set = set()
        if resume:
            if os.path.isfile(log_path):
                with open(log_path) as f:
                    for line in f.readlines()[1:]:
                        name = line.split(",")[0].strip().strip('"')
                        if name:
                            done.add(name)
            # drop CSV rows from slides missing their timing-log row: an
            # interrupt can land between the two appends in _emit (the rows
            # flush first), and --resume reruns exactly those slides --
            # without this sweep their rows would duplicate
            if os.path.isfile(csv_path):
                with open(csv_path) as f:
                    rows = f.readlines()
                kept = [r for r in rows
                        if r.split(",")[1].strip().strip('"') in done]
                if len(kept) != len(rows):
                    tmp = csv_path + ".tmp"
                    with open(tmp, "w") as f:
                        f.writelines(kept)
                    os.replace(tmp, csv_path)
            return done
        for path in (csv_path, log_path):
            if os.path.isfile(path):
                os.remove(path)
        return done

    def run_slide(self, slide_path: str, output_dir: str, patient_id: str,
                  output_file_ext: str = "_GlomusMergedList_",
                  json_dir: Optional[str] = None,
                  write_overlay: bool = True,
                  progress: bool = False) -> np.ndarray:
        t0 = time.time()
        with wsi.open_slide(slide_path) as slide:
            merged = self._detect_and_merge(slide, slide_path, patient_id)
            t_detect = time.time() - t0
            return self._segment_and_emit(
                slide, slide_path, patient_id, merged, output_dir,
                output_file_ext, json_dir, write_overlay, progress,
                t0, t_detect)

    def run_slides(self, jobs, output_dir: str,
                   output_file_ext: str = "_GlomusMergedList_",
                   json_dir: Optional[str] = None,
                   write_overlay: bool = True, progress: bool = False,
                   on_result=None, pipeline: bool = True) -> int:
        """Multi-slide runner with cross-slide pipelining.

        ``jobs``: iterable of ``(slide_path, patient_id)``.  With
        ``pipeline=True`` the slides stream through three overlapped
        stages: slide N+1's detection scan + box merge (producer thread),
        slide N's fused segmentation (caller thread), and slide N-1's
        artifact emission -- overlay reads + CSV/log flush, pure host
        work -- on an emitter thread.  Both hand-off queues are one-deep;
        up to five slides can be open at once (one per stage plus one in
        each queue).  The detector and the segmenter enqueue their device
        work on the same stream, so the overlap is the host's: reads,
        resizes, packing, JSON and overlay encoding.

        Per-slide artifacts and their ordering are identical to calling
        :meth:`run_slide` per job (the single serial emitter flushes the
        CSV/timing rows in job order).  ``on_result(patient_id,
        slide_path, error, seconds)`` is called per slide in order, with
        ``error=None`` on success; with a reporter, a slide failure is
        isolated and later slides still run.  WITHOUT ``on_result`` the
        stream stops at the first failure (``run_slide``-loop semantics:
        in-flight work drains, remaining slides are not processed) and
        the error re-raises.  ``KeyboardInterrupt``/``SystemExit`` are
        never treated as slide failures -- they abort the stream.
        Returns the number of successful slides."""
        import queue
        import threading

        jobs = list(jobs)
        # ok / first per-slide failure (no-reporter mode) / emitter
        # infrastructure failure (e.g. the reporter callback itself threw)
        state = {"ok": 0, "first_error": None, "emitter_error": None}
        stop = threading.Event()
        SENTINEL = object()

        def detect_job(slide_path, patient_id, t0):
            slide = wsi.open_slide(slide_path)
            try:
                merged = self._detect_and_merge(slide, slide_path,
                                                patient_id)
            except BaseException:
                slide.close()
                raise
            return slide, merged, time.time() - t0

        def finish(slide, slide_path, patient_id, t0, error, staged):
            """The single per-slide result-dispatch contract, shared by
            the serial path and the emitter thread: emit artifacts,
            close the slide, report/record the outcome."""
            try:
                if error is None:
                    merged, canvas, t_detect = staged
                    try:
                        self._emit(slide, slide_path, patient_id, merged,
                                   canvas, output_dir, output_file_ext,
                                   write_overlay, t0, t_detect)
                        state["ok"] += 1
                    except Exception as e:  # per-slide isolation --
                        # KeyboardInterrupt/SystemExit abort instead
                        error = e
            finally:
                if slide is not None:
                    slide.close()
            if on_result is not None:
                on_result(patient_id, slide_path, error,
                          round(time.time() - t0, 3))
            elif error is not None:
                if state["first_error"] is None:
                    state["first_error"] = error
                # no reporter: stop the stream at the first failure
                stop.set()

        if not pipeline:
            for slide_path, patient_id in jobs:
                if stop.is_set():
                    break
                t0 = time.time()
                try:
                    staged = detect_job(slide_path, patient_id, t0)
                except Exception as e:
                    finish(None, slide_path, patient_id, t0, e, None)
                    continue
                slide, merged, t_detect = staged
                try:
                    canvas = self._segment(slide, patient_id, merged,
                                           json_dir, progress)
                except Exception as e:
                    finish(slide, slide_path, patient_id, t0, e, None)
                    continue
                finish(slide, slide_path, patient_id, t0, None,
                       (merged, canvas, t_detect))
            if on_result is None and state["first_error"] is not None:
                raise state["first_error"]
            return state["ok"]

        q: "queue.Queue" = queue.Queue(maxsize=1)
        emit_q: "queue.Queue" = queue.Queue(maxsize=1)

        def producer():
            for slide_path, patient_id in jobs:
                if stop.is_set():
                    break
                t0 = time.time()
                try:
                    q.put((slide_path, patient_id, t0,
                           detect_job(slide_path, patient_id, t0)))
                except BaseException as e:
                    # catching everything guarantees the sentinel below --
                    # a dying producer would deadlock the consumer; the
                    # consumer aborts on non-Exception items
                    q.put((slide_path, patient_id, t0, e))
                    if not isinstance(e, Exception):
                        break
            q.put(SENTINEL)

        def emitter():
            while True:
                item = emit_q.get()
                if item is SENTINEL:
                    return
                try:
                    finish(*item)
                except BaseException as e:
                    # the emitter must never die mid-stream (the main
                    # thread's one-deep put() would deadlock): record the
                    # infrastructure failure and keep draining -- finish()
                    # closes each slide before its reporting step, so
                    # later slides still close
                    if state["emitter_error"] is None:
                        state["emitter_error"] = e
                    stop.set()

        threading.Thread(target=producer, daemon=True).start()
        et = threading.Thread(target=emitter, daemon=True)
        et.start()
        abort_error = None
        while True:
            item = q.get()
            if item is SENTINEL:
                break
            slide_path, patient_id, t0, staged = item
            if isinstance(staged, BaseException):
                if not isinstance(staged, Exception):
                    stop.set()
                    abort_error = staged
                    continue  # drain the producer to its sentinel
                if stop.is_set():
                    # stream stopping: nothing may be reported after the
                    # stream starts dropping results (staged successes
                    # are dropped below; dropping errors too keeps the
                    # reporter's per-slide ordering intact)
                    continue
                emit_q.put((None, slide_path, patient_id, t0, staged,
                            None))
                continue
            slide, merged, t_detect = staged
            if stop.is_set():
                # stream stopping (first failure without a reporter, or
                # an abort): drop staged work, but keep draining so the
                # producer's put() never deadlocks
                slide.close()
                continue
            try:
                canvas = self._segment(slide, patient_id, merged,
                                       json_dir, progress)
            except Exception as e:
                emit_q.put((slide, slide_path, patient_id, t0, e, None))
                continue
            except BaseException as e:
                slide.close()
                stop.set()
                abort_error = e
                continue
            emit_q.put((slide, slide_path, patient_id, t0, None,
                        (merged, canvas, t_detect)))
        emit_q.put(SENTINEL)
        et.join()
        if abort_error is not None:
            raise abort_error
        if state["emitter_error"] is not None:
            raise state["emitter_error"]
        if on_result is None and state["first_error"] is not None:
            raise state["first_error"]
        return state["ok"]

    def _detect_and_merge(self, slide, slide_path: str,
                          patient_id: str) -> List[List[float]]:
        """Stage 1 of a slide: window scan -> conf filter -> greedy merge."""
        mpp_x = float(slide.properties[wsi.PROPERTY_NAME_MPP_X])
        mpp_y = float(slide.properties[wsi.PROPERTY_NAME_MPP_Y])
        detections = self.detect_slide(slide, os.path.dirname(slide_path),
                                       patient_id,
                                       os.path.basename(slide_path))
        return self.merge_boxes(detections, mpp_x, mpp_y)

    def _segment_and_emit(self, slide, slide_path: str, patient_id: str,
                          merged: List[List[float]], output_dir: str,
                          output_file_ext: str, json_dir: Optional[str],
                          write_overlay: bool, progress: bool,
                          t0: float, t_detect: float) -> np.ndarray:
        """Stage 2+3 inline: fused segmentation, then every per-slide
        artifact (the pipelined path in :meth:`run_slides` runs
        :meth:`_segment` and :meth:`_emit` on different threads)."""
        canvas = self._segment(slide, patient_id, merged, json_dir,
                               progress)
        self._emit(slide, slide_path, patient_id, merged, canvas,
                   output_dir, output_file_ext, write_overlay, t0,
                   t_detect)
        return canvas

    def _segment(self, slide, patient_id: str, merged: List[List[float]],
                 json_dir: Optional[str], progress: bool) -> np.ndarray:
        """Stage 2: the fused device segmentation (+ per-crop artifacts,
        which segment_slide's own one-deep pipeline overlaps with device
        compute).  Merged boxes of zero width or height keep their CSV row
        but are not segmented and get no per-crop artifact; their count
        goes to ``degenerate_boxes[patient_id]`` and to the log."""
        skipped = sum(not has_pixels(box) for box in merged)
        self.degenerate_boxes[patient_id] = skipped
        if skipped:
            log.warning("%s: %d merged box(es) of zero width or height kept "
                        "in the merged CSV, not segmented", patient_id,
                        skipped)
        on_crop = None
        if json_dir is not None:
            crop_dir = os.path.join(json_dir, patient_id)
            os.makedirs(crop_dir, exist_ok=True)

            def crop_name(box) -> str:
                x1, y1, x2, y2 = box
                return "xmin{}_ymin{}_xmax{}_ymax{}".format(
                    int(x1 / MAGNIFICATION), int(y1 / MAGNIFICATION),
                    int(x2 / MAGNIFICATION), int(y2 / MAGNIFICATION))

            if self.crop_artifact == "labelme":
                def on_crop(box, class_map):
                    name = crop_name(box)
                    relabeled = relabel_to_cityscapes(
                        class_map.astype(np.uint8))
                    doc = build_labelme_doc(relabeled, relabeled,
                                            name + ".PNG")
                    with open(os.path.join(crop_dir, name + ".json"),
                              "w") as jf:
                        json.dump(doc, jf, indent=4)
            else:
                # GTCS contract: crop-resolution label PNGs named by the /8
                # box coords, mode 'L' grayscale -- what the staged GTCS
                # stitcher reads
                from PIL import Image

                def on_crop(box, class_map):
                    Image.fromarray(class_map.astype(np.uint8),
                                    mode="L").save(
                        os.path.join(crop_dir, crop_name(box) + ".PNG"))

        return self.segmenter.segment_slide(slide, merged,
                                            progress=progress,
                                            on_crop=on_crop)

    def _emit(self, slide, slide_path: str, patient_id: str,
              merged: List[List[float]], canvas: np.ndarray,
              output_dir: str, output_file_ext: str, write_overlay: bool,
              t0: float, t_detect: float) -> None:
        """Stage 3: the per-slide public artifacts.

        The merged CSV rows (merge_overlaped_glomus.py:102-124 schema)
        flush together with the timing-log row AFTER segmentation
        completes, so an interrupt mid-slide followed by --resume (which
        skips slides present in the timing log) never leaves
        partially-written slides' rows in the accumulated CSV -- rerunning
        the slide would duplicate them.  A fresh run truncates via
        prepare_output() before the first slide."""
        os.makedirs(output_dir, exist_ok=True)
        file_name = os.path.basename(slide_path)
        csv_rows = [
            ",{},\"{}\",{},{},{},{},{}\n".format(
                patient_id, file_name, int(rect[0]), int(rect[1]),
                int(rect[2]), int(rect[3]), rect[4])
            for rect in merged]
        if write_overlay:
            self._write_overlay(slide, canvas, output_dir, patient_id)
        csv_path = os.path.join(
            output_dir, f"{self.data_category}{output_file_ext}.csv")
        with open(csv_path, "a") as f:
            f.writelines(csv_rows)
        log_path = os.path.join(
            output_dir, f"{self.data_category}{output_file_ext}_log.csv")
        new = not os.path.isfile(log_path)
        with open(log_path, "a") as f:
            if new:
                f.write("file,time,detect_time,timestamp\n")
            now = datetime.datetime.today().strftime("%Y-%m-%dT%H:%M:%S")
            f.write('"{}",{},{},{}\n'.format(
                patient_id, time.time() - t0, t_detect, now))

    def _write_overlay(self, slide, canvas: np.ndarray, output_dir: str,
                       patient_id: str) -> None:
        """{patient}_pred.jpg: /8 slide with palette-colored labels,
        0.4 org / 0.6 label (eval_wsi_segmentation.py:215-241; this one
        covers the whole slide, the reference pastes evaluated windows
        only).

        The /8 background comes from the pyramid level with downsample
        exactly 8 when the slide has one -- 1/64 of the bytes to decode --
        and from level-0 strip decimation otherwise.  Pixel difference
        between the two sources is the scanner's own pyramid resampling
        vs nearest decimation; the label blend math is identical."""
        import cv2

        h8, w8 = canvas.shape
        base = np.zeros((h8, w8, 3), np.uint8)
        level = None
        try:
            cand = slide.get_best_level_for_downsample(8)
            if abs(float(slide.level_downsamples[cand]) - 8.0) < 1e-6:
                level = cand
        except Exception:
            level = None
        if level is not None:
            lw, lh = slide.level_dimensions[level]
            w, h = min(lw, w8), min(lh, h8)
            base[:h, :w] = slide.read_region_array(
                (0, 0), level, (w, h))[:, :, ::-1]  # RGB->BGR
            # scanners floor the level geometry while the /8 canvas
            # ceils: any uncovered right/bottom edge (a few px) falls
            # back to level-0 decimation instead of staying black
            if w < w8:
                edge = slide.read_region_array(
                    (w * 8, 0), 0, ((w8 - w) * 8, h8 * 8))[::8, ::8, ::-1]
                base[:, w:] = edge[:h8, :w8 - w]
            if h < h8:
                edge = slide.read_region_array(
                    (0, h * 8), 0, (w8 * 8, (h8 - h) * 8))[::8, ::8, ::-1]
                base[h:, :] = edge[:h8 - h, :w8]
        else:
            strip = 2048  # level-0 rows per read
            for y0 in range(0, h8 * 8, strip):
                rows = min(strip, h8 * 8 - y0)
                region = slide.read_region_array((0, y0), 0,
                                                 (w8 * 8, rows))
                small = region[::8, ::8, ::-1]  # /8, RGB->BGR
                rows8 = min(small.shape[0], h8 - y0 // 8)
                base[y0 // 8: y0 // 8 + rows8] = small[:rows8]
        color = colorize(canvas, self.palette, bgr=True)
        out = cv2.addWeighted(base, 0.4, color, 0.6, 0)
        cv2.imwrite(os.path.join(output_dir, patient_id + "_pred.jpg"), out)
