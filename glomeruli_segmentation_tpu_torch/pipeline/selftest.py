"""Real-artifact acceptance harness (``gseg-selftest``).

The public mirror of the reference repository strips the binary artifacts
the reference pipeline actually runs on: the downloadable
``frozen_inference_graph.pb`` (``example/README.md:20-24``) and the sample
Hamamatsu ``.ndpi`` slides (``example/README.md:27-38``,
``.MISSING_LARGE_BLOBS``).  Every reader and importer in this framework is
therefore validated against synthetic fixtures; the residual risk is that
a *scanner-written* NDPI or the *published* frozen graph holds a surprise.
This harness closes that gap the moment the artifacts are available:

    GSEG_REAL_NDPI=/data/PAS-001.ndpi GSEG_REAL_PB=/models/frozen.pb \
        gseg-selftest --out verdict.json

Checks (each skipped gracefully when its artifact is absent):

- **reader acceptance**: open the slide with BOTH readers (C++
  ``NativeSlide`` and the pure-python ``Slide``), compare the openslide
  property surface, level geometry, and decoded pixels for a deterministic
  set of regions across every level — the two readers are bit-identical
  twins by contract (tests/test_native_reader.py), so any divergence or
  decode failure on a real file is a finding;
- **frozen-graph acceptance**: import the ``.pb`` through
  ``convert/pb_import.py`` (pure-python protobuf walk -> OD-API param
  assembly), run one detection window through
  :class:`..pipeline.detect.ODAPIDetectorBackend` on ``device`` (on the
  card its two NMS stages launch the NMS kernel, K3, once each), and
  sanity-check the output contract (normalized boxes, scores in [0, 1]).
  The window comes from the real slide when one is given, else synthetic
  tissue.

The verdict JSON records every comparison plus sha256 digests of the
decoded regions so later runs (e.g. after a reader change) can diff
byte-exactly.  Exit status: 0 = all present checks passed (or nothing to
check), 2 = a check failed.

The port's counterpart of ``glomeruli_segmentation_tpu/pipeline/
selftest.py``, on the port's own modules: its slide readers
(``wsi.open_slide``, ``wsi.native_reader.NativeSlide``), ``convert/
pb_import``, the torch ``ODAPIDetectorBackend``, ``BoxMerger``,
``_CollectingDetector`` and the annotation handlers.  The detector runs on
``device`` (the card unless the caller passes ``device="cpu"``).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import traceback
from typing import Optional

import numpy as np


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def check_ndpi(path: str, region: int = 512) -> dict:
    """Open with both readers; compare properties, geometry and pixels."""
    from ..wsi.tiff_reader import Slide

    result: dict = {"path": path, "ok": False}
    t0 = time.perf_counter()
    py = Slide(path)
    result["open_python_s"] = round(time.perf_counter() - t0, 3)
    result["dimensions"] = list(py.dimensions)
    result["level_count"] = py.level_count
    result["level_dimensions"] = [list(d) for d in py.level_dimensions]
    result["properties"] = dict(py.properties)

    native = None
    try:
        from ..wsi.native_reader import NativeSlide

        t0 = time.perf_counter()
        native = NativeSlide(path)
        result["open_native_s"] = round(time.perf_counter() - t0, 3)
    except (ImportError, OSError) as e:
        result["native_reader"] = f"unavailable ({e}); python-only checks"

    if native is not None:
        mismatches = []
        if tuple(native.dimensions) != tuple(py.dimensions):
            mismatches.append("dimensions")
        if native.level_count != py.level_count:
            mismatches.append("level_count")
        for key, val in py.properties.items():
            if str(native.properties.get(key)) != str(val):
                mismatches.append(f"property:{key}")
        result["property_mismatches"] = mismatches

    # deterministic region set: corners + center of every level, plus a
    # tile-straddling offset (tile seams are where real scanner files
    # surprise parsers)
    regions = []
    decode_errors = []
    pixel_mismatches = []
    for level, (lw, lh) in enumerate(py.level_dimensions):
        ds = py.level_downsamples[level]
        w = min(region, lw)
        h = min(region, lh)
        spots = [(0, 0), (max(0, lw - w), max(0, lh - h)),
                 ((lw - w) // 2, (lh - h) // 2),
                 (min(lw - w, 173), min(lh - h, 201))]
        for lx, ly in spots:
            loc0 = (int(lx * ds), int(ly * ds))  # level-0 coords
            entry = {"level": level, "location": list(loc0),
                     "size": [w, h]}
            try:
                a = np.asarray(py.read_region_array(loc0, level, (w, h)))
                entry["sha256"] = _sha(a)
                entry["mean"] = round(float(a.mean()), 3)
            except Exception as e:
                decode_errors.append(dict(entry, reader="python",
                                          error=repr(e)))
                continue
            if native is not None:
                try:
                    b = np.asarray(native.read_region_array(loc0, level,
                                                            (w, h)))
                except Exception as e:
                    decode_errors.append(dict(entry, reader="native",
                                              error=repr(e)))
                    continue
                if not np.array_equal(a, b):
                    entry["native_sha256"] = _sha(b)
                    pixel_mismatches.append(entry)
            regions.append(entry)
    result["regions"] = regions
    result["decode_errors"] = decode_errors
    result["pixel_mismatches"] = pixel_mismatches
    result["ok"] = (not decode_errors and not pixel_mismatches
                    and not result.get("property_mismatches", []))
    py.close()
    if native is not None:
        native.close()
    return result


def _leaves(tree):
    """The arrays of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    else:
        yield tree


def check_pb(path: str, slide_path: Optional[str] = None,
             window: int = 1024, device="cuda") -> dict:
    """Import the frozen graph and run one detection window through it."""
    from ..convert.pb_import import load_frozen_graph_constants
    from ..pipeline.detect import ODAPIDetectorBackend

    result: dict = {"path": path, "ok": False}
    t0 = time.perf_counter()
    consts = load_frozen_graph_constants(path)
    result["graph_constants"] = len(consts)
    result["parse_s"] = round(time.perf_counter() - t0, 3)
    backend = ODAPIDetectorBackend(consts=consts, batch_size=1,
                                   device=device)
    result["num_classes"] = backend.num_classes
    result["assembled_params"] = sum(
        int(np.prod(p.shape)) for p in _leaves(backend.params))

    if slide_path:
        from ..wsi import open_slide

        with open_slide(slide_path) as slide:
            level = slide.get_best_level_for_downsample(8)
            lw, lh = slide.level_dimensions[level]
            ds = slide.level_downsamples[level]
            lx, ly = (lw - window) // 2, (lh - window) // 2
            img = np.asarray(slide.read_region_array(
                (int(lx * ds), int(ly * ds)), level, (window, window)))
        result["window_source"] = "slide-center"
    else:
        from ..wsi.synthetic import pas_like_image

        img, _ = pas_like_image(window, window, seed=0, n_glomeruli=3)
        result["window_source"] = "synthetic"

    t0 = time.perf_counter()
    boxes, scores, classes, num = backend.detect_batch(img[None])
    result["detect_s"] = round(time.perf_counter() - t0, 3)
    contract = []
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        contract.append(f"boxes shape {boxes.shape}")
    if not np.all(np.isfinite(scores)):
        contract.append("non-finite scores")
    elif scores.size and (scores.min() < -1e-5 or scores.max() > 1 + 1e-5):
        contract.append(f"scores outside [0,1]: {scores.min()}.."
                        f"{scores.max()}")
    if np.all(boxes == 0) and np.all(scores == 0):
        contract.append("all-zero output (dead graph?)")
    result["contract_violations"] = contract
    order = np.argsort(-scores[0])[:5]
    result["top_detections"] = [
        {"score": round(float(scores[0][i]), 4),
         "class": int(classes[0][i]),
         "box_norm": [round(float(v), 4) for v in boxes[0][i]]}
        for i in order]
    result["ok"] = not contract
    return result


# the reference repository's example data (``example/data/02_PAS/PAS-001/
# annotations``), relative to the working directory: run from the root of
# a checkout of the reference, or pass ``data_dir``
REAL_GT_DATA_DIR = os.path.join("example", "data")


def check_real_gt_recall(slide_path: str, pb_path: Optional[str] = None,
                         data_dir: str = REAL_GT_DATA_DIR,
                         staining: str = "OPT_PAS",
                         patient: str = "PAS-001",
                         window_um: int = 2000,
                         overlap_ratio: float = 0.1,
                         detect_conf: float = 0.2,
                         merge_conf: float = 0.9,
                         merge_overlap: float = 0.35,
                         iou_threshold: float = 0.01,
                         device="cuda") -> dict:
    """Full detect->merge chain on the real slide, scored against the real
    hand-annotated GT XML (the one piece of real data the mirror ships:
    ``example/data/02_PAS/PAS-001/annotations/OPT_PAS_PAS-001_pw40_ds8.xml``,
    28 glomerulus boxes).

    Recall semantics follow ``make_seg_data.py:107-111,184-204``: a GT box
    counts as hit when at least one merged detection overlaps it with
    rectangle IoU >= ``iou_threshold`` (default 0.01, the reference CLI
    default); GT boxes are annotated at ds-8 and scale x8 to level 0
    (``make_seg_data.py:166``).  Operating point defaults are the
    example's (``example/README.md:34-49``): 2000 um windows, overlap
    0.1, detect conf 0.2; merge conf 0.9, overlap 0.35.

    Needs the published frozen graph for meaningful numbers — without
    ``pb_path`` the check is skipped (a randomly initialized detector
    scores noise, not parity)."""
    import glob
    import re

    from ..utils.annotation import (ANNOTATION_FILE_PATTERN,
                                    AnnotationHandler, rect_iou)
    from ..utils.glomus_handler import GlomusHandler

    result: dict = {"slide": slide_path, "ok": False}
    ann_dir = os.path.join(data_dir, GlomusHandler.get_staining_type(staining),
                           patient, "annotations")
    pattern = re.compile(ANNOTATION_FILE_PATTERN, re.IGNORECASE)
    xmls = [f for f in sorted(glob.glob(os.path.join(ann_dir, "*.xml")))
            if os.path.basename(f).startswith(staining)
            and pattern.findall(os.path.splitext(os.path.basename(f))[0])]
    if not xmls:
        return {"skipped": f"no {staining} GT XML under {ann_dir}"}
    xml_path = xmls[0]
    body = os.path.splitext(os.path.basename(xml_path))[0]
    times = int(pattern.findall(body)[0][2])  # ds group -> level-0 scale
    handler = AnnotationHandler.__new__(AnnotationHandler)
    handler.gt_list, handler.gt_name_list = [], []
    handler.read_annotation(os.path.dirname(xml_path),
                            os.path.basename(xml_path))
    gt_boxes = [[v * times for v in gt] for gt, name
                in zip(handler.gt_list, handler.gt_name_list)
                if name in ("glomerulus", "glomerulus-kana")]
    result["gt_xml"] = xml_path
    result["gt_boxes"] = len(gt_boxes)

    if not pb_path:
        return {"skipped": "recall needs the published frozen graph "
                           "(--pb / GSEG_REAL_PB); random weights would "
                           "score noise", "gt_xml": xml_path,
                "gt_boxes": len(gt_boxes)}

    # the GT is for one specific slide: only score a slide whose level-0
    # geometry matches the annotated canvas (size x ds) — scoring an
    # unrelated slide against PAS-001's boxes would report a meaningless
    # failure
    import xml.etree.ElementTree as ElementTree

    size = ElementTree.parse(xml_path).find("size")
    want = (int(size.find("width").text) * times,
            int(size.find("height").text) * times)
    from .. import wsi as _wsi

    with _wsi.open_slide(slide_path) as slide:
        have = tuple(slide.dimensions)
    if any(abs(h - w) > 0.01 * w for h, w in zip(have, want)):
        return {"skipped": f"slide geometry {have} does not match the GT "
                           f"canvas {want} (annotated size x ds{times}) — "
                           "not the annotated slide",
                "gt_xml": xml_path, "gt_boxes": len(gt_boxes),
                "slide_dimensions": list(have)}

    import tempfile

    from .. import wsi as _wsi
    from ..convert.pb_import import load_frozen_graph_constants
    from ..pipeline.detect import ODAPIDetectorBackend
    from ..pipeline.merge import BoxMerger
    from .e2e import _CollectingDetector

    t0 = time.perf_counter()
    backend = ODAPIDetectorBackend(
        consts=load_frozen_graph_constants(pb_path), batch_size=4,
        device=device)
    with _wsi.open_slide(slide_path) as slide:
        mpp_x = float(slide.properties[_wsi.PROPERTY_NAME_MPP_X])
        mpp_y = float(slide.properties[_wsi.PROPERTY_NAME_MPP_Y])
        det = _CollectingDetector(
            staining, target_list="",
            data_dir=os.path.dirname(slide_path),
            output_dir=tempfile.mkdtemp(prefix="gseg_selftest_"),
            output_file_ext="_selftest", window_size=window_um,
            overlap_ratio=overlap_ratio, conf_threshold=detect_conf,
            batch_size=backend.batch_size)
        det.org_slide_width, det.org_slide_height = slide.dimensions
        det.mpp_x, det.mpp_y = mpp_x, mpp_y
        det.org_slide_objective_power = int(float(
            slide.properties[_wsi.PROPERTY_NAME_OBJECTIVE_POWER]))
        det.scan_region(backend, slide, "", patient,
                        os.path.basename(slide_path), output_file=None)
        detections = det.collected
    candidates = []
    for x1, y1, x2, y2, conf in detections:
        if conf >= merge_conf:
            candidates.append([x1, y1, x2, y2, conf,
                               (x2 - x1) * (y2 - y1), 0.0])
    merged = BoxMerger(merge_overlap).merge_all(candidates, mpp_x, mpp_y)
    result["detect_merge_s"] = round(time.perf_counter() - t0, 3)
    result["raw_detections"] = len(detections)
    result["merged_detections"] = len(merged)

    hits = 0
    max_ious = []
    matched_det = set()
    for gt in gt_boxes:
        best = 0.0
        for ind, det in enumerate(merged):
            iou = rect_iou(gt, det)
            if iou >= iou_threshold:
                matched_det.add(ind)
            best = max(best, iou)
        max_ious.append(round(best, 4))
        if best >= iou_threshold:
            hits += 1
    recall = hits / len(gt_boxes) if gt_boxes else 0.0
    precision = (len(matched_det) / len(merged)) if merged else 0.0
    result.update({
        "recall_hit_num": hits,
        "recall": round(recall, 4),
        "precision": round(precision, 4),
        "gt_max_iou": max_ious,
        "iou_threshold": iou_threshold,
        "operating_point": {
            "window_um": window_um, "overlap_ratio": overlap_ratio,
            "detect_conf": detect_conf, "merge_conf": merge_conf,
            "merge_overlap": merge_overlap},
        # the published pipeline is a research-grade detector; anything
        # under half the GT found means an import/geometry fault, not
        # model noise
        "ok": recall >= 0.5,
    })
    return result


def run_selftest(ndpi: Optional[str] = None, pb: Optional[str] = None,
                 out: Optional[str] = None, device="cuda") -> dict:
    verdict: dict = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    ran = []
    # hand the slide to the pb check only when it actually exists — a
    # missing --ndpi must degrade the pb check to its synthetic-window
    # fallback, not fail it
    ndpi_ok = bool(ndpi) and os.path.isfile(ndpi)
    for key, path, fn, kwargs in (
            ("ndpi", ndpi, check_ndpi, {}),
            ("pb", pb, check_pb,
             {"slide_path": ndpi if ndpi_ok else None, "device": device})):
        if not path:
            verdict[key] = {"skipped": "no artifact given "
                            f"(--{key} / GSEG_REAL_{key.upper()})"}
            continue
        if not os.path.isfile(path):
            verdict[key] = {"skipped": f"not a file: {path}"}
            continue
        try:
            verdict[key] = fn(path, **kwargs)
        except Exception as e:
            verdict[key] = {"path": path, "ok": False, "error": repr(e),
                            "traceback": traceback.format_exc()}
        ran.append(key)
    # full-chain recall vs the real GT XML (VERDICT r4: stop at decode
    # checks no longer — score detect->merge against the 28 real boxes)
    if ndpi_ok:
        try:
            rec = check_real_gt_recall(
                ndpi, pb_path=pb if (pb and os.path.isfile(pb)) else None,
                device=device)
        except Exception as e:
            rec = {"ok": False, "error": repr(e),
                   "traceback": traceback.format_exc()}
        verdict["recall_vs_real_gt"] = rec
        if "skipped" not in rec:
            ran.append("recall_vs_real_gt")
    verdict["checks_run"] = ran
    verdict["ok"] = all(verdict[k].get("ok") for k in ran) if ran else True
    if out:
        with open(out, "w") as f:
            json.dump(verdict, f, indent=2)
    return verdict
