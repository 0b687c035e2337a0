"""Sliding-window glomerulus detection over a slide, on the GPU.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/detect.py``: choose
the pyramid level with objective/downsample <= 5x, slide a ``STD_SIZE``-
micrometre window with ``OVERLAP_RATIO``, detect in batches of windows, and
write CSV rows in level-0 pixel coordinates.  :class:`TorchDetectorBackend`
is the counterpart of ``JaxDetectorBackend``: the ResNet-50-C4 Faster R-CNN
(:mod:`..models.faster_rcnn`), one model view and anchor set per window
geometry, results packed on the device and read back once per batch.
:class:`ODAPIDetectorBackend` runs the reference's own detector, the OD-API
frozen graph (:mod:`..models.od_api_frcnn`), the same way.

:meth:`GlomusDetector.split_all` is the ``gseg-detect`` loop: per target
list entry it finds the slide (or PNG) in ``<data_dir>/<staining dir>/
<specimen>/``, scans it and appends the CSV rows and a ``file,time``
timing-log row; with ``resume`` it skips the slides the timing log already
holds and appends.  A PNG is scanned at its own pixels with the slide
metadata of its target-list line (:meth:`GlomusDetector.
scan_region_from_image`).  :meth:`GlomusDetector.scan_slide` scans one open
slide; the end-to-end pipeline calls it directly.  The data-parallel
window mesh is not ported.
"""
from __future__ import annotations

import datetime
import math
import os
import queue
import threading
import time
from typing import Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import read_host, readback, resolve_device, tf32
from ..convert.pb_import import (assemble_od_api_params,
                                 load_od_api_detector_params)
from ..models.faster_rcnn import FasterRCNN, FasterRCNNConfig, build_anchors
from ..models.od_api_frcnn import (ODAPIConfig, ODAPIFasterRCNN,
                                   keep_aspect_resize_shape)
from ..models.od_api_frcnn import build_anchors as build_od_api_anchors
from ..ops.resize import (resize_bilinear, resize_bilinear_tf1,
                          resize_bilinear_tf1_np)
from ..utils.glomus_handler import GlomusHandler
from ..utils.target_list import read_target_list
from ..wsi import (PROPERTY_NAME_MPP_X, PROPERTY_NAME_MPP_Y,
                   PROPERTY_NAME_OBJECTIVE_POWER, open_slide)

NDPI_EXT = [".ndpi", ".tiff", ".tif", ".svs"]
PNG_EXT = [".PNG", ".png"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DetectorBackend:
    """Protocol: batched window detection.

    ``detect_batch(images)`` takes (B, H, W, 3) uint8 RGB windows and
    returns numpy ``(boxes, scores, classes, num)`` with boxes normalized
    ``[ymin, xmin, ymax, xmax]`` sorted by descending score per window (the
    frozen-graph output contract).

    Device backends may also implement the async pair
    ``detect_batch_submit(images) -> handle`` / ``read_detections(handle)``
    so the scan loop launches batch N+1 before it reads batch N.
    """

    batch_size: int = 8

    def detect_batch(self, images: np.ndarray):
        raise NotImplementedError

    detect_batch_submit = None  # async pair unsupported by default

    def read_detections(self, handle):
        raise NotImplementedError


def pack_detections(out: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The four detection outputs as one (B, 6M + 1) float32 tensor on their
    device, so a batch is read back with one copy."""
    b = out["detection_boxes"]  # (B, M, 4)
    n = b.shape[0]
    return torch.cat([b.reshape(n, -1),
                      out["detection_scores"].float(),
                      out["detection_classes"].float(),
                      out["num_detections"].reshape(n, 1).float()], dim=1)


def unpack_detections(packed: np.ndarray):
    m = (packed.shape[1] - 1) // 6
    n = packed.shape[0]
    return (packed[:, : m * 4].reshape(n, m, 4),
            packed[:, m * 4: m * 5],
            packed[:, m * 5: m * 6],
            packed[:, -1])


class _PackedBackend(DetectorBackend):
    """A device backend whose ``detect_batch_submit`` returns a
    :func:`..readback` handle on the packed result of
    :func:`pack_detections`, read back with one copy.

    The forward runs with the TF32 switches it has when nothing else sets
    them (torch's defaults): cuDNN TF32 on, matmul TF32 off.  It sets them
    itself under the port's TF32 lock, so a segmenter dispatching from
    another thread with other settings cannot change its detections."""

    CUDNN_TF32, MATMUL_TF32 = True, False

    def _launch(self, model, x: torch.Tensor, anchors: torch.Tensor):
        with tf32(self.CUDNN_TF32, self.MATMUL_TF32):
            out = pack_detections(model.detect(x, anchors))
        return readback(out)

    def read_detections(self, handle):
        return unpack_detections(read_host(handle))

    def detect_batch(self, images: np.ndarray):
        return self.read_detections(self.detect_batch_submit(images))


class TorchDetectorBackend(_PackedBackend):
    """Faster R-CNN backend on ``device`` (CUDA unless the caller passes
    ``device="cpu"``).

    ``state`` is the port's detector state (``convert/detector_import``).
    Weights are held once in ``compute_dtype``; each window geometry gets a
    model view and its anchors, made at first use.  ``kernel_nms=False``
    runs the plain NMS instead of the K3 kernel (for comparisons).
    """

    def __init__(self, state: Mapping[str, torch.Tensor],
                 config: Optional[FasterRCNNConfig] = None,
                 batch_size: int = 8, compute_dtype: str = "bfloat16",
                 device="cuda", kernel_nms: bool = True):
        self.base_config = config or FasterRCNNConfig()
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.model = FasterRCNN(self.base_config, kernel_nms=kernel_nms) \
            .load_state(state).to(self.device, _DTYPES[compute_dtype]).eval()
        self._geometry = {}

    def _model_for(self, h: int, w: int):
        key = (h, w)
        if key not in self._geometry:
            model = self.model.with_image_size(h, w)
            anchors = build_anchors(model.config).to(self.device)
            self._geometry[key] = (model, anchors)
        return self._geometry[key]

    @torch.inference_mode()
    def detect_batch_submit(self, images: np.ndarray):
        """Upload and launch; returns the packed result's readback handle.
        On a card the windows go through pinned memory without waiting for
        the device, so the host can stage the next batch meanwhile."""
        model, anchors = self._model_for(images.shape[1], images.shape[2])
        x = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            x = x.pin_memory()
        x = x.to(self.device, non_blocking=True)
        return self._launch(model, x, anchors)


class ODAPIDetectorBackend(_PackedBackend):
    """The reference's OD-API frozen graph (``frozen_inference_graph.pb``)
    on ``device`` (CUDA unless the caller passes ``device="cpu"``): its
    constants assembled into :class:`..models.od_api_frcnn.ODAPIFasterRCNN`
    (inception_v2, BN folded), one model view and anchor set per window
    geometry.  Counterpart of the JAX package's ``ODAPIDetectorBackend``.

    Weights come from ``pb_path``, or ``consts`` (an extracted constant
    dict), or ``params`` (an assembled tree, with ``num_classes``).  A
    window is first resized to the graph's ``keep_aspect_ratio_resizer``
    shape (:func:`..models.od_api_frcnn.keep_aspect_resize_shape`):

    - by default on the host, with TF1 sampling (:func:`..ops.resize.
      resize_bilinear_tf1_np`), the float result cast to the compute type
      before the upload (in torch: numpy has no bfloat16);
    - ``compat_tf1_resize=False``: cv2 half-pixel bilinear on the host.
      cv2 is imported on first use, so this raises where cv2 is missing;
    - ``device_resize=True``: after the upload, on the device
      (:func:`..ops.resize.resize_bilinear_tf1` or ``resize_bilinear``).

    Normalized output boxes are aspect-preserving, so they map back to the
    window unchanged.  ``kernel_nms`` and the async pair are as in
    :class:`TorchDetectorBackend`; ``config_overrides`` are
    :class:`..models.od_api_frcnn.ODAPIConfig` fields.
    """

    def __init__(self, pb_path: Optional[str] = None, batch_size: int = 8,
                 compute_dtype: str = "bfloat16", consts=None, params=None,
                 num_classes: Optional[int] = None,
                 device_resize: bool = False, compat_tf1_resize: bool = True,
                 device="cuda", kernel_nms: bool = True,
                 **config_overrides):
        if params is not None:
            if num_classes is None:
                raise ValueError("params requires num_classes")
            self.params, self.num_classes = params, num_classes
        elif consts is not None:
            self.params, self.num_classes = assemble_od_api_params(consts)
        else:
            self.params, self.num_classes = load_od_api_detector_params(
                pb_path)
        self.batch_size = batch_size
        self.compute_dtype = compute_dtype
        self.device_resize = device_resize
        self.compat_tf1_resize = compat_tf1_resize
        self.device = resolve_device(device)
        self.base_config = ODAPIConfig(num_classes=self.num_classes,
                                       **config_overrides)
        self.model = ODAPIFasterRCNN(
            self.params, self.base_config, compute_dtype, kernel_nms) \
            .to(self.device, memory_format=torch.channels_last).eval()
        self._geometry = {}

    def _model_for(self, h: int, w: int):
        """-> (resized shape, model view, anchors) of an h x w window."""
        key = (h, w)
        if key not in self._geometry:
            cfg = self.base_config
            rh, rw = keep_aspect_resize_shape(h, w, cfg.min_dimension,
                                              cfg.max_dimension)
            model = self.model.with_image_size(rh, rw)
            anchors = build_od_api_anchors(model.config).to(self.device)
            self._geometry[key] = ((rh, rw), model, anchors)
        return self._geometry[key]

    def resize_host(self, images: np.ndarray, rh: int, rw: int
                    ) -> torch.Tensor:
        """The host resize of a window batch -> a CPU tensor to upload."""
        if self.compat_tf1_resize:
            resized = np.stack([resize_bilinear_tf1_np(im, rh, rw)
                                for im in images])
            return torch.from_numpy(resized).to(_DTYPES[self.compute_dtype])
        import cv2

        return torch.from_numpy(np.stack([
            cv2.resize(im, (rw, rh), interpolation=cv2.INTER_LINEAR)
            for im in images]))

    @torch.inference_mode()
    def detect_batch_submit(self, images: np.ndarray):
        """Resize (on the host by default), upload through pinned memory
        without waiting for the device, launch; returns the packed result's
        readback handle."""
        h, w = images.shape[1:3]
        (rh, rw), model, anchors = self._model_for(h, w)
        resize = (rh, rw) != (h, w)
        if resize and not self.device_resize:
            x = self.resize_host(images, rh, rw)
        else:
            x = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            x = x.pin_memory()
        x = x.to(self.device, non_blocking=True)
        if resize and self.device_resize:
            op = (resize_bilinear_tf1 if self.compat_tf1_resize
                  else resize_bilinear)
            x = op(x, rh, rw)
        return self._launch(model, x, anchors)


def threshold_boxes(boxes: np.ndarray, scores: np.ndarray, window_x: int,
                    window_y: int, thresh: float) -> List[List]:
    """Normalized boxes -> thresholded window-pixel boxes (scores are sorted
    descending)."""
    count = int(np.sum(scores >= thresh))
    out = []
    for i in range(count):
        ymin, xmin, ymax, xmax = boxes[i]
        out.append([int(window_x * xmin), int(window_y * ymin),
                    int(window_x * xmax), int(window_y * ymax),
                    float(scores[i])])
    return out


class GlomusDetector(GlomusHandler):
    """Whole-slide sliding-window detection runner."""

    def __init__(self, data_category: str, target_list: str, data_dir: str,
                 output_dir: str, output_file_ext: str,
                 window_size: Optional[int], overlap_ratio: Optional[float],
                 conf_threshold: float, batch_size: int = 8,
                 resume: bool = False):
        self.data_category = data_category
        self.set_type(data_category)
        if window_size is None or window_size == "":
            self.STD_SIZE = 500
            self.OVERLAP_RATIO = 0.5
        else:
            self.STD_SIZE = window_size
            self.OVERLAP_RATIO = overlap_ratio
        self.CONF_THRESH = conf_threshold
        self.batch_size = batch_size
        self.staining_dir = GlomusHandler.get_staining_type(data_category)
        self.target_list = target_list
        self.data_dir = data_dir
        self.output_root_dir = output_dir
        os.makedirs(self.output_root_dir, exist_ok=True)
        self.output_file_path = os.path.join(
            self.output_root_dir, self.TYPE + output_file_ext + ".csv")
        self.log_file = os.path.join(
            self.output_root_dir, self.TYPE + output_file_ext + "_log.csv")
        # with resume, the slides the timing log holds are skipped and the
        # outputs appended to
        self.resume = resume
        self._completed = set()
        if resume and os.path.isfile(self.log_file):
            with open(self.log_file) as f:
                for line in f.readlines()[1:]:
                    name = line.split(",")[0].strip().strip('"')
                    if name:
                        self._completed.add(name)
        # per-slide metadata
        self.org_slide_width = 0
        self.org_slide_height = 0
        self.org_slide_objective_power = 0.0
        self.slide_downsample = 0.0
        self.mpp_x = 0.0
        self.mpp_y = 0.0

    # ---------------- geometry ----------------
    def calc_window_size(self):
        """µm window -> px sizes + grid counts."""
        window_x_org = float(self.STD_SIZE) / self.mpp_x
        window_y_org = float(self.STD_SIZE) / self.mpp_y
        x_split_times = int(math.ceil(
            self.org_slide_width / window_x_org / (1.0 - self.OVERLAP_RATIO)))
        y_split_times = int(math.ceil(
            self.org_slide_height / window_y_org / (1.0 - self.OVERLAP_RATIO)))
        window_x = int(math.ceil(window_x_org / self.slide_downsample))
        window_y = int(math.ceil(window_y_org / self.slide_downsample))
        return (window_x_org, window_y_org, x_split_times, y_split_times,
                window_x, window_y)

    # ---------------- main loops ----------------
    def split_all(self, backend: DetectorBackend):
        """Scan every slide of the target list; write the detection CSV and
        the ``file,time`` timing log (opened ``w``, or ``a`` when resuming
        over a log that holds slides)."""
        site_name = self.data_dir.split("/")[-2] if "/" in self.data_dir else ""
        mode = "a" if (self.resume and self._completed) else "w"
        with open(self.output_file_path, mode) as output_file, \
                open(self.log_file, mode) as log_file:
            if mode == "w":
                log_file.write("file,time\n")
            for entry in read_target_list(self.target_list):
                if entry.is_comment:
                    continue
                if entry.file_name in self._completed:
                    print(f"skip {entry.file_name} (already processed)")
                    continue
                meta = entry.metadata
                self.org_slide_width = meta.org_slide_width
                self.org_slide_height = meta.org_slide_height
                self.org_slide_objective_power = meta.org_slide_objective_power
                self.slide_downsample = meta.slide_downsample
                self.mpp_x = meta.mpp_x
                self.mpp_y = meta.mpp_y

                target_dir = os.path.join(self.data_dir, self.staining_dir,
                                          entry.specimen_id)
                if not os.path.isdir(target_dir):
                    continue
                for candidate in sorted(os.listdir(target_dir)):
                    body, ext = os.path.splitext(candidate)
                    if entry.file_name.find(body) >= 0 and ext in NDPI_EXT:
                        image_type = "ndpi"
                    elif entry.file_name.find(body) >= 0 and ext in PNG_EXT:
                        image_type = "png"
                    else:
                        continue
                    start_time = time.time()
                    self.split(backend, image_type, site_name,
                               entry.specimen_id, candidate, output_file)
                    log_file.write('"{}",{}\n'.format(
                        entry.file_name, time.time() - start_time))
                    log_file.flush()
                    break

    def split(self, backend, image_type, site_name, patient_id, file_name,
              output_file):
        """Scan one file: a PNG through PIL (imported here) with the target
        list's metadata, a slide through :func:`..wsi.open_slide`."""
        path = os.path.join(self.data_dir, self.staining_dir, patient_id,
                            file_name)
        if image_type == "png":
            from PIL import Image

            with Image.open(path) as img:
                self.scan_region_from_image(backend, img, site_name,
                                            patient_id, file_name,
                                            output_file)
        else:
            with open_slide(path) as slide:
                self.scan_slide(backend, slide, site_name, patient_id,
                                file_name, output_file)

    def scan_slide(self, backend, slide, site_name, specimen_id, file_name,
                   output_file):
        """Read the slide's size, mpp and objective power, then
        :meth:`scan_region` (the slide branch of :meth:`split`, given an
        open slide)."""
        self.org_slide_width, self.org_slide_height = slide.dimensions
        self.mpp_x = float(slide.properties[PROPERTY_NAME_MPP_X])
        self.mpp_y = float(slide.properties[PROPERTY_NAME_MPP_Y])
        self.org_slide_objective_power = int(float(
            slide.properties[PROPERTY_NAME_OBJECTIVE_POWER]))
        self.scan_region(backend, slide, site_name, specimen_id, file_name,
                         output_file)

    def _iter_batches(self, windows: Iterator[Tuple[int, int, np.ndarray]]):
        """Group (i, j, image) windows into batches of ``batch_size``, with
        the window reads on a producer thread so they overlap the device."""
        q: "queue.Queue" = queue.Queue(maxsize=2 * self.batch_size)
        sentinel = object()

        def producer():
            # a read failure reaches the consumer instead of truncating the
            # scan silently
            try:
                for item in windows:
                    q.put(item)
                q.put(sentinel)
            except BaseException as e:  # re-raised in the consumer loop
                q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        buf = []
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            buf.append(item)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf:
            yield buf
        thread.join()

    def _run_windows(self, backend, windows, window_x, window_y, scale,
                     offset_fn, output_file, site_name, specimen_id,
                     file_name):
        def emit(batch, results):
            boxes, scores, classes, num = results
            for (i, j, _), b, s in zip(batch, boxes, scores):
                bs = threshold_boxes(b, s, window_x, window_y,
                                     self.CONF_THRESH)
                x_start, y_start = offset_fn(i, j)
                self.write_detected_result(bs, i, j, x_start, y_start,
                                           output_file, site_name,
                                           specimen_id, file_name, scale)

        submit = getattr(backend, "detect_batch_submit", None)
        pending = None  # one batch deep: launch N+1, then read N
        for batch in self._iter_batches(windows):
            images = np.stack([im for _, _, im in batch])
            if len(batch) < self.batch_size:
                pad = np.repeat(images[-1:], self.batch_size - len(batch), 0)
                images = np.concatenate([images, pad])
            if submit is None:
                emit(batch, backend.detect_batch(images))
                continue
            handle = submit(images)
            if pending is not None:
                emit(pending[0], backend.read_detections(pending[1]))
            pending = (batch, handle)
        if pending is not None:
            emit(pending[0], backend.read_detections(pending[1]))

    def scan_region(self, backend, slide, site_name, specimen_id, file_name,
                    output_file):
        """``slide``: anything with ``level_count``, ``level_downsamples`` and
        ``read_region_array(location, level, size)`` (RGB uint8)."""
        # level with objective/downsample <= 5x
        self.slide_downsample = 8.0
        target_level = min(3, slide.level_count - 1)
        for level, downsample in enumerate(slide.level_downsamples):
            if self.org_slide_objective_power / downsample <= 5.0:
                target_level = level
                self.slide_downsample = slide.level_downsamples[level]
                break
        (window_x_org, window_y_org, x_split, y_split, window_x,
         window_y) = self.calc_window_size()
        slide_window_x = int(window_x_org * (1.0 - self.OVERLAP_RATIO))
        slide_window_y = int(window_y_org * (1.0 - self.OVERLAP_RATIO))

        def windows():
            for j in range(y_split):
                for i in range(x_split):
                    x_start = slide_window_x * i
                    y_start = slide_window_y * j
                    region = slide.read_region_array(
                        (x_start, y_start), target_level,
                        (window_x, window_y))
                    yield i, j, region

        def offset(i, j):
            return slide_window_x * i, slide_window_y * j

        self._run_windows(backend, windows(), window_x, window_y,
                          self.slide_downsample, offset, output_file,
                          site_name, specimen_id, file_name)

    def scan_region_from_image(self, backend, img, site_name, specimen_id,
                               file_name, output_file):
        """The PNG path: ``img`` (a PIL image) is the slide at
        ``slide_downsample``, and the window offsets are scaled to level 0
        when the rows are written."""
        (window_x_org, window_y_org, x_split, y_split, window_x,
         window_y) = self.calc_window_size()
        slide_window_x = int(window_x * (1.0 - self.OVERLAP_RATIO))
        slide_window_y = int(window_y * (1.0 - self.OVERLAP_RATIO))

        def windows():
            for j in range(y_split):
                for i in range(x_split):
                    x_start = slide_window_x * i
                    y_start = slide_window_y * j
                    region = img.crop((x_start, y_start, x_start + window_x,
                                       y_start + window_y))
                    arr = np.asarray(region.convert("RGB"))
                    yield i, j, arr

        def offset(i, j):
            return (slide_window_x * i * self.slide_downsample,
                    slide_window_y * j * self.slide_downsample)

        self._run_windows(backend, windows(), window_x, window_y,
                          self.slide_downsample, offset, output_file,
                          site_name, specimen_id, file_name)

    def write_detected_result(self, bs, i, j, x_start, y_start, output_file,
                              site_name, specimen_id, file_name, scale):
        if len(bs) == 0:
            print("X:{}, Y:{}".format(i, j))
            return
        for box in bs:
            if box[4] > 0:
                now = datetime.datetime.today().strftime("%Y-%m-%dT%H:%M:%S")
                output_file.write(
                    '"' + site_name + '","' + specimen_id + '","'
                    + file_name + '",new,' + now + ","
                    + str(x_start + box[0] * scale) + ","
                    + str(y_start + box[1] * scale) + ","
                    + str(x_start + box[2] * scale) + ","
                    + str(y_start + box[3] * scale) + ","
                    + str(box[4]) + "\n")
                output_file.flush()
