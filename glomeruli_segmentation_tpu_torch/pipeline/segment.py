"""Per-crop ESPNet segmentation stage (``gseg-segment``) on the GPU.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/segment.py``, the
equivalent of ``module/espnet/test/VisualizeResults_iou.py``: glomerular
crop PNGs -> class maps, colored overlays, pixel-count CSVs, labelme-style
polygon JSONs and (with ground truth) per-image and global IoU reports.
Crops are host-decoded, preprocessed (the exact cv2 path or the fused
device path) and batched to a fixed batch size.

Two engines, as in the JAX package: ``xla`` (its default) runs the plain
``nn.Module`` :class:`..models.espnet.ESPNet` (or ``ESPNetEncoder``);
``fused`` runs :class:`..models.espnet_fused.FusedESPNet`, whose q level-3
blocks go through the fused ESP block kernel (K1).  ``data_parallel``
splits each crop batch over a data mesh of that many devices
(:mod:`..parallel.mesh`; the ``xla`` engine only, as in the JAX package);
``pack_output`` packs the class-map readback 3 px/byte.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import List, Sequence

import numpy as np
import torch

from .. import read_host, readback, resolve_device, tf32
from ..convert.espnet_import import infer_architecture, load_espnet_state_dict
from ..eval.boundary import bound2line
from ..eval.iou_eval import IouEval
from ..models.espnet import ESPNet, ESPNetEncoder
from ..models.espnet_fused import FusedESPNet
from ..ops.preprocess import (
    maybe_pack,
    postprocess_nearest_host,
    preprocess_batch_device,
    preprocess_host,
    read_packed,
)
from ..ops.resize import resize_bilinear
from ..parallel.mesh import Replicas, make_mesh, upload, visible_devices
from ..palette import (
    ESPNET_PALETTE,
    PRED_LABEL_IDX,
    colorize,
    relabel_to_cityscapes,
)
from ..utils.labelme_io import img_arr_to_b64
from .fused import _DTYPES


@dataclasses.dataclass
class SegmenterConfig:
    weights: str
    classes: int = 5
    p: int = 2
    q: int = 8
    decoder: bool = True  # False -> ESPNet-C encoder (output 1/8, x8 upsample)
    in_width: int = 1024
    in_height: int = 512
    mean: Sequence[float] = (0.0, 0.0, 0.0)  # BGR
    std: Sequence[float] = (1.0, 1.0, 1.0)   # BGR
    batch_size: int = 8
    # "highest" and "high": float32 convolutions and matmuls in full
    # float32 (TF32 off), the parity mode.  The JAX package's "high" is
    # bf16x3 passes, close to float32; the card has no such mode, so it
    # runs as "highest".  "default": TF32 on for both.
    precision: str = "highest"
    device_preprocess: bool = False
    compute_dtype: str = "float32"
    # 'fused' runs the level-3 ESP blocks through K1 (inference only);
    # 'xla' is the plain nn.Module path
    engine: str = "xla"
    # split crop batches over an N-device mesh (0 = one device, -1 = all
    # devices); weights replicated on each
    data_parallel: int = 0
    # pack k class-map pixels per byte (base-`classes`) before the readback:
    # exact, 3x fewer device->host bytes at 5 classes
    pack_output: bool = False


class _Replica:
    """The segmenter's model on one device, with its mean and std there."""

    def __init__(self, sd, config: SegmenterConfig, device: torch.device,
                 dtype: torch.dtype):
        self.model = self.fused = None
        if config.engine == "fused":
            self.fused = FusedESPNet(sd, fuse_level3=True, dtype=dtype,
                                     device=device)
        else:
            cls = ESPNet if config.decoder else ESPNetEncoder
            self.model = cls(config.classes, config.p, config.q)
            self.model.load_state_dict(sd, strict=True)
            self.model.to(device, dtype).eval()
        self.mean_std = torch.tensor(
            np.stack([np.asarray(config.mean, np.float32),
                      np.asarray(config.std, np.float32)]), device=device)


class EspnetSegmenter:
    """Batched ESPNet crop segmentation on ``device`` (the card unless the
    caller passes ``device="cpu"``).  With ``config.data_parallel`` the
    batch splits over a data mesh of ``devices`` (default: the visible
    devices of ``device``'s type)."""

    def __init__(self, config: SegmenterConfig, device="cuda", devices=None):
        if config.engine not in ("xla", "fused"):
            raise ValueError(f"unknown engine {config.engine!r}")
        if config.precision not in ("default", "high", "highest"):
            raise ValueError(f"unknown precision {config.precision!r}")
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {config.compute_dtype!r}: "
                             f"one of {sorted(_DTYPES)}")
        self.config = config
        if not os.path.isfile(config.weights):
            raise SystemExit(
                f"Pre-trained model file does not exist: {config.weights}")
        sd = load_espnet_state_dict(config.weights)
        classes, p, q, has_decoder = infer_architecture(sd)
        if (classes, p, q) != (config.classes, config.p, config.q):
            raise ValueError(
                f"checkpoint architecture (classes={classes}, p={p}, q={q}) "
                f"does not match config ({config.classes}, {config.p}, {config.q})"
            )
        if config.decoder and not has_decoder:
            raise ValueError("decoder requested but checkpoint is encoder-only")
        if not config.decoder and has_decoder:
            sd = {k[len("encoder."):]: v for k, v in sd.items()
                  if k.startswith("encoder.")}
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        self.allow_tf32 = config.precision == "default"
        if config.data_parallel:
            if config.engine == "fused":
                # as in the JAX package: the sharded path runs the xla
                # engine
                raise ValueError(
                    "engine='fused' does not support data_parallel")
            n_dev = config.data_parallel
            mesh = make_mesh(None if n_dev < 0 else n_dev,
                             devices=(visible_devices(self.device)
                                      if devices is None else devices))
            d = mesh.shape["data"]
            if config.batch_size % d:
                raise ValueError(
                    f"batch_size {config.batch_size} must be a multiple of "
                    f"the data-axis size {d}")
            self._replicas = Replicas.build(
                mesh.axis_devices("data"),
                lambda dev: _Replica(sd, config, dev, self.dtype))
            self.device = self._replicas.devices[0]
        else:
            self._replicas = Replicas(
                [self.device], [_Replica(sd, config, self.device,
                                         self.dtype)], [None])
        first = self._replicas.replicas[0]
        self.model, self._fused = first.model, first.fused

    @torch.no_grad()
    def _forward(self, rep: _Replica, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) float32 -> (B, H, W) uint8 argmax class map
        (packed to (B, H, ceil(W/k)) with ``config.pack_output``)."""
        cfg = self.config
        with tf32(self.allow_tf32, self.allow_tf32):
            x = batch.to(self.dtype).permute(0, 3, 1, 2)
            if rep.fused is not None:
                logits = rep.fused(x)
            else:
                logits = rep.model(x.contiguous())
            if not cfg.decoder:
                # torch nn.Upsample(scale_factor=8, mode='bilinear'),
                # VisualizeResults_iou.py:125-126,258-261
                nhwc = logits.permute(0, 2, 3, 1)
                up = resize_bilinear(nhwc, nhwc.shape[1] * 8,
                                     nhwc.shape[2] * 8)
                maps = torch.argmax(up, dim=-1).to(torch.uint8)
            else:
                maps = torch.argmax(logits, dim=1).to(torch.uint8)
            return maybe_pack(maps, cfg.classes, cfg.pack_output)

    def _host_batch(self, images_bgr: List[np.ndarray]) -> tuple:
        """A crop batch as the host arrays the forward uploads: the padded
        uint8 crops and their sizes (``device_preprocess``), or the
        reference-exact cv2 preprocessing's float32 batch."""
        cfg = self.config
        if cfg.device_preprocess:
            max_h = max(im.shape[0] for im in images_bgr)
            max_w = max(im.shape[1] for im in images_bgr)
            padded = np.zeros((len(images_bgr), max_h, max_w, 3), np.uint8)
            hs = np.zeros(len(images_bgr), np.int32)
            ws = np.zeros(len(images_bgr), np.int32)
            for i, im in enumerate(images_bgr):
                padded[i, : im.shape[0], : im.shape[1]] = im
                hs[i], ws[i] = im.shape[:2]
            return padded, hs, ws
        return (np.stack([preprocess_host(im, cfg.mean, cfg.std,
                                          cfg.in_width, cfg.in_height)
                          for im in images_bgr]),)

    def _preprocessed(self, rep: _Replica, device: torch.device,
                      *arrays) -> torch.Tensor:
        """:meth:`_host_batch`'s arrays uploaded to ``device`` -> the
        (B, in_h, in_w, 3) float32 network input there."""
        cfg = self.config
        tensors = [upload(a, device) for a in arrays]
        if cfg.device_preprocess:
            return preprocess_batch_device(*tensors, rep.mean_std,
                                           cfg.in_height, cfg.in_width)
        return tensors[0]

    def preprocess(self, images_bgr: List[np.ndarray]) -> torch.Tensor:
        """Crops -> the network input on the (first) device."""
        return self._preprocessed(self._replicas.replicas[0], self.device,
                                  *self._host_batch(images_bgr))

    def segment_images(self, images_bgr: List[np.ndarray]) -> List[np.ndarray]:
        """BGR uint8 crops -> per-crop class maps at original crop size."""
        cfg = self.config
        results: List[np.ndarray] = []
        for start in range(0, len(images_bgr), cfg.batch_size):
            chunk = images_bgr[start: start + cfg.batch_size]
            maps = self.read_net_res(self.submit_net_res(chunk))
            for im, cmap in zip(chunk, maps):
                results.append(
                    postprocess_nearest_host(cmap, im.shape[0], im.shape[1]))
        return results

    def submit_net_res(self, images_bgr: List[np.ndarray]):
        """Submit ONE batch (<= batch_size crops): preprocess, upload and
        launch the forward, then enqueue the class maps' copy to the host
        (:func:`..readback`) and return at once, so the card computes while
        the host does other work.  Pair with :meth:`read_net_res`."""
        cfg = self.config
        n = len(images_bgr)
        if not 0 < n <= cfg.batch_size:
            raise ValueError(
                f"submit_net_res takes 1..batch_size ({cfg.batch_size}) "
                f"crops per call, got {n}")
        chunk = list(images_bgr)
        if n < cfg.batch_size:  # pad to the fixed batch shape
            chunk = chunk + [chunk[-1]] * (cfg.batch_size - n)

        def one(rep, dev, *arrays):
            return readback(self._forward(
                rep, self._preprocessed(rep, dev, *arrays)))

        return self._replicas.submit(one, *self._host_batch(chunk)), n

    def read_net_res(self, handle) -> np.ndarray:
        """A :meth:`submit_net_res` handle as (n, in_h, in_w) uint8 class
        maps (waits for that batch only; unpacked on the host with
        ``config.pack_output``)."""
        out, n = handle
        return read_packed(read_host(out), self.config.classes,
                           self.config.in_width, self.config.pack_output)[:n]

    def class_maps_net_res(self, images_bgr: List[np.ndarray]) -> np.ndarray:
        """Class maps at network resolution (in_height, in_width) — used for
        the confusion-matrix evaluation which the reference computes before
        the nearest-resize back (VisualizeResults_iou.py:202-203)."""
        cfg = self.config
        out = []
        for start in range(0, len(images_bgr), cfg.batch_size):
            chunk = images_bgr[start: start + cfg.batch_size]
            out.append(self.read_net_res(self.submit_net_res(chunk)))
        return np.concatenate(out, axis=0)


def build_labelme_doc(class_map: np.ndarray, json_image: np.ndarray,
                      name: str) -> dict:
    """labelme-style JSON document with polygon boundaries + b64 image
    (VisualizeResults_iou.py:161-182).  ``class_map`` must already be in
    the cityscapes relabeling when that is the output convention."""
    boundary_lines = bound2line(class_map, max_classes=4)
    shapes = []
    for idx, label in PRED_LABEL_IDX.items():
        for poly in boundary_lines.get(idx, []):
            shapes.append({
                "line_color": None,
                "points": poly.tolist(),
                "fill_color": None,
                "label": label,
            })
    return {
        "shapes": shapes,
        "lineColor": [0, 0, 0, 255],
        "imagePath": name,
        "flags": {},
        "fillColor": [0, 0, 0, 255],
        "imageData": img_arr_to_b64(json_image),
    }


def run_segment(args, device="cuda", devices=None) -> None:
    """Full VisualizeResults_iou-equivalent artifact generation.
    ``devices``: the mesh's devices under ``--data_parallel`` (default:
    the visible devices of ``device``'s type)."""
    import cv2
    import glob

    rgb_image_list = sorted(
        glob.glob(os.path.join(args.rgb_data_dir, "*", "*.PNG")))
    if args.label_data_dir is not None:
        label_image_list = sorted(
            glob.glob(os.path.join(args.label_data_dir, "*", "*.PNG")))
        assert len(rgb_image_list) == len(label_image_list)
    else:
        label_image_list = [None] * len(rgb_image_list)

    if getattr(args, "skip_existing", False):
        # per-crop resumability: crops with an existing output JSON are done
        kept = []
        for img_name, label_name in zip(rgb_image_list, label_image_list):
            patient_id = os.path.basename(os.path.dirname(img_name))
            json_path = os.path.join(
                args.savedir, patient_id,
                os.path.basename(img_name).replace(args.img_extn, "json"))
            if not os.path.isfile(json_path):
                kept.append((img_name, label_name))
        skipped = len(rgb_image_list) - len(kept)
        if skipped:
            print(f"skipping {skipped} crops with existing outputs")
        rgb_image_list = [k[0] for k in kept]
        label_image_list = [k[1] for k in kept]

    cfg = SegmenterConfig(
        weights=args.weights,
        classes=args.classes,
        p=args.p,
        q=args.q,
        decoder=(args.modelType == 1),
        in_width=args.inWidth,
        in_height=args.inHeight,
        mean=[float(m) for m in args.mean],
        std=[float(s) for s in args.std],
        batch_size=getattr(args, "batch_size", 8),
        device_preprocess=getattr(args, "fast", False),
        precision=getattr(args, "precision", "highest"),
        engine=getattr(args, "engine", "xla"),
        data_parallel=getattr(args, "data_parallel", 0),
        pack_output=getattr(args, "pack_output", False),
    )
    segmenter = EspnetSegmenter(cfg, device=device, devices=devices)

    os.makedirs(args.savedir, exist_ok=True)
    print("num of image:{}".format(len(rgb_image_list)))
    iou_eval_val = IouEval(args.classes)
    dataset_d = defaultdict(lambda: defaultdict(int))

    save_summary_acc = os.path.join(args.savedir, "summary_accuracy.csv")
    save_summary_data = os.path.join(args.savedir, "summary_dataset.csv")
    save_summary_pixel = os.path.join(args.savedir, "summary_pixel.csv")
    with open(save_summary_acc, "w") as summary_acc, \
            open(save_summary_data, "w") as summary_data, \
            open(save_summary_pixel, "w") as summary_pixel:
        summary_acc.write(
            "filename,glomerulus, crescent, sclerosis, mesangium, background "
            "iou,glomerulus iou,crescent iou,sclerosis iou, mesangium iou,mIoU\n")
        summary_data.write("patient_id, glomerulus, crescent, sclerosis, mesangium\n")
        summary_pixel.write(
            "patient_id, filename, background, glomerulus, crescent, "
            "sclerosis, mesangium\n")

        bs = cfg.batch_size

        def emit(batch):
            batch_names, batch_labels, images, handle = batch
            net_maps = segmenter.read_net_res(handle)
            for img_name, label_name, img_orig, net_map in zip(
                    batch_names, batch_labels, images, net_maps):
                _emit_crop_outputs(args, segmenter, iou_eval_val, dataset_d,
                                   summary_acc, summary_pixel, img_name,
                                   label_name, img_orig, net_map)

        # one-deep submit/emit pipeline: batch N+1 is uploaded and launched
        # before batch N's host-side artifact writes (contours, base64
        # JSON, overlay JPEGs), so the card computes while the host emits;
        # each read waits for its own batch only (readback)
        pending = None
        for start in range(0, len(rgb_image_list), bs):
            batch_names = rgb_image_list[start: start + bs]
            batch_labels = label_image_list[start: start + bs]
            images = [cv2.imread(n) for n in batch_names]
            handle = segmenter.submit_net_res(images)
            if pending is not None:
                emit(pending)
            pending = (batch_names, batch_labels, images, handle)
        if pending is not None:
            emit(pending)

        if label_image_list and label_image_list[0] is not None:
            for patient, values_d in dataset_d.items():
                summary_data.write(patient)
                for i in range(1, args.classes):
                    summary_data.write(",{}".format(values_d[i]))
                summary_data.write("\n")
            overall_acc, per_class_acc, per_class_iou, miou = \
                iou_eval_val.get_metric_right()
            with open(os.path.join(args.savedir, "overall_accuracy.txt"),
                      "w") as f:
                f.write("overall_acc:{}, per_class_acc:{}, per_class_iou:{}, "
                        "mIOU:{}".format(overall_acc, per_class_acc,
                                         per_class_iou, miou))


def _emit_crop_outputs(args, segmenter, iou_eval_val, dataset_d, summary_acc,
                       summary_pixel, img_name, label_name, img_orig, net_map):
    import cv2
    from PIL import Image as PILImage

    patient_id = os.path.basename(os.path.dirname(img_name))
    name = os.path.basename(img_name)
    name_rsplit = name.rsplit(".", 1)
    output_dir = os.path.join(args.savedir, patient_id)
    os.makedirs(output_dir, exist_ok=True)

    class_map = postprocess_nearest_host(net_map, img_orig.shape[0],
                                         img_orig.shape[1])

    overlayed = None
    if args.colored:
        class_map_color = colorize(class_map, ESPNET_PALETTE, bgr=True)
        if args.overlay:
            overlayed = cv2.addWeighted(img_orig, 0.4, class_map_color, 0.6, 0)
            cv2.imwrite(os.path.join(output_dir, name_rsplit[0] + "_overlay.jpg"),
                        overlayed)
            cv2.imwrite(os.path.join(output_dir, name_rsplit[0] + "_org.png"),
                        img_orig)

    counts = [int(np.count_nonzero(class_map == c)) for c in range(5)]
    summary_pixel.write("{},{},{},{},{},{},{}\n".format(
        patient_id, name.replace(args.img_extn, "png"), *counts))

    if args.cityFormat:
        class_map = relabel_to_cityscapes(class_map.astype(np.uint8))

    # What goes into the labelme JSON's imageData: the shipped
    # VisualizeResults_iou.py stores the original crop ("org"), but the WSI
    # evaluator decodes imageData as the cityscapes-relabeled class map —
    # the behaviour of the missing VisualizeResults_iou_pixel.py
    # (eval_wsi_segmentation.py:287,294-297; VisualizeResults_iou.py:178-179).
    json_image = (class_map.astype(np.uint8)
                  if getattr(args, "json_image_data", "org") == "classmap"
                  else img_orig)

    output_d = build_labelme_doc(class_map, json_image, name)
    with open(os.path.join(output_dir, name.replace(args.img_extn, "json")),
              "w") as out_json:
        json.dump(output_d, out_json, indent=4)

    if label_name is not None:
        assert os.path.basename(img_name) == os.path.basename(label_name)
        img_label = np.asarray(PILImage.open(label_name))
        assert img_label.shape[0] == img_orig.shape[0]
        assert img_label.shape[1] == img_orig.shape[1]
        img_label_re = cv2.resize(img_label, (args.inWidth, args.inHeight),
                                  interpolation=cv2.INTER_NEAREST)
        unique_values = np.unique(img_label_re)
        for v in unique_values.tolist():
            dataset_d[patient_id][v] += 1
        each_eval = IouEval(args.classes)
        iou_eval_val.add_batch(net_map, img_label_re)
        hist = each_eval.add_batch(net_map, img_label_re)
        _, _, per_class_iou, _ = each_eval.get_metric_right()
        hist_tp_fn_fp = hist.sum(1) + hist.sum(0) - np.diag(hist)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_class_iou_ex = np.diag(hist)[unique_values] / \
                hist_tp_fn_fp[unique_values]
        miou_each = np.nanmean(per_class_iou_ex)
        flags = [1 if np.count_nonzero(unique_values == c) else 0
                 for c in (1, 2, 3, 4)]
        summary_acc.write("{}/{},{},{},{},{},{},{},{},{},{},{}\n".format(
            patient_id, name.replace(args.img_extn, "png"), *flags,
            per_class_iou[0], per_class_iou[1], per_class_iou[2],
            per_class_iou[3], per_class_iou[4], miou_each))

        if overlayed is not None:
            gt_color = colorize(img_label, ESPNET_PALETTE, bgr=True)
            overlayed_gt = cv2.addWeighted(img_orig, 0.4, gt_color, 0.6, 0)
            h, w = img_orig.shape[:2]
            # an int array, as the reference writes it (cv2 falls back to
            # 8 bits per channel)
            combined = np.zeros((h, w * 3, 3), dtype=int)
            combined[:, :w] = img_orig
            combined[:, w:2 * w] = overlayed_gt
            combined[:, 2 * w:] = overlayed
            out3 = os.path.join(args.savedir, "combined_images", patient_id)
            os.makedirs(out3, exist_ok=True)
            cv2.imwrite(os.path.join(out3, name.replace(args.img_extn, "png")),
                        combined)
