"""Whole-slide detector training driver (``gseg-train-detector``).

Counterpart of ``glomeruli_segmentation_tpu/train/detector_driver.py``: it
samples detection windows from annotated slides (Pascal-VOC XMLs at ds-8
coordinates, the layout ``make_seg_data`` reads), trains the training form
of :class:`..models.faster_rcnn.FasterRCNN` with the two-stage losses of
:mod:`.detector_train`, and saves a ``detector.ckpt.pth`` that both
packages' detect commands load.

Window sampling: positive-biased -- each step picks a random annotated
slide, then with p=0.7 a window centred near a random GT box (jittered),
else a uniform window; boxes are clipped to the window and kept when at
least half their area survives.  With equal ``seed`` the window sequence is
the JAX package's byte for byte: the JAX driver draws one batch for
``model.init`` before its loop, and so does this one.  The initial weights
are not the JAX package's (:func:`..convert.detector_import.
init_detector_state` draws Flax's initialisers with numpy; JAX's random
stream cannot be made in torch).

A step holds both TF32 switches off under the port's TF32 lock over the
forward, the backward and Adam's update (``torch.optim.Adam(lr,
eps=1e-8)``, no weight decay, as ``optax.adam``).  The proposals go
through :func:`..ops.nms.nms` without a graph: one K3 launch a step on the
card.  ``bf16`` autocasts the forward to bfloat16; parameters, BN
statistics, box math and the loss stay float32.  ``data_parallel`` other
than 0 (the JAX driver's window mesh) raises ``SystemExit``: it is not
ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, tf32, wsi
from ..utils.annotation import AnnotationHandler
from ..utils.glomus_handler import GlomusHandler


@dataclasses.dataclass
class DetectorTrainConfig:
    image_size: int = 512
    batch_size: int = 4
    steps: int = 2000
    lr: float = 1e-3
    max_gt: int = 16
    level_downsample: float = 8.0
    pos_window_prob: float = 0.7
    eval_every: int = 200
    seed: int = 0


class SlideWindowSampler:
    """Random detection windows + clipped GT boxes from annotated slides.
    A copy of the JAX package's sampler, reading slides through the port's
    :func:`..wsi.open_slide`."""

    def __init__(self, staining_type: str, data_dir: str, target_list: str,
                 config: DetectorTrainConfig):
        self.config = config
        self.staining_dir = GlomusHandler.get_staining_type(staining_type)
        self.slides = []  # (slide, level, gt_boxes_level_coords)
        handler = AnnotationHandler(data_dir, staining_type)
        with open(target_list) as f:
            patients = [line.split(os.sep)[0].strip() for line in f
                        if line.strip()]
        for patient in patients:
            pdir = os.path.join(data_dir, self.staining_dir, patient)
            ann_dir = os.path.join(pdir, "annotations")
            if not os.path.isdir(ann_dir):
                continue
            slide_files = [p for pat in ("*ndpi", "*.tiff", "*.tif")
                           for p in glob.glob(os.path.join(pdir, pat))]
            if not slide_files:
                continue
            slide = wsi.open_slide(slide_files[0])
            level = slide.get_best_level_for_downsample(
                config.level_downsample)
            for xml in sorted(glob.glob(os.path.join(ann_dir, "*.xml"))):
                handler.clear_annotation()
                try:
                    handler.read_annotation(ann_dir, os.path.basename(xml))
                except Exception:
                    continue
                ds_ann = self._annotation_downsample(os.path.basename(xml))
                scale = ds_ann / slide.level_downsamples[level]
                boxes = [[b[1] * scale, b[0] * scale, b[3] * scale,
                          b[2] * scale]  # [ymin, xmin, ymax, xmax]
                         for b, name in zip(handler.gt_list,
                                            handler.gt_name_list)
                         if name in ("glomerulus", "glomerulus-kana")]
                if boxes:
                    self.slides.append((slide, level,
                                        np.asarray(boxes, np.float32)))
        if not self.slides:
            raise SystemExit("no annotated slides found for detector training")

    @staticmethod
    def _annotation_downsample(file_name: str) -> float:
        m = re.search(r"_ds(\d{1,2})", file_name)
        return float(m.group(1)) if m else 8.0

    def sample_batch(self, rng: np.random.Generator):
        cfg = self.config
        s = cfg.image_size
        images = np.zeros((cfg.batch_size, s, s, 3), np.uint8)
        gt_boxes = np.zeros((cfg.batch_size, cfg.max_gt, 4), np.float32)
        gt_classes = np.zeros((cfg.batch_size, cfg.max_gt), np.int32)
        gt_valid = np.zeros((cfg.batch_size, cfg.max_gt), bool)
        for b in range(cfg.batch_size):
            slide, level, boxes = self.slides[
                int(rng.integers(len(self.slides)))]
            lw, lh = slide.level_dimensions[level]
            ds = slide.level_downsamples[level]
            if rng.random() < cfg.pos_window_prob and len(boxes):
                gt = boxes[int(rng.integers(len(boxes)))]
                cy = (gt[0] + gt[2]) / 2 + rng.uniform(-s / 4, s / 4)
                cx = (gt[1] + gt[3]) / 2 + rng.uniform(-s / 4, s / 4)
                y0 = int(np.clip(cy - s / 2, 0, max(lh - s, 0)))
                x0 = int(np.clip(cx - s / 2, 0, max(lw - s, 0)))
            else:
                y0 = int(rng.integers(0, max(lh - s, 1)))
                x0 = int(rng.integers(0, max(lw - s, 1)))
            region = slide.read_region_array(
                (int(x0 * ds), int(y0 * ds)), level, (s, s))
            images[b] = region
            count = 0
            for gy1, gx1, gy2, gx2 in boxes:
                cy1 = np.clip(gy1 - y0, 0, s)
                cx1 = np.clip(gx1 - x0, 0, s)
                cy2 = np.clip(gy2 - y0, 0, s)
                cx2 = np.clip(gx2 - x0, 0, s)
                if (cy2 - cy1) * (cx2 - cx1) < 0.5 * (gy2 - gy1) * (gx2 - gx1):
                    continue
                if count >= self.config.max_gt:
                    break
                gt_boxes[b, count] = [cy1, cx1, cy2, cx2]
                gt_classes[b, count] = 1
                gt_valid[b, count] = True
                count += 1
        return images, gt_boxes, gt_classes, gt_valid


def refuse_data_parallel(data_parallel: int) -> None:
    """The JAX driver's window mesh is not ported: ``--data_parallel``
    other than 0 raises ``SystemExit`` naming itself."""
    if data_parallel:
        raise SystemExit(f"not ported: --data_parallel {data_parallel} (the "
                         "data-parallel detector trainer)")


def upload_batch(batch, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """A sampler batch as tensors on ``device``: the windows (N, H, W, 3)
    as float32 (cast on the device from the uint8 upload), the GT boxes,
    classes and valid mask.  On a card each goes through pinned memory
    without waiting."""
    out = []
    for arr in batch:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    out[0] = out[0].float()
    return tuple(out)


def train_step(model, optimizer, forward, anchors, batch, bf16: bool = False
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One step on an uploaded batch ``(x, gb, gc, gv)``: ``forward(model,
    x, anchors)`` (the stage outputs), :func:`.detector_train.
    detector_loss` in float32, backward, the optimizer's update.  Both TF32
    switches are held off under the port's TF32 lock from the forward
    through the update.  Returns the losses (detached, on the device) and
    the step's proposals."""
    from .detector_train import detector_loss

    x, gb, gc, gv = batch
    model.train()
    with tf32(False, False):
        optimizer.zero_grad(set_to_none=True)
        with (torch.autocast(x.device.type, dtype=torch.bfloat16) if bf16
              else contextlib.nullcontext()):
            out = forward(model, x, anchors)
        losses = detector_loss(anchors, out, gb, gc, gv)
        losses["total"].backward()
        optimizer.step()
    return ({k: v.detach() for k, v in losses.items()},
            out["proposals"].detach())


def native_forward(model, x, anchors):
    return model(x, anchors)


def log_line(step: int, losses: Dict[str, torch.Tensor]) -> str:
    """The JAX driver's log line: ``step i: rpn_cls=..., ..., total=...``,
    the losses read back in one copy."""
    values = torch.stack(list(losses.values())).double().cpu().tolist()
    return f"step {step}: " + ", ".join(
        f"{k}={v:.4f}" for k, v in zip(losses, values))


def run_steps(sampler: SlideWindowSampler, rng: np.random.Generator, steps,
              model, optimizer, forward, anchors, device: torch.device,
              bf16: bool, log_every: int) -> None:
    """``steps`` training steps, each on the sampler's next batch; logs
    every ``log_every`` steps (the only reads of the losses: the steps are
    otherwise enqueued without waiting for the device)."""
    for i in range(steps):
        batch = upload_batch(sampler.sample_batch(rng), device)
        losses, _ = train_step(model, optimizer, forward, anchors, batch,
                               bf16)
        if i % log_every == 0:
            print(log_line(i, losses))


def train_detector(staining: str, data_dir: str, target_list: str,
                   output_dir: str,
                   config: Optional[DetectorTrainConfig] = None,
                   model_config=None, log_every: int = 50,
                   data_parallel: int = 0, bf16: bool = False,
                   device="cuda") -> str:
    """Train and save ``detector.ckpt.pth``; returns its path.  The
    weights start from :func:`..convert.detector_import.
    init_detector_state` (seed ``config.seed``).  ``device`` is ``cuda``
    unless the caller asks for the CPU."""
    from ..convert.detector_import import (init_detector_state,
                                           save_detector_checkpoint)
    from ..models.faster_rcnn import (FasterRCNN, FasterRCNNConfig,
                                      build_anchors)

    refuse_data_parallel(data_parallel)
    dev = resolve_device(device)
    config = config or DetectorTrainConfig()
    if model_config is None:
        model_config = FasterRCNNConfig(
            image_size=(config.image_size, config.image_size))
    sampler = SlideWindowSampler(staining, data_dir, target_list, config)
    rng = np.random.default_rng(config.seed)

    model = FasterRCNN(model_config, train_form=True).load_state(
        init_detector_state(config.seed, model_config)).to(dev)
    anchors = build_anchors(model_config).to(dev)
    # the JAX driver initialises its model on one batch before the loop:
    # draw it, so the windows that follow are the JAX package's
    sampler.sample_batch(rng)
    optimizer = torch.optim.Adam(model.parameters(), lr=config.lr,
                                 eps=1e-8)
    run_steps(sampler, rng, config.steps, model, optimizer, native_forward,
              anchors, dev, bf16, log_every)

    os.makedirs(output_dir, exist_ok=True)
    return save_detector_checkpoint(
        model.detector_state(), model_config,
        os.path.join(output_dir, "detector.ckpt.pth"))
