"""SegFormer test/report stage (ref ``module/SegFormer/test/test.py``) on
the GPU.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/segformer_test.py``:
per-crop inference over the GTCS test split: per-image mean-IoU rows into
``pred_summary_pixel.csv`` (with the glomerulus column aggregating all
foreground, ``test.py:276-280``), the micro-averaged ``summary_report.csv``
(``test.py:283-309``), optional prediction/overlay triptychs with a 100 µm
scale bar (``test.py:88-146``), and best-checkpoint discovery from the
training ``log.txt`` (``test.py:149-171``).  The forward runs on
``device`` in float32 with TF32 off; each crop's logits are upsampled to
label size and argmaxed there, and only the class map comes back.
"""
from __future__ import annotations

import ast
import csv
import glob
import os
from typing import Dict

import numpy as np
import torch

from ..data.segformer_dataset import ResizedGlomerularDataset
from ..eval.mean_iou import mean_iou
from ..palette import GTCS_PALETTE

# mpp fixed at 0.228 for the scale bar, as the reference does (test.py:91-93)
SLIDE_INFO_MPPX = 0.228
SCALE_BAR_LENGTH = round(100.0 / SLIDE_INFO_MPPX)

GTCS_COLUMNS = ["background", "glomerulus", "tuft", "crescent", "sclerosis"]


def search_best_checkpoint(model_base_path: str) -> str:
    """Pick the best checkpoint by parsing eval_mean_iou from log.txt."""
    best_iou = 0.0
    best_epoch = 0
    last_epoch = 0
    with open(os.path.join(model_base_path, "log.txt")) as log:
        for line in log.readlines():
            if "eval_mean_iou" in line:
                line = line[line.find("{"): line.find("}") + 1]
                d = ast.literal_eval(line)
                value = float(d["eval_mean_iou"])
                if best_iou < value:
                    best_iou = value
                    best_epoch = int(d["epoch"])
                last_epoch = int(d["epoch"])
    checkpoints = glob.glob(os.path.join(model_base_path, "checkpoint-*"))
    assert len(checkpoints) > 0, "checkpoints does not found."
    cps = sorted(int(os.path.basename(c).replace("checkpoint-", ""))
                 for c in checkpoints)
    best = cps[-1] if best_epoch == last_epoch else cps[-2]
    return f"checkpoint-{best}"


def save_triptych(pred_seg: np.ndarray, gt_seg: np.ndarray,
                  image_file_name: str, report_root_path: str,
                  specimen_id: str, file_name: str) -> None:
    from PIL import Image, ImageDraw

    pred_img = Image.fromarray(np.uint8(pred_seg), mode="L")
    seg_dir = os.path.join(report_root_path, "seg", specimen_id)
    os.makedirs(seg_dir, exist_ok=True)
    pred_img.save(os.path.join(seg_dir, file_name))

    palette = np.array(GTCS_PALETTE)
    color_seg = np.zeros((*pred_seg.shape, 3), np.uint8)
    color_gt = np.zeros((*gt_seg.shape, 3), np.uint8)
    for label, color in enumerate(palette):
        color_seg[pred_seg == label] = color
        color_gt[gt_seg == label] = color

    org = Image.open(image_file_name).convert("RGBA")
    seg = Image.blend(org, Image.fromarray(color_seg).convert("RGBA"), 0.7)
    gt = Image.blend(org, Image.fromarray(color_gt).convert("RGBA"), 0.7)
    concat = Image.new("RGBA", (org.width * 3, org.height))
    draw = ImageDraw.Draw(org)
    h = org.height
    draw.line((30, h - 30, SCALE_BAR_LENGTH + 30, h - 30), fill="black",
              width=16)
    draw.text((int(SCALE_BAR_LENGTH / 2) - 70, h - 114), text="100 μm",
              fill="black")
    concat.paste(org, (0, 0))
    concat.paste(seg, (org.width, 0))
    concat.paste(gt, (org.width * 2, 0))
    out_dir = os.path.join(report_root_path, specimen_id)
    os.makedirs(out_dir, exist_ok=True)
    concat.save(os.path.join(out_dir, file_name))


def run_segformer_test(args, device="cuda") -> None:
    """``device="cpu"`` runs the model on the CPU (for tests)."""
    from .. import resolve_device, tf32
    from ..models.segformer import (Segformer, config_from_state_dict,
                                    upsample_logits)
    from .fused_segformer import load_segformer_checkpoint

    if getattr(args, "data_parallel", 0):
        raise NotImplementedError(
            f"data_parallel={args.data_parallel}: the crop-batch mesh is not "
            "ported (ROADMAP queue 1, 'The rest': parallelism, "
            "parallel/* onto torch.distributed)")
    dev = resolve_device(device)
    if args.checkpoint == "":
        model_base = os.path.join(
            args.model_base_path,
            f"{args.model_site}/{args.pretrained_model}/fold{args.fold}")
        checkpoint = search_best_checkpoint(model_base)
    else:
        checkpoint = args.checkpoint
    model_path = os.path.join(
        args.model_base_path,
        f"{args.model_site}/{args.pretrained_model}/fold{args.fold}/"
        f"{checkpoint}")
    state_dict, _ = load_segformer_checkpoint(
        os.path.join(model_path, "flax_model.pth"))
    # geometry inferred from the checkpoint so any MiT variant loads
    # (models/segformer.py::config_from_state_dict)
    model = Segformer(config_from_state_dict(state_dict,
                                             num_labels=args.num_labels))
    model.load_state_dict(state_dict, strict=True)
    model.to(dev).eval()

    data_source = os.path.join(args.data_root, args.target_site,
                               args.data_date)
    test_ds = ResizedGlomerularDataset(
        data_source, rgb_subdir="rgb", label_subdir="label/gtcs",
        transforms=None, mode="test", fold=args.fold,
        detected_mode=args.detected_mode,
        input_size=getattr(args, "input_size", 512))

    report_root = os.path.join(args.report_root_path, args.target_site,
                               args.model_site, args.data_date,
                               args.pretrained_model, f"fold{args.fold}")
    os.makedirs(report_root, exist_ok=True)

    # crops arrive uniformly resized (ResizedGlomerularDataset), so the
    # forward batches ``--batch_size`` crops per launch (the reference
    # feeds its session one crop at a time, test.py:60-74; per-image
    # metrics and CSV rows are unchanged).  The tail pads by repeating
    # the last crop, so every batch has one shape.
    bs = max(1, int(getattr(args, "batch_size", 1) or 1))

    @torch.no_grad()
    def forward(batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(batch)
        if dev.type == "cuda":
            x = x.pin_memory().to(dev, non_blocking=True)
        with tf32(False, False):
            return model(x)

    @torch.no_grad()
    def predict(logits: torch.Tensor, h: int, w: int) -> np.ndarray:
        up = upsample_logits(logits, h, w)
        return torch.argmax(up, dim=-1)[0].cpu().numpy()

    metrics_sum: Dict[str, np.ndarray] = {}
    data_len = len(test_ds)
    with open(os.path.join(report_root, "pred_summary_pixel.csv"),
              mode="w") as summary_pixel:
        writer = csv.writer(summary_pixel)
        writer.writerow(["specimen_id", "filename"] + GTCS_COLUMNS
                        + ["mIoU"])
        def process(pending):
            idxs, items, batch_logits = pending
            for pos, (idx, item) in enumerate(zip(idxs, items)):
                image_file = test_ds.images[idx]
                specimen_id = image_file.split("/")[-2]
                file_name = image_file.split("/")[-1]
                logits = batch_logits[pos: pos + 1]
                gt = item["labels"]
                pred = predict(logits, gt.shape[0], gt.shape[1])
                metrics = mean_iou([pred], [gt], args.num_labels,
                                   ignore_index=255)
                for key, value in metrics.items():
                    metrics_sum[key] = metrics_sum.get(key, 0) + value
                if args.save_image:
                    save_triptych(pred, gt, image_file, report_root,
                                  specimen_id, file_name)
                p = metrics["total_area_pred_label"]
                pixels = [p[0], p[1] + p[2] + p[3] + p[4], p[2], p[3],
                          p[4]]
                writer.writerow([specimen_id, file_name] + list(pixels)
                                + [metrics["mean_iou"]])
                if (idx + 1) % 10 == 0:
                    print(f"{idx + 1}/{data_len}")

        # one-deep submit/process pipeline (as in the staged segment
        # command): batch N+1's forward is launched before batch N's host
        # work (per-crop metrics, triptych writes)
        pending = None
        for start in range(0, data_len, bs):
            idxs = list(range(start, min(start + bs, data_len)))
            items = [test_ds.get(i) for i in idxs]
            batch = np.stack([np.asarray(it["pixel_values"])
                              for it in items])
            if len(idxs) < bs:
                batch = np.concatenate(
                    [batch, np.repeat(batch[-1:], bs - len(idxs), axis=0)])
            batch_logits = forward(batch)
            if pending is not None:
                process(pending)
            pending = (idxs, items, batch_logits)
        if pending is not None:
            process(pending)

    # 0/0 -> NaN is the mmseg convention for absent classes; the nanmeans
    # below skip them (reference mean_iou semantics)
    with np.errstate(divide="ignore", invalid="ignore"):
        overall_iou = metrics_sum["total_area_intersect"] / \
            metrics_sum["total_area_union"]
        overall_acc = metrics_sum["total_area_intersect"] / \
            metrics_sum["total_area_label"]
    for key in list(metrics_sum):
        if key not in ("total_area_intersect", "total_area_union",
                       "total_area_label", "total_area_pred_label"):
            metrics_sum[key] = metrics_sum[key] / data_len
    metrics_sum["overall_iou"] = overall_iou
    metrics_sum["overall_acc"] = overall_acc
    metrics_sum["overall_mean_acc"] = np.nanmean(overall_acc)
    metrics_sum["overall_mean_iou"] = np.nanmean(overall_iou)
    for key in ("per_category_iou", "per_category_accuracy",
                "total_area_intersect", "total_area_union",
                "total_area_label", "overall_accuracy",
                "total_area_pred_label"):
        metrics_sum.pop(key, None)
    metrics_sum = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in metrics_sum.items()}
    print(metrics_sum)
    with open(os.path.join(report_root, "summary_report.csv"),
              mode="w") as overall:
        writer = csv.writer(overall)
        writer.writerow(["metric", "value"] + GTCS_COLUMNS)
        for key, value in metrics_sum.items():
            if isinstance(value, list):
                writer.writerow([key, ""] + value)
            else:
                writer.writerow([key, value])
