"""SegFormer (MiT) for the GTCS labels: weights, the program under test,
and the plain reference's scores.

The program is what ``gseg-e2e --segformer_checkpoint`` builds
(``cli/e2e.py`` ``build_pipeline``): ``SegformerSlideSegmenter`` in
float32 with TF32 off, crops resized on the host to the input size as
uint8 by OpenCV, the logits blended on the device at the /8 pixels.

The reference, per crop: the same OpenCV uint8 INTER_LINEAR resize (the
model's input is defined by it, so the reference calls it too), /255 and
the ImageNet normalisation, the plain float32 SegFormer with TF32 off,
and its logits upsampled bilinearly (half-pixel, clamped edges, as
``F.interpolate`` with ``align_corners=False``) to the crop's size, taken
at OpenCV's nearest sampling of the crop to its /8 size.  Its scores are
those logits.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..reference.resample import linear_taps, nearest
from ..reference.segformer import Segformer
from .espnet_ensemble import BLOCK

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _layers(model):
    return [m for m in model.modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device, atlas=None) -> dict:
    """A state dict in the served float32, on ``device``, from ``seed`` in
    one uniform draw: each linear and conv layer's weights and biases in
    +-1/sqrt(fan in) (PyTorch's default range), norms at identity, the
    head's BN statistics at (0, 1), the classifier scaled by
    ``classifier_scale``, which widens the logits' top-2 margins.  Then,
    given the run's pixel ``atlas``, the classifier's bias is shifted so
    that every label's mean logit over two regions of it is the same: a
    label then wins where the pixels say so, not everywhere by its offset
    alone, as some seeds' draws would have it."""
    model = Segformer(cfg).to(device)
    params = [p for m in _layers(model) for p in m.parameters()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(p.numel() for p in params), generator=gen,
                   device=device) * 2 - 1
    pos = 0
    for m in _layers(model):
        w = m.weight
        bound = 1.0 / math.sqrt(w[0].numel())
        for p in m.parameters():
            p.copy_(u[pos: pos + p.numel()].view_as(p) * bound)
            pos += p.numel()
    head = model.decode_head.classifier
    head.weight.mul_(cfg["classifier_scale"])
    head.bias.mul_(cfg["classifier_scale"])
    if atlas is not None:
        side = min(atlas.shape[0], 1024)
        corners = torch.randint(0, atlas.shape[0] - side + 1, (2, 2),
                                generator=gen, device=device).tolist()
        s = cfg["input_size"]
        u8 = np.stack([cv2_resize(atlas[y: y + side, x: x + side], s)
                       for y, x in corners])
        with _tf32(False):
            mean = model.eval()(_normalised(u8, device)).double().mean(
                dim=(0, 2, 3))
        head.bias.sub_((mean - mean.mean()).to(head.bias.dtype))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def cv2_resize(u8: np.ndarray, s: int) -> np.ndarray:
    """OpenCV's uint8 INTER_LINEAR resize to (s, s), as the program's."""
    import cv2

    return cv2.resize(u8, (s, s), interpolation=cv2.INTER_LINEAR)


def _normalised(u8: np.ndarray, device) -> torch.Tensor:
    """(n, 3, s, s) float32 network input of (n, s, s, 3) uint8 RGB crops:
    /255 and the ImageNet normalisation."""
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    x = (torch.from_numpy(u8).to(device).float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def build(cfg: dict, weights, device, workdir: str):
    from glomeruli_segmentation_tpu_torch.pipeline.fused_segformer import (
        SegformerSlideConfig, SegformerSlideSegmenter)

    return SegformerSlideSegmenter(
        weights, SegformerSlideConfig(num_labels=cfg["num_labels"],
                                      input_size=cfg["input_size"],
                                      batch_size=cfg["crop_batch"],
                                      compute_dtype=cfg["compute_dtype"]),
        device=device)


def result_reads(segmenter):
    from glomeruli_segmentation_tpu_torch.pipeline import fused_segformer

    return [(fused_segformer, "read_host")]


def flops_per_crop(cfg: dict) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    model = Segformer(cfg).to("meta")
    s = cfg["input_size"]
    x = torch.empty(1, 3, s, s, device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return float(counter.get_total_flops())


@contextlib.contextmanager
def _tf32(on: bool):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@torch.no_grad()
def reference_scores(cfg: dict, weights, slide, boxes, device,
                     control: bool = False):
    """(box, logits (labels, h // 8, w // 8)) per box with pixels.
    ``control`` runs the reference with TF32 on: the precision below the
    configuration's float32."""
    net = Segformer(cfg)
    net.load_state_dict({k: v.cpu() for k, v in weights.items()},
                        strict=True)
    net = net.to(device).eval()
    s = cfg["input_size"]
    boxes = [[int(v) for v in b[:4]] for b in boxes]
    boxes = [b for b in boxes if b[2] > b[0] and b[3] > b[1]]
    with _tf32(control):
        for first in range(0, len(boxes), BLOCK):
            chunk = boxes[first: first + BLOCK]
            u8 = np.stack([cv2_resize(slide.read_region_array(
                (x1, y1), 0, (x2 - x1, y2 - y1)), s)
                for x1, y1, x2, y2 in chunk])
            logits = net(_normalised(u8, device)).double()
            hq = logits.shape[2]
            for k, (x1, y1, x2, y2) in enumerate(chunk):
                h, w = y2 - y1, x2 - x1
                ylo, yhi, wy = linear_taps(hq, h, nearest(h // 8, h),
                                           device)
                xlo, xhi, wx = linear_taps(hq, w, nearest(w // 8, w),
                                           device)
                lg = logits[k]
                rows = lg[:, ylo] * (1 - wy[:, None]) + lg[:, yhi] \
                    * wy[:, None]
                yield (x1, y1, x2, y2), rows[:, :, xlo] * (1 - wx) \
                    + rows[:, :, xhi] * wx
