"""The 5-fold ESPNet ensemble: weights, the program under test, and the
plain reference's scores.

The program is what ``gseg-e2e`` builds at its defaults
(``cli/e2e.py`` ``build_pipeline``): ``EnsembleSegmenter`` from fold
checkpoints, ``engine="auto"`` (packed below batch 96, level 3 through
K1), driven by ``FusedSlideSegmenter`` with the flat transfer and the /8
gather on the device.

The reference, per crop: the BGR crop resized to the network input
(bilinear, OpenCV's half-pixel sampling, float), each fold's
normalisation ``(x - mean) / std / 255``, the plain float32 ESPNet with
TF32 off, the softmax of each fold summed over folds; its scores at the
/8 pixels are the sums at OpenCV's nearest sampling of the network output
to the crop's /8 size.
"""
from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch

from ..reference.espnet import ESPNet
from ..reference.resample import linear_taps, nearest

# crops the reference runs at once
BLOCK = 8


def _layers(model):
    return [m for m in model.modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]


@torch.no_grad()
def make_weights(cfg: dict, seed: int, device, atlas: np.ndarray):
    """One state dict per fold (float32, on the host, in the reference's
    key layout), made on ``device`` from ``seed``: He-normal kernels,
    PReLU slopes in [0.1, 0.4], BN affines near identity, all in one
    normal and one uniform draw per fold; then BN running statistics set
    as training leaves them, by one train-mode forward (momentum 1) over
    two regions of the run's pixel ``atlas`` at a quarter of the network
    input, normalised with the fold's constants."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    side = min(atlas.shape[0], 1024)
    corners = torch.randint(0, atlas.shape[0] - side + 1, (2, 2),
                            generator=gen, device=device).tolist()
    h, w = cfg["in_height"] // 4, cfg["in_width"] // 4
    calib = torch.stack([resize(torch.from_numpy(
        atlas[y: y + side, x: x + side, ::-1].copy()).to(device), h, w)
        for y, x in corners])
    out = []
    for fold in cfg["folds"]:
        model = ESPNet(cfg["classes"], cfg["p"], cfg["q"]).to(device)
        kernels = [m.weight for m in _layers(model)]
        vecs = [(n, p) for n, p in model.named_parameters() if p.dim() == 1]
        z = torch.randn(sum(k.numel() for k in kernels) + sum(
            p.numel() for _, p in vecs), generator=gen, device=device)
        u = torch.rand(sum(p.numel() for _, p in vecs), generator=gen,
                       device=device)
        pos = upos = 0
        for m in _layers(model):
            k = m.weight
            fan_in = k.shape[0] if isinstance(
                m, torch.nn.ConvTranspose2d) else k[0].numel()
            k.copy_(z[pos: pos + k.numel()].view_as(k)
                    * math.sqrt(2.0 / fan_in))
            pos += k.numel()
        for name, p in vecs:
            zz = z[pos: pos + p.numel()]
            uu = u[upos: upos + p.numel()]
            pos += p.numel()
            upos += p.numel()
            if name.endswith("act.weight"):
                p.copy_(0.1 + 0.3 * uu)
            elif name.endswith("weight"):
                p.copy_(0.8 + 0.4 * uu)
            else:
                p.copy_(0.1 * zz)
        mean, std = cfg["fold_normalization"][str(fold)]
        mean = torch.tensor(mean, device=device)
        std = torch.tensor(std, device=device)
        x = ((calib.float() - mean) / std / 255.0).permute(0, 3, 1, 2)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = 1.0
        model.train()
        with _full_f32():
            model(x.contiguous())
        sd = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
        for k in sd:
            if k.endswith("num_batches_tracked"):
                sd[k] = torch.tensor(0, dtype=torch.int64)
        out.append(sd)
    return out


@contextlib.contextmanager
def _full_f32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def build(cfg: dict, weights, device, workdir: str):
    """The program under test, its fold checkpoints written to
    ``workdir`` as ``gseg-e2e`` reads them."""
    from glomeruli_segmentation_tpu_torch.pipeline.fused import (
        EnsembleConfig, EnsembleSegmenter, FusedSlideSegmenter)

    paths = []
    for fold, sd in zip(cfg["folds"], weights):
        path = os.path.join(workdir, f"espnet_fold{fold}.pth")
        torch.save(sd, path)
        paths.append(path)
    ensemble = EnsembleSegmenter(
        EnsembleConfig(checkpoints=paths, folds=tuple(cfg["folds"]),
                       classes=cfg["classes"], p=cfg["p"], q=cfg["q"],
                       in_height=cfg["in_height"], in_width=cfg["in_width"],
                       batch_size=cfg["crop_batch"],
                       compute_dtype=cfg["compute_dtype"],
                       precision=cfg["precision"],
                       accum_dtype=cfg["accum_dtype"]),
        engine=cfg["engine"], device=device)
    return FusedSlideSegmenter(ensemble, transfer=cfg["transfer"])


def result_reads(segmenter):
    """The calls in which the slide loop waits for a batch's result."""
    return [(segmenter.ensemble, "read_gathered")]


def flops_per_crop(cfg: dict) -> float:
    """Floating-point operations of one crop through every fold of the
    reference at the network input, counted from the shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    model = ESPNet(cfg["classes"], cfg["p"], cfg["q"]).to("meta")
    x = torch.empty(1, 3, cfg["in_height"], cfg["in_width"], device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return float(counter.get_total_flops()) * len(cfg["folds"])


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _to_fp8(model) -> None:
    """Every convolution's weights and inputs through float8 e4m3, its sums
    in float32: the precision below the configuration's bfloat16."""
    for m in _layers(model):
        m.weight.data = _fp8(m.weight.data)
        m.register_forward_pre_hook(lambda mod, args: (_fp8(args[0]),))


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) pixels -> (out_h, out_w, C) float32, OpenCV's bilinear
    sampling, rows then columns."""
    img = img.float()
    lo, hi, w = linear_taps(img.shape[0], out_h, np.arange(out_h),
                            img.device)
    w = w.float()[:, None, None]
    img = img[lo] * (1 - w) + img[hi] * w
    lo, hi, w = linear_taps(img.shape[1], out_w, np.arange(out_w),
                            img.device)
    w = w.float()[None, :, None]
    return img[:, lo] * (1 - w) + img[:, hi] * w


@torch.no_grad()
def reference_scores(cfg: dict, weights, slide, boxes, device,
                     control: bool = False):
    """(box, scores) for each box with pixels, scores (classes, h // 8,
    w // 8) on ``device``.  ``control`` runs the reference in float8."""
    nets = []
    for sd in weights:
        net = ESPNet(cfg["classes"], cfg["p"], cfg["q"])
        net.load_state_dict(sd, strict=True)
        net = net.to(device).eval()
        if control:
            _to_fp8(net)
        nets.append(net)
    norms = [[torch.tensor(v, device=device) for v in
              cfg["fold_normalization"][str(f)]] for f in cfg["folds"]]
    in_h, in_w = cfg["in_height"], cfg["in_width"]
    boxes = [[int(v) for v in b[:4]] for b in boxes]
    boxes = [b for b in boxes if b[2] > b[0] and b[3] > b[1]]
    with _full_f32():
        for first in range(0, len(boxes), BLOCK):
            chunk = boxes[first: first + BLOCK]
            x = torch.stack([resize(torch.from_numpy(
                slide.read_region_array((x1, y1), 0, (x2 - x1, y2 - y1))
                [:, :, ::-1].copy()).to(device), in_h, in_w)
                for x1, y1, x2, y2 in chunk])
            total = None
            for net, (mean, std) in zip(nets, norms):
                z = ((x - mean) / std / 255.0).permute(0, 3, 1, 2)
                p = torch.softmax(net(z.contiguous()), dim=1)
                total = p if total is None else total + p
            for k, (x1, y1, x2, y2) in enumerate(chunk):
                ys = torch.from_numpy(nearest((y2 - y1) // 8, in_h)).to(
                    device)
                xs = torch.from_numpy(nearest((x2 - x1) // 8, in_w)).to(
                    device)
                yield (x1, y1, x2, y2), total[k][:, ys][:, :, xs]
