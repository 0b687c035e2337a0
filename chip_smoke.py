"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 switches;
2. builds every kernel of the port from ``glomeruli_segmentation_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) into build/torch_kernels/;
3. holds K1 (the fused ESP block) and K2 (the ESP block on the padded
   layout, with zero halo columns and pad channels checked) against their
   plain PyTorch versions at the main paths' shapes, in float32 with TF32
   off and in bfloat16, and times both;
4. drives the main path at full width -- the 5-fold ESPNet slide segmenter
   (5 classes, p=2, q=8, 512x1024 network input, crop batch 32, bf16) on
   a seeded synthetic slide with random seeded weights -- with the kernel
   launch counts set to 0 just before and read just after, first with the
   ``fused`` engine, then with the fold-packed ``packed`` engine (what
   ``engine="auto"`` picks at batch 32), once with its plain level 2 and
   once with K2, in turns with the fused engine, each form traced; then
   runs the f32 "highest" paths with and without each kernel, and the
   fused model against the plain ``nn.Module`` ESPNet on a small input;
5. holds K3 (greedy NMS) against ``nms_plain`` at both of the detector's
   NMS shapes, on seeded boxes with tied scores and on the real proposals
   of one window batch (indices and counts must be equal), and times both;
6. drives the second path at full width -- the ResNet-50-C4 Faster R-CNN
   window detector (``FasterRCNNConfig()``, bf16, random seeded weights
   with calibrated BN statistics) over a seeded level-3 pyramid stub at
   the e2e operating point (2000 um windows, overlap 0.1, 0.2265 um/px,
   1104x1104 px windows, batch 8: 20 windows in 3 batches) -- with the K3
   count set to 0 just before and read just after; checks the detection
   output contract; compares the scan with the plain NMS in turns; then
   runs one f32 batch (TF32 off) with and without the kernel, which must
   agree exactly, and traces one bf16 batch;
7. prints one JSON line of kernel results and, last, one JSON status line.

Any failed check raises, so the exit code is non-zero and the status line
is not printed.  It needs a CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    random_detector_state,
)
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    load_espnet_state_dict,
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.faster_rcnn import (
    FasterRCNNConfig,
    build_anchors,
)
from glomeruli_segmentation_tpu_torch.models.espnet import create_espnet
from glomeruli_segmentation_tpu_torch.models.espnet_fused import FusedESPNet
from glomeruli_segmentation_tpu_torch.models.espnet_packed import (
    PackedEnsembleESPNet,
)
from glomeruli_segmentation_tpu_torch.ops import _build
from glomeruli_segmentation_tpu_torch.ops.esp_block import (
    HALO,
    esp_block_fused,
    esp_block_padded,
    esp_block_padded_plain,
    esp_block_plain,
    esp_pad_io,
    pack_esp_weights,
)
from glomeruli_segmentation_tpu_torch.ops.nms import nms, nms_plain, premask
from glomeruli_segmentation_tpu_torch.pipeline.detect import (
    GlomusDetector,
    TorchDetectorBackend,
)
from glomeruli_segmentation_tpu_torch.pipeline.fused import (
    FOLD_NORMALIZATION,
    EnsembleConfig,
    EnsembleSegmenter,
    FusedSlideSegmenter,
)

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# |kernel - plain| <= atol + rtol * |plain|, per type.  f32: the same f32
# products summed in another order.  bf16: one bf16 rounding of the output
# (2^-8 relative) and of the 1x1 reduce, which may land on either side.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
# main-path shape of every level-3 block: crop batch 32, 512x1024 / 8
K1_SHAPE = (32, 64, 128, 128)
# the packed engine's level 2: crop batch 32, 512x1024 / 4, 5 folds x 64
# channels (n = 60, n1 = 80), and its padded layout (W + 2*HALO, C to 384)
K2_SHAPE = (32, 128, 256, 320)
K2_PADDED = (32, 128, 256 + 2 * HALO, 384)
# the detector's NMS problems per window batch of 8: (P, N, k, IoU)
K3_SHAPES = {"rpn": (8, 2000, 300, 0.7), "second": (8, 300, 100, 0.6)}
# float32 operations per box in a greedy step that emits a box: the IoU
# (2 min, 2 max, 2 sub, 2 clamp, mul, add, sub, div), the threshold and
# winner compares, the suppression select, and the argmax compare
K3_OPS_PER_BOX = 14
# the e2e operating point: 2000 um windows, overlap 0.1, 40x at
# 0.2265 um/px, level 3 (downsample 8) -> ceil(2000 / 0.2265 / 8) = 1104 px
DET_WINDOW_UM, DET_OVERLAP, DET_MPP, DET_BATCH = 2000, 0.1, 0.2265, 8
DET_WINDOW_PX = 1104
# level-3 size of the smoke slide (level 0 is 35328 x 26496): 5 x 4 windows
DET_LEVEL3_HW = (3312, 4416)


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, after warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------- kernels K1 and K2: the ESP block ----------------
def block_case(label: str, kernel, plain, x, operands, pixels: int,
               after=None) -> dict:
    """An ESP block kernel against its plain version on ``x`` (f32 or bf16)
    and the f32 ``operands`` (w1, wd, scale, bias, alpha), both timed in
    turns; the bound from what the call must move and compute.  ``after``
    checks the kernel's output further."""
    dtype = x.dtype
    w1, wd = (t.to("cuda", dtype) for t in operands[:2])
    args = (x, w1, wd, *(t.cuda() for t in operands[2:]))
    y = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOLERANCE[dtype]
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    check(bool(torch.isfinite(y).all()), f"{label} {dtype}: non-finite")
    check(bad == 0, f"{label} {dtype}: {bad} values outside atol {atol} "
                    f"rtol {rtol} (max abs err {err.max().item():.3e})")
    if after is not None:
        after(y)
    max_abs = err.max().item()
    max_rel = (err / ref.float().abs().clamp_min(1e-3)).max().item()
    out_numel = y.numel()
    del y, ref, err
    # plain, kernel, kernel, plain: one card, in turns
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = plain if name == "plain" else kernel
        times[name].append(cuda_ms(lambda: fn(*args)))
    c, n = w1.shape
    size = x.element_size()
    # the input's logical pixels read once (K2's halo columns and pad
    # channels are zero by contract), the whole output written once
    nbytes = ((pixels * c + out_numel + w1.numel() + wd.numel()) * size
              + 3 * c * 4)
    # 1x1 reduce C->n, then 9n-deep products into n1 + 4n = C outputs
    ops = 2 * pixels * (c * n + 9 * n * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape),
            "max_abs_err": max_abs, "max_rel_err": max_rel,
            "tolerance": [atol, rtol],
            "ms": float(np.mean(times["kernel"])),
            "plain_ms": float(np.mean(times["plain"])),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gbytes": nbytes / 1e9, "gflop": ops / 1e9}


def print_block_case(label: str, r: dict, name_power: str) -> None:
    print(f"{label} {r['dtype']} {tuple(r['shape'])}: max abs err "
          f"{r['max_abs_err']:.3e} max rel err {r['max_rel_err']:.3e} "
          f"(tolerance atol {r['tolerance'][0]} rtol {r['tolerance'][1]}); "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms'] * 1e3:.1f} us by {r['bound_by']} "
          f"({r['gbytes']:.3f} GB, {r['gflop']:.2f} GFLOP); library: no "
          f"single PyTorch call computes the block | {name_power}",
          flush=True)


def check_zero_padding(y, c: int) -> None:
    """K2's output keeps the padded layout: zero halo columns and zero pad
    channels, exactly."""
    check(bool((y[:, :, :HALO] == 0).all() and (y[:, :, -HALO:] == 0).all()),
          "K2: nonzero halo columns in the output")
    check(bool((y[..., c:] == 0).all()), "K2: nonzero pad channels")


# ---------------- the slice: a synthetic slide ----------------
class NumpySlide:
    """An in-memory slide: ``.dimensions`` and ``read_region_array`` over an
    RGB uint8 array; pixels outside the image read white."""

    def __init__(self, image: np.ndarray):
        self.image = image
        self.dimensions = (image.shape[1], image.shape[0])

    def read_region_array(self, location, level, size):
        check(level == 0, "NumpySlide has level 0 only")
        (x0, y0), (w, h) = location, size
        out = np.full((h, w, 3), 255, np.uint8)
        ys, xs = max(y0, 0), max(x0, 0)
        ye = min(y0 + h, self.image.shape[0])
        xe = min(x0 + w, self.image.shape[1])
        if ye > ys and xe > xs:
            out[ys - y0: ye - y0, xs - x0: xe - x0] = \
                self.image[ys:ye, xs:xe]
        return out


def synthetic_slide(seed: int, height: int, width: int, n_boxes: int,
                    box_min: int, box_max: int):
    """A PAS-like slide (pink noisy background, dark round blobs) and one
    detection box per blob, sized ``box_min`` to ``box_max`` pixels; the
    last box overhangs the right edge."""
    rng = np.random.RandomState(seed)
    img = np.empty((height, width, 3), np.uint8)
    for row in range(0, height, 1024):
        band = img[row: row + 1024]
        noise = rng.randint(-12, 12, band.shape, dtype=np.int16)
        band[:] = np.clip(noise + np.asarray((230, 205, 215), np.int16),
                          0, 255)
    boxes = []
    for i in range(n_boxes):
        bw, bh = rng.randint(box_min, box_max + 1, 2)
        x1 = width - bw // 2 if i == n_boxes - 1 else \
            rng.randint(0, width - bw)
        y1 = rng.randint(0, height - bh)
        boxes.append([int(x1), int(y1), int(x1 + bw), int(y1 + bh), 0.9])
        cy, cx = y1 + bh // 2, x1 + bw // 2
        r = min(bw, bh) * 3 // 8
        y_lo, y_hi = max(cy - r, 0), min(cy + r, height)
        x_lo, x_hi = max(cx - r, 0), min(cx + r, width)
        yy, xx = np.mgrid[y_lo:y_hi, x_lo:x_hi]
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        patch = img[y_lo:y_hi, x_lo:x_hi]
        patch[d2 < r * r] = (170, 110, 150)
        patch[d2 < (r // 2) ** 2] = (140, 80, 120)
    return NumpySlide(img), boxes


def write_checkpoints(folder: Path, classes: int, p: int, q: int):
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for fold in range(1, 6):
        path = folder / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, classes, p, q), path)
        paths.append(str(path))
    return paths


def segment(ensemble, slide, boxes):
    """One timed segment_slide; returns (canvas, seconds, (K1 launches, K2
    launches))."""
    seg = FusedSlideSegmenter(ensemble)
    torch.cuda.synchronize()
    esp_block_fused.launches = esp_block_padded.launches = 0
    t0 = time.perf_counter()
    canvas = seg.segment_slide(slide, boxes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return canvas, seconds, (esp_block_fused.launches,
                             esp_block_padded.launches)


def check_canvas(canvas, slide, boxes, classes: int, label: str) -> None:
    width, height = slide.dimensions
    check(canvas.shape == (height // 8, width // 8),
          f"{label}: canvas shape {canvas.shape}")
    check(int(canvas.max()) < classes, f"{label}: canvas max {canvas.max()}")
    check(outside_boxes_is_background(canvas, boxes),
          f"{label}: canvas has labels outside every box")


def _kernel_group(name: str) -> str:
    if "esp_dma_reduce_kernel" in name or "esp_dma_branch_kernel" in name:
        return "K2 esp_block_dma"
    if "esp_reduce_kernel" in name or "esp_branch_kernel" in name:
        return "K1 esp_block"
    if "nms_kernel" in name:
        return "K3 nms"
    low = name.lower()
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copies"
    # cuDNN's convolutions; cuBLAS (nvjet, cutlass) runs some 1x1 convs and
    # the box head's Linear layers
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm",
                              "dgrad", "wgrad", "winograd", "fft", "nvjet",
                              "cutlass")):
        return "cuDNN/cuBLAS conv"
    if "index" in low or "gather" in low:
        return "gathers"
    return "other (elementwise, sort, softmax, argmax)"


def trace(fn) -> dict:
    """One traced run of ``fn()``, apart from the timed runs: device time
    by kernel group and the device's idle share of the traced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (us / 1e3, e.count)
        elif e.key.startswith("aten::") and us > 0:
            # device time of the kernels this operator launched itself
            ops[e.key] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        group = _kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "groups_ms": groups,
            "top": [[name[:90], ms, count] for name, (ms, count) in top],
            "top_ops": [[name, ms, count] for name, (ms, count) in top_ops]}


def print_trace(title: str, prof: dict, name_power: str) -> None:
    print(f"profile {title} (traced run): wall {prof['wall_ms']:.1f} ms, "
          f"device busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; by group (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(prof["groups_ms"].items(), key=lambda kv: -kv[1]))
          + f" | {name_power}")
    for kname, ms, count in prof["top"]:
        print(f"  {ms:9.2f} ms {count:6d}x  {kname}")
    print("  by the operator that launched the kernels: " + ", ".join(
        f"{name} {ms:.2f} ms/{count}" for name, ms, count in prof["top_ops"]))


def conv_flops(model, images, anchors) -> float:
    """Operations of every convolution and linear layer in one detect call,
    counted from the shapes they see (2 per multiply-add)."""
    total = [0]

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            k = module.in_channels // module.groups * \
                module.kernel_size[0] * module.kernel_size[1]
        else:
            k = module.in_features
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        model.detect(images, anchors)
    finally:
        for h in handles:
            h.remove()
    return float(total[0])


def outside_boxes_is_background(canvas, boxes) -> bool:
    mask = np.zeros(canvas.shape, bool)
    for x1, y1, x2, y2, _ in boxes:
        mask[y1 // 8: y2 // 8, x1 // 8: x2 // 8] = True
    return bool((canvas[~mask] == 0).all())


# ---------------- the packed engine ----------------
def packed_phase(config, fused, slide, boxes, fused_canvas,
                 name_power: str) -> int:
    """The fold-packed engine on the bf16 slide, with the plain level 2
    (``gseg-e2e``'s default) and with K2, timed in turns with the fused
    engine; launch counts and canvases checked; both packed forms traced.
    Returns K2's launches in its timed run."""
    bs = config.batch_size
    n_batches = math.ceil(len(boxes) / bs)
    want_k1 = config.q * len(config.folds) * n_batches
    want_k2 = config.p * n_batches
    engines = {"fused": fused,
               "packed": EnsembleSegmenter(config, engine="packed"),
               "packed K2": EnsembleSegmenter(config, engine="packed",
                                              fuse_level2=True)}
    check(engines["packed"].fuse_level3 and engines["packed K2"].fuse_level2
          and not engines["packed"].fuse_level2, "packed engine options")
    for name in ("packed", "packed K2"):
        segment(engines[name], slide, boxes[:bs])  # warm-up
    secs, peak, counts, canvases = {}, {}, {}, {}
    for name in ("fused", "packed", "packed K2", "packed K2", "packed",
                 "fused"):
        torch.cuda.reset_peak_memory_stats()
        out, t, n = segment(engines[name], slide, boxes)
        peak[name] = max(peak.get(name, 0.0),
                         torch.cuda.max_memory_allocated() / 1e9)
        check_canvas(out, slide, boxes, config.classes, name)
        want = (want_k1, want_k2 if name == "packed K2" else 0)
        if name != "fused":
            check(n == want, f"{name}: (K1, K2) launched {n}, want {want}")
        secs.setdefault(name, []).append(t)
        counts[name] = n
        canvases.setdefault(name, out)
    for name, ts in secs.items():
        med = float(np.median(ts))
        print(f"slice bf16 batch {bs}, engine {name}: s/slide in turns "
              + ", ".join(f"{t:.4f}" for t in ts)
              + f" (median {med:.4f}, {len(boxes) / med:.2f} crops/s); "
              f"(K1, K2) launches {counts[name]}; peak memory "
              f"{peak[name]:.3f} GB; canvas pixels equal to the fused "
              f"engine's first run {(canvases[name] == fused_canvas).mean():.6f}"
              f" | {name_power}", flush=True)
    for name in ("packed", "packed K2"):
        ens = engines[name]
        print_trace(f"bf16 slide, engine {name}", trace(
            lambda: FusedSlideSegmenter(ens).segment_slide(slide, boxes)),
            name_power)
    return counts["packed K2"][1]


def packed_f32_phase(config, slide, boxes, fused_canvas,
                     name_power: str) -> None:
    """f32 "highest": the packed canvases with K2 and with the plain level 2
    must agree; the packed-against-fused agreement is printed."""
    n_batches = math.ceil(len(boxes) / config.batch_size)
    runs = {}
    for fuse_level2 in (False, True):
        ens = EnsembleSegmenter(config, engine="packed",
                                fuse_level2=fuse_level2)
        out, t, n = segment(ens, slide, boxes)
        del ens
        want = (config.q * len(config.folds) * n_batches,
                config.p * n_batches if fuse_level2 else 0)
        check(n == want, f"packed f32: (K1, K2) launched {n}, want {want}")
        check_canvas(out, slide, boxes, config.classes, "packed f32")
        runs[fuse_level2] = (out, t)
    same = float((runs[True][0] == runs[False][0]).mean())
    vs_fused = float((runs[False][0] == fused_canvas).mean())
    print(f"packed f32 highest: K2 {runs[True][1]:.4f} s/slide, plain level "
          f"2 {runs[False][1]:.4f} s/slide; equal canvas pixels K2 vs plain "
          f"level 2 {same:.6f}, packed vs fused engine {vs_fused:.6f} of "
          f"{fused_canvas.size} | {name_power}", flush=True)
    check(same >= 0.999, f"f32 packed K2/plain canvases agree on {same}")


# ---------------- kernel K3: greedy NMS ----------------
def seeded_nms_problem(seed: int, p: int, n: int):
    """P sets of N overlapping boxes in a 1104-px window; scores on a grid
    of 1/256, so equal scores are common and the tie order is exercised."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, DET_WINDOW_PX, (p, n, 2))
    sizes = rng.uniform(16, 400, (p, n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    scores = np.round(rng.uniform(0, 1, (p, n)) * 256) / 256
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda())


def nms_case(boxes, scores, k: int, thr: float,
             score_threshold: float = float("-inf")) -> dict:
    """K3 against nms_plain on one batch of problems: equal indices and
    counts; both timed in turns; the bound from what this input needs."""
    p, n = scores.shape
    idx, num = nms(boxes, scores, k, thr, score_threshold)
    torch.cuda.synchronize()
    masked = premask(scores, score_threshold)
    want_idx, want_num = nms_plain(boxes, masked, k, thr)
    torch.cuda.synchronize()
    check(torch.equal(idx, want_idx) and torch.equal(num, want_num),
          f"K3 ({p}, {n}) -> {k}: indices differ from nms_plain at "
          f"{int((idx != want_idx).sum())} of {idx.numel()} slots")
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "kernel":
            times[name].append(cuda_ms(
                lambda: nms(boxes, scores, k, thr, score_threshold)))
        else:
            times[name].append(cuda_ms(
                lambda: nms_plain(boxes, masked, k, thr), iters=5))
    valid = num.long().cpu()
    # a step that emits a box runs the whole IoU pass; the step that finds
    # no live box (when fewer than k are emitted) only the argmax
    ops = int((valid * n * K3_OPS_PER_BOX + (valid < k).long() * n).sum())
    nbytes = p * n * (16 + 4) + p * k * 4 + p * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return {"shape": [p, n, k, thr], "emitted": valid.tolist(),
            "max_abs_err": float((idx - want_idx).abs().max()),
            "ms": float(np.mean(times["kernel"])),
            "plain_ms": float(np.mean(times["plain"])),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kbytes": nbytes / 1e3, "mops": ops / 1e6}


def print_nms_case(label: str, r: dict, name_power: str) -> None:
    p, n, k, thr = r["shape"]
    print(f"K3 nms {label} ({p}, {n}) -> {k} IoU {thr}: indices and counts "
          f"equal to nms_plain, emitted {min(r['emitted'])}.."
          f"{max(r['emitted'])}; kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.2f} us by "
          f"{r['bound_by']} ({r['kbytes']:.1f} kB, {r['mops']:.1f} M ops); "
          f"library: no single PyTorch call computes greedy NMS | "
          f"{name_power}", flush=True)


# ---------------- the detector slice ----------------
class PyramidStub:
    """An in-memory slide whose pyramid holds level 3 only (downsample 8,
    RGB uint8); level 0 is 8x its size.  Pixels outside read white."""

    def __init__(self, level3: np.ndarray):
        self.level3 = level3
        self.level_count = 4
        self.level_downsamples = (1.0, 2.0, 4.0, 8.0)
        self.dimensions = (level3.shape[1] * 8, level3.shape[0] * 8)
        self.properties = {"openslide.mpp-x": str(DET_MPP),
                           "openslide.mpp-y": str(DET_MPP),
                           "openslide.objective-power": "40"}

    def read_region_array(self, location, level, size):
        check(level == 3, "PyramidStub has level 3 only")
        x0, y0 = int(location[0] / 8), int(location[1] / 8)
        (w, h), img = size, self.level3
        out = np.full((h, w, 3), 255, np.uint8)
        xs, ys = max(x0, 0), max(y0, 0)
        xe, ye = min(x0 + w, img.shape[1]), min(y0 + h, img.shape[0])
        if xe > xs and ye > ys:
            out[ys - y0: ye - y0, xs - x0: xe - x0] = img[ys:ye, xs:xe]
        return out


def pyramid_slide(seed: int) -> PyramidStub:
    """A seeded PAS-like level 3: pink noise, dark round glomerulus-sized
    blobs (radius 30 to 80 px at 1.8 um/px)."""
    rng = np.random.RandomState(seed)
    h, w = DET_LEVEL3_HW
    img = np.empty((h, w, 3), np.uint8)
    for row in range(0, h, 512):
        band = img[row: row + 512]
        noise = rng.randint(-12, 12, band.shape, dtype=np.int16)
        band[:] = np.clip(noise + np.asarray((230, 205, 215), np.int16),
                          0, 255)
    for _ in range(60):
        r = int(rng.randint(30, 81))
        cy, cx = int(rng.randint(r, h - r)), int(rng.randint(r, w - r))
        yy, xx = np.mgrid[-r:r, -r:r]
        patch = img[cy - r: cy + r, cx - r: cx + r]
        patch[yy ** 2 + xx ** 2 < r * r] = (170, 110, 150)
        patch[yy ** 2 + xx ** 2 < (r // 2) ** 2] = (140, 80, 120)
    return PyramidStub(img)


class RecordingBackend:
    """Forwards the async pair to a backend and keeps what it reads."""

    def __init__(self, backend):
        self.backend = backend
        self.batch_size = backend.batch_size
        self.results = []

    def detect_batch_submit(self, images):
        return self.backend.detect_batch_submit(images)

    def read_detections(self, handle):
        result = self.backend.read_detections(handle)
        self.results.append(result)
        return result


def check_detections(results, max_detections: int) -> int:
    """The frozen-graph output contract; returns the number of detections."""
    total = 0
    for boxes, scores, classes, num in results:
        check(bool(np.isfinite(boxes).all() and np.isfinite(scores).all()),
              "non-finite detections")
        check(bool((boxes >= 0).all() and (boxes <= 1).all()),
              "boxes outside [0, 1]")
        check(bool((boxes[..., 0] <= boxes[..., 2]).all()
                   and (boxes[..., 1] <= boxes[..., 3]).all()),
              "a box with ymin > ymax or xmin > xmax")
        check(bool((np.diff(scores, axis=1) <= 0).all()),
              "scores not sorted descending")
        check(bool((num <= max_detections).all() and (num >= 0).all()),
              f"num_detections {num}")
        check(bool((classes == 1).all()), "a class other than 1")
        total += int(num.sum())
    return total


def scan(detector, backend, slide, path: Path):
    """One timed scan_slide; returns (seconds, K3 launches, CSV rows)."""
    torch.cuda.synchronize()
    nms.launches = 0
    t0 = time.perf_counter()
    with open(path, "w") as out:
        detector.scan_slide(backend, slide, "smoke", "S1", "S1.ndpi", out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, nms.launches, len(path.read_text().splitlines())


def detector_phases(name_power: str):
    """K3 against its plain version, the detector slice at full width, the
    f32 kernel/plain comparison and a traced batch.  Returns (the K3
    cases, K3 launches of the timed scan)."""
    # ---- the detector: weights, one window batch, K3 against plain ----
    det_cfg = FasterRCNNConfig()
    t0 = time.perf_counter()
    det_state = random_detector_state(0, det_cfg)
    print(f"detector: ResNet-50-C4 Faster R-CNN, {det_cfg}; random weights "
          f"(seed 0), BN calibrated on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    backend = TorchDetectorBackend(det_state, det_cfg, batch_size=DET_BATCH)
    slide3 = pyramid_slide(seed=1)
    step = int(DET_WINDOW_UM / DET_MPP * (1 - DET_OVERLAP))
    images = np.stack([
        slide3.read_region_array((step * i, step * j), 3,
                                 (DET_WINDOW_PX, DET_WINDOW_PX))
        for j in range(2) for i in range(5)][:DET_BATCH])
    backend.detect_batch(images)  # warm-up, not counted
    model = backend.model.with_image_size(DET_WINDOW_PX, DET_WINDOW_PX)
    anchors = build_anchors(model.config).cuda()
    with torch.no_grad():
        out = model(torch.from_numpy(images).cuda(), anchors)
        rpn_boxes, rpn_scores = model.rpn_candidates(
            out["rpn_objectness"], out["rpn_deltas"], anchors)
        cand_boxes, cand_scores = model.detection_candidates(
            out["proposals"], out["class_scores"], out["box_deltas"])
    del out
    check(tuple(rpn_scores.shape) == K3_SHAPES["rpn"][:2]
          and tuple(cand_scores.shape) == K3_SHAPES["second"][:2],
          f"NMS problems {tuple(rpn_scores.shape)}, "
          f"{tuple(cand_scores.shape)}")
    k3 = {}
    for label, (p_, n_, k_, thr) in K3_SHAPES.items():
        k3[f"{label} seeded"] = nms_case(*seeded_nms_problem(7, p_, n_),
                                         k_, thr)
    k3["rpn proposals"] = nms_case(rpn_boxes, rpn_scores,
                                   det_cfg.post_nms_top_n,
                                   det_cfg.rpn_nms_threshold)
    k3["second candidates"] = nms_case(cand_boxes, cand_scores,
                                       det_cfg.max_detections,
                                       det_cfg.second_nms_threshold,
                                       det_cfg.score_threshold)
    # the frozen-graph backend's pre_nms_top_n (not on this path yet)
    k3["6000 seeded"] = nms_case(*seeded_nms_problem(8, 2, 6000), 300, 0.7)
    for label, r in k3.items():
        print_nms_case(label, r, name_power)

    # ---- the detector slice at full width, bf16 ----
    detector = GlomusDetector(
        "OPT_PAS", "", str(WORK), str(WORK / "detect"), "_smoke",
        window_size=DET_WINDOW_UM, overlap_ratio=DET_OVERLAP,
        # random weights carry no confidence: every detection is written
        conf_threshold=0.0, batch_size=DET_BATCH)
    recorder = RecordingBackend(backend)
    torch.cuda.reset_peak_memory_stats()
    det_s, det_launches, det_rows = scan(detector, recorder, slide3,
                                         WORK / "detect_kernel.csv")
    det_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    geometry = detector.calc_window_size()
    check(geometry[2:] == (5, 4, DET_WINDOW_PX, DET_WINDOW_PX),
          f"window geometry {geometry}")
    n_windows = geometry[2] * geometry[3]
    det_batches = math.ceil(n_windows / DET_BATCH)
    check(len(recorder.results) == det_batches,
          f"{len(recorder.results)} batches read, want {det_batches}")
    check(det_launches == 2 * det_batches,
          f"K3 launched {det_launches} times, want {2 * det_batches}")
    n_det = check_detections(recorder.results, det_cfg.max_detections)
    top = max(float(r[1].max()) for r in recorder.results)
    print(f"detector slice bf16 batch {DET_BATCH}: {n_windows} windows of "
          f"{DET_WINDOW_PX}x{DET_WINDOW_PX} in {det_batches} batches, "
          f"{det_s:.4f} s/slide, {n_windows / det_s:.2f} windows/s, K3 "
          f"launches {det_launches}, peak memory {det_peak_gb:.3f} GB, "
          f"{n_det} detections (top score {top:.4f}), {det_rows} CSV rows | "
          f"{name_power}", flush=True)
    check(n_det > 0 and det_rows > 0, "no detections")
    plain_backend = TorchDetectorBackend(det_state, det_cfg,
                                         batch_size=DET_BATCH,
                                         kernel_nms=False)
    plain_backend.detect_batch(images)  # warm-up
    turns = {"kernel": [det_s], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        secs, n_launch, _ = scan(
            detector, backend if name == "kernel" else plain_backend, slide3,
            WORK / f"detect_{name}.csv")
        check(n_launch == (det_launches if name == "kernel" else 0),
              f"{name} scan launched K3 {n_launch} times")
        turns[name].append(secs)
    same_rows = [ln.split(",")[5:] for ln in (
        WORK / "detect_kernel.csv").read_text().splitlines()] == \
        [ln.split(",")[5:] for ln in (
            WORK / "detect_plain.csv").read_text().splitlines()]
    print("detector slice bf16 s/slide in turns: K3 "
          + ", ".join(f"{s_:.4f}" for s_ in turns["kernel"])
          + f" (median {np.median(turns['kernel']):.4f}); plain NMS "
          + ", ".join(f"{s_:.4f}" for s_ in turns["plain"])
          + f" (median {np.median(turns['plain']):.4f}); CSV boxes and "
          f"scores equal: {same_rows} | {name_power}", flush=True)
    del plain_backend

    # ---- f32, TF32 off: detections with and without K3 are identical ----
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    f32_runs = {}
    for kernel_nms in (True, False):
        b32 = TorchDetectorBackend(det_state, det_cfg, batch_size=DET_BATCH,
                                   compute_dtype="float32",
                                   kernel_nms=kernel_nms)
        nms.launches = 0
        t0 = time.perf_counter()
        f32_runs[kernel_nms] = b32.detect_batch(images)
        f32_runs[kernel_nms] += (time.perf_counter() - t0, nms.launches)
        del b32
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = saved
    same = all(np.array_equal(a, b) for a, b in
               zip(f32_runs[True][:4], f32_runs[False][:4]))
    print(f"detector f32 (TF32 off), one batch of {DET_BATCH}: K3 "
          f"{f32_runs[True][4]:.4f} s ({f32_runs[True][5]} launches), plain "
          f"NMS {f32_runs[False][4]:.4f} s ({f32_runs[False][5]} launches); "
          f"detections identical: {same}; detections per window "
          f"{f32_runs[True][3].astype(int).tolist()} | {name_power}",
          flush=True)
    check(f32_runs[True][5] == 2 and f32_runs[False][5] == 0,
          "f32 launch counts")
    check(same, "f32 detections differ with and without K3")

    prof = trace(lambda: backend.detect_batch(images))
    print_trace(f"bf16 detector batch ({DET_BATCH} windows)", prof,
                name_power)
    flops = conv_flops(model, torch.from_numpy(images).cuda(), anchors)
    conv_ms = prof["groups_ms"].get("cuDNN/cuBLAS conv", 0.0)
    rate = f"{flops / conv_ms / 1e9:.1f} TFLOP/s" if conv_ms else \
        "no convolution time traced"
    print(f"detector convolutions and linear layers: {flops / 1e12:.3f} "
          f"TFLOP per batch of {DET_BATCH}; at the traced {conv_ms:.2f} ms "
          f"{rate} | {name_power}", flush=True)
    return k3, det_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    name_power = card()
    print(name_power)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    # ---- build ----
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {_build.SOURCES}")
    for src, (seconds, log) in _build.build_log.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  nvcc {src}.cu {seconds:.2f} s: " + " | ".join(lines))

    # ---- kernels K1 and K2 against their plain versions ----
    classes, p, q = 5, 2, 8
    sd = random_state_dict(1, classes, p, q)
    ckpts = write_checkpoints(WORK / "folds", classes, p, q)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_ops = [torch.from_numpy(v) for v in
              pack_esp_weights(sd, "encoder.level3.0.")]
    # K2's operands: the first block of the packed level 2 of the 5 folds
    packed_f32 = PackedEnsembleESPNet(
        [load_espnet_state_dict(c) for c in ckpts],
        [FOLD_NORMALIZATION[f][0] for f in range(1, 6)],
        [FOLD_NORMALIZATION[f][1] for f in range(1, 6)],
        fuse_level2=True, dtype=torch.float32)
    k2_ops = [t.cpu() for t in packed_f32.level2_kernel[0]]
    k2_channels = k2_ops[0].shape[0]
    del packed_f32
    k1, k2 = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(K1_SHAPE, generator=gen, device="cuda").to(dtype)
        k1[dtype] = block_case("K1", esp_block_fused, esp_block_plain, x,
                               k1_ops, math.prod(K1_SHAPE[:3]))
        print_block_case("K1 esp_block_fused", k1[dtype], name_power)
        x = esp_pad_io(torch.randn(K2_SHAPE, generator=gen, device="cuda")
                       .to(dtype))
        check(tuple(x.shape) == K2_PADDED, f"K2 input {tuple(x.shape)}")
        k2[dtype] = block_case(
            "K2", esp_block_padded, esp_block_padded_plain, x, k2_ops,
            math.prod(K2_SHAPE[:3]),
            after=lambda y: check_zero_padding(y, k2_channels))
        print_block_case("K2 esp_block_padded", k2[dtype], name_power)
        del x
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    # ---- the main path: 5-fold slide segmentation at full width ----
    slide, boxes = synthetic_slide(seed=0, height=6144, width=8192,
                                   n_boxes=80, box_min=256, box_max=1200)
    batch = 32
    n_batches = math.ceil(len(boxes) / batch)
    config = EnsembleConfig(checkpoints=ckpts, classes=classes, p=p, q=q,
                            batch_size=batch)
    ensemble = EnsembleSegmenter(config, engine="fused")
    check(ensemble.fuse_level3, "batch 32 must take the kernel path")
    segment(ensemble, slide, boxes[:batch])  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    canvas, seconds, (launches, _) = segment(ensemble, slide, boxes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = q * 5 * n_batches
    check(launches == want, f"K1 launched {launches} times, want {want}")
    check_canvas(canvas, slide, boxes, classes, "fused bf16")
    print(f"slice bf16 batch {batch}: {len(boxes)} crops in {n_batches} "
          f"batches, {seconds:.4f} s/slide, {len(boxes) / seconds:.2f} "
          f"crops/s, K1 launches {launches}, peak memory {peak_gb:.3f} GB, "
          f"classes present {np.unique(canvas).tolist()} | {name_power}",
          flush=True)

    # the same slide with level 3 on plain torch ops, in turns with the
    # kernel path: plain, kernel, kernel, plain
    plain_l3 = EnsembleSegmenter(config, fuse_level3=False)
    segment(plain_l3, slide, boxes[:batch])  # warm-up
    turns = {"kernel": [seconds], "plain": []}
    same = {"kernel": [], "plain": []}
    for name in ("plain", "kernel"):
        ens = ensemble if name == "kernel" else plain_l3
        out, secs, _ = segment(ens, slide, boxes)
        turns[name].append(secs)
        same[name].append(float((out == canvas).mean()))
    print("slice bf16 s/slide in turns: kernel path "
          + ", ".join(f"{s:.4f}" for s in turns["kernel"])
          + f" (median {np.median(turns['kernel']):.4f}); plain level 3 "
          + ", ".join(f"{s:.4f}" for s in turns["plain"])
          + f" (median {np.median(turns['plain']):.4f}); canvas pixels equal "
          f"to the first kernel run: kernel {min(same['kernel']):.6f}, plain "
          f"{min(same['plain']):.6f} | {name_power}", flush=True)
    del plain_l3
    print_trace("bf16 slide", trace(
        lambda: FusedSlideSegmenter(ensemble).segment_slide(slide, boxes)),
        name_power)
    k2_launches = packed_phase(config, ensemble, slide, boxes, canvas,
                               name_power)
    del ensemble

    # ---- f32 "highest": kernel paths against their plain versions ----
    f32 = EnsembleConfig(checkpoints=ckpts, classes=classes, p=p, q=q,
                         batch_size=batch, compute_dtype="float32",
                         precision="highest")
    with_kernel, t_k, (n_k, _) = segment(EnsembleSegmenter(f32), slide,
                                         boxes)
    plain, t_p, (n_p, _) = segment(EnsembleSegmenter(f32, fuse_level3=False),
                                   slide, boxes)
    check(n_k == want and n_p == 0, f"f32 launches {n_k}/{n_p}")
    same_kp = float((with_kernel == plain).mean())
    same_bf = float((with_kernel == canvas).mean())
    print(f"slice f32 highest: kernel path {t_k:.4f} s/slide "
          f"({len(boxes) / t_k:.2f} crops/s), plain level 3 {t_p:.4f} s "
          f"({len(boxes) / t_p:.2f} crops/s); equal canvas pixels kernel vs "
          f"plain {same_kp:.6f}, bf16 vs f32 {same_bf:.6f} of "
          f"{canvas.size} | {name_power}", flush=True)
    check(same_kp >= 0.999, f"f32 kernel/plain canvases agree on {same_kp}")
    packed_f32_phase(f32, slide, boxes, with_kernel, name_power)

    # ---- fused model against the plain nn.Module on a small input ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = create_espnet(classes, p, q).cuda().eval()
    net.load_state_dict(sd, strict=True)
    x = torch.randn(2, 3, 128, 256, generator=torch.Generator()
                    .manual_seed(3)).cuda() / 255
    with torch.no_grad():
        want_logits = net(x)
    got_logits = FusedESPNet(sd)(x)
    diff = (got_logits - want_logits).abs().max().item()
    same = (got_logits.argmax(1) == want_logits.argmax(1)).float().mean()
    print(f"FusedESPNet (K1) vs plain ESPNet, f32, (2, 3, 128, 256): max abs "
          f"logit diff {diff:.3e}, argmax agreement {same.item():.6f}")
    check(diff < 1e-3 and same.item() >= 0.999, "fused model disagrees")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    k3, det_launches = detector_phases(name_power)

    def esp_entry(name, source, replaces, r, n_launch):
        bf16, f32r = r[torch.bfloat16], r[torch.float32]
        return {
            "name": name, "route": "cuda",
            "source": f"glomeruli_segmentation_tpu_torch/csrc/{source}",
            "replaces": f"glomeruli_segmentation_tpu/ops/pallas/{replaces}",
            "launches": n_launch, "max_abs_err": bf16["max_abs_err"],
            "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
            "library_ms": None, "dtype": "bfloat16", "shape": bf16["shape"],
            "f32": {k: f32r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}}

    k3_main = k3["rpn seeded"]
    print(json.dumps({"kernels": [
        esp_entry("esp_block_fused", "esp_block.cu",
                  "esp_block.py:72 (_esp_kernel)", k1, launches),
        esp_entry("esp_block_padded", "esp_block_dma.cu",
                  "esp_block.py:167 (_esp_kernel_dma)", k2, k2_launches),
        {"name": "nms", "route": "cuda",
         "source": "glomeruli_segmentation_tpu_torch/csrc/nms.cu",
         "replaces": "glomeruli_segmentation_tpu/ops/pallas/nms_pallas.py:27 "
                     "(_nms_kernel)",
         "launches": det_launches,
         "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": None, "dtype": "float32",
         "shape": k3_main["shape"],
         "cases": {label: {k: r[k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by")}
             for label, r in k3.items()}},
    ]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
