"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 switches;
2. builds every kernel of the port from ``glomeruli_segmentation_tpu_torch/
   csrc`` (one ``nvcc`` per source, all at once) into build/torch_kernels/;
3. holds each kernel against its plain PyTorch version at the main path's
   shapes, in float32 with TF32 off and in bfloat16, and times both;
4. drives the main path at full width -- the 5-fold ESPNet slide segmenter
   (5 classes, p=2, q=8, 512x1024 network input, crop batch 32, bf16) on
   a seeded synthetic slide with random seeded weights -- with the kernel
   launch counts set to 0 just before and read just after; then runs the
   f32 "highest" path with and without the kernel, and the fused model
   against the plain ``nn.Module`` ESPNet on a small input;
5. prints one JSON line of kernel results and, last, one JSON status line.

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

from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.espnet import create_espnet
from glomeruli_segmentation_tpu_torch.models.espnet_fused import FusedESPNet
from glomeruli_segmentation_tpu_torch.ops import _build
from glomeruli_segmentation_tpu_torch.ops.esp_block import (
    esp_block_fused,
    esp_block_plain,
    pack_esp_weights,
)
from glomeruli_segmentation_tpu_torch.pipeline.fused import (
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


# ---------------- kernel K1: fused ESP block ----------------
def esp_block_case(dtype, sd, seed: int = 0) -> dict:
    """K1 against esp_block_plain at the main-path shape, in ``dtype``."""
    b, h, w, c = K1_SHAPE
    w1, wd, scale, bias, alpha = pack_esp_weights(sd, "encoder.level3.0.")
    n, n_pad = w1.shape[1], wd.shape[2]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(K1_SHAPE, generator=gen).to("cuda", dtype)
    args = (x, torch.from_numpy(w1).to("cuda", dtype),
            torch.from_numpy(wd).to("cuda", dtype),
            *(torch.from_numpy(v).cuda() for v in (scale, bias, alpha)))
    y = esp_block_fused(*args)
    torch.cuda.synchronize()
    ref = esp_block_plain(*args)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOLERANCE[dtype]
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    check(bool(torch.isfinite(y).all()), f"K1 {dtype}: non-finite output")
    check(bad == 0, f"K1 {dtype}: {bad} values outside atol {atol} rtol "
                    f"{rtol} (max abs err {err.max().item():.3e})")
    # plain, kernel, kernel, plain: one card, in turns
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = esp_block_plain if name == "plain" else esp_block_fused
        times[name].append(cuda_ms(lambda: fn(*args)))
    size = x.element_size()
    nbytes = (2 * x.numel() + w1.size + wd.size) * size + 3 * c * 4
    # 1x1 reduce C->n, then 9n-deep products into n1 + 4n = C outputs
    ops = 2 * b * h * w * (c * n + 9 * n * c)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err.max().item(),
            "max_rel_err": (err / ref.float().abs().clamp_min(1e-3)).max()
            .item(), "tolerance": [atol, rtol],
            "ms": float(np.mean(times["kernel"])),
            "plain_ms": float(np.mean(times["plain"])),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "gbytes": nbytes / 1e9, "gflop": ops / 1e9, "n_pad": n_pad}


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
    """One timed segment_slide; returns (canvas, seconds, K1 launches)."""
    seg = FusedSlideSegmenter(ensemble)
    torch.cuda.synchronize()
    esp_block_fused.launches = 0
    t0 = time.perf_counter()
    canvas = seg.segment_slide(slide, boxes)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return canvas, seconds, esp_block_fused.launches


def _kernel_group(name: str) -> str:
    if "esp_reduce_kernel" in name or "esp_branch_kernel" in name:
        return "K1 esp_block"
    low = name.lower()
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copies"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm",
                              "dgrad", "wgrad", "winograd", "fft")):
        return "cuDNN conv"
    return "other (elementwise, gathers, softmax, argmax)"


def profile_slide(ensemble, slide, boxes) -> dict:
    """One traced segment_slide, apart from the timed runs: device time by
    kernel group and the device's idle share of the traced wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seg = FusedSlideSegmenter(ensemble)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        seg.segment_slide(slide, boxes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups = {}
    for name, (ms, _) in kernels.items():
        group = _kernel_group(name)
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "groups_ms": groups,
            "top": [[name[:90], ms, count] for name, (ms, count) in top]}


def outside_boxes_is_background(canvas, boxes) -> bool:
    mask = np.zeros(canvas.shape, bool)
    for x1, y1, x2, y2, _ in boxes:
        mask[y1 // 8: y2 // 8, x1 // 8: x2 // 8] = True
    return bool((canvas[~mask] == 0).all())


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

    # ---- kernel K1 against its plain version ----
    classes, p, q = 5, 2, 8
    sd = random_state_dict(1, classes, p, q)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    k1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        r = k1[dtype] = esp_block_case(dtype, sd)
        print(f"K1 esp_block_fused {r['dtype']} {K1_SHAPE}: max abs err "
              f"{r['max_abs_err']:.3e} max rel err {r['max_rel_err']:.3e} "
              f"(tolerance atol {r['tolerance'][0]} rtol "
              f"{r['tolerance'][1]}); kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.1f} us "
              f"by {r['bound_by']} ({r['gbytes']:.3f} GB, {r['gflop']:.2f} "
              f"GFLOP); library: no single PyTorch call computes the block "
              f"| {name_power}", flush=True)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = tf32

    # ---- the main path: 5-fold slide segmentation at full width ----
    ckpts = write_checkpoints(WORK / "folds", classes, p, q)
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
    canvas, seconds, launches = segment(ensemble, slide, boxes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    height, width = slide.dimensions[1], slide.dimensions[0]
    want = 8 * 5 * n_batches
    check(launches == want, f"K1 launched {launches} times, want {want}")
    check(canvas.shape == (height // 8, width // 8),
          f"canvas shape {canvas.shape}")
    check(int(canvas.max()) < classes, f"canvas max {canvas.max()}")
    check(outside_boxes_is_background(canvas, boxes),
          "canvas has labels outside every box")
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
    for name in ("plain", "kernel", "kernel", "plain"):
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
    prof = profile_slide(ensemble, slide, boxes)
    print(f"profile bf16 slide (traced run): wall {prof['wall_ms']:.1f} ms, "
          f"device busy {prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}; by group (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in
                      sorted(prof["groups_ms"].items(), key=lambda kv: -kv[1]))
          + f" | {name_power}")
    for kname, ms, count in prof["top"]:
        print(f"  {ms:9.2f} ms {count:6d}x  {kname}")
    del ensemble, plain_l3

    # ---- f32 "highest": kernel path against the plain level 3 ----
    f32 = EnsembleConfig(checkpoints=ckpts, classes=classes, p=p, q=q,
                         batch_size=batch, compute_dtype="float32",
                         precision="highest")
    with_kernel, t_k, n_k = segment(EnsembleSegmenter(f32), slide, boxes)
    plain, t_p, n_p = segment(EnsembleSegmenter(f32, fuse_level3=False),
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

    bf16 = k1[torch.bfloat16]
    f32r = k1[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "esp_block_fused", "route": "cuda",
        "source": "glomeruli_segmentation_tpu_torch/csrc/esp_block.cu",
        "replaces": "glomeruli_segmentation_tpu/ops/pallas/esp_block.py:72 "
                    "(_esp_kernel)",
        "launches": launches, "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": None, "dtype": "bfloat16", "shape": list(K1_SHAPE),
        "f32": {k: f32r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
    }]}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
