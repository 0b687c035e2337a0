"""Time the default packed slide of two checkouts of the port in turns.

    python3 slide_turns.py CHECKOUT_A CHECKOUT_B [--slides 3]

Runs four processes, A, B, B, A, one after the other.  Each imports the
port and the smoke helpers of its own checkout (that checkout's
``chip_smoke.py``: ``synthetic_slide``, ``write_checkpoints``, ``segment``,
``trace``, ``scan``, ``pyramid_slide`` and the detector's names), so two
versions of the package never share a process.  Each builds the kernels
in its checkout and times three scans of the smoke's ResNet-50-C4
detector (bf16, K3); warms up ``EnsembleSegmenter(engine="packed")``
(what ``gseg-e2e`` runs at crop batch 32) on the smoke slide of
``chip_smoke.py`` (80 crops, bf16), times ``--slides`` slides, traces one
more, and times the host's parts of one more (slide reads and flat
packing on the producer thread, submits and result reads on the main
thread); then times three detector scans again, so that what the slides
leave in the process shows on the other path.  It prints one JSON line.
The last lines are a summary per checkout (s/slide of every slide and
scan in turn order, their medians, the traced idle share and copy time,
the host's parts, and whether the canvases of both checkouts are
byte-identical), each with the card's name and power limit.  Needs a
CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(root: str, slides: int) -> None:
    sys.path.insert(0, root)
    import chip_smoke as cs  # this checkout's own
    from glomeruli_segmentation_tpu_torch.pipeline.fused import (
        EnsembleConfig, EnsembleSegmenter, FusedSlideSegmenter)

    for module in (cs, sys.modules["glomeruli_segmentation_tpu_torch"]):
        if not Path(module.__file__).resolve().is_relative_to(
                Path(root).resolve()):
            raise RuntimeError(f"{module.__name__} from {module.__file__}, "
                               f"not {root}")
    slide, boxes = cs.synthetic_slide(seed=0, height=6144, width=8192,
                                      n_boxes=80, box_min=256, box_max=1200)
    det_fresh = detector_scans(cs, 3)
    config = EnsembleConfig(
        checkpoints=cs.write_checkpoints(cs.WORK / "folds", 5, 2, 8),
        classes=5, p=2, q=8, batch_size=32)
    ensemble = EnsembleSegmenter(config, engine="packed")
    cs.segment(ensemble, slide, boxes[:32])  # warm-up, kernels built
    secs, canvas = [], None
    for _ in range(slides):
        canvas, seconds, _ = cs.segment(ensemble, slide, boxes)
        secs.append(seconds)
    prof = cs.trace(
        lambda: FusedSlideSegmenter(ensemble).segment_slide(slide, boxes))
    spans = host_spans(ensemble, slide, boxes, FusedSlideSegmenter)
    det_after = detector_scans(cs, 3)
    print(json.dumps({
        "root": root, "s_per_slide": secs,
        "canvas_sha256": hashlib.sha256(canvas.tobytes()).hexdigest(),
        "traced_wall_ms": prof["wall_ms"],
        "device_busy_ms": prof["device_busy_ms"],
        "idle_share": prof["idle_share"],
        "copies_ms": prof["groups_ms"].get("copies", 0.0),
        "host_ms": spans, "detector_s_fresh": det_fresh,
        "detector_s_after_slides": det_after}), flush=True)


def detector_scans(cs, scans: int) -> list:
    """s/slide of ``scans`` timed scans of the smoke's ResNet-50-C4
    detector (bf16, K3, batch 8) over its 20-window pyramid stub, after
    one warm-up scan."""
    cfg = cs.FasterRCNNConfig()
    backend = cs.TorchDetectorBackend(cs.random_detector_state(0, cfg), cfg,
                                      batch_size=cs.DET_BATCH)
    slide3 = cs.pyramid_slide(seed=1)
    detector = cs.GlomusDetector(
        "OPT_PAS", "", str(cs.WORK), str(cs.WORK / "detect_turns"),
        "_turns", window_size=cs.DET_WINDOW_UM,
        overlap_ratio=cs.DET_OVERLAP, conf_threshold=0.0,
        batch_size=cs.DET_BATCH)
    csv = cs.WORK / "detect_turns.csv"
    cs.scan(detector, backend, slide3, csv)  # warm-up
    return [cs.scan(detector, backend, slide3, csv)[0]
            for _ in range(scans)]


def host_spans(ensemble, slide, boxes, segmenter_cls) -> dict:
    """One more slide with the host's parts timed by wrapping them (both
    checkouts have these names): the producer thread's slide reads and
    flat packing, and on the main thread the batch submits (upload and
    launch) and the result reads (waiting for the device); ms summed over
    the slide, and the wall ms."""
    import torch

    from glomeruli_segmentation_tpu_torch.pipeline import fused

    spent = {"read_region": 0.0, "pack_flat": 0.0, "submit": 0.0,
             "read_maps": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += (time.perf_counter() - t0) * 1e3
        return wrapper

    pack = fused.pack_crops_flat
    slide.read_region_array = timed("read_region", slide.read_region_array)
    fused.pack_crops_flat = timed("pack_flat", pack)
    ensemble.submit_batch_gather_flat = timed(
        "submit", ensemble.submit_batch_gather_flat)
    ensemble.read_maps = timed("read_maps", ensemble.read_maps)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segmenter_cls(ensemble).segment_slide(slide, boxes)
        torch.cuda.synchronize()
        spent["wall"] = (time.perf_counter() - t0) * 1e3
    finally:
        fused.pack_crops_flat = pack
        for obj, name in ((slide, "read_region_array"),
                          (ensemble, "submit_batch_gather_flat"),
                          (ensemble, "read_maps")):
            delattr(obj, name)
    return spent


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="*")
    parser.add_argument("--slides", type=int, default=3)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.child, args.slides)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("slide_turns: CUDA is not available", file=sys.stderr)
        return 2
    if len(args.roots) != 2:
        parser.error("give two checkouts")
    name_power = card()
    a, b = (str(Path(r).resolve()) for r in args.roots)
    runs = {a: [], b: []}
    for root in (a, b, b, a):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", root,
             "--slides", str(args.slides)], cwd=root, capture_output=True,
            text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"turn in {root} failed: {proc.returncode}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["process_s"] = time.perf_counter() - t0
        print(json.dumps(result), flush=True)
        runs[root].append(result)
    shas = {r["canvas_sha256"] for rs in runs.values() for r in rs}
    for root, rs in runs.items():
        secs = [s for r in rs for s in r["s_per_slide"]]
        median = statistics.median(secs)
        print(f"packed default slide, {root}: s/slide in turn order "
              + ", ".join(f"{s:.4f}" for s in secs)
              + f" (median {median:.4f}, {80 / median:.2f} crops/s); traced "
              "idle share " + ", ".join(f"{r['idle_share']:.3f}" for r in rs)
              + "; traced wall / busy / copies ms " + ", ".join(
                  f"{r['traced_wall_ms']:.1f} / {r['device_busy_ms']:.1f} / "
                  f"{r['copies_ms']:.1f}" for r in rs)
              + "; host ms of a timed slide (wall, slide reads, flat "
              "packing, submits, result reads) " + ", ".join(
                  "/".join(f"{r['host_ms'][k]:.1f}" for k in (
                      "wall", "read_region", "pack_flat", "submit",
                      "read_maps")) for r in rs)
              + f" | {name_power}", flush=True)
        for key, when in (("detector_s_fresh", "in a fresh process"),
                          ("detector_s_after_slides",
                           "after the slides, same process")):
            det = [s for r in rs for s in r[key]]
            print(f"ResNet-50-C4 detector scan {when}, {root}: s/slide in "
                  "turn order " + ", ".join(f"{s:.4f}" for s in det)
                  + f" (median {statistics.median(det):.4f}) | "
                  f"{name_power}", flush=True)
    print(f"canvases byte-identical across both checkouts and all turns: "
          f"{len(shas) == 1} | {name_power}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
