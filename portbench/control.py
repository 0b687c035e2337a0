"""The readings that a cell's limit is set from, at the cell's own size.

    python3 portbench/control.py --workload <name> --seeds 11 12 ... \\
        --control_seeds 11 12 13 [--slides 8]

For each of ``--seeds``: set-up as in a run, ``--slides`` slides of that
seed through the program, and the number compared on the sample a run
takes (the program's reading).  For each of ``--control_seeds``: the
reference in the precision below the configuration's, put in the
program's place, on the same slides and sample (the control's reading).
One JSON line per reading, then a summary line.  Needs the card.
"""
import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import check, harness, traffic  # noqa: E402
from portbench.stages import segment  # noqa: E402


def control_canvases(family, cfg, weights, stream, picks, device) -> dict:
    """The control's canvases: the reference in the lower precision, its
    argmax max-pasted as the slide segmenters paste."""
    out = {}
    for i in picks:
        slide = stream.slide(i)
        width, height = slide.dimensions
        canvas = np.zeros((height // 8, width // 8), np.uint8)
        for (x1, y1, x2, y2), scores in family.reference_scores(
                cfg, weights, slide, slide.boxes, device, control=True):
            small = scores.argmax(0).to(torch.uint8).cpu().numpy()
            y0, x0 = y1 // 8, x1 // 8
            ch = max(0, min(small.shape[0], canvas.shape[0] - y0))
            cw = max(0, min(small.shape[1], canvas.shape[1] - x0))
            region = canvas[y0: y0 + ch, x0: x0 + cw]
            np.maximum(region, small[:ch, :cw], out=region)
        out[i] = canvas
    return out


def reading(cfg, params, seed, slides, device, control) -> dict:
    t0 = time.perf_counter()
    family, atlas, weights = segment.inputs(cfg, params, seed, device)
    stream = traffic.SlideStream(params, seed, atlas)
    failed = 0
    keep = segment.Sample(seed, params["check_slides"])
    if control:
        for i in range(slides):
            keep.offer(i, len(stream.slide(i).boxes), None)
    else:
        with tempfile.TemporaryDirectory() as work:
            seg = family.build(cfg, weights, device, work)
            _, _, failed, _, _ = segment.walk(seg, stream, 0, keep,
                                              count=slides)
            del seg
    picks = keep.picks()
    canvases = keep.canvases()
    if control:
        canvases = control_canvases(family, cfg, weights, stream, picks,
                                    device)
    got = segment.compare(family, cfg, weights, stream, canvases, picks,
                          device)
    return dict(check.numbers(got), seed=seed, control=control,
                stray=got["stray"], pixels=got["pixels"], failed=failed,
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control_seeds", type=int, nargs="*", default=[])
    parser.add_argument("--slides", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    _, cfg, params = harness.resolve(args.workload)
    rows = []
    for seeds, control in ((args.seeds, False), (args.control_seeds, True)):
        for seed in seeds:
            r = reading(cfg, params, seed % 2**63, args.slides, "cuda",
                        control)
            rows.append(r)
            print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "limits": cfg["limits"],
               "card": torch.cuda.get_device_name(0)}
    for key in ("canvas_gap", "mismatch_share"):
        summary[key] = {
            "program_max": max((r[key] for r in rows if not r["control"]),
                               default=None),
            "control_min": min((r[key] for r in rows if r["control"]),
                               default=None)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
