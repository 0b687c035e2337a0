"""Which detector seeds give the end-to-end smoke slide enough boxes.

    python3 e2e_seeds.py FIRST LAST        # one GPU; seeds FIRST..LAST-1

Prints the machine's image libraries (PIL, cv2, libjpeg headers), writes
``chip_smoke.py``'s e2e slide (timed) and, for each seed, builds the OD-API
detector on ``random_od_api_consts(seed)`` at the published widths, scans
the slide with the CLI's detection threshold (0.2) and merges the boxes
with its merge thresholds (0.9, 0.35): detections, merged boxes, their
sides and their summed area (what the crop reads, the segmenter and the
labelme JSONs scale with).  ``chip_smoke.E2E_DETECTOR_SEED`` is chosen
from this output.
"""
import importlib.util
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from glomeruli_segmentation_tpu_torch import wsi
from glomeruli_segmentation_tpu_torch.convert.pb_import import (
    random_od_api_consts,
)
from glomeruli_segmentation_tpu_torch.pipeline.detect import (
    ODAPIDetectorBackend,
)
from glomeruli_segmentation_tpu_torch.pipeline.e2e import FusedEndToEnd


def main(first: int, last: int) -> int:
    if not torch.cuda.is_available():
        print("e2e_seeds: CUDA is not available", file=sys.stderr)
        return 2
    for mod in ("PIL", "cv2"):
        found = importlib.util.find_spec(mod) is not None
        print(f"{mod}: " + (__import__(mod).__version__ if found
                            else "missing"))
    for header in ("/usr/include/jpeglib.h", "/usr/include/turbojpeg.h"):
        print(f"{header}: {'present' if os.path.exists(header) else 'missing'}")
    path = cs.WORK / "e2e_seeds" / "E2E.tiff"
    print(f"slide written in {cs.e2e_slide(path):.2f} s "
          f"({cs.E2E_COMPRESSION}, {path.stat().st_size / 1e6:.1f} MB) | "
          f"{cs.card()}", flush=True)
    for seed in range(first, last):
        t0 = time.perf_counter()
        backend = ODAPIDetectorBackend(consts=random_od_api_consts(seed),
                                       batch_size=cs.DET_BATCH)
        pipe = FusedEndToEnd(backend, segmenter=object())
        with wsi.open_slide(str(path)) as slide:
            dets = pipe.detect_slide(slide, "", "S", path.name)
            merged = pipe.merge_boxes(dets, cs.DET_MPP, cs.DET_MPP)
        conf = np.asarray([d[4] for d in dets] or [0.0])
        sides = np.asarray([(r[2] - r[0], r[3] - r[1]) for r in merged]
                           or [(0, 0)])
        area = sum((r[2] - r[0]) * (r[3] - r[1]) for r in merged) / 1e6
        print(f"seed {seed}: {len(dets)} detections >= 0.2 (>= 0.9: "
              f"{int((conf >= 0.9).sum())}, top {conf.max():.4f}); merged "
              f"{len(merged)}, summed area {area:.1f} Mpx, sides (w, h) min "
              f"{sides.min(0).tolist()} median {np.median(sides, 0).tolist()} "
              f"max {sides.max(0).tolist()}; {time.perf_counter() - t0:.1f} s",
              flush=True)
        del backend, pipe
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2])))
