"""Per-crop class pixel-count statistics (ref ``module/tools/area_stats.py``).

Walks label PNGs named ``xmin{X}_ymin{Y}_xmax{X}_ymax{Y}``, optionally
applying the prediction relabel {13,12,11,8,7}->{4..0}, and writes a CSV of
per-class pixel counts with the parsed crop coordinates.

The port's copy of ``glomeruli_segmentation_tpu/tools/area_stats.py`` (the
port imports nothing of the JAX package).  Run as ``python -m
glomeruli_segmentation_tpu_torch.tools.area_stats``.
"""
import csv
import glob
import os
from argparse import ArgumentParser

import numpy as np
from PIL import Image as PILImage

from ..palette import relabel_from_cityscapes


def extract_cor(name: str, img_extn: str):
    coords = {}
    for split in name.split("_"):
        for key in ("xmin", "ymin", "xmax", "ymax"):
            if key in split:
                value = split[len(key):]
                if key == "ymax":
                    value = value.rstrip(f".{img_extn}")
                coords[key] = value
    return coords["xmin"], coords["ymin"], coords["xmax"], coords["ymax"]


def load_data(args, file_name: str):
    parts = file_name.split("/")
    assert "H" in parts[-2]
    patient_id = parts[-2]
    xmin, ymin, xmax, ymax = extract_cor(parts[-1], args.img_extn)
    img = np.asarray(PILImage.open(file_name))
    if args.data_type == "pred":
        img = relabel_from_cityscapes(img)
    counts = [int(np.count_nonzero(img == c)) for c in range(5)]
    assert counts[0] > 0
    return [patient_id, parts[-1], xmin, ymin, xmax, ymax, *counts]


def run(args):
    files = glob.glob(os.path.join(args.label_data_dir, "H*",
                                   f"*.{args.img_extn}"))
    rows = [load_data(args, f) for f in files]
    with open(args.output_csv, "w") as f:
        writer = csv.writer(f)
        writer.writerow(["patient_id", "file_name", "xmin", "ymin", "xmax",
                         "ymax", "background", "glomerulus", "crescent",
                         "sclerosis", "mesangium"])
        writer.writerows(rows)


def main(argv=None):
    parser = ArgumentParser(
        description="Glomerular segmentation on the cropped images")
    parser.add_argument("--label_data_dir", required=True)
    parser.add_argument("--img_extn", default="PNG")
    parser.add_argument("--data_type", default="ground-truth",
                        choices=["pred", "ground-truth"])
    parser.add_argument("--output_csv", default="./result.csv")
    args = parser.parse_args(argv)
    assert "csv" in args.output_csv
    run(args)


if __name__ == "__main__":
    main()
