"""Dump slide dimensions per patient (ref ``module/tools/slides_size_stats.py``).

The port's copy of ``glomeruli_segmentation_tpu/tools/slides_size_stats.py``
(the port imports nothing of the JAX package).  Run as ``python -m
glomeruli_segmentation_tpu_torch.tools.slides_size_stats``.
"""
import glob
import os
from argparse import ArgumentParser

from .. import wsi
from ..pipeline.seg_data import SLIDE_EXTENSIONS


def run(args):
    patient_d = {}
    for line in open(args.target_list):
        patient_id = line.rstrip()
        if not patient_id:
            continue
        slides = []
        for pattern in SLIDE_EXTENSIONS:
            slides += glob.glob(os.path.join(args.wsi_dir, patient_id,
                                             pattern))
        print(slides)
        slide = wsi.open_slide(slides[0])
        patient_d[patient_id] = slide.dimensions
    with open(args.output_file, "w") as out_f:
        for patient_id, (w, h) in patient_d.items():
            out_f.write("{},{},{}\n".format(patient_id, w, h))


def main(argv=None):
    parser = ArgumentParser(description="summarize slide sizes")
    parser.add_argument("--target_list", required=True)
    parser.add_argument("--wsi_dir", required=True)
    parser.add_argument("--output_file", required=True)
    run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
