"""In-place relabel mesangium (4) -> glomerulus (1) in palette PNGs
(ref ``module/tools/label_transform.py``).

The port's copy of ``glomeruli_segmentation_tpu/tools/label_transform.py``
(the port imports nothing of the JAX package).  Run as ``python -m
glomeruli_segmentation_tpu_torch.tools.label_transform``.
"""
import glob
from argparse import ArgumentParser

import numpy as np
from PIL import Image as PILImage


def run(args):
    files = glob.glob(f"{args.parent_dir}/*/*.PNG")
    for filename in files:
        print("Filename:{}".format(filename))
        img_pil = PILImage.open(filename)
        palette = img_pil.getpalette()
        img_np = np.asarray(img_pil)
        print("Num of mesangium pixels:{}".format(
            np.count_nonzero(img_np == 4)))
        out = np.where(img_np == 4, 1, img_np).astype(np.uint8)
        with PILImage.fromarray(out, mode="P") as img:
            img.putpalette(palette)
            img.save(filename)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--parent_dir", required=True)
    run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
