"""Draw GT boxes from annotation XML onto the ds8 overview PNG
(ref ``module/tools/bbox_draw.py``).

The port's copy of ``glomeruli_segmentation_tpu/tools/bbox_draw.py`` (the
port imports nothing of the JAX package).  Run as ``python -m
glomeruli_segmentation_tpu_torch.tools.bbox_draw``.
"""
import glob
import os
import xml.etree.ElementTree as ElementTree
from argparse import ArgumentParser

from PIL import Image, ImageDraw

from .. import wsi


def load_xml(xml_file):
    gt_list = []
    tree = ElementTree.parse(xml_file)
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        if bbox is not None:
            gt_list.append([float(bbox.find(k).text)
                            for k in ("xmin", "ymin", "xmax", "ymax")])
    return gt_list


def draw(pil_image, output_image, gt_list, width, margin_x=0, margin_y=0):
    d = ImageDraw.Draw(pil_image)
    for box in gt_list:
        d.rectangle(((box[0] - margin_x, box[1] - margin_y),
                     (box[2] + 2 * margin_x, box[3] + 2 * margin_y)),
                    fill=None, outline="yellow", width=width)
    pil_image.save(output_image)


def read_slide_and_cal_margin(slide_path):
    slide = wsi.open_slide(slide_path)
    margin = 20
    mpp_x = float(slide.properties[wsi.PROPERTY_NAME_MPP_X])
    mpp_y = float(slide.properties[wsi.PROPERTY_NAME_MPP_Y])
    print(slide.level_dimensions)
    return (int(round(margin / mpp_x)) / 8, int(round(margin / mpp_y)) / 8)


def run(args):
    file_list = []
    if args.wsi_dir is not None:
        for line in open(args.target_list):
            patient_id = line.rstrip()
            if not patient_id:
                continue
            ndpi_l = (glob.glob(os.path.join(args.wsi_dir, patient_id,
                                             "*ndpi"))
                      or glob.glob(os.path.join(args.wsi_dir, patient_id,
                                                "*.tiff")))
            gt_l = glob.glob(os.path.join(args.wsi_dir, patient_id,
                                          "annotations", "*xml"))
            png_l = glob.glob(os.path.join(args.wsi_dir, patient_id, "*PNG"))
            output_dir = os.path.join(args.output_dir, patient_id)
            os.makedirs(output_dir, exist_ok=True)
            file_list.append([png_l[0], ndpi_l[0], gt_l[0],
                              os.path.join(output_dir,
                                           f"overlay_linewidth{args.width}.PNG")])
    else:
        file_list.append([args.raw_image, args.ndpi_image,
                          args.annotation_file, args.output_image])
    for raw, slide_path, xml, out in file_list:
        read_slide_and_cal_margin(slide_path)
        gt_list = load_xml(xml)
        draw(Image.open(raw), out, gt_list, args.width, 0, 0)


def main(argv=None):
    parser = ArgumentParser(description="Depict Glomerular area")
    parser.add_argument("--raw_image", type=str)
    parser.add_argument("--ndpi_image", type=str)
    parser.add_argument("--annotation_file", type=str)
    parser.add_argument("--output_image", type=str)
    parser.add_argument("--output_dir", type=str)
    parser.add_argument("--width", default=10, type=int)
    parser.add_argument("--wsi_dir", default=None)
    parser.add_argument("--target_list", type=str)
    args = parser.parse_args(argv)
    if args.raw_image is not None:
        assert args.raw_image != args.output_image
    run(args)


if __name__ == "__main__":
    main()
