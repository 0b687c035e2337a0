"""CLI: make segmentation data from the detection result
(``gseg-make-seg-data``).

    python -m glomeruli_segmentation_tpu_torch.cli.make_seg_data \
        --staining OPT_PAS --merged_detection_result_csv CSV \
        --target_list LIST --wsi_dir DIR \
        [--segmentation_gt_json_dir DIR --object_detection_gt_xml_dir DIR]

Counterpart of ``glomeruli_segmentation_tpu/cli/make_seg_data.py``, with
the same flags and dests (``module/faster-rcnn/make_seg_data.py:363-392``).
With both GT directories it crops the detections and writes GT label PNGs
(``scan_files``); without, it only crops.  Numpy, PIL and the port's slide
reader: no device work.
"""
import argparse

from ..pipeline.seg_data import SegDataGenerator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Make segmentation data from the result of the detection")
    parser.add_argument("--staining", required=True,
                        help="staining method, e.g. OPT_PAS")
    parser.add_argument("--merged_detection_result_csv", dest="input_csv",
                        required=True)
    parser.add_argument("--target_list", required=True)
    parser.add_argument("--wsi_dir", required=True)
    parser.add_argument("--segmentation_gt_json_dir", dest="seg_gt_json_dir",
                        default=None)
    parser.add_argument("--object_detection_gt_xml_dir", dest="ob_gt_xml_dir",
                        default=None)
    parser.add_argument("--iou_threshold", type=float, default=0.01)
    parser.add_argument("--output_dir", default="./output/seg_data")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=0)
    parser.add_argument("--segmentation_gt_png_dir", dest="gt_png_dir",
                        default=None)
    parser.add_argument("--no_save", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    gen = SegDataGenerator(args.staining, args.ob_gt_xml_dir,
                           args.target_list, args.input_csv,
                           args.iou_threshold, args.output_dir, args.wsi_dir,
                           args.gt_png_dir, args.seg_gt_json_dir,
                           args.no_save, args.start, args.end)
    gen.read_detected_glomus_list()
    if args.seg_gt_json_dir is None or args.ob_gt_xml_dir is None:
        gen.output_org_files()
    else:
        gen.scan_files()


if __name__ == "__main__":
    main()
