"""CLI: GTCS WSI stitch + evaluation (``gseg-eval-wsi-gtcs``).

    python -m glomeruli_segmentation_tpu_torch.cli.eval_wsi_gtcs \
        --staining OPT_PAS --merged_detection_result_csv CSV \
        --target_list LIST --wsi_dir DIR --seg_pred_image_dir DIR \
        [--seg_gt_image_dir DIR --evaluate]

Counterpart of ``glomeruli_segmentation_tpu/cli/eval_wsi_gtcs.py``, with
the same flags and defaults (the flag surface of
``module/SegFormer/test/eval_wsi_segmentation_gtcs.py:439-466``).  Host
code: no device work.
"""
import argparse

from ..pipeline.eval_wsi_gtcs import GtcsWsiEvaluator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="merge cropped glomerular segmented images")
    parser.add_argument("--staining", required=True)
    parser.add_argument("--merged_detection_result_csv", dest="input_csv",
                        required=True)
    parser.add_argument("--target_list", required=True)
    parser.add_argument("--wsi_dir", required=True)
    parser.add_argument("--seg_pred_image_dir", required=True)
    parser.add_argument("--seg_gt_image_dir", default=None)
    parser.add_argument("--object_detection_gt_xml_dir", dest="ob_gt_xml_dir",
                        default=None)
    parser.add_argument("--iou_threshold", type=float, default=0.01)
    parser.add_argument("--output_file", default="seg_data_output.tsv")
    parser.add_argument("--output_dir", default="./output/seg_data_pred")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=0)
    parser.add_argument("--window_size", type=int, default=2400)
    parser.add_argument("--segmentation_gt_png_dir", dest="gt_png_dir",
                        default=None)
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--classes", type=int, default=5)
    parser.add_argument("--fix_window_bug", action="store_true")
    parser.add_argument("--evaluate", action="store_true",
                        help="run the GT evaluation path (scan_files: "
                             "stitched GT + IoU/Dice TSV).  The reference "
                             "ships this code but leaves the call commented "
                             "out, running generate_pred_wsi in both "
                             "branches (module/SegFormer/test/"
                             "eval_wsi_segmentation_gtcs.py:469-477); the "
                             "default preserves that behavior")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.evaluate and not args.seg_gt_image_dir:
        parser.error("--evaluate requires --seg_gt_image_dir")
    evaluator = GtcsWsiEvaluator(
        args.staining, args.ob_gt_xml_dir, args.target_list, args.input_csv,
        args.iou_threshold, args.output_file, args.output_dir, args.wsi_dir,
        args.seg_gt_image_dir, args.window_size, args.seg_pred_image_dir,
        args.classes, args.no_save, args.start, args.end,
        compat_window_bug=not args.fix_window_bug)
    evaluator.read_detected_glomus_list()
    if args.evaluate:
        evaluator.scan_files()
    else:
        evaluator.generate_pred_wsi()


if __name__ == "__main__":
    main()
