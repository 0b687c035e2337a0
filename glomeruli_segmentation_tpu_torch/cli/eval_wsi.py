"""CLI: merge cropped glomerular segmented images and evaluate on WSI
(``gseg-eval-wsi``).

    python -m glomeruli_segmentation_tpu_torch.cli.eval_wsi \
        --staining OPT_PAS --merged_detection_result_csv CSV \
        --target_list LIST --wsi_dir DIR --segmentation_pred_json_dir DIR \
        [--object_detection_gt_xml_dir DIR --segmentation_gt_json_dir DIR \
         --segmentation_gt_png_dir DIR]

Counterpart of ``glomeruli_segmentation_tpu/cli/eval_wsi.py``, with the
same flags (``module/espnet/test/eval_wsi_segmentation.py:397-422``);
``--fix_window_bug`` additionally disables the reference's y-bound quirk.
With all three GT directories it evaluates (``scan_files``: the TSV and the
``_gt.jpg``/``_pred.jpg`` overlays); otherwise it writes the prediction
overlays only.  Host code: no device work.
"""
import argparse

from ..pipeline.eval_wsi import WsiEvaluator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="merge cropped glomerular segmented images")
    parser.add_argument("--staining", required=True)
    parser.add_argument("--merged_detection_result_csv", dest="input_csv",
                        required=True)
    parser.add_argument("--target_list", required=True)
    parser.add_argument("--wsi_dir", required=True)
    parser.add_argument("--segmentation_pred_json_dir",
                        dest="seg_pred_json_dir", required=True)
    parser.add_argument("--object_detection_gt_xml_dir", dest="ob_gt_xml_dir",
                        default=None)
    parser.add_argument("--segmentation_gt_json_dir", dest="seg_gt_json_dir",
                        default=None)
    parser.add_argument("--iou_threshold", type=float, default=0.01)
    parser.add_argument("--output_file",
                        default="./output/seg_data_pred/seg_data_output.tsv")
    parser.add_argument("--output_dir", default="./output/seg_data_pred")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=0)
    parser.add_argument("--window_size", type=int, default=2400)
    parser.add_argument("--segmentation_gt_png_dir", dest="gt_png_dir",
                        default=None)
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--classes", type=int, default=5)
    parser.add_argument("--fix_window_bug", action="store_true",
                        help="use slide height (not width) as the y window "
                             "bound; the reference compares against width")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    evaluator = WsiEvaluator(
        args.staining, args.ob_gt_xml_dir, args.target_list, args.input_csv,
        args.iou_threshold, args.output_file, args.output_dir, args.wsi_dir,
        args.gt_png_dir, args.seg_gt_json_dir, args.window_size,
        args.seg_pred_json_dir, args.classes, args.no_save, args.start,
        args.end, compat_window_bug=not args.fix_window_bug)
    evaluator.read_detected_glomus_list()
    if (args.seg_gt_json_dir is None or args.gt_png_dir is None
            or args.ob_gt_xml_dir is None):
        evaluator.generate_pred_wsi()
    else:
        evaluator.scan_files()


if __name__ == "__main__":
    main()
