"""CLI for merging overlapped detections (``gseg-merge``).

    python -m glomeruli_segmentation_tpu_torch.cli.merge \
        --detected_list CSV --output_dir DIR --overlap_threshold 0.35

Flag surface mirrors ``module/faster-rcnn/merge_overlaped_glomus.py:362-382``.
The port's own copy of ``glomeruli_segmentation_tpu/cli/merge.py``, over
the port's :func:`..pipeline.merge.run_merge`; a test holds the two equal.
"""
import argparse

from ..pipeline.merge import run_merge


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="MERGE_OVERLAPPED_GLOMUS")
    parser.add_argument("--staining", dest="staining", type=str,
                        default="OPT_PAS")
    parser.add_argument("--target_list", dest="target_list", type=str)
    parser.add_argument("--detected_list", dest="input_file", type=str,
                        required=True)
    parser.add_argument("--output_dir", dest="output_dir", type=str,
                        required=True)
    parser.add_argument("--output_file_ext", dest="training_type", type=str,
                        default="")
    parser.add_argument("--conf_threshold", dest="conf_threshold", type=float,
                        default=0.6)
    parser.add_argument("--data_dir", dest="annotation_dir", type=str)
    parser.add_argument("--overlap_threshold", dest="overlap_threshold",
                        type=float, required=True)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_merge(args.staining, args.input_file, args.output_dir,
              args.training_type, args.conf_threshold, args.annotation_dir,
              args.overlap_threshold, args.target_list)


if __name__ == "__main__":
    main()
