"""CLI: SegFormer GTCS testing and reporting (``gseg-segformer-test``) on
the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.segformer_test \
        --fold 1 --target_site 01_Todai --model_site 01_Todai \
        --data_date DATE --model_base_path DIR --report_root_path DIR \
        --data_root DIR [--save_image 1]

Counterpart of ``glomeruli_segmentation_tpu/cli/segformer_test.py``, with
the same flags and defaults (the flag surface of
``module/SegFormer/test/test.py:175-206``).  ``--data_parallel`` other than
0 raises: the crop-batch mesh is not ported.  ``main(argv,
device="cuda")`` runs on the card and raises without one;
``device="cpu"`` runs on the CPU.
"""
import argparse

from ..pipeline.segformer_test import run_segformer_test


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="segformer")
    parser.add_argument("--num_labels", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--fold", type=int, required=True)
    parser.add_argument("--target_site", type=str,
                        choices=["01_Todai", "02_Kitano"], required=True)
    parser.add_argument("--model_site", type=str,
                        choices=["01_Todai", "02_Kitano"], required=True)
    parser.add_argument("--data_date", type=str, required=True)
    parser.add_argument("--model_base_path", type=str, required=True)
    parser.add_argument("--pretrained_model", type=str,
                        default="segformer/20220804_b4")
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--save_image", type=int, default=0)
    parser.add_argument("--report_root_path", type=str, required=True)
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--detected_mode", type=int, default=0)
    parser.add_argument("--input_size", type=int, default=512)
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="not ported: must stay 0")
    return parser


def main(argv=None, device="cuda"):
    run_segformer_test(build_parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
