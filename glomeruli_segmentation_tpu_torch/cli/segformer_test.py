"""CLI: SegFormer GTCS testing and reporting (``gseg-segformer-test``) on
the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.segformer_test \
        --fold 1 --target_site 01_Todai --model_site 01_Todai \
        --data_date DATE --model_base_path DIR --report_root_path DIR \
        --data_root DIR [--save_image 1]

Counterpart of ``glomeruli_segmentation_tpu/cli/segformer_test.py``, with
the same flags and defaults (the flag surface of
``module/SegFormer/test/test.py:175-206``).  ``--data_parallel N`` splits
each crop batch over N devices (``-1``: all visible cards).  ``main(argv,
device="cuda")`` runs on the card and raises without one;
``device="cpu"`` runs on the CPU, and ``devices`` gives the mesh's devices
(for tests: N logical ``cpu`` devices).
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
                        help="split crop batches over an N-device mesh "
                             "(0 = one device, -1 = all devices); "
                             "batch_size must be a multiple of N")
    return parser


def main(argv=None, device="cuda", devices=None):
    run_segformer_test(build_parser().parse_args(argv), device=device,
                       devices=devices)


if __name__ == "__main__":
    main()
