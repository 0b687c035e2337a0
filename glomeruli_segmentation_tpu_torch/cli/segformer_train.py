"""CLI: SegFormer GTCS fine-tuning (``gseg-segformer-train``) on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.segformer_train \
        --site 01_Todai --data_root DIR --data_date DATE --model_root DIR \
        [--pretrained_checkpoint mit-b0/model.safetensors]

Counterpart of ``glomeruli_segmentation_tpu/cli/segformer_train.py``, with
the same flags and defaults (the flag surface of
``module/SegFormer/train/train.py:121-155``), plus ``--device`` (default
``cuda``, which raises without a card; ``cpu`` runs on the CPU).
``--data_parallel``, ``--coordinator``, ``--num_processes`` and
``--process_id`` train on the ranks of ``parallel/distributed.py``, as
``cli/train.py`` does.
"""
import argparse

from ..train.segformer_train import train_segformer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="segformer")
    parser.add_argument("--num_labels", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--dl_num_workers", type=int, default=2)
    parser.add_argument("--prefetch", type=int, default=1,
                        help="batches staged ahead of the device step; "
                             "0 = synchronous loading")
    parser.add_argument("--max_epoch", type=int, default=1000)
    parser.add_argument("--fold", type=int, default=1)
    parser.add_argument("--site", type=str,
                        choices=["01_Todai", "02_Kitano"], required=True)
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--data_date", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="20220720")
    parser.add_argument("--model_root", type=str, required=True)
    parser.add_argument("--pretrained_model", type=str,
                        default="nvidia/mit-b0",
                        help="hub id kept for compatibility; use "
                             "--pretrained_checkpoint for a local HF "
                             "checkpoint to import")
    parser.add_argument("--pretrained_checkpoint", type=str, default=None,
                        help="local HF checkpoint dir / pytorch_model.bin / "
                             "model.safetensors to initialize from")
    parser.add_argument("--lr", type=float, default=0.00006)
    parser.add_argument("--save_interval", type=int, default=20)
    parser.add_argument("--accumulation_steps", type=int, default=1)
    parser.add_argument("--checkpoint", type=str, default="")
    parser.add_argument("--input_size", type=int, default=512,
                        help="feature-extractor resize target")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 autocast of the forward; parameters, "
                             "optimizer state and norm statistics stay "
                             "float32 (default: full float32, TF32 off)")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="shard batches over an N-device mesh "
                             "(-1 = all devices; 0 = single device)")
    parser.add_argument("--coordinator", default=None,
                        help="multi-host: coordinator address host:port "
                             "(or GSEG_COORDINATOR); combine with "
                             "--data_parallel -1 to span the global mesh")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-host: total process count "
                             "(or GSEG_NUM_PROCESSES)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host: this process's rank "
                             "(or GSEG_PROCESS_ID)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def main(argv=None, device=None, devices=None) -> str:
    """Fine-tune; returns the output directory.  ``device`` overrides
    ``--device``; ``devices`` lists the ranks' devices."""
    return train_segformer(build_parser().parse_args(argv), device, devices)


if __name__ == "__main__":
    main()
