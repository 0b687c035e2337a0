"""CLI: ESPNet training (``gseg-train``) on the GPU.

    python -m glomeruli_segmentation_tpu_torch.cli.train --data_dir DIR \
        --classes 5 --cached_data_file DIR/data.p --savedir DIR/results
    python -m glomeruli_segmentation_tpu_torch.cli.train --data_dir DIR \
        --classes 5 --cached_data_file DIR/data.p --savedir DIR/results \
        --decoder True --scaleIn 1 \
        --pretrained DIR/results_enc_2_8/model_300.pth

Counterpart of ``glomeruli_segmentation_tpu/cli/train.py``, with the same
flags and defaults (the flag surface of ``module/espnet/train/
main.py:450-477``), plus ``--device`` (default ``cuda``, which raises
without a card; ``cpu`` runs on the CPU).  ``--data_parallel`` other than
0, ``--coordinator``, ``--num_processes`` and ``--process_id`` raise
``SystemExit`` naming themselves: the multi-card trainer is not ported.
"""
from argparse import ArgumentParser

from ..train.espnet_train import train_validate_segmentation


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--model", default="ESPNet")
    parser.add_argument("--data_dir", default="./city")
    parser.add_argument("--inWidth", type=int, default=1024)
    parser.add_argument("--inHeight", type=int, default=512)
    parser.add_argument("--scaleIn", type=int, default=8,
                        help="8 for ESPNet-C, 1 for ESPNet")
    parser.add_argument("--max_epochs", type=int, default=300)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--step_loss", type=int, default=100)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--savedir", default="./results_enc_")
    parser.add_argument("--visualizeNet", type=bool, default=True)
    parser.add_argument("--resume", type=bool, default=False)
    parser.add_argument("--classes", type=int, default=20)
    parser.add_argument("--cached_data_file", default="city.p")
    parser.add_argument("--logFile", default="trainValLog.txt")
    parser.add_argument("--gpu_id", default=0, type=int,
                        help="kept for reference CLI compatibility")
    parser.add_argument("--decoder", type=bool, default=False)
    parser.add_argument("--pretrained",
                        default="../pretrained/encoder/espnet_p_2_q_8.pth")
    parser.add_argument("--p", default=2, type=int)
    parser.add_argument("--q", default=8, type=int)
    parser.add_argument("--resumeLoc", default="checkpoint.pth.tar")
    parser.add_argument("--weight_decay", type=float, default=5e-4,
                        help="coupled L2 weight decay (reference default "
                             "5e-4, module/espnet/train/main.py:382)")
    parser.add_argument("--data_parallel", type=int, default=0,
                        help="not ported: must stay 0")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 autocast of the forward; parameters, "
                             "gradients, optimizer state and BN statistics "
                             "stay float32 (default: full float32, TF32 "
                             "off, matching the reference recipe)")
    parser.add_argument("--prefetch", type=int, default=1,
                        help="batches staged ahead of the device step by "
                             "the loader's producer thread (the torch "
                             "DataLoader's worker prefetch); 0 = "
                             "synchronous loading")
    parser.add_argument("--coordinator", default=None,
                        help="not ported: multi-host coordinator")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="not ported: multi-host process count")
    parser.add_argument("--process_id", type=int, default=None,
                        help="not ported: multi-host rank")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser


def main(argv=None):
    """Train; returns the :class:`EspnetTrainer` (its ``timings`` hold
    each step's loader wait and step time)."""
    return train_validate_segmentation(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
