"""CLI: build train.txt / val.txt dataset lists
(ref ``module/espnet/train/create_dataset_txt.py``).

    python -m glomeruli_segmentation_tpu_torch.cli.create_dataset_txt \
        --data_dir DIR

Counterpart of ``glomeruli_segmentation_tpu/cli/create_dataset_txt.py``
(``gseg-create-dataset-txt``); host code, the same lists byte for byte."""
import argparse

from ..data.load_data import create_dataset_txt


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="This program makes trainval list")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Set path to parent data directory")
    args = parser.parse_args(argv)
    create_dataset_txt(args.data_dir)


if __name__ == "__main__":
    main()
