"""Plot Loss/mIoU curves from trainValLog.txt (ref ``module/tools/loss_plot.py``).

The port's copy of ``glomeruli_segmentation_tpu/tools/loss_plot.py`` (the
port imports nothing of the JAX package).  Run as ``python -m
glomeruli_segmentation_tpu_torch.tools.loss_plot``.
"""
from argparse import ArgumentParser


def run(args):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    df = pd.read_csv(args.loss_tsv, header=0, index_col=0, delimiter="\t")
    print(df.columns)
    ax = df[["Loss (train)", "Loss (val)", "mIoU (train)",
             "mIoU (val)"]].plot(secondary_y=["mIoU (train)", "mIoU (val)"],
                                 mark_right=False)
    ax.set_ylabel("Loss", fontsize=15)
    ax.right_ax.set_ylabel("mIoU", fontsize=15)
    ax.set_xlabel("Epoch", fontsize=15)
    ax.set_ylim(0, 1)
    ax.right_ax.set_ylim(0, 1)
    ax.set_xlim(0, 100)
    plt.savefig(args.output_png)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--loss_tsv", required=True)
    parser.add_argument("--output_png", required=True)
    args = parser.parse_args(argv)
    assert ".png" in args.output_png
    run(args)


if __name__ == "__main__":
    main()
