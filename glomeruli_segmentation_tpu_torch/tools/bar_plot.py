"""Pred-vs-GT per-class area bar charts + MAE summary
(ref ``module/tools/bar_plot.py``).

The port's copy of ``glomeruli_segmentation_tpu/tools/bar_plot.py`` (the
port imports nothing of the JAX package).  Run as ``python -m
glomeruli_segmentation_tpu_torch.tools.bar_plot``.
"""
from argparse import ArgumentParser

CLASSES = ["glomerulus", "crescent", "sclerosis", "mesangium"]


def run(pred_csv, gt_csv, output_png, graph_type, output_csv):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    import pandas as pd

    pred_df = pd.read_csv(pred_csv, header=0, delimiter=",")
    gt_df = pd.read_csv(gt_csv, header=0, delimiter=",")
    patient_ids = pred_df["patient_id"].unique()
    x = 5 if patient_ids.shape[0] > 8 else 4
    fig, ax = plt.subplots(2, x, sharex="col", sharey="row")
    cols = ["Prediction", "Ground truth"]
    handles = []
    df = pd.DataFrame(index=CLASSES, columns=[])
    for ind, patient_id in enumerate(patient_ids):
        pred_ex = pred_df[pred_df["patient_id"] == patient_id]
        gt_ex = gt_df[gt_df["patient_id"] == patient_id]
        if graph_type == "sum":
            # px -> µm via the 0.23 µm/px factor (bar_plot.py:54-57)
            merged = pd.concat([np.sqrt(pred_ex[CLASSES].sum() * 0.23),
                                np.sqrt(gt_ex[CLASSES].sum() * 0.23)],
                               axis=1)
            merged.columns = cols
            handles.append(_draw(merged, ind, ax, x, 2500, plt))
        else:
            pred_rate = pred_ex[CLASSES].apply(
                lambda r: r / sum(r), axis=1).mean()
            gt_rate = gt_ex[CLASSES].apply(
                lambda r: r / sum(r), axis=1).mean()
            merged = pd.concat([pred_rate, gt_rate], axis=1)
            merged.columns = cols
            handles.append(_draw(merged, ind, ax, x, 1, plt))
            df = pd.concat([df, merged[cols[0]] - merged[cols[1]]], axis=1)
    df = df.apply(lambda v: abs(v))
    df.to_csv(output_csv)
    fig.legend(handles, labels=cols)
    if graph_type == "sum":
        plt.gcf().text(0.005, 0.6, "μm$^{2}$", rotation=90)
    else:
        plt.gcf().text(0.005, 0.5, "Average rate", rotation=90)
    plt.gcf().text(0.5, 0.005, "class")
    plt.tight_layout()
    fig.savefig(output_png)


def _draw(merged, ind, ax, xsize, ymax, plt):
    row = 0 if ind < xsize else 1
    col = ind % xsize
    ax[row, col].set_ylim(0, ymax)
    handle = merged.plot(ax=ax[row, col], kind="bar", legend=False)
    plt.subplots_adjust(left=0.15)
    return handle


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--pixel_pred_csv", required=True)
    parser.add_argument("--pixel_gt_csv", required=True)
    parser.add_argument("--output_png", required=True)
    parser.add_argument("--output_summary_csv", required=True)
    parser.add_argument("--graph_type", choices=["sum", "rate"],
                        required=True)
    args = parser.parse_args(argv)
    assert ".png" in args.output_png
    run(args.pixel_pred_csv, args.pixel_gt_csv, args.output_png,
        args.graph_type, args.output_summary_csv)


if __name__ == "__main__":
    main()
