"""The port's host tools (``tools/*``) and ``utils/summary.model_summary``
against the JAX package's, on the same inputs: CSVs, text and label PNGs
byte for byte; the plots' PNGs by their decoded pixels (matplotlib draws
the same figure from the same data in one process)."""
import numpy as np
import pytest
import torch
from PIL import Image

from glomeruli_segmentation_tpu.tools import area_stats as jax_area_stats
from glomeruli_segmentation_tpu.tools import bar_plot as jax_bar_plot
from glomeruli_segmentation_tpu.tools import bbox_draw as jax_bbox_draw
from glomeruli_segmentation_tpu.tools import (
    label_transform as jax_label_transform,
)
from glomeruli_segmentation_tpu.tools import loss_plot as jax_loss_plot
from glomeruli_segmentation_tpu.tools import (
    slides_size_stats as jax_slides_size_stats,
)
from glomeruli_segmentation_tpu.utils.labelme_io import lblsave
from glomeruli_segmentation_tpu.utils.summary import (
    model_summary as jax_model_summary,
)
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_ndpi_like_tiff,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.tools import (
    area_stats,
    bar_plot,
    bbox_draw,
    label_transform,
    loss_plot,
    slides_size_stats,
)
from glomeruli_segmentation_tpu_torch.utils.summary import model_summary

CLASSES = ["glomerulus", "crescent", "sclerosis", "mesangium"]


def _label_tree(root, values_per_crop):
    """Palette label PNGs ``<root>/H16-0000k/xmin.._ymin.._xmax.._ymax...PNG``
    with the given {class: pixel count} per crop."""
    for k, values in enumerate(values_per_crop):
        d = root / f"H16-0000{k % 2 + 1}"
        d.mkdir(parents=True, exist_ok=True)
        lbl = np.zeros((40, 50), np.uint8)
        for i, (cls, n) in enumerate(values.items()):
            lbl.reshape(-1)[100 * i: 100 * i + n] = cls
        lblsave(str(d / f"xmin{10 + k}_ymin20_xmax{60 + k}_ymax70.PNG"), lbl)
    return root


CROPS = [{1: 30, 2: 20, 4: 10}, {4: 25}, {1: 300, 3: 7}, {13: 40, 12: 9,
                                                          8: 3, 7: 5}]


@pytest.mark.parametrize("data_type", ["ground-truth", "pred"])
def test_area_stats_csv_identical(tmp_path, data_type):
    labels = _label_tree(tmp_path / "labels", CROPS)
    outs = {}
    for name, tool in (("port", area_stats), ("jax", jax_area_stats)):
        outs[name] = tmp_path / f"{name}.csv"
        tool.main(["--label_data_dir", str(labels), "--data_type",
                   data_type, "--output_csv", str(outs[name])])
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    assert len(outs["port"].read_text().splitlines()) == 1 + len(CROPS)


def test_label_transform_pngs_identical(tmp_path, capsys):
    trees = {name: _label_tree(tmp_path / name, CROPS)
             for name in ("port", "jax")}
    label_transform.main(["--parent_dir", str(trees["port"])])
    port_out = capsys.readouterr().out
    jax_label_transform.main(["--parent_dir", str(trees["jax"])])
    jax_out = capsys.readouterr().out
    assert port_out.replace(str(trees["port"]), "") == \
        jax_out.replace(str(trees["jax"]), "")
    files = sorted(p.relative_to(trees["port"])
                   for p in trees["port"].rglob("*.PNG"))
    assert len(files) == len(CROPS)
    for rel in files:
        got = (trees["port"] / rel).read_bytes()
        assert got == (trees["jax"] / rel).read_bytes()
        assert np.count_nonzero(np.asarray(Image.open(trees["port"] / rel))
                                == 4) == 0


def _pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def test_loss_plot_same_figure(tmp_path, capsys):
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    tsv = tmp_path / "trainValLog.txt"
    rows = ["Epoch\tLoss (train)\tLoss (val)\tmIoU (train)\tmIoU (val)\t"
            "Learning rate\t"]
    rng = np.random.RandomState(0)
    for epoch in range(12):
        rows.append("\t".join([str(epoch)] + [
            f"{v:.4f}" for v in rng.uniform(0, 1, 4)] + ["0.0005"]))
    tsv.write_text("\n".join(rows))
    outs = {}
    for name, tool in (("port", loss_plot), ("jax", jax_loss_plot)):
        outs[name] = tmp_path / f"{name}.png"
        tool.main(["--loss_tsv", str(tsv), "--output_png", str(outs[name])])
    printed = capsys.readouterr().out.splitlines()
    assert printed[: len(printed) // 2] == printed[len(printed) // 2:]
    np.testing.assert_array_equal(_pixels(outs["port"]),
                                  _pixels(outs["jax"]))


def _pixel_csvs(tmp_path, n_patients):
    """Pred and GT pixel-count CSVs in ``summary_pixel.csv``'s columns."""
    rng = np.random.RandomState(n_patients)
    paths = {}
    for kind in ("pred", "gt"):
        lines = ["patient_id,file_name," + ",".join(CLASSES)]
        for p in range(n_patients):
            for c in range(3):
                counts = rng.randint(1, 5000, 4)
                lines.append(f"H16-{p:05d},crop{c}.PNG,"
                             + ",".join(map(str, counts)))
        paths[kind] = tmp_path / f"{kind}.csv"
        paths[kind].write_text("\n".join(lines) + "\n")
    return paths


@pytest.mark.parametrize("graph_type,n_patients", [("rate", 3), ("sum", 3),
                                                   ("rate", 9)])
def test_bar_plot_same_summary_and_figure(tmp_path, graph_type, n_patients):
    pytest.importorskip("pandas")
    pytest.importorskip("matplotlib")
    csvs = _pixel_csvs(tmp_path, n_patients)
    outs = {}
    for name, tool in (("port", bar_plot), ("jax", jax_bar_plot)):
        outs[name] = (tmp_path / f"{name}.png", tmp_path / f"{name}.csv")
        tool.main(["--pixel_pred_csv", str(csvs["pred"]),
                   "--pixel_gt_csv", str(csvs["gt"]),
                   "--output_png", str(outs[name][0]),
                   "--output_summary_csv", str(outs[name][1]),
                   "--graph_type", graph_type])
    assert outs["port"][1].read_bytes() == outs["jax"][1].read_bytes()
    if graph_type == "rate":  # one MAE column per patient
        header = outs["port"][1].read_text().splitlines()[0]
        assert header.count(",") == n_patients
    np.testing.assert_array_equal(_pixels(outs["port"][0]),
                                  _pixels(outs["jax"][0]))


def _slides(root):
    """Two patients' slides: a tiled JPEG pyramid and an NDPI-like file."""
    img, _ = pas_like_image(512, 768, seed=5, n_glomeruli=2)
    (root / "H16-00001").mkdir(parents=True)
    write_pyramidal_tiff(str(root / "H16-00001" / "a.tiff"), img, mpp=0.25,
                         objective_power=40.0, levels=2)
    (root / "H16-00002").mkdir(parents=True)
    write_ndpi_like_tiff(str(root / "H16-00002" / "b.ndpi"), img[:400],
                         mpp=0.228, objective_power=40.0, levels=2)
    return root


def test_slides_size_stats_identical(tmp_path):
    wsi_dir = _slides(tmp_path / "wsi")
    targets = tmp_path / "targets.txt"
    targets.write_text("H16-00001\n\nH16-00002\n")
    outs = {}
    for name, tool in (("port", slides_size_stats),
                       ("jax", jax_slides_size_stats)):
        outs[name] = tmp_path / f"{name}.csv"
        tool.main(["--target_list", str(targets), "--wsi_dir", str(wsi_dir),
                   "--output_file", str(outs[name])])
    assert outs["port"].read_bytes() == outs["jax"].read_bytes() == \
        b"H16-00001,768,512\nH16-00002,768,400\n"


def _xml(path, boxes):
    objects = "".join(
        f"<object><name>glomerulus</name><bndbox><xmin>{a}</xmin>"
        f"<ymin>{b}</ymin><xmax>{c}</xmax><ymax>{d}</ymax></bndbox></object>"
        for a, b, c, d in boxes)
    path.write_text(f"<annotation>{objects}<object><name>x</name></object>"
                    "</annotation>")


@pytest.mark.parametrize("mode", ["files", "wsi_dir"])
def test_bbox_draw_pngs_identical(tmp_path, capsys, mode):
    wsi_dir = _slides(tmp_path / "wsi")
    for patient in ("H16-00001", "H16-00002"):
        ann = wsi_dir / patient / "annotations"
        ann.mkdir()
        _xml(ann / f"OPT_PAS_{patient}_pw40_ds8.xml",
             [(10, 12, 40, 44), (50, 20, 90, 61.5)])
        overview, _ = pas_like_image(64, 96, seed=2, n_glomeruli=1)
        Image.fromarray(overview).save(wsi_dir / patient / "overview.PNG")
    targets = tmp_path / "targets.txt"
    targets.write_text("H16-00001\nH16-00002\n")
    outs = {}
    for name, tool in (("port", bbox_draw), ("jax", jax_bbox_draw)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        if mode == "files":
            p = wsi_dir / "H16-00002"
            argv = ["--raw_image", str(p / "overview.PNG"), "--ndpi_image",
                    str(p / "b.ndpi"), "--annotation_file",
                    str(p / "annotations" / "OPT_PAS_H16-00002_pw40_ds8.xml"),
                    "--output_image", str(out_dir / "H16-00002.PNG"),
                    "--width", "3"]
        else:
            argv = ["--wsi_dir", str(wsi_dir), "--target_list", str(targets),
                    "--output_dir", str(out_dir), "--width", "2"]
        tool.main(argv)
        outs[name] = out_dir
    printed = capsys.readouterr().out.splitlines()
    assert printed[: len(printed) // 2] == printed[len(printed) // 2:]
    files = sorted(p.relative_to(outs["port"])
                   for p in outs["port"].rglob("*.PNG"))
    assert len(files) == (1 if mode == "files" else 2)
    for rel in files:
        assert (outs["port"] / rel).read_bytes() == \
            (outs["jax"] / rel).read_bytes()


def test_model_summary_identical():
    rng = np.random.RandomState(0)
    tree = {"encoder": {"level1": {"c": {"conv": {
        "kernel": rng.normal(size=(3, 3, 3, 16)).astype(np.float32)}}},
        "level2": {"bn": {"scale": np.ones(16), "bias": np.zeros(16)}}},
        "classifier": {"kernel": np.zeros((2, 2, 5, 5))}}
    text = model_summary(tree)
    assert text == jax_model_summary(tree)
    assert f"total parameters: {3 * 3 * 3 * 16 + 32 + 2 * 2 * 5 * 5}" in text
    # the port's trees hold tensors: the same text
    as_tensors = {"encoder": {"level1": {"c": {"conv": {"kernel": torch.zeros(
        3, 3, 3, 16)}}}, "level2": {"bn": {"scale": torch.ones(16),
                                           "bias": torch.zeros(16)}}},
        "classifier": {"kernel": torch.zeros(2, 2, 5, 5)}}
    assert model_summary(as_tensors) == text
