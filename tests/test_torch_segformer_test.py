"""The port's GTCS test stage (``gseg-segformer-test``: ``eval/mean_iou.py``,
``data/segformer_dataset.py``, ``pipeline/segformer_test.py`` and
``cli/segformer_test.py``) against the JAX package's on the CPU: the metric
with ``ignore_index`` and ``reduce_labels``, the dataset's fold split and
pixel values, best-checkpoint discovery, and every file of the command
(``pred_summary_pixel.csv``, ``summary_report.csv``, the ``seg/`` label
PNGs and the triptychs) byte for byte."""
import argparse

import numpy as np
import pytest

from glomeruli_segmentation_tpu.cli import segformer_test as jax_cli
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.data import segformer_dataset as jax_dataset
from glomeruli_segmentation_tpu.eval import mean_iou as jax_mean_iou
from glomeruli_segmentation_tpu.pipeline import (
    segformer_test as jax_segformer_test,
)
from glomeruli_segmentation_tpu_torch.cli import segformer_test as port_cli
from glomeruli_segmentation_tpu_torch.data import (
    segformer_dataset as port_dataset,
)
from glomeruli_segmentation_tpu_torch.eval import mean_iou as port_mean_iou
from glomeruli_segmentation_tpu_torch.pipeline import (
    segformer_test as port_segformer_test,
)

from test_segformer_pipeline import _gtcs_tree
from test_torch_segformer import assert_wide_margins, jax_logits, \
    jax_variables
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

INPUT = 64
DATE = "20260101"


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("reduce_labels", [False, True])
def test_mean_iou_matches_jax(reduce_labels):
    rng = np.random.RandomState(0)
    preds = rng.randint(0, 5, (3, 20, 30))
    gts = rng.randint(0, 5, (3, 20, 30))
    gts[0, :4] = 255                       # ignored
    gts[1][gts[1] == 3] = 0                # a class absent from a map
    for args in ((preds[0], gts[0], 5, 255, reduce_labels),
                 (preds[1], gts[1], 5, 255, reduce_labels)):
        assert _same(port_mean_iou.intersect_and_union(*args),
                     jax_mean_iou.intersect_and_union(*args))
    for nan_to_num in (None, 0):
        got = port_mean_iou.mean_iou(list(preds), list(gts), 5, 255,
                                     reduce_labels, nan_to_num)
        want = jax_mean_iou.mean_iou(list(preds), list(gts), 5, 255,
                                     reduce_labels, nan_to_num)
        assert _same(got, want)
    # one 2-D map, as the test stage passes it
    assert _same(port_mean_iou.mean_iou(preds[2], gts[2], 5, 255),
                 jax_mean_iou.mean_iou(preds[2], gts[2], 5, 255))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's GTCS fixture: 5 specimens x 2 crops of 96 px under
    ``01_Todai/<date>/{rgb,label/gtcs}``, and a training output directory
    with two checkpoints and the log naming the first."""
    root = tmp_path_factory.mktemp("gtcs_test")
    _gtcs_tree(root)
    v = jax_variables(seed=9)
    run = root / "models" / "01_Todai" / "exp" / "fold1"
    for n, seed in ((1, 9), (2, 10)):
        (run / f"checkpoint-{n}").mkdir(parents=True)
        w = v if n == 1 else jax_variables(seed=seed)
        save_torch_legacy({"params": w["params"],
                           "batch_stats": w["batch_stats"],
                           "num_labels": 5},
                          str(run / f"checkpoint-{n}" / "flax_model.pth"))
    (run / "log.txt").write_text(
        "{'eval_mean_iou': 0.5, 'epoch': 1}\n"
        "{'loss': 0.3, 'epoch': 2}\n"
        "{'eval_mean_iou': 0.25, 'epoch': 2}\n")
    return root, v


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_dataset_matches_jax(tree, mode):
    root, _ = tree
    source = str(root / "01_Todai" / DATE)
    for fold in (1, 3):
        got = port_dataset.ResizedGlomerularDataset(source, mode=mode,
                                                    fold=fold,
                                                    input_size=INPUT)
        want = jax_dataset.ResizedGlomerularDataset(source, mode=mode,
                                                    fold=fold,
                                                    input_size=INPUT)
        assert got.pairs == want.pairs and got.images == want.images
        assert len(got) == {"train": 8, "val": 2, "test": 10}[mode]
        for i in range(len(got)):
            assert _same(got[i], want[i])
    x = np.random.RandomState(1).randint(0, 256, (50, 70, 3), np.uint8)
    assert np.array_equal(port_dataset.feature_extract(x, 32),
                          jax_dataset.feature_extract(x, 32))
    assert (port_dataset.IMAGENET_MEAN.tolist(), port_dataset.INPUT_SIZE) \
        == (jax_dataset.IMAGENET_MEAN.tolist(), jax_dataset.INPUT_SIZE)


def test_search_best_checkpoint_matches_jax(tree, tmp_path):
    root, _ = tree
    run = str(root / "models" / "01_Todai" / "exp" / "fold1")
    assert port_segformer_test.search_best_checkpoint(run) == \
        jax_segformer_test.search_best_checkpoint(run) == "checkpoint-1"
    # the best epoch is the last: the newest checkpoint
    for n in (4, 8):
        (tmp_path / f"checkpoint-{n}").mkdir()
    (tmp_path / "log.txt").write_text("{'eval_mean_iou': 0.1, 'epoch': 4}\n"
                                      "{'eval_mean_iou': 0.2, 'epoch': 8}\n")
    assert port_segformer_test.search_best_checkpoint(str(tmp_path)) == \
        jax_segformer_test.search_best_checkpoint(str(tmp_path)) == \
        "checkpoint-8"


def test_parser_matches_jax():
    def surface(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       a.required, tuple(a.choices or ()))
                      for a in parser._actions)

    assert surface(port_cli.build_parser()) == \
        surface(jax_cli.build_parser())


def _argv(root, report, *extra):
    return ["--fold", "1", "--target_site", "01_Todai", "--model_site",
            "01_Todai", "--data_date", DATE, "--model_base_path",
            str(root / "models"), "--pretrained_model", "exp",
            "--report_root_path", str(report), "--data_root", str(root),
            "--input_size", str(INPUT), "--batch_size", "3",
            "--save_image", "1", *extra]


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_cli_matches_jax(tree, tmp_path):
    """10 crops in batches of 3 (the last padded by repetition); the
    checkpoint found from ``log.txt``; every report file byte-identical."""
    root, v = tree
    ds = port_dataset.ResizedGlomerularDataset(
        str(root / "01_Todai" / DATE), mode="test", input_size=INPUT)
    assert_wide_margins(jax_logits(v, np.stack(
        [ds[i]["pixel_values"] for i in range(len(ds))])))
    port_cli.main(_argv(root, tmp_path / "port"), device="cpu")
    jax_cli.main(_argv(root, tmp_path / "jax"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys()
    differ = [k for k in got if got[k] != want[k]]
    assert not differ, differ
    rep = "01_Todai/01_Todai/20260101/exp/fold1/"
    rows = got[rep + "pred_summary_pixel.csv"].decode().splitlines()
    assert rows[0] == ("specimen_id,filename,background,glomerulus,tuft,"
                       "crescent,sclerosis,mIoU")
    assert len(rows) == 11
    for row in rows[1:]:
        cells = row.split(",")
        assert float(cells[2]) + float(cells[3]) == 96 * 96
    assert sum(k.startswith(rep + "seg/") for k in got) == 10
    assert b"overall_mean_iou" in got[rep + "summary_report.csv"]


def test_data_parallel_raises(tree, tmp_path):
    """``--data_parallel 2`` as in the JAX command: on one device it raises
    the JAX package's error before writing any report (the report
    directory is made first, in both packages); over 2 logical CPU devices
    (the batch of 4 split 2 + 2) every report file equals the JAX
    command's with the same flag."""
    import torch

    root, _ = tree
    argv = ("--data_parallel", "2", "--batch_size", "4")
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        port_cli.main(_argv(root, tmp_path / "one", *argv), device="cpu")
    assert not _files(tmp_path / "one")
    port_cli.main(_argv(root, tmp_path / "port", *argv), device="cpu",
                  devices=[torch.device("cpu")] * 2)
    jax_cli.main(_argv(root, tmp_path / "jax", *argv))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) > 10
    differ = [k for k in got if got[k] != want[k]]
    assert not differ, differ


def test_runs_on_the_card_by_default(tree, tmp_path, monkeypatch):
    import torch

    root, _ = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_segformer_test.run_segformer_test(
            port_cli.build_parser().parse_args(_argv(root, tmp_path)))
    assert isinstance(port_cli.build_parser(), argparse.ArgumentParser)
