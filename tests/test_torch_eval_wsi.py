"""The port's slide evaluator (``pipeline/eval_wsi.py``,
``cli/eval_wsi.py``) against the JAX package's on the CPU, and the staged
segment-and-evaluate chain (merge -> make-seg-data -> segment -> eval-wsi)
through both packages' command ``main``s on the same slide and weights."""
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import eval_wsi as jax_cli_eval
from glomeruli_segmentation_tpu.cli import make_seg_data as jax_cli_seg_data
from glomeruli_segmentation_tpu.cli import merge as jax_cli_merge
from glomeruli_segmentation_tpu.cli import segment as jax_cli_segment
from glomeruli_segmentation_tpu.pipeline import eval_wsi as jax_eval_wsi
from glomeruli_segmentation_tpu_torch.cli import eval_wsi as cli_eval
from glomeruli_segmentation_tpu_torch.cli import make_seg_data as cli_seg_data
from glomeruli_segmentation_tpu_torch.cli import merge as cli_merge
from glomeruli_segmentation_tpu_torch.cli import segment as cli_segment
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import eval_wsi

from test_torch_seg_data import HEIGHT, PATIENT, WIDTH, tree_files, write_tree
from test_torch_segment import MEAN, STD

PACKAGES = {"port": eval_wsi, "jax": jax_eval_wsi}
COMMANDS = {"port": (cli_merge.main, cli_seg_data.main, cli_segment.main,
                     cli_eval.main),
            "jax": (jax_cli_merge.main, jax_cli_seg_data.main,
                    jax_cli_segment.main, jax_cli_eval.main)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The shared slide tree, random fold weights (p=2, q=2), and the
    port's crops, labels and prediction JSONs for it."""
    t = write_tree(tmp_path_factory.mktemp("eval_wsi"))
    root = t["root"]
    t["weights"] = str(root / "espnet_fold1.pth")
    torch.save(random_state_dict(1, 5, p=2, q=2, calib_size=(128, 256)),
               t["weights"])
    seg_out = root / "seg_data"
    cli_seg_data.main(make_seg_data_argv(t, seg_out))
    t["seg_out"] = seg_out
    t["pred_dir"] = root / "pred"
    cli_segment.main(segment_argv(t, seg_out, t["pred_dir"]), device="cpu")
    return t


def make_seg_data_argv(t, out, merged_csv=None):
    return ["--staining", "OPT_PAS", "--merged_detection_result_csv",
            str(merged_csv or t["merged_csv"]), "--target_list",
            str(t["target_list"]), "--wsi_dir", str(t["wsi_dir"]),
            "--segmentation_gt_json_dir", str(t["seg_gt_dir"]),
            "--object_detection_gt_xml_dir", str(t["data_dir"]),
            "--output_dir", str(out)]


def segment_argv(t, seg_out, pred_dir, engine="xla"):
    return ["--rgb_data_dir", str(seg_out / "org_image"),
            "--label_data_dir", str(seg_out / "label" / "all"),
            "--savedir", str(pred_dir), "--weights", t["weights"],
            "--inWidth", "256", "--inHeight", "128", "--p", "2", "--q", "2",
            "--decoder", "--cityFormat", "--json_image_data", "classmap",
            "--colored", "--overlay", "--engine", engine,
            "--batch_size", "2", "--mean", *map(str, MEAN),
            "--std", *map(str, STD)]


def eval_argv(t, seg_out, pred_dir, tsv, out, merged_csv=None, gt=True):
    argv = ["--staining", "OPT_PAS", "--merged_detection_result_csv",
            str(merged_csv or t["merged_csv"]), "--target_list",
            str(t["target_list"]), "--wsi_dir", str(t["wsi_dir"]),
            "--segmentation_pred_json_dir", str(pred_dir),
            "--output_file", str(tsv), "--output_dir", str(out),
            "--window_size", "600"]
    if gt:
        argv += ["--object_detection_gt_xml_dir", str(t["data_dir"]),
                 "--segmentation_gt_json_dir", str(t["seg_gt_dir"]),
                 "--segmentation_gt_png_dir",
                 str(seg_out / "label" / "all")]
    return argv


@pytest.mark.parametrize("compat", [True, False])
def test_iter_windows_matches_jax(compat):
    for w, h, size in ((2048, 1536, 600), (1536, 2048, 600),
                       (1000, 3000, 2400), (2400, 2400, 2400),
                       (5000, 1200, 700), (601, 1800, 600)):
        got = list(eval_wsi.iter_windows(w, h, size, compat))
        assert got == list(jax_eval_wsi.iter_windows(w, h, size, compat))
        assert all(x1 <= w and y1 <= h for _, _, x1, y1 in got)
    # the reference's y bound: a tall slide loses its bottom windows
    tall = list(eval_wsi.iter_windows(1536, 2048, 600, compat))
    assert max(y1 for *_, y1 in tall) == (1200 if compat else 2048)
    assert eval_wsi.MARGIN_UM == jax_eval_wsi.MARGIN_UM


def _evaluate(mod, t, out, gt):
    ev = mod.WsiEvaluator(
        "OPT_PAS", str(t["data_dir"]) if gt else None,
        str(t["target_list"]), t["merged_csv"], 0.01, str(out / "eval.tsv"),
        str(out / "wsi"), str(t["wsi_dir"]),
        gt_png_dir=str(t["seg_out"] / "label" / "all") if gt else None,
        seg_gt_json_dir=str(t["seg_gt_dir"]) if gt else None,
        window_size=600, seg_pred_json_dir=str(t["pred_dir"]), nclasses=5)
    ev.read_detected_glomus_list()
    if gt:
        ev.scan_files()
    else:
        ev.generate_pred_wsi()
    return tree_files(out)


@pytest.mark.parametrize("gt", [True, False], ids=["gt", "no_gt"])
def test_wsi_evaluator_matches_jax(tree, tmp_path, gt):
    """GT mode: the TSV and both overlays byte-identical; no-GT mode: the
    prediction overlay byte-identical."""
    got = {key: _evaluate(mod, tree, tmp_path / key, gt)
           for key, mod in PACKAGES.items()}
    assert got["port"].keys() == got["jax"].keys()
    assert [k for k in got["port"] if got["port"][k] != got["jax"][k]] == []
    want = {f"wsi/{PATIENT}_pred.jpg"} | (
        {"eval.tsv", f"wsi/{PATIENT}_gt.jpg"} if gt else set())
    assert set(got["port"]) == want
    if gt:
        rows = got["port"]["eval.tsv"].decode().split("\n")
        assert len(rows) == 2 and rows[0].startswith(PATIENT + "\t")
        assert rows[1].startswith("total\t")
        assert np.isfinite(float(rows[1].split("\t")[-1]))
    import cv2
    jpg = cv2.imread(str(tmp_path / "port" / "wsi" / f"{PATIENT}_pred.jpg"))
    assert jpg.shape == (HEIGHT // 8, WIDTH // 8, 3)


def test_eval_wsi_parser_matches_jax():
    argv = ["--staining", "OPT_PAS", "--merged_detection_result_csv", "m",
            "--target_list", "t", "--wsi_dir", "w",
            "--segmentation_pred_json_dir", "p"]
    for extra in ([], ["--fix_window_bug", "--classes", "4", "--no_save",
                       "--window_size", "1200", "--start", "1",
                       "--end", "2"]):
        assert vars(cli_eval.build_parser().parse_args(argv + extra)) == \
            vars(jax_cli_eval.build_parser().parse_args(argv + extra))


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_staged_chain_matches_jax(tree, tmp_path, engine):
    """merge -> make-seg-data -> segment -> eval-wsi through each package's
    command ``main``s from the same detection CSV, slide, annotations and
    weights: every file of every stage byte-identical, apart from the
    merge's timing log (wall times)."""
    outs = {}
    for key, (merge, seg_data_main, segment_main, eval_main) in \
            COMMANDS.items():
        out = tmp_path / key
        merge(["--staining", "OPT_PAS", "--detected_list",
               str(tree["detect_csv"]), "--data_dir", str(tree["data_dir"]),
               "--output_dir", str(out / "merged"), "--output_file_ext",
               "cli", "--conf_threshold", "0.9", "--overlap_threshold",
               "0.35", "--target_list", str(tree["target_list"])])
        merged = out / "merged" / "OPT_PAS_GlomusMergedList_cli.csv"
        seg_data_main(make_seg_data_argv(tree, out / "seg_data", merged))
        argv = segment_argv(tree, out / "seg_data", out / "pred", engine)
        if key == "port":
            segment_main(argv, device="cpu")
        else:
            segment_main(argv)
        eval_main(eval_argv(tree, out / "seg_data", out / "pred",
                            out / "eval.tsv", out / "wsi", merged))
        eval_main(eval_argv(tree, out / "seg_data", out / "pred",
                            out / "eval_pred_only.tsv", out / "wsi_pred",
                            merged, gt=False) + ["--fix_window_bug"])
        outs[key] = {k: v for k, v in tree_files(out).items()
                     if not k.endswith("_log.csv")}
    assert outs["port"].keys() == outs["jax"].keys()
    assert [k for k in outs["port"]
            if outs["port"][k] != outs["jax"][k]] == []
    files = outs["port"]
    n_crops = len([k for k in files if k.startswith("seg_data/org_image/")])
    assert n_crops == len(files["merged/OPT_PAS_GlomusMergedList_cli.csv"]
                          .decode().splitlines()) >= 2
    assert len([k for k in files if k.startswith(f"pred/{PATIENT}/")
                and k.endswith(".json")]) == n_crops
    assert {"eval.tsv", f"wsi/{PATIENT}_gt.jpg", f"wsi/{PATIENT}_pred.jpg",
            f"wsi_pred/{PATIENT}_pred.jpg"} <= set(files)
    assert "eval_pred_only.tsv" not in files
