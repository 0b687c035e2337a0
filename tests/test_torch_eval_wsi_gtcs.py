"""The port's GTCS WSI stitcher and evaluator (``pipeline/eval_wsi_gtcs.py``
and ``cli/eval_wsi_gtcs.py``, ``gseg-eval-wsi-gtcs``) against the JAX
package's on the CPU, on the JAX package's fixture (a 1536x2048 pyramid,
label PNGs over the margin frame, a merged CSV): both modes' TSV and
``_gt.jpg``/``_pred.jpg`` byte-identical, through the class and through
the command with and without ``--evaluate``."""
import pytest

from glomeruli_segmentation_tpu.cli import eval_wsi_gtcs as jax_cli
from glomeruli_segmentation_tpu.pipeline import (
    eval_wsi_gtcs as jax_eval_wsi_gtcs,
)
from glomeruli_segmentation_tpu_torch.cli import eval_wsi_gtcs as port_cli
from glomeruli_segmentation_tpu_torch.pipeline import (
    eval_wsi_gtcs as port_eval_wsi_gtcs,
)

from test_eval_wsi_gtcs import PATIENT, gtcs_tree  # noqa: F401 (fixture)

PACKAGES = {"port": port_eval_wsi_gtcs, "jax": jax_eval_wsi_gtcs}
CLIS = {"port": port_cli, "jax": jax_cli}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _evaluator(module, root, out, pred_dir="pred", **kw):
    ev = module.GtcsWsiEvaluator(
        "OPT_PAS", None, str(root / "targets.txt"), str(root / "merged.csv"),
        0.01, "out.tsv", str(out), str(root / "wsi"), str(root / "gt"),
        window_size=600, seg_pred_image_dir=str(root / pred_dir),
        nclasses=5, **kw)
    ev.read_detected_glomus_list()
    return ev


@pytest.mark.parametrize("mode", ["scan_files", "generate_pred_wsi"])
@pytest.mark.parametrize("compat", [True, False])
def test_evaluator_matches_jax(gtcs_tree, tmp_path, mode, compat):
    got = {}
    for name, module in PACKAGES.items():
        ev = _evaluator(module, gtcs_tree, tmp_path / name,
                        compat_window_bug=compat)
        assert ev.detected_glomus_list.keys() == {PATIENT}
        getattr(ev, mode)()
        got[name] = _files(tmp_path / name)
    assert got["port"] == got["jax"]
    assert set(got["port"]) == {"out.tsv", f"{PATIENT}_gt.jpg",
                                f"{PATIENT}_pred.jpg"}
    last = got["port"]["out.tsv"].decode().splitlines()[-1].split("\t")
    assert last[0] == "total" and len(last) == 7
    if mode == "scan_files":
        assert float(last[1]) > 0.999      # the prediction is the GT


def test_constants_and_parser_match_jax():
    assert (port_eval_wsi_gtcs.MAGNIFICATION, port_eval_wsi_gtcs.MARGIN_UM) \
        == (jax_eval_wsi_gtcs.MAGNIFICATION, jax_eval_wsi_gtcs.MARGIN_UM)

    def surface(parser):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       a.required) for a in parser._actions)

    assert surface(port_cli.build_parser()) == surface(jax_cli.build_parser())


def _argv(root, out, *extra):
    return ["--staining", "OPT_PAS",
            "--merged_detection_result_csv", str(root / "merged.csv"),
            "--target_list", str(root / "targets.txt"),
            "--wsi_dir", str(root / "wsi"),
            "--seg_pred_image_dir", str(root / "pred"),
            "--seg_gt_image_dir", str(root / "gt"),
            "--output_dir", str(out), "--window_size", "600", *extra]


@pytest.mark.parametrize("extra", [[], ["--evaluate"], ["--no_save"],
                                   ["--evaluate", "--fix_window_bug"]])
def test_cli_matches_jax(gtcs_tree, tmp_path, extra):
    got = {}
    for name, cli in CLIS.items():
        cli.main(_argv(gtcs_tree, tmp_path / name, "--output_file", "o.tsv",
                       *extra))
        got[name] = _files(tmp_path / name)
    assert got["port"] == got["jax"]
    assert ("--no_save" in extra) == (f"{PATIENT}_pred.jpg"
                                      not in got["port"])
    rows = got["port"]["o.tsv"].decode().splitlines()
    assert rows[0].startswith(PATIENT + "\t") and rows[-1].startswith(
        "total\t")


def test_evaluate_needs_the_gt_dir(gtcs_tree, tmp_path, capsys):
    argv = [a for a in _argv(gtcs_tree, tmp_path) if a != str(
        gtcs_tree / "gt")]
    argv.remove("--seg_gt_image_dir")
    for cli in CLIS.values():
        with pytest.raises(SystemExit) as e:
            cli.main(argv + ["--evaluate"])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.count("--evaluate requires --seg_gt_image_dir") == 2
