"""The port's ``gseg-train-detector`` command (``cli/train_detector.py``)
against the JAX package's: the parser flag for flag (plus ``--device``),
the refused and defaulted paths, and two-step CPU runs of both trainers
through ``main`` whose checkpoints the JAX package's ``gseg-detect``
loads."""
import re

import numpy as np
import pytest

from pb_graph_writer import write_graph
from test_od_api_import import build_od_api_consts

from glomeruli_segmentation_tpu.cli import detect as jax_detect_cli
from glomeruli_segmentation_tpu.cli import train_detector as jax_cli
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.cli import train_detector as port_cli

PATIENT = "H16-33333"
REQUIRED = ["--data_dir", "d", "--target_list", "t", "--output_dir", "o"]
JAX_FLAGS = [a for a in jax_cli.build_parser()._actions if a.dest != "help"]
# the JAX driver's log line, with the same four losses and their total
LOG = re.compile(r"^step \d+: rpn_cls=[-\d.e]+, rpn_reg=[-\d.e]+, "
                 r"roi_cls=[-\d.e]+, roi_reg=[-\d.e]+, total=[-\d.e]+$")


def _action(parser, dest):
    return next(a for a in parser._actions if a.dest == dest)


@pytest.mark.parametrize("want", JAX_FLAGS, ids=[a.dest for a in JAX_FLAGS])
def test_flag_matches_jax(want):
    got = _action(port_cli.build_parser(), want.dest)
    for attr in ("option_strings", "default", "type", "choices", "required",
                 "nargs", "const"):
        assert getattr(got, attr) == getattr(want, attr), (want.dest, attr)


def test_parser_adds_only_device():
    got = [a.dest for a in port_cli.build_parser()._actions]
    assert got == [a.dest for a in jax_cli.build_parser()._actions] + \
        ["device"]
    args = port_cli.build_parser().parse_args(REQUIRED)
    assert args.device == "cuda"
    assert vars(jax_cli.build_parser().parse_args(REQUIRED)).items() <= \
        vars(args).items()


@pytest.mark.parametrize("extra", [[], ["--finetune_pb", "graph.pb"]],
                         ids=["native", "finetune_pb"])
def test_data_parallel_raises_naming_itself(extra):
    with pytest.raises(SystemExit, match="--data_parallel"):
        port_cli.main(REQUIRED + ["--data_parallel", "2", "--device", "cpu"]
                      + extra)


@pytest.mark.parametrize("extra", [[], ["--finetune_pb", "graph.pb"]],
                         ids=["native", "finetune_pb"])
def test_runs_on_cuda_by_default(extra, monkeypatch):
    """Without ``--device`` both trainers ask for the card, and raise where
    there is none (no fall back to the CPU)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(REQUIRED + extra)


@pytest.fixture(scope="module")
def annotated_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    img, centers = pas_like_image(1536, 2048, seed=11, n_glomeruli=4)
    pdir = tmp / "data" / "02_PAS" / PATIENT
    (pdir / "annotations").mkdir(parents=True)
    write_pyramidal_tiff(str(pdir / f"{PATIENT}.tiff"), img, mpp=0.25,
                         objective_power=40.0, levels=4)
    objs = "".join(
        f"<object><name>glomerulus</name><bndbox><xmin>{(cx - r) // 8}"
        f"</xmin><ymin>{(cy - r) // 8}</ymin><xmax>{(cx + r) // 8}</xmax>"
        f"<ymax>{(cy + r) // 8}</ymax></bndbox></object>"
        for cx, cy, r in centers)
    (pdir / "annotations" / f"OPT_PAS_{PATIENT}_{PATIENT}_pw40_ds8.xml"
     ).write_text(f"<annotation>{objs}</annotation>")
    (tmp / "targets.txt").write_text(f"{PATIENT}/{PATIENT}\n")
    return tmp


def _args(tree, out, *extra):
    return ["--data_dir", str(tree / "data"), "--target_list",
            str(tree / "targets.txt"), "--output_dir", str(out), "--steps",
            "2", "--batch_size", "2", "--image_size", "128", "--device",
            "cpu", *extra]


def test_native_two_steps_on_the_cpu(annotated_tree, tmp_path, capsys):
    """Two steps of the tiny backbone: the log line of step 0 (the JAX
    driver logs every 50), and a ``detector.ckpt.pth`` the JAX package's
    ``gseg-detect`` loads."""
    path = port_cli.main(_args(annotated_tree, tmp_path / "model",
                               "--backbone", "tiny", "--seed", "1"))
    out = capsys.readouterr().out.splitlines()
    assert path == str(tmp_path / "model" / "detector.ckpt.pth")
    assert out[-1] == f"saved {path}"
    assert len(out) == 2 and LOG.match(out[0]) and out[0].startswith(
        "step 0: ")
    backend = jax_detect_cli.load_backend(str(tmp_path / "model"), None, 2)
    assert backend.base_config.backbone == "tiny"
    assert backend.base_config.image_size == (128, 128)
    boxes, scores, _, _ = backend.detect_batch(
        np.zeros((2, 128, 128, 3), np.uint8))
    assert np.isfinite(scores).all() and boxes.shape[0] == 2


def test_finetune_pb_two_steps_on_the_cpu(annotated_tree, tmp_path, capsys):
    """``--finetune_pb`` on a frozen graph of ``build_od_api_consts``: two
    steps, ``od_api_detector.ckpt.pth`` with the fine-tuner's 64 proposals,
    which the JAX package's ``gseg-detect`` loads."""
    consts, _, _ = build_od_api_consts(seed=3)
    pb = tmp_path / "frozen_inference_graph.pb"
    write_graph(consts, str(pb))
    path = port_cli.main(_args(annotated_tree, tmp_path / "model",
                               "--finetune_pb", str(pb)))
    out = capsys.readouterr().out.splitlines()
    assert path == str(tmp_path / "model" / "od_api_detector.ckpt.pth")
    assert out[-1] == f"saved {path}"
    assert len(out) == 2 and LOG.match(out[0])
    from glomeruli_segmentation_tpu.train.od_api_finetune import (
        load_od_api_checkpoint,
    )

    _, n, saved = load_od_api_checkpoint(path)
    assert n == 1 and saved["max_proposals"] == 64
    assert tuple(saved["image_size"]) == (128, 128)
    backend = jax_detect_cli.load_backend(
        str(tmp_path / "model"), None, 2,
        od_api_overrides={"min_dimension": 128, "max_dimension": 128})
    _, scores, _, _ = backend.detect_batch(np.zeros((2, 128, 128, 3),
                                                    np.uint8))
    assert np.isfinite(scores).all()
