"""The port's ``gseg-selftest`` (``pipeline/selftest.py``, ``cli/
selftest.py``) against the JAX package's on the synthetic stand-ins of
``tests/test_selftest.py``: a pyramidal TIFF slide, an NDPI-like one, and
the tiny-width OD-API graph of ``tests/test_od_api_import.py`` written by
``tests/pb_graph_writer.py``.  The verdicts are equal in every field except
the ``*_s`` timings and the time stamp; the detectors run in float32 (the
JAX package's backend tests' setting), where the verdict's scores and
normalised boxes, rounded to 4 places, match to 1e-5."""
import functools
import json

import pytest

from pb_graph_writer import write_graph
from test_od_api_import import build_od_api_consts
from test_torch_e2e import StubBackend
from test_torch_native_reader import jax_native  # noqa: F401 (fixture)

from glomeruli_segmentation_tpu.cli import selftest as jax_cli
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu.pipeline import selftest as jax_selftest
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_ndpi_like_tiff,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.cli import selftest as port_cli
from glomeruli_segmentation_tpu_torch.ops import nms as port_nms
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.pipeline import selftest as port_selftest

TOLERANCE = 1e-5


@pytest.fixture(scope="module")
def slide_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("selftest") / "s.tiff")
    img, _ = pas_like_image(1024, 1536, seed=3, n_glomeruli=2)
    write_pyramidal_tiff(path, img, mpp=0.25, objective_power=40.0,
                         levels=3)
    return path


@pytest.fixture(scope="module")
def ndpi_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("selftest_ndpi") / "s.ndpi")
    img, _ = pas_like_image(530, 700, seed=3, n_glomeruli=4)
    write_ndpi_like_tiff(path, img, mpp=0.228, objective_power=40.0,
                         levels=2, mcu_starts=True)
    return path


@pytest.fixture(scope="module")
def pb_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("selftest_pb")
               / "frozen_inference_graph.pb")
    consts, _, _ = build_od_api_consts()
    write_graph(consts, path)
    return path


@pytest.fixture
def float32(monkeypatch, jax_native):  # noqa: F811
    """Both packages' OD-API backends in float32; the JAX package's
    ``NativeSlide`` loaded, so its ``check_ndpi`` takes the native branch
    as the port's does."""
    for module in (jax_detect, port_detect):
        monkeypatch.setattr(module, "ODAPIDetectorBackend", functools.partial(
            module.ODAPIDetectorBackend, compute_dtype="float32"))


def _comparable(value):
    """The verdict without its time stamp and ``*_s`` timings, and without
    tracebacks (they name each package's files)."""
    if isinstance(value, dict):
        return {k: _comparable(v) for k, v in value.items()
                if k not in ("ts", "traceback") and not k.endswith("_s")}
    if isinstance(value, list):
        return [_comparable(v) for v in value]
    return value


def assert_same(got, want, where="verdict"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert abs(got - want) <= TOLERANCE, (where, got, want)
    else:
        assert got == want, (where, got, want)


def _recall_skip(verdict, data_dir):
    """The recall check's skip message with its GT directory taken out:
    each package has its own default (the JAX one a fixed path)."""
    rec = verdict.pop("recall_vs_real_gt")
    assert data_dir in rec["skipped"]
    return rec["skipped"].replace(data_dir, "<data_dir>")


@pytest.mark.parametrize("with_ndpi,with_pb", [(True, True), (True, False),
                                               (False, True)])
def test_verdict_matches_jax(slide_path, pb_path, float32, with_ndpi,
                             with_pb):
    ndpi = slide_path if with_ndpi else None
    pb = pb_path if with_pb else None
    port_nms.nms.launches = 0
    got = port_selftest.run_selftest(ndpi=ndpi, pb=pb, device="cpu")
    want = jax_selftest.run_selftest(ndpi=ndpi, pb=pb)
    assert port_nms.nms.launches == 0  # the CPU runs the plain NMS
    assert got["ok"] and got["checks_run"] == want["checks_run"]
    if with_ndpi:
        assert "open_native_s" in got["ndpi"] and "open_native_s" in \
            want["ndpi"]
        assert _recall_skip(got, port_selftest.REAL_GT_DATA_DIR) == \
            _recall_skip(want, jax_selftest.REAL_GT_DATA_DIR)
    assert_same(_comparable(got), _comparable(want))


@pytest.mark.parametrize("kind", ["tiled", "ndpi"])
def test_check_ndpi_matches_jax(slide_path, ndpi_path, jax_native,  # noqa
                                kind):
    path = slide_path if kind == "tiled" else ndpi_path
    got = port_selftest.check_ndpi(path, region=256)
    want = jax_selftest.check_ndpi(path, region=256)
    assert got["ok"], got
    assert got["decode_errors"] == got["pixel_mismatches"] == []
    assert got["property_mismatches"] == []
    assert {r["level"] for r in got["regions"]} == set(
        range(got["level_count"]))
    assert_same(_comparable(got), _comparable(want))


@pytest.mark.parametrize("source", ["slide-center", "synthetic"])
def test_check_pb_matches_jax(slide_path, pb_path, float32, source):
    slide = slide_path if source == "slide-center" else None
    got = port_selftest.check_pb(pb_path, slide_path=slide, window=256,
                                 device="cpu")
    want = jax_selftest.check_pb(pb_path, slide_path=slide, window=256)
    assert got["ok"] and got["window_source"] == source
    assert got["graph_constants"] > 100
    assert got["contract_violations"] == []
    assert len(got["top_detections"]) == 5
    assert_same(_comparable(got), _comparable(want))


def test_check_pb_default_dtype_runs(pb_path):
    """The backend's own bfloat16 default, as the command runs it."""
    got = port_selftest.check_pb(pb_path, window=256, device="cpu")
    assert got["ok"] and got["contract_violations"] == []
    scores = [d["score"] for d in got["top_detections"]]
    assert all(0 <= s <= 1 for s in scores)


def _gt_tree(root, slide_dims, ds=8):
    """The reference's GT layout: <root>/02_PAS/PAS-001/annotations/
    OPT_PAS_PAS-001_pw40_ds8.xml, boxes at ds8."""
    ann = root / "02_PAS" / "PAS-001" / "annotations"
    ann.mkdir(parents=True)
    w, h = slide_dims[0] // ds, slide_dims[1] // ds
    objects = "".join(
        f"<object><name>{name}</name><bndbox><xmin>{x0}</xmin><ymin>{y0}"
        f"</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
        for name, (x0, y0, x1, y1) in (
            ("glomerulus", (20, 10, 60, 40)), ("glomerulus-kana", (100, 70,
                                                                  150, 110)),
            ("other", (5, 5, 9, 9))))
    (ann / "OPT_PAS_PAS-001_pw40_ds8.xml").write_text(
        f"<annotation><size><width>{w}</width><height>{h}</height>"
        f"</size>{objects}</annotation>")
    return str(root)


# fields of the recall check that follow the merged boxes: with the random
# tiny graph many windows give near-equal scores (uniform background, one
# score to 1e-6), so float noise between the packages reorders detections
# that the merge then takes in another order
MERGE_FIELDS = ("merged_detections", "recall_hit_num", "recall",
                "precision", "gt_max_iou", "ok")


@pytest.mark.parametrize("case", ["stub", "graph", "no-pb", "other-slide"])
def test_check_real_gt_recall_matches_jax(tmp_path, slide_path, pb_path,
                                          float32, monkeypatch, case):
    """The detect -> merge chain scored against a GT XML: skipped without
    a graph or when the slide is not the annotated one, else run through
    ``_CollectingDetector`` and ``BoxMerger`` at the example's operating
    point (merge confidence 0.1 here, so that the random graph's boxes
    reach the merge).  ``stub``: both packages' backends replaced by the
    tests' deterministic numpy detector, so every field must agree."""
    if case == "stub":
        for module in (jax_detect, port_detect):
            monkeypatch.setattr(module, "ODAPIDetectorBackend",
                                lambda *a, **k: StubBackend())
    dims = (1536, 1024) if case != "other-slide" else (4096, 4096)
    data_dir = _gt_tree(tmp_path / "data", dims)
    kwargs = dict(pb_path=None if case == "no-pb" else pb_path,
                  data_dir=data_dir, merge_conf=0.1)
    got = port_selftest.check_real_gt_recall(slide_path, device="cpu",
                                             **kwargs)
    want = jax_selftest.check_real_gt_recall(slide_path, **kwargs)
    assert got["gt_boxes"] == 2
    if case in ("stub", "graph"):
        assert "skipped" not in got and got["raw_detections"] > 0
        assert got["merged_detections"] > 0
        assert len(got["gt_max_iou"]) == 2
    else:
        assert "skipped" in got
    if case == "graph":
        for key in MERGE_FIELDS:
            assert key in got and key in want
            del got[key], want[key]
    assert_same(_comparable(got), _comparable(want))


def test_corrupt_file_is_flagged(tmp_path):
    bad = tmp_path / "bad.tiff"
    bad.write_bytes(b"II*\0" + b"\x99" * 64)
    got = port_selftest.run_selftest(ndpi=str(bad), device="cpu")
    want = jax_selftest.run_selftest(ndpi=str(bad))
    assert got["checks_run"] == ["ndpi"] and not got["ok"]
    assert got["ndpi"]["error"] == want["ndpi"]["error"]
    assert "traceback" in got["ndpi"]


def test_parser_matches_jax(monkeypatch):
    monkeypatch.setenv("GSEG_REAL_NDPI", "/slides/a.ndpi")
    monkeypatch.setenv("GSEG_REAL_PB", "/models/frozen.pb")
    got, want = port_cli.build_parser(), jax_cli.build_parser()
    assert vars(got.parse_args([])) == vars(want.parse_args([])) == {
        "ndpi": "/slides/a.ndpi", "pb": "/models/frozen.pb",
        "out": "selftest_verdict.json"}
    assert [(a.dest, a.default, a.help) for a in got._actions] == \
        [(a.dest, a.default, a.help) for a in want._actions]


def test_cli_verdict_exit_codes_and_skip(tmp_path, slide_path, pb_path,
                                         capsys):
    out = tmp_path / "verdict.json"
    rc = port_cli.main(["--ndpi", slide_path, "--pb", pb_path, "--out",
                        str(out)], device="cpu")
    assert rc == 0
    verdict = json.load(open(out))
    assert verdict["ok"] and verdict["checks_run"] == ["ndpi", "pb"]
    assert json.loads(capsys.readouterr().out) == verdict

    # no artifacts: exit 0, both sections skipped, the hint on stderr
    rc = port_cli.main(["--ndpi", "", "--pb", "", "--out", ""], device="cpu")
    captured = capsys.readouterr()
    assert rc == 0
    printed = json.loads(captured.out)
    assert printed["checks_run"] == []
    assert "skipped" in printed["ndpi"] and "skipped" in printed["pb"]
    assert "nothing to check" in captured.err

    # a missing path is a skip, not a failure
    assert port_cli.main(["--ndpi", str(tmp_path / "nope.ndpi"), "--out",
                          ""], device="cpu") == 0
    capsys.readouterr()

    # a failed check exits 2, as the JAX command does
    bad = tmp_path / "bad.tiff"
    bad.write_bytes(b"II*\0" + b"\x99" * 64)
    argv = ["--ndpi", str(bad), "--out", ""]
    assert port_cli.main(argv, device="cpu") == jax_cli.main(argv) == 2
