"""Merged boxes of zero width or height in the port, on the CPU at a tiny
ESPNet ensemble and a tiny SegFormer.

The rule (``pipeline/fused.py`` ``crop_boxes``, both segmenters): such a
box keeps its merged-CSV row, because the detector reported it, but it is
not read, segmented or pasted and gets no per-crop artifact; it is left
out before the crop batches are cut, and ``FusedEndToEnd.
degenerate_boxes`` counts it per slide (``gseg-serve``: the log row's
``degenerate_boxes``).  ``gseg-make-seg-data`` writes no crop or label
for it (``pipeline/merge.py`` ``has_pixels``, the same test).  The JAX
package stops the slide on such a box, so
the boxes are injected by wrapping the merge step, and each slide is held
against the same slide without them: the same CSV apart from their rows,
and every other artifact byte for byte.  The slides without them are held
against the JAX package's artifacts."""
import json
import logging

import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import make_seg_data as jax_seg_data_cli
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.pipeline import e2e as jax_e2e
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.cli import detect as port_cli_detect
from glomeruli_segmentation_tpu_torch.cli import e2e as port_cli_e2e
from glomeruli_segmentation_tpu_torch.cli import (
    make_seg_data as port_seg_data_cli,
)
from glomeruli_segmentation_tpu_torch.cli import serve as port_cli_serve
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.convert.segformer_import import (
    state_dict_from_variables,
)
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused
from glomeruli_segmentation_tpu_torch.pipeline import merge as port_merge
from glomeruli_segmentation_tpu_torch.pipeline import (
    fused_segformer as port_fused_segformer,
)
from glomeruli_segmentation_tpu_torch.pipeline import seg_data as port_seg_data
from glomeruli_segmentation_tpu_torch.pipeline import serve as port_serve

from test_torch_e2e import (  # noqa: F401 (fixtures)
    CSV, GEOMETRY, LOG, StubBackend, assert_same_artifacts, checkpoints,
    crop_files, ensembles, rows, slides, write_slide,
)
from test_torch_fused_segformer import (  # noqa: F401 (fixtures)
    BOXES, INPUT, slide_path, variables,
)
from test_torch_seg_data import tree, tree_files  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STUB = dict(GEOMETRY, detect_conf=0.5, merge_conf=0.9)
PATIENT = "H16-7"


def degenerate(box):
    """Two boxes without pixels beside ``box``: zero height, then zero
    width (the same row length, so the CSV writes them alike)."""
    zero_h, zero_w = list(box), list(box)
    zero_h[3] = zero_h[1]
    zero_w[2] = zero_w[0]
    return [zero_h, zero_w]


def inject(merge_boxes, where=(0, None)):
    """A merge step that adds :func:`degenerate` boxes of its first box:
    the zero-height one at ``where[0]``, the zero-width one at
    ``where[1]`` (None: the end)."""
    def merged(*args):
        out = list(merge_boxes(*args))
        if out:
            zero_h, zero_w = degenerate(out[0])
            out.insert(where[0], zero_h)
            out.insert(len(out) if where[1] is None else where[1], zero_w)
        return out
    return merged


def csv_line(pid, file_name, rect):
    """A merged-CSV row as ``FusedEndToEnd`` writes it."""
    return ",{},\"{}\",{},{},{},{},{}".format(
        pid, file_name, int(rect[0]), int(rect[1]), int(rect[2]),
        int(rect[3]), rect[4])


def without(csv_rows, extra):
    """``csv_rows`` with each of ``extra`` taken out once."""
    out = list(csv_rows)
    for line in extra:
        out.remove(line)
    return out


class ReadLog:
    """A slide whose region reads are recorded (size of each)."""

    def __init__(self, slide):
        self._slide = slide
        self.sizes = []
        self.dimensions = slide.dimensions

    def read_region_array(self, location, level, size):
        self.sizes.append(tuple(size))
        return self._slide.read_region_array(location, level, size)


def test_crop_boxes_rule():
    dets = [[10.7, 20.2, 50.9, 60.1, 0.95],    # 40 x 40 after the cast
            [10.2, 20.0, 50.0, 20.9, 0.95],    # zero height
            [10.0, 20.0, 10.8, 60.0, 0.95],    # zero width
            [30.0, 40.0, 20.0, 80.0, 0.95],    # negative width
            [0.0, 0.0, 1.0, 1.0, 0.9]]         # one pixel
    assert port_fused.crop_boxes(dets) == [[10, 20, 50, 60], [0, 0, 1, 1]]
    assert [port_merge.has_pixels(d) for d in dets] == \
        [True, False, False, False, True]
    assert port_fused.crop_boxes([]) == []


def test_reader_gives_empty_crops(slide_path):
    """What such a box would read: a (0, w, 3) or (h, 0, 3) array, which
    cv2's resize and the nearest upsample refuse."""
    with port_wsi.open_slide(slide_path) as slide:
        assert slide.read_region_array((64, 128), 0, (40, 0)).shape == \
            (0, 40, 3)
        assert slide.read_region_array((64, 128), 0, (0, 40)).shape == \
            (40, 0, 3)


def _espnet_pipe(ensembles, transfer):
    return port_e2e.FusedEndToEnd(StubBackend(), ensembles[0],
                                  transfer=transfer, **STUB)


@pytest.mark.parametrize("json_out", [True, False], ids=["json", "no_json"])
@pytest.mark.parametrize("transfer", ["flat", "padded"])
def test_espnet_slide_with_degenerate_boxes(ensembles, slides, tmp_path,
                                            transfer, json_out):
    """A zero-height box at the front and a zero-width one at the end of
    the merged list: the slide finishes, both are counted, the CSV keeps
    their rows and every other artifact equals the same slide's without
    them, whose artifacts equal the JAX package's."""
    path, pid = slides[1]
    json_dir = (lambda d: str(d / "json")) if json_out else (lambda d: None)
    pipe = _espnet_pipe(ensembles, transfer)
    base = tmp_path / "base"
    base_canvas = pipe.run_slide(path, str(base), pid,
                                 json_dir=json_dir(base))
    assert pipe.degenerate_boxes == {pid: 0}
    if json_out and transfer == "flat":
        jax_dir = tmp_path / "jax"
        jax_pipe = jax_e2e.FusedEndToEnd(StubBackend(), ensembles[1], **STUB)
        jax_pipe.run_slide(path, str(jax_dir), pid,
                           json_dir=str(jax_dir / "json"))
        assert_same_artifacts(base, jax_dir, [pid])
    merged = []
    merge_boxes = inject(pipe.merge_boxes)
    pipe.merge_boxes = lambda *a: merged.append(merge_boxes(*a)) or \
        merged[-1]
    got = tmp_path / "degenerate"
    port_e2e.FusedEndToEnd.prepare_output(str(got), "OPT_PAS")
    assert pipe.run_slides([(path, pid)], str(got), json_dir=json_dir(got),
                           pipeline=True) == 1
    assert pipe.degenerate_boxes == {pid: 2}
    extra = [csv_line(pid, path.rsplit("/", 1)[1], b)
             for b in (merged[0][0], merged[0][-1])]
    assert without(rows(got / CSV), extra) == rows(base / CSV)
    assert crop_files(got, pid) == crop_files(base, pid)
    if json_out:
        assert len(crop_files(got, pid)) == len(rows(base / CSV)) > 0
    for name in crop_files(got, pid):
        assert (got / name).read_bytes() == (base / name).read_bytes(), name
    assert (got / f"{pid}_pred.jpg").read_bytes() == \
        (base / f"{pid}_pred.jpg").read_bytes()
    assert [ln.split(",")[0] for ln in rows(got / LOG)] == \
        [ln.split(",")[0] for ln in rows(base / LOG)]
    canvas = pipe.run_slide(path, str(tmp_path / "serial"), pid,
                            json_dir=json_dir(tmp_path / "serial"))
    np.testing.assert_array_equal(canvas, base_canvas)


def refuse_batches(monkeypatch, segmenter):
    """Fail the test if ``segmenter`` submits a batch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a batch of boxes without pixels was "
                             "submitted")

    for name in dir(segmenter):
        if name.startswith("submit"):
            monkeypatch.setattr(segmenter, name, refuse)


def _segmenter(kind, ensembles, variables):
    if kind == "segformer":
        return port_fused_segformer.SegformerSlideSegmenter(
            state_dict_from_variables(variables),
            port_fused_segformer.SegformerSlideConfig(input_size=64,
                                                      batch_size=2),
            device="cpu")
    return port_fused.FusedSlideSegmenter(
        ensembles[0], transfer="padded" if kind == "host_resize" else kind,
        host_resize=kind == "host_resize")


@pytest.mark.parametrize("on_crop", [False, True], ids=["gather", "on_crop"])
@pytest.mark.parametrize("kind", ["flat", "padded", "host_resize",
                                  "segformer"])
def test_only_degenerate_boxes(ensembles, variables, slide_path,
                               monkeypatch, kind, on_crop):
    """Detections made only of boxes without pixels (more than a batch):
    no read, no batch, no per-crop call, an all-background canvas."""
    seg = _segmenter(kind, ensembles, variables)
    refuse_batches(monkeypatch,
                   seg if kind == "segformer" else seg.ensemble)
    dets = [b for box in ([64, 128, 576, 640, 0.95],
                          [700, 200, 1100, 900, 0.95])
            for b in degenerate(box)]
    crops = []
    with port_wsi.open_slide(slide_path) as s_:
        slide = ReadLog(s_)
        canvas = seg.segment_slide(
            slide, dets, on_crop=(lambda box, m: crops.append(box))
            if on_crop else None)
    assert not slide.sizes and not crops
    assert canvas.shape == (slide.dimensions[1] // 8,
                            slide.dimensions[0] // 8)
    assert not canvas.any()


@pytest.mark.parametrize("on_crop", [False, True], ids=["gather", "on_crop"])
def test_segformer_slide_with_degenerate_boxes(variables, slide_path,
                                               on_crop):
    """The SegFormer producer never reads a (0, w, 3) crop: the canvas and
    every crop's map equal those of the boxes without the degenerate ones,
    which share their batches."""
    seg = port_fused_segformer.SegformerSlideSegmenter(
        state_dict_from_variables(variables),
        port_fused_segformer.SegformerSlideConfig(input_size=INPUT,
                                                  batch_size=2),
        device="cpu")
    dets = [b + [0.95] for b in BOXES]
    zero_h, zero_w = degenerate(dets[0])
    with_bad = [zero_h] + dets[:2] + [zero_w] + dets[2:]
    out = {}
    for name, boxes in (("base", dets), ("degenerate", with_bad)):
        maps = {}
        with port_wsi.open_slide(slide_path) as s_:
            slide = ReadLog(s_)
            canvas = seg.segment_slide(
                slide, boxes, on_crop=(lambda box, m: maps.__setitem__(
                    tuple(box), m)) if on_crop else None)
        assert all(w > 0 and h > 0 for w, h in slide.sizes)
        out[name] = (canvas, maps, slide.sizes)
    np.testing.assert_array_equal(out["degenerate"][0], out["base"][0])
    assert out["degenerate"][2] == out["base"][2]
    assert out["degenerate"][1].keys() == out["base"][1].keys()
    for box, m in out["base"][1].items():
        np.testing.assert_array_equal(out["degenerate"][1][box], m)
    assert out["base"][0].any()


def test_e2e_with_only_degenerate_boxes(ensembles, slides, tmp_path,
                                        monkeypatch, caplog):
    """A slide whose merged boxes all lack pixels: it finishes with their
    CSV rows, no per-crop file, an overlay of the slide alone, a warning
    and the count."""
    path, pid = slides[1]
    pipe = _espnet_pipe(ensembles, "flat")
    merge_boxes = pipe.merge_boxes
    pipe.merge_boxes = lambda *a: [b for box in merge_boxes(*a)
                                   for b in degenerate(box)]
    refuse_batches(monkeypatch, pipe.segmenter.ensemble)
    out = tmp_path / "out"
    with caplog.at_level(logging.WARNING, logger=port_e2e.__name__):
        canvas = pipe.run_slide(path, str(out), pid,
                                json_dir=str(out / "json"))
    n = len(rows(out / CSV))
    assert n > 0 and n % 2 == 0
    assert pipe.degenerate_boxes == {pid: n}
    assert f"{pid}: {n} merged box(es) of zero width or height" in \
        caplog.text
    assert crop_files(out, pid) == [] and not canvas.any()
    assert (out / f"{pid}_pred.jpg").stat().st_size > 0


@pytest.fixture(scope="module")
def layout(tmp_path_factory, variables):
    """One slide under the staining's directory, its target list, two
    fold checkpoints and a SegFormer training output."""
    root = tmp_path_factory.mktemp("degenerate_cli")
    slide_dir = root / "data" / "02_PAS" / PATIENT
    slide_dir.mkdir(parents=True)
    write_slide(slide_dir / f"{PATIENT}.tiff", seed=31)
    (root / "targets.txt").write_text(f"{PATIENT}/{PATIENT}.tiff\n")
    (root / "weights").mkdir()
    for fold in (1, 2):
        torch.save(random_state_dict(fold, 5, p=2, q=2),
                   root / "weights" / f"espnet_fold{fold}.pth")
    ckpt = root / "ckpt" / "checkpoint-3"
    ckpt.mkdir(parents=True)
    save_torch_legacy({"params": variables["params"],
                       "batch_stats": variables["batch_stats"],
                       "num_labels": 5}, str(ckpt / "flax_model.pth"))
    return root


FAMILIES = {
    "espnet": lambda root: ["--segmentation_weights_dir",
                            str(root / "weights"), "--folds", "1", "2",
                            "--precision", "highest"],
    "segformer": lambda root: ["--segformer_checkpoint",
                               str(root / "ckpt" / "checkpoint-3"),
                               "--input_size", str(INPUT)],
}


def _argv(root, out, family):
    return ["--model", "stub", "--output_dir", str(out),
            "--seg_batch_size", "2", "--window_size", "64",
            "--overlap_ratio", "0.5", "--conf_threshold", "0.5",
            *FAMILIES[family](root)]


def _inputs(root):
    return ["--target_list", str(root / "targets.txt"),
            "--data_dir", str(root / "data")]


@pytest.fixture
def stub_detector(monkeypatch):
    backend = StubBackend()
    monkeypatch.setattr(port_cli_detect, "load_backend",
                        lambda *a, **k: backend)


@pytest.fixture
def injection(monkeypatch):
    """``start()`` makes every ``FusedEndToEnd``'s merge step add the two
    boxes (the zero-height one second, the zero-width one third) and
    returns the list of the merged lists it gives."""
    def start():
        seen = []
        merge_boxes = port_e2e.FusedEndToEnd.merge_boxes

        def merged(self, *args):
            out = inject(lambda *a: merge_boxes(self, *a),
                         where=(1, 2))(*args)
            seen.append(out)
            return out

        monkeypatch.setattr(port_e2e.FusedEndToEnd, "merge_boxes", merged)
        return seen
    return start


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_e2e_cli_with_degenerate_boxes(layout, tmp_path, stub_detector,
                                       injection, family):
    """``gseg-e2e`` (the ESPNet JSON path, and ``--segformer_checkpoint``
    with its label PNGs) finishes the slide, and its artifacts equal the
    run's without the boxes apart from their CSV rows."""
    base = tmp_path / "base"
    port_cli_e2e.main(_argv(layout, base, family) + _inputs(layout),
                      device="cpu")
    seen = injection()
    got = tmp_path / "got"
    port_cli_e2e.main(_argv(layout, got, family) + _inputs(layout),
                      device="cpu")
    assert len(seen) == 1 and len(seen[0]) >= 3
    extra = [csv_line(PATIENT, f"{PATIENT}.tiff", b)
             for b in (seen[0][1], seen[0][2])]
    assert without(rows(got / CSV), extra) == rows(base / CSV)
    files = crop_files(got, PATIENT)
    assert files == crop_files(base, PATIENT)
    assert len(files) == len(rows(base / CSV))
    assert all(f.endswith(".json" if family == "espnet" else ".PNG")
               for f in files)
    for name in files + [f"{PATIENT}_pred.jpg"]:
        assert (got / name).read_bytes() == (base / name).read_bytes(), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serve_with_degenerate_boxes(layout, tmp_path, stub_detector,
                                     injection, family):
    """``gseg-serve``: the ticket goes to ``done/``, its log row counts the
    boxes, and the artifacts equal ``gseg-e2e``'s on the same slide, the
    boxes injected into both."""
    seen = injection()
    e2e = tmp_path / "e2e"
    port_cli_e2e.main(_argv(layout, e2e, family) + _inputs(layout),
                      device="cpu")
    spool = tmp_path / "spool"
    spool.mkdir()
    slide = layout / "data" / "02_PAS" / PATIENT / f"{PATIENT}.tiff"
    (spool / "job1.json").write_text(json.dumps(
        {"slide_path": str(slide), "patient_id": PATIENT}))
    out = tmp_path / "serve"
    port_cli_serve.main(_argv(layout, out, family) + [
        "--spool_dir", str(spool), "--max_slides", "1",
        "--poll_interval", "0.01"], device="cpu")
    assert sorted(p.name for p in (spool / "done").iterdir()) == \
        ["job1.json"]
    assert not list((spool / "failed").iterdir())
    logged = [json.loads(ln) for ln in
              (out / "serve_log.jsonl").read_text().splitlines()]
    assert [(r["status"], r["degenerate_boxes"]) for r in logged] == \
        [("done", 2)]
    assert len(seen) == 2 and seen[0] == seen[1]
    assert_same_artifacts(out, e2e, [PATIENT])


@pytest.mark.parametrize("pipeline", [True, False])
def test_server_rows_without_degenerate_boxes(ensembles, slides, tmp_path,
                                              pipeline):
    """A slide without such boxes keeps the row's keys: no
    ``degenerate_boxes``, as the JAX package's server writes it."""
    path, pid = slides[1]
    spool = tmp_path / "spool"
    spool.mkdir()
    (spool / "t.json").write_text(json.dumps({"slide_path": path,
                                              "patient_id": pid}))
    server = port_serve.SlideServer(
        _espnet_pipe(ensembles, "flat"), str(spool), str(tmp_path / "out"),
        poll_interval=0.01, pipeline=pipeline)
    assert server.serve(max_slides=1) == 1
    row, = [json.loads(ln) for ln in
            (tmp_path / "out" / "serve_log.jsonl").read_text().splitlines()]
    assert row["status"] == "done" and "degenerate_boxes" not in row
    assert server.pipe.degenerate_boxes == {}


@pytest.mark.parametrize("mode", ["gt", "no_gt"])
def test_make_seg_data_with_degenerate_boxes(tree, tmp_path, mode, caplog):
    """``gseg-make-seg-data`` (GT and no-GT mode) on the merged CSV with a
    zero-height and a zero-width row added: the crops and labels of the
    CSV without them, which equal the JAX command's, and a warning that
    counts them; so ``gseg-segment`` reads the same crops."""
    csv_rows = open(tree["merged_csv"]).read().splitlines(True)
    added = []
    for box in degenerate([int(v) for v in csv_rows[0].split(",")[3:7]]):
        fields = csv_rows[0].split(",")
        fields[3:7] = [str(v) for v in box]
        added.append(",".join(fields))
    with_bad = tmp_path / "merged_degenerate.csv"
    with_bad.write_text("".join(added[:1] + csv_rows + added[1:]))
    base = ["--staining", "OPT_PAS", "--target_list",
            str(tree["target_list"]), "--wsi_dir", str(tree["wsi_dir"])]
    if mode == "gt":
        base += ["--segmentation_gt_json_dir", str(tree["seg_gt_dir"]),
                 "--object_detection_gt_xml_dir", str(tree["data_dir"])]
    files = {}
    for name, cli, csv in (("jax", jax_seg_data_cli, tree["merged_csv"]),
                           ("port", port_seg_data_cli, tree["merged_csv"]),
                           ("degenerate", port_seg_data_cli, with_bad)):
        out = tmp_path / name
        caplog.clear()
        with caplog.at_level(logging.WARNING,
                             logger=port_seg_data.__name__):
            cli.main(base + ["--merged_detection_result_csv", str(csv),
                             "--output_dir", str(out)])
        files[name] = tree_files(out)
    assert "2 merged box(es) of zero width or height not cropped" in \
        caplog.text
    assert files["port"] == files["jax"]
    assert files["degenerate"] == files["port"]
    crops = [k for k in files["port"] if k.startswith("org_image/")]
    assert len(crops) == len(csv_rows)
