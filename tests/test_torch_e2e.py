"""The port's end-to-end slide pipeline (``pipeline/e2e.py``) against the
JAX package's ``FusedEndToEnd`` on the CPU, at small sizes: the same
synthetic pyramidal TIFFs (the JAX package's writer) through both, with
the detector backends and the packed ensembles of both packages built from
the same weights, and with one numpy stub backend shared by both; then the
port's cross-slide pipelining, its failure rules, the resume bookkeeping
and the overlay writer."""
import glob
import os
import sys

import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu.pipeline import e2e as jax_e2e
from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide as JaxSlide
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.faster_rcnn import (
    FasterRCNNConfig,
)
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused

from test_torch_faster_rcnn import DETECT, DETECT_SEED, _setup
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MPP = 0.25
FOLDS = (1, 2)
SMALL = dict(folds=FOLDS, p=2, q=2, in_height=64, in_width=128,
             batch_size=2, compute_dtype="float32", precision="highest")
# 64 um windows on a 10x slide: the scan reads level 1 (downsample 2) in
# windows of 128 px, the tiny detector's own size, 48 windows a slide
GEOMETRY = dict(window_size=64, overlap_ratio=0.5, merge_overlap=0.35)
# the random detector's scores lie in 0.35..0.49: these thresholds keep a
# few boxes, away from every score
REAL_CONF = dict(detect_conf=0.3, merge_conf=0.4)
CSV = "OPT_PAS_GlomusMergedList_.csv"
LOG = "OPT_PAS_GlomusMergedList__log.csv"


def write_slide(path, seed, levels=4, compression="jpeg"):
    """A 768x1024 PAS-like pyramid at 0.25 um/px, objective 10."""
    img, _ = pas_like_image(768, 1024, seed=seed, n_glomeruli=4)
    write_pyramidal_tiff(str(path), img, mpp=MPP, objective_power=10.0,
                         levels=levels, compression=compression)
    return str(path)


@pytest.fixture(scope="module")
def slides(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e_slides")
    return [(write_slide(d / f"H{i}.tiff", seed=30 + i), f"H{i}")
            for i in range(3)]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e_folds")
    paths = []
    for fold in FOLDS:
        path = d / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, 5, p=2, q=2), path)
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def ensembles(checkpoints):
    """(port, JAX) packed ensembles on the same checkpoints."""
    return (port_fused.EnsembleSegmenter(
                port_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
                engine="packed", device="cpu"),
            jax_fused.EnsembleSegmenter(
                jax_fused.EnsembleConfig(checkpoints=checkpoints, **SMALL),
                engine="packed"))


@pytest.fixture(scope="module")
def backends():
    """(port, JAX) ResNet detector backends from the same Flax variables
    (the tiny backbone at 128x128, BN statistics calibrated)."""
    _, variables, _, _, _, _, _ = _setup("detect", DETECT_SEED)
    return (port_detect.TorchDetectorBackend(
                state_dict_from_flax(variables), FasterRCNNConfig(**DETECT),
                batch_size=4, compute_dtype="float32", device="cpu"),
            jax_detect.JaxDetectorBackend(
                variables, jax_frcnn.FasterRCNNConfig(**DETECT),
                batch_size=4, compute_dtype="float32"))


class StubBackend:
    """Deterministic numpy detections: per window, the bounding box of its
    dark (glomerulus-coloured) pixels at score 0.95, none where it has too
    few.  No async pair, so the scans take the synchronous path."""

    batch_size = 4

    def detect_batch(self, images):
        b, h, w, _ = images.shape
        boxes = np.zeros((b, 1, 4), np.float32)
        scores = np.zeros((b, 1), np.float32)
        for i, im in enumerate(images):
            ys, xs = np.nonzero(im.mean(axis=-1) < 185)
            if len(ys) >= 50:
                boxes[i, 0] = [ys.min() / h, xs.min() / w, ys.max() / h,
                               xs.max() / w]
                scores[i, 0] = 0.95
        return (boxes, scores, np.ones((b, 1), np.float32),
                (scores[:, 0] > 0).astype(np.float32))


def run_both(port_pipe, jax_pipe, slide, tmp_path, **kw):
    """One slide through each pipeline -> (port dir, JAX dir, canvases)."""
    path, pid = slide
    out = {}
    for name, pipe in (("port", port_pipe), ("jax", jax_pipe)):
        d = tmp_path / name
        out[name] = (d, pipe.run_slide(path, str(d), pid,
                                       json_dir=str(d / "json"), **kw))
    return out["port"], out["jax"]


def rows(path):
    return path.read_text().splitlines()


def log_rows(path):
    """Timing-log rows without their times: header, then patient ids."""
    lines = rows(path)
    return [lines[0]] + [ln.split(",")[0] for ln in lines[1:]]


def crop_files(d, pid):
    return sorted(os.path.relpath(p, d) for p in glob.glob(
        str(d / "json" / pid / "*")))


def assert_same_artifacts(port_dir, jax_dir, pids, csv_exact=True):
    """Merged CSV, timing log (apart from its times), every per-crop file
    and every overlay of two output directories."""
    got, want = rows(port_dir / CSV), rows(jax_dir / CSV)
    if csv_exact:
        assert got == want
    else:
        # every column but the confidence; that is the detector's f32
        # score, from convolutions the two frameworks sum in another order
        assert [r.rsplit(",", 1)[0] for r in got] == \
            [r.rsplit(",", 1)[0] for r in want]
        np.testing.assert_allclose([float(r.rsplit(",", 1)[1]) for r in got],
                                   [float(r.rsplit(",", 1)[1]) for r in want],
                                   rtol=1e-6, atol=1e-6)
    assert log_rows(port_dir / LOG) == log_rows(jax_dir / LOG)
    for pid in pids:
        names = crop_files(port_dir, pid)
        assert names == crop_files(jax_dir, pid)
        for name in names:
            assert (port_dir / name).read_bytes() == \
                (jax_dir / name).read_bytes(), name
        assert (port_dir / f"{pid}_pred.jpg").read_bytes() == \
            (jax_dir / f"{pid}_pred.jpg").read_bytes()


def test_real_backends_match_jax(backends, ensembles, slides, tmp_path):
    """The port's detector and packed ensemble against the JAX package's,
    from the same weights: the same merged boxes, byte-identical labelme
    JSONs and overlay, equal canvases, the same CSV rows (confidences to
    f32 rounding) and timing-log rows."""
    port_pipe = port_e2e.FusedEndToEnd(backends[0], ensembles[0],
                                       **GEOMETRY, **REAL_CONF)
    jax_pipe = jax_e2e.FusedEndToEnd(backends[1], ensembles[1], **GEOMETRY,
                                     **REAL_CONF)
    (pd, pc), (jd, jc) = run_both(port_pipe, jax_pipe, slides[0], tmp_path)
    pid = slides[0][1]
    assert len(rows(pd / CSV)) >= 2
    assert len(crop_files(pd, pid)) == len(rows(pd / CSV))
    np.testing.assert_array_equal(pc, jc)
    assert pc.max() > 0
    assert_same_artifacts(pd, jd, [pid], csv_exact=False)


@pytest.mark.parametrize("crop_artifact,transfer",
                         [("labelme", "auto"), ("png", "padded")])
def test_stub_backend_matches_jax(ensembles, slides, tmp_path,
                                  crop_artifact, transfer):
    """One numpy backend shared by both pipelines: merge, segment and emit
    give byte-identical artifacts, labelme JSONs or label PNGs."""
    backend = StubBackend()
    kw = dict(GEOMETRY, detect_conf=0.5, merge_conf=0.9,
              crop_artifact=crop_artifact, transfer=transfer)
    port_pipe = port_e2e.FusedEndToEnd(backend, ensembles[0], **kw)
    jax_pipe = jax_e2e.FusedEndToEnd(backend, ensembles[1], **kw)
    assert port_pipe.segmenter.transfer == \
        ("flat" if transfer == "auto" else transfer)
    (pd, pc), (jd, jc) = run_both(port_pipe, jax_pipe, slides[1], tmp_path)
    pid = slides[1][1]
    files = crop_files(pd, pid)
    assert files and len(files) == len(rows(pd / CSV))
    assert all(f.endswith(".json" if crop_artifact == "labelme" else ".PNG")
               for f in files)
    np.testing.assert_array_equal(pc, jc)
    assert_same_artifacts(pd, jd, [pid])


def test_run_slides_pipelined_matches_serial(backends, ensembles, slides,
                                             tmp_path):
    """Three slides through the port with its real backends: the pipelined
    run's artifacts are byte-identical to the serial run's, and both
    equal one run_slide per slide."""
    pipe = port_e2e.FusedEndToEnd(backends[0], ensembles[0], **GEOMETRY,
                                  **REAL_CONF)
    dirs = {}
    for mode in ("serial", "pipelined"):
        d = tmp_path / mode
        port_e2e.FusedEndToEnd.prepare_output(str(d), "OPT_PAS")
        seen = []
        assert pipe.run_slides(slides, str(d), json_dir=str(d / "json"),
                               pipeline=mode == "pipelined",
                               on_result=lambda *r: seen.append(r)) == 3
        assert [(r[0], r[2]) for r in seen] == \
            [(pid, None) for _, pid in slides]
        dirs[mode] = d
    one = tmp_path / "one_by_one"
    for path, pid in slides:
        pipe.run_slide(path, str(one), pid, json_dir=str(one / "json"))
    pids = [pid for _, pid in slides]
    assert_same_artifacts(dirs["pipelined"], dirs["serial"], pids)
    assert_same_artifacts(dirs["serial"], one, pids)


@pytest.mark.parametrize("pipeline", [False, True])
def test_run_slides_failure_rules(ensembles, slides, tmp_path, pipeline):
    """With a reporter a failing slide is isolated and later slides run;
    without one the stream stops at the first failure and re-raises."""
    pipe = port_e2e.FusedEndToEnd(StubBackend(), ensembles[0], **GEOMETRY,
                                  detect_conf=0.5, merge_conf=0.9)
    bad = [slides[0], (str(tmp_path / "missing.tiff"), "GHOST"), slides[2]]
    results = []
    out = tmp_path / "isolated"
    port_e2e.FusedEndToEnd.prepare_output(str(out), "OPT_PAS")
    ok = pipe.run_slides(bad, str(out), write_overlay=False,
                         pipeline=pipeline,
                         on_result=lambda pid, sp, err, sec:
                         results.append((pid, err is None)))
    assert ok == 2
    assert results == [(slides[0][1], True), ("GHOST", False),
                       (slides[2][1], True)]
    assert log_rows(out / LOG)[1:] == [f'"{slides[0][1]}"',
                                       f'"{slides[2][1]}"']
    stopped = tmp_path / "stopped"
    with pytest.raises(FileNotFoundError):
        pipe.run_slides(bad, str(stopped), write_overlay=False,
                        pipeline=pipeline)
    # the slide before the failure is written and the failing one is not;
    # a pipelined run may still finish the slide it had in flight
    logged = log_rows(stopped / LOG)[1:]
    assert logged[0] == f'"{slides[0][1]}"' and '"GHOST"' not in logged
    if not pipeline:
        assert logged == [f'"{slides[0][1]}"']


def test_prepare_output_resume_matches_jax(tmp_path):
    """Resume keeps the timing log's slides and sweeps CSV rows of slides
    without a log row; a fresh run truncates.  The same files as the JAX
    package's, step by step."""
    csv_rows = [',H1,"H1.tiff",1,2,3,4,0.95\n',
                ',H2,"H2.tiff",5,6,7,8,0.97\n',
                ',H9,"H9.tiff",1,2,3,4,0.5\n']
    log = ('file,time,detect_time,timestamp\n'
           '"H1",1.0,0.5,2026-01-01T00:00:00\n'
           '"H2",1.0,0.5,2026-01-01T00:00:00\n')
    results = {}
    for name, cls in (("port", port_e2e.FusedEndToEnd),
                      ("jax", jax_e2e.FusedEndToEnd)):
        d = tmp_path / name
        d.mkdir()
        (d / CSV).write_text("".join(csv_rows))
        (d / LOG).write_text(log)
        done = cls.prepare_output(str(d), "OPT_PAS", resume=True)
        swept = (d / CSV).read_text()
        again = cls.prepare_output(str(d), "OPT_PAS", resume=True)
        fresh = cls.prepare_output(str(d), "OPT_PAS")
        results[name] = (done, swept, again, fresh, sorted(os.listdir(d)))
    assert results["port"] == results["jax"]
    done, swept, again, fresh, left = results["port"]
    assert done == again == {"H1", "H2"}
    assert swept == "".join(csv_rows[:2])
    assert fresh == set() and left == []


@pytest.mark.parametrize("levels", [4, 3])
def test_overlay_matches_jax(tmp_path, levels):
    """The overlay from the downsample-8 pyramid level (4 levels) and from
    level-0 decimation (3 levels): byte-identical to the JAX package's."""
    path = write_slide(tmp_path / "s.tiff", seed=41, levels=levels)
    canvas = np.zeros((768 // 8, 1024 // 8), np.uint8)
    canvas[20:60, 30:90] = 2
    canvas[70:80, 10:20] = 4
    for name, pipe, open_slide in (
            ("port", port_e2e.FusedEndToEnd(StubBackend(), segmenter=object()),
             port_wsi.open_slide),
            ("jax", jax_e2e.FusedEndToEnd(StubBackend(), segmenter=object()),
             JaxSlide)):
        (tmp_path / name).mkdir()
        with open_slide(path) as slide:
            assert (abs(slide.level_downsamples[-1] - 8.0) < 1e-6) == \
                (levels == 4)
            pipe._write_overlay(slide, canvas, str(tmp_path / name), "P")
    assert (tmp_path / "port" / "P_pred.jpg").read_bytes() == \
        (tmp_path / "jax" / "P_pred.jpg").read_bytes()


def test_overlay_pyramid_edge_filled_matches_jax(tmp_path):
    """A downsample-8 level one pixel short of the /8 canvas on both axes:
    the right and bottom edges come from level-0 decimation, as in the JAX
    package, not black."""
    import cv2

    h8, w8 = 64, 96

    class ShortLevelSlide:
        level_downsamples = [1.0, 8.0]
        level_dimensions = [(w8 * 8, h8 * 8), (w8 - 1, h8 - 1)]

        def get_best_level_for_downsample(self, ds):
            return 1

        def read_region_array(self, location, level, size):
            w, h = size
            return np.full((h, w, 3), 255, np.uint8)

    canvas = np.zeros((h8, w8), np.uint8)
    for name, cls in (("port", port_e2e.FusedEndToEnd),
                      ("jax", jax_e2e.FusedEndToEnd)):
        (tmp_path / name).mkdir()
        cls(StubBackend(), segmenter=object())._write_overlay(
            ShortLevelSlide(), canvas, str(tmp_path / name), "P")
    got = tmp_path / "port" / "P_pred.jpg"
    assert got.read_bytes() == (tmp_path / "jax" / "P_pred.jpg").read_bytes()
    jpg = cv2.imread(str(got))
    assert jpg[:, -1].mean() > 60 and jpg[-1, :].mean() > 60


def test_unported_options_raise(ensembles):
    """``host_resize`` is taken as the JAX package takes it (the padded
    transfer under ``"auto"``; ``"flat"`` raises its error); a bad
    ``crop_artifact`` or both an ensemble and a segmenter raise."""
    for transfer, want in (("auto", "padded"), ("padded", "padded")):
        pipes = [cls(StubBackend(), ens, host_resize=True,
                     transfer=transfer)
                 for cls, ens in ((port_e2e.FusedEndToEnd, ensembles[0]),
                                  (jax_e2e.FusedEndToEnd, ensembles[1]))]
        assert [(p.segmenter.host_resize, p.segmenter.transfer)
                for p in pipes] == [(True, want)] * 2
    for cls, ens in ((port_e2e.FusedEndToEnd, ensembles[0]),
                     (jax_e2e.FusedEndToEnd, ensembles[1])):
        with pytest.raises(ValueError, match="transfer='flat' is "
                                             "single-device"):
            cls(StubBackend(), ens, host_resize=True, transfer="flat")
    with pytest.raises(ValueError, match="crop_artifact"):
        port_e2e.FusedEndToEnd(StubBackend(), ensembles[0],
                               crop_artifact="tiff")
    with pytest.raises(ValueError, match="OR segmenter"):
        port_e2e.FusedEndToEnd(StubBackend(), ensembles[0],
                               segmenter=object())


@pytest.mark.parametrize("missing", ["PIL", "cv2"])
def test_missing_image_library_raises(ensembles, slides, tmp_path,
                                      monkeypatch, missing):
    """Without PIL the labelme JSONs, and without cv2 their contours and
    the overlay, raise ImportError where they are written; nothing takes
    another path."""
    pipe = port_e2e.FusedEndToEnd(StubBackend(), ensembles[0], **GEOMETRY,
                                  detect_conf=0.5, merge_conf=0.9)
    # uncompressed, so that the slide reads need no PIL
    path, pid = write_slide(tmp_path / "raw.tiff", 31, compression="none"), "R"
    monkeypatch.setitem(sys.modules, missing, None)
    with pytest.raises(ImportError):
        pipe.run_slide(path, str(tmp_path / "j"), pid,
                       json_dir=str(tmp_path / "j" / "json"),
                       write_overlay=False)
    if missing == "cv2":
        with pytest.raises(ImportError):
            pipe.run_slide(path, str(tmp_path / "o"), pid)


# ---- the per-crop artifact writer's threads ----
def test_crop_writer_writes_every_crop_and_raises_the_first_failure():
    import threading
    import time

    written, lock = [], threading.Lock()
    waiting, most = [0], [0]

    def write(box, class_map):
        time.sleep(0.002)
        with lock:
            written.append(box)
            waiting[0] -= 1

    with port_e2e._CropWriter(write) as writer:
        for i in range(40):
            with lock:
                waiting[0] += 1
                most[0] = max(most[0], waiting[0])
            writer.submit(i, None)
    assert sorted(written) == list(range(40))
    # a crop's map is held from its submit to its write: at most twice as
    # many crops as threads (one more while submit waits for a slot)
    assert most[0] <= 2 * port_e2e.CROP_WRITERS + 1

    def failing(box, class_map):
        if box in (3, 7):
            raise ValueError(f"crop {box}")

    with pytest.raises(ValueError, match="crop 3"):
        with port_e2e._CropWriter(failing) as writer:
            for i in range(10):
                writer.submit(i, None)


def test_crop_writer_waits_and_keeps_the_segmenters_error():
    """An error of the segmentation itself is what leaves the block, after
    every write submitted before it has finished."""
    import time

    done = []

    def write(box, class_map):
        time.sleep(0.01)
        done.append(box)

    with pytest.raises(KeyError):
        with port_e2e._CropWriter(write) as writer:
            for i in range(6):
                writer.submit(i, None)
            raise KeyError("segmenter")
    assert sorted(done) == list(range(6))


def test_pipelined_runs_scan_on_one_thread_across_calls(ensembles, slides,
                                                        tmp_path):
    """Every pipelined ``run_slides`` call of a pipe scans on the pipe's
    one scanning thread, not on a thread of its own: on a card a thread
    that ran the detector keeps the CUDA libraries' per-thread state after
    it exits, so a thread per call (per wave of a resident server) would
    leak it.  No thread is left behind but that one."""
    import threading

    scanned = []

    class Recording(StubBackend):
        def detect_batch(self, images):
            scanned.append(threading.get_native_id())
            return super().detect_batch(images)

    pipe = port_e2e.FusedEndToEnd(Recording(), ensembles[0], **GEOMETRY,
                                  detect_conf=0.5, merge_conf=0.9)
    threads = []
    for call in range(3):
        d = tmp_path / f"call{call}"
        port_e2e.FusedEndToEnd.prepare_output(str(d), "OPT_PAS")
        assert pipe.run_slides(slides[:2], str(d), pipeline=True) == 2
        threads.append(threading.active_count())
    assert len(set(scanned)) == 1 and \
        scanned[0] != threading.get_native_id()
    assert threads[0] == threads[1] == threads[2]
