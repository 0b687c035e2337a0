"""The port's detect stage (``gseg-detect``: ``GlomusDetector.split_all``,
``split``, ``resume``, the PNG path and ``cli/detect.main``) against the
JAX package's on the CPU, and the staged chain detect -> merge against the
port's end-to-end merged boxes."""
import functools
import re

import numpy as np
import pytest
import torch
from PIL import Image

from glomeruli_segmentation_tpu.cli import detect as jax_cli_detect
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.cli import detect as cli_detect
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused
from glomeruli_segmentation_tpu_torch.pipeline.merge import run_merge
from glomeruli_segmentation_tpu_torch.wsi.synthetic import pas_like_image

from test_torch_e2e import CSV, StubBackend, write_slide
from test_torch_e2e_cli import _write_detector_ckpt

TIFF, PNG = "H16-1", "H16-2"
# 64 um windows: the 10x TIFF is read at level 1 in 128-px windows; the PNG
# stands for a 1536x2048 slide at downsample 8, so its windows are 32 px
GEOMETRY = dict(window_size=64, overlap_ratio=0.5)
PNG_META = "1536,2048,40,8.0,0.25,0.25"
PACKAGES = {"port": port_detect.GlomusDetector,
            "jax": jax_detect.GlomusDetector}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """``<root>/data/02_PAS/<specimen>/`` with a pyramidal TIFF and a PNG
    (a /8 PAS-like image), and target lists naming one or both."""
    root = tmp_path_factory.mktemp("detect_stage")
    for pid in (TIFF, PNG):
        (root / "data" / "02_PAS" / pid).mkdir(parents=True)
    write_slide(root / "data" / "02_PAS" / TIFF / f"{TIFF}.tiff", seed=60)
    img = pas_like_image(1536, 2048, seed=61, n_glomeruli=4)[0][::8, ::8]
    Image.fromarray(img).save(root / "data" / "02_PAS" / PNG / f"{PNG}.png")
    (root / "both.txt").write_text(f"#H16-0/x.tiff\n{TIFF}/{TIFF}.tiff\n"
                                   f"{PNG}/{PNG}.png,{PNG_META}\n"
                                   f"H16-missing/H16-missing.tiff\n")
    (root / "tiff.txt").write_text(f"{TIFF}/{TIFF}.tiff\n")
    return root


def _mask_time(rows):
    return [re.sub(r",new,[^,]+,", ",new,T,", r) for r in rows]


def _outputs(out, ext):
    """(CSV rows without their timestamps, timing-log rows without their
    times)."""
    csv = (out / f"OPT_PAS{ext}.csv").read_text().splitlines()
    log = (out / f"OPT_PAS{ext}_log.csv").read_text().splitlines()
    return _mask_time(csv), [log[0]] + [r.split(",")[0] for r in log[1:]]


def _split_all(name, data, target_list, out, **kw):
    det = PACKAGES[name]("OPT_PAS", str(data / target_list),
                         str(data / "data"), str(out), "_s",
                         conf_threshold=0.5, batch_size=4, **GEOMETRY, **kw)
    det.split_all(StubBackend())
    return det


def test_split_all_tiff_and_png_match_jax(data, tmp_path):
    """One stub backend, one target list with a TIFF slide and a PNG: the
    same CSV rows (timestamps aside) and timing-log rows (times aside)."""
    got = {}
    for name in PACKAGES:
        _split_all(name, data, "both.txt", tmp_path / name)
        got[name] = _outputs(tmp_path / name, "_s")
    assert got["port"] == got["jax"]
    rows, log = got["port"]
    assert log == ["file,time", f'"{TIFF}.tiff"', f'"{PNG}.png"']
    for pid in (TIFF, PNG):
        assert any(f'"{pid}"' in r for r in rows), pid
    # the PNG path writes level-0 coordinates: window offsets x downsample 8
    png_x2 = [float(r.split(",")[7]) for r in rows if f'"{PNG}"' in r]
    assert max(png_x2) > 256 * 2


def test_resume_matches_jax(data, tmp_path):
    """A run over the TIFF alone, then ``resume=True`` over both: the TIFF
    is skipped, the PNG appended (no second header); a second resume
    changes nothing.  The same files and completed sets as the JAX
    package's."""
    got = {}
    for name in PACKAGES:
        out = tmp_path / name
        _split_all(name, data, "tiff.txt", out)
        first = _outputs(out, "_s")
        det = _split_all(name, data, "both.txt", out, resume=True)
        second = _outputs(out, "_s")
        again = _split_all(name, data, "both.txt", out, resume=True)
        got[name] = (first, det._completed, second, again._completed,
                     _outputs(out, "_s"))
    assert got["port"] == got["jax"]
    first, done1, second, done2, third = got["port"]
    assert done1 == {f"{TIFF}.tiff"}
    assert done2 == {f"{TIFF}.tiff", f"{PNG}.png"}
    assert second[0][:len(first[0])] == first[0]
    assert second[1] == ["file,time", f'"{TIFF}.tiff"', f'"{PNG}.png"']
    assert third == second


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("detect_model")
    _write_detector_ckpt(d / "detector.ckpt.pth")
    return d


def test_main_matches_jax(data, model_dir, tmp_path, monkeypatch):
    """``cli/detect.main`` on a ``detector.ckpt.pth`` (the tiny ResNet
    detector on the CPU) against the JAX package's ``main``: the same rows,
    coordinates and scores to 1e-6.  Both backends compute in f32 here:
    the CLIs' bf16 default rounds differently in XLA and in torch."""
    for cls in (port_detect.TorchDetectorBackend,
                jax_detect.JaxDetectorBackend):
        monkeypatch.setattr(cls, "__init__", functools.partialmethod(
            cls.__init__, compute_dtype="float32"))

    def argv(out):
        return ["--model", str(model_dir),
                "--target_list", str(data / "tiff.txt"),
                "--data_dir", str(data / "data"), "--staining", "OPT_PAS",
                "--output_dir", str(out), "--batch_size", "4",
                "--window_size", "64", "--overlap_ratio", "0.5",
                "--conf_threshold", "0.3"]

    jax_cli_detect.main(argv(tmp_path / "jax"))
    cli_detect.main(argv(tmp_path / "port"), device="cpu")
    got = _outputs(tmp_path / "port", "_GlomusList")
    want = _outputs(tmp_path / "jax", "_GlomusList")
    assert got[1] == want[1] == ["file,time", f'"{TIFF}.tiff"']
    assert len(got[0]) == len(want[0]) > 10
    assert [r.split(",")[:5] for r in got[0]] == \
        [r.split(",")[:5] for r in want[0]]
    np.testing.assert_allclose(
        [[float(v) for v in r.split(",")[5:]] for r in got[0]],
        [[float(v) for v in r.split(",")[5:]] for r in want[0]],
        rtol=1e-6, atol=1e-6)


def test_main_runs_on_cuda_by_default(data, model_dir, tmp_path,
                                      monkeypatch):
    """Without ``device`` the command asks for the card, and raises where
    there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_detect.main(["--model", str(model_dir),
                         "--target_list", str(data / "tiff.txt"),
                         "--data_dir", str(data / "data"),
                         "--output_dir", str(tmp_path)])


def test_staged_detect_merge_equals_e2e(data, tmp_path):
    """The staged chain (``split_all`` -> detect CSV -> ``run_merge``)
    gives the port's end-to-end merged boxes, and segmenting the staged
    boxes gives the end-to-end canvas."""
    _split_all("port", data, "tiff.txt", tmp_path / "staged")
    merged_csv = run_merge("OPT_PAS", str(tmp_path / "staged" / "OPT_PAS_s.csv"),
                           str(tmp_path / "staged"), "s", 0.9,
                           str(data / "data"), 0.35, str(data / "tiff.txt"))
    staged = [[float(v) for v in ln.split(",")[3:8]]
              for ln in open(merged_csv).read().splitlines()]

    ckpt = tmp_path / "espnet_fold1.pth"
    torch.save(random_state_dict(1, 5, p=1, q=2), ckpt)
    ensemble = port_fused.EnsembleSegmenter(port_fused.EnsembleConfig(
        checkpoints=[str(ckpt)], folds=(1,), in_height=64, in_width=128,
        batch_size=2, compute_dtype="float32", precision="highest"),
        engine="packed", device="cpu")
    pipe = port_e2e.FusedEndToEnd(StubBackend(), ensemble, **GEOMETRY,
                                  detect_conf=0.5, merge_conf=0.9,
                                  merge_overlap=0.35)
    path = str(data / "data" / "02_PAS" / TIFF / f"{TIFF}.tiff")
    out = tmp_path / "e2e"
    canvas = pipe.run_slide(path, str(out), TIFF, write_overlay=False)
    e2e = [[float(v) for v in ln.split(",")[3:8]]
           for ln in (out / CSV).read_text().splitlines()]
    assert len(e2e) == len(staged) > 0
    np.testing.assert_allclose(sorted(e2e), sorted(staged), rtol=1e-6)
    with port_wsi.open_slide(path) as slide:
        want = port_fused.FusedSlideSegmenter(ensemble).segment_slide(
            slide, staged)
    np.testing.assert_array_equal(canvas, want)
    assert canvas.max() > 0
