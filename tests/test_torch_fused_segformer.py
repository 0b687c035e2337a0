"""The port's SegFormer/GTCS slide path (``pipeline/fused_segformer.py``)
and its commands (``gseg-e2e`` and ``gseg-serve`` with
``--segformer_checkpoint``) against the JAX package's on the CPU: the
segmenter's canvases on the device-gather and ``on_crop`` paths and its
per-crop maps, a producer failure, the CLI's artifacts (merged CSV, label
PNGs, overlay) byte for byte with one stub detector on both sides, the
ESPNet-only flags' conflict, and the server's artifacts."""
import cv2
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import detect as jax_cli_detect
from glomeruli_segmentation_tpu.cli import e2e as jax_cli_e2e
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.pipeline import (
    fused_segformer as jax_fused_segformer,
)
from glomeruli_segmentation_tpu.wsi.tiff_reader import Slide as JaxSlide
from glomeruli_segmentation_tpu_torch import wsi as port_wsi
from glomeruli_segmentation_tpu_torch.cli import detect as port_cli_detect
from glomeruli_segmentation_tpu_torch.cli import e2e as port_cli_e2e
from glomeruli_segmentation_tpu_torch.cli import serve as port_cli_serve
from glomeruli_segmentation_tpu_torch.convert.segformer_import import (
    state_dict_from_variables,
)
from glomeruli_segmentation_tpu_torch.palette import GTCS_PALETTE
from glomeruli_segmentation_tpu_torch.pipeline import (
    fused_segformer as port_fused_segformer,
)

from test_e2e_fused import _make_slide
from test_fused_pipeline import _FailingSlide
from test_torch_e2e import (CSV, LOG, StubBackend, assert_same_artifacts,
                            crop_files, write_slide)
from test_torch_segformer import assert_wide_margins, jax_variables

# the network input of these tests (the CLI default is 512): the logits
# are 64x64, and crops of 133 to 1400 px upsample from them
INPUT = 256
# ragged crop sizes (two gather-table buckets) and an odd size
BOXES = [[64, 128, 576, 640], [700, 200, 1100, 900],
         [100, 900, 1500, 1400], [900, 1000, 1033, 1217]]
PATIENT = "H16-2"


@pytest.fixture(scope="module")
def variables():
    return jax_variables(seed=3)


@pytest.fixture(scope="module")
def slide_path(tmp_path_factory):
    path, _, _ = _make_slide(tmp_path_factory.mktemp("segformer_slide"),
                             patient="H16-88888")
    return str(path)


def _segment(segmenter, slide):
    """(device-gather canvas, on_crop canvas, per-crop maps)."""
    dets = [b + [0.95] for b in BOXES]
    maps = {}
    ds8 = segmenter.segment_slide(slide, dets)
    full = segmenter.segment_slide(
        slide, dets, on_crop=lambda box, m: maps.__setitem__(tuple(box), m))
    return ds8, full, maps


def test_segmenter_matches_jax(variables, slide_path):
    jax_seg = jax_fused_segformer.SegformerSlideSegmenter(
        variables, jax_fused_segformer.SegformerSlideConfig(
            input_size=INPUT, batch_size=2))
    port_seg = port_fused_segformer.SegformerSlideSegmenter(
        state_dict_from_variables(variables),
        port_fused_segformer.SegformerSlideConfig(input_size=INPUT,
                                                  batch_size=2),
        device="cpu")
    with JaxSlide(slide_path) as slide:
        crops = np.stack([cv2.resize(slide.read_region_array(
            (x1, y1), 0, (x2 - x1, y2 - y1)), (INPUT, INPUT),
            interpolation=cv2.INTER_LINEAR) for x1, y1, x2, y2 in BOXES])
        assert_wide_margins(np.asarray(jax_seg._logits(crops)))
        want = _segment(jax_seg, slide)
    with port_wsi.open_slide(slide_path) as slide:
        got = _segment(port_seg, slide)
    # the port's two paths: the same logits, the same blend
    assert np.array_equal(got[0], got[1])
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.uint8 and np.array_equal(g, w)
    assert got[2].keys() == want[2].keys() == {tuple(b) for b in BOXES}
    for box, m in got[2].items():
        x1, y1, x2, y2 = box
        assert m.shape == (y2 - y1, x2 - x1) and m.dtype == np.uint8
        assert np.array_equal(m, want[2][box]), box
    assert len(np.unique(got[0])) > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmenter_fixed_batch_shape(variables, slide_path, dtype):
    """Every batch has ``batch_size`` rows, zero past the chunk's crops,
    in both compute dtypes; the logits come out float32."""
    seg = port_fused_segformer.SegformerSlideSegmenter(
        state_dict_from_variables(variables),
        port_fused_segformer.SegformerSlideConfig(
            input_size=64, batch_size=2, compute_dtype=dtype), device="cpu")
    seen, logits = [], seg.logits

    def recording(batch):
        seen.append((tuple(batch.shape), int(batch[-1].sum())))
        out = logits(batch)
        assert out.dtype == torch.float32
        return out

    seg.logits = recording
    with port_wsi.open_slide(slide_path) as slide:
        canvas = seg.segment_slide(slide, [b + [0.9] for b in BOXES[:3]])
    assert seen[0][0] == seen[1][0] == (2, 64, 64, 3)
    assert seen[0][1] > 0 and seen[1][1] == 0
    assert canvas.max() < 5


def test_producer_failure_propagates(variables, slide_path):
    """A slide-read failure on the staging thread raises out of
    ``segment_slide`` instead of leaving a truncated canvas."""
    seg = port_fused_segformer.SegformerSlideSegmenter(
        state_dict_from_variables(variables),
        port_fused_segformer.SegformerSlideConfig(input_size=64,
                                                  batch_size=2),
        device="cpu")
    slide = _FailingSlide(port_wsi.open_slide(slide_path), fail_after=3)
    boxes = [[64 * (i % 4), 64, 64 * (i % 4) + 128, 192, 0.9]
             for i in range(8)]
    with pytest.raises(IOError, match="corrupt tile"):
        seg.segment_slide(slide, boxes)


@pytest.fixture(scope="module")
def layout(tmp_path_factory, variables):
    """One slide under the staining's directory, its target list, and a
    training output directory holding the checkpoint."""
    root = tmp_path_factory.mktemp("segformer_cli")
    slide_dir = root / "data" / "02_PAS" / PATIENT
    slide_dir.mkdir(parents=True)
    write_slide(slide_dir / f"{PATIENT}.tiff", seed=51)
    (root / "targets.txt").write_text(f"{PATIENT}/{PATIENT}.tiff\n")
    ckpt = root / "ckpt" / "checkpoint-3"
    ckpt.mkdir(parents=True)
    save_torch_legacy({"params": variables["params"],
                       "batch_stats": variables["batch_stats"],
                       "num_labels": 5}, str(ckpt / "flax_model.pth"))
    return root


@pytest.fixture
def stub_detectors(monkeypatch):
    """Both packages' ``load_backend`` return one numpy stub detector."""
    backend = StubBackend()
    for module in (jax_cli_detect, port_cli_detect):
        monkeypatch.setattr(module, "load_backend",
                            lambda *a, **k: backend)


def _argv(root, out, *extra):
    return ["--model", "stub", "--target_list", str(root / "targets.txt"),
            "--data_dir", str(root / "data"), "--output_dir", str(out),
            "--segformer_checkpoint", str(root / "ckpt" / "checkpoint-3"),
            "--input_size", str(INPUT), "--seg_batch_size", "2",
            "--window_size", "64", "--overlap_ratio", "0.5",
            "--conf_threshold", "0.5", *extra]


def test_e2e_cli_matches_jax(layout, tmp_path, stub_detectors):
    """Merged CSV, timing log rows, mode-'L' label PNGs and the
    GTCS-palette overlay byte-identical to the JAX command's; ``--resume``
    leaves both outputs alone."""
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port_cli_e2e.main(_argv(layout, port_out), device="cpu")
    jax_cli_e2e.main(_argv(layout, jax_out))
    pngs = crop_files(port_out, PATIENT)
    rows = (port_out / CSV).read_text().splitlines()
    assert len(pngs) == len(rows) > 0
    assert_same_artifacts(port_out, jax_out, [PATIENT])
    from PIL import Image

    for name in pngs:
        with Image.open(port_out / name) as im:
            assert im.mode == "L" and np.asarray(im).max() < 5
    before = {d: ((d / CSV).read_bytes(), (d / LOG).read_bytes())
              for d in (port_out, jax_out)}
    port_cli_e2e.main(_argv(layout, port_out, "--resume"), device="cpu")
    jax_cli_e2e.main(_argv(layout, jax_out, "--resume"))
    assert {d: ((d / CSV).read_bytes(), (d / LOG).read_bytes())
            for d in (port_out, jax_out)} == before


def test_build_pipeline_selects_gtcs_family(layout):
    args = port_cli_e2e.build_parser().parse_args(
        _argv(layout, layout / "unused"))
    pipe = port_cli_e2e.build_pipeline(args, StubBackend(), device="cpu")
    seg = pipe.segmenter
    assert isinstance(seg, port_fused_segformer.SegformerSlideSegmenter)
    assert (seg.config.input_size, seg.config.batch_size,
            seg.config.num_labels, seg.config.compute_dtype) == \
        (INPUT, 2, 5, "float32")
    assert pipe.crop_artifact == "png" and pipe.palette is GTCS_PALETTE
    args = port_cli_e2e.build_parser().parse_args(
        ["--model", "m", "--target_list", "t", "--data_dir", "d"])
    with pytest.raises(SystemExit, match="--segmentation_weights_dir is "
                                         "required"):
        port_cli_e2e.build_pipeline(args, StubBackend(), device="cpu")


@pytest.mark.parametrize("extra", [
    ["--segmentation_weights_dir", "w"], ["--folds", "1"],
    ["--engine", "packed"], ["--precision", "highest"],
    ["--transfer", "padded"], ["--host_resize"], ["--pack_output"],
    ["--fold_parallel", "2"], ["--folds", "1", "2", "--host_resize"]])
def test_espnet_only_flags_conflict_like_jax(layout, tmp_path, extra,
                                             stub_detectors):
    messages = []
    for main in (lambda a: port_cli_e2e.main(a, device="cpu"),
                 jax_cli_e2e.main):
        with pytest.raises(SystemExit) as e:
            main(_argv(layout, tmp_path / "o", *extra))
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert messages[0].startswith("these flags apply only to the 5-fold "
                                  "ESPNet ensemble and conflict with "
                                  "--segformer_checkpoint: ")
    assert not (tmp_path / "o").exists()


def test_data_parallel_stays_refused(layout, tmp_path, stub_detectors):
    with pytest.raises(SystemExit, match="not ported: --data_parallel"):
        port_cli_e2e.main(_argv(layout, tmp_path / "o", "--data_parallel",
                                "2"), device="cpu")


def test_serve_leaves_the_artifacts_of_e2e(layout, tmp_path,
                                           stub_detectors):
    e2e_out, serve_out = tmp_path / "e2e", tmp_path / "serve"
    port_cli_e2e.main(_argv(layout, e2e_out), device="cpu")
    spool = tmp_path / "spool"
    spool.mkdir()
    (spool / "job1.json").write_text(
        '{"slide_path": "%s", "patient_id": "%s"}'
        % (layout / "data" / "02_PAS" / PATIENT / f"{PATIENT}.tiff",
           PATIENT))
    argv = [a for a in _argv(layout, serve_out)]
    i = argv.index("--target_list")
    del argv[i: i + 4]                       # no target list or data dir
    port_cli_serve.main(argv + ["--spool_dir", str(spool), "--max_slides",
                                "1", "--poll_interval", "0.01"],
                        device="cpu")
    assert sorted(p.name for p in (spool / "done").iterdir()) == \
        ["job1.json"]
    assert_same_artifacts(serve_out, e2e_out, [PATIENT])
