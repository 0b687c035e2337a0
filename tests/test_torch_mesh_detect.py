"""The window mesh of the port's detectors against the JAX package's on
the CPU: both backends with ``data_parallel=2`` and ``gseg-detect
--data_parallel 2`` on 2 logical CPU devices against the JAX package's
virtual CPU devices (``tests/conftest.py``), in f32."""
import numpy as np

from glomeruli_segmentation_tpu.cli import detect as jax_cli_detect
from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu_torch.cli import detect as cli_detect
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models.faster_rcnn import (
    FasterRCNNConfig,
)
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect

from test_od_api_import import build_od_api_consts
from test_torch_detect_stage import _outputs
from test_torch_faster_rcnn import DETECT, DETECT_SEED, _setup
from test_torch_mesh_pipelines import (cpus, fold_dir, layout,  # noqa
                                       small_f32)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assert_detections(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_detector_window_meshes_match_jax():
    """Both backends with ``data_parallel=2``: each window batch split
    2 + 2 over the mesh, one replica a device; the detections equal the
    JAX backends' under their meshes and the one-device backends'."""
    _, variables, _, _, _, _, _ = _setup("detect", DETECT_SEED)
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (4, 128, 128, 3)).astype(np.uint8)
    f32 = dict(batch_size=4, compute_dtype="float32")
    native = [port_detect.TorchDetectorBackend(
        state_dict_from_flax(variables), FasterRCNNConfig(**DETECT),
        device="cpu", data_parallel=dp, devices=cpus(2), **f32)
        for dp in (2, 0)]
    want = jax_detect.JaxDetectorBackend(
        variables, jax_frcnn.FasterRCNNConfig(**DETECT), data_parallel=2,
        **f32).detect_batch(images)
    assert native[0].mesh.shape["data"] == 2 and native[1].mesh is None
    _assert_detections(native[0].detect_batch(images), want)
    _assert_detections(native[0].detect_batch(images),
                       native[1].detect_batch(images))
    consts, _, _ = build_od_api_consts(seed=8)
    od = dict(min_dimension=64, max_dimension=96, max_proposals=10, **f32)
    got = port_detect.ODAPIDetectorBackend(
        consts=consts, device="cpu", data_parallel=2, devices=cpus(2),
        **od).detect_batch(images[:, :96, :112])
    _assert_detections(got, jax_detect.ODAPIDetectorBackend(
        consts=consts, data_parallel=2, **od).detect_batch(
        images[:, :96, :112]))
    _assert_detections(got, port_detect.ODAPIDetectorBackend(
        consts=consts, device="cpu", **od).detect_batch(
        images[:, :96, :112]))


def test_detect_cli_data_parallel_matches_jax(layout, small_f32, tmp_path):
    """``gseg-detect --data_parallel 2``: the rows equal the JAX command's
    with the same flag (coordinates exact, scores to 1e-6)."""
    def argv(out):
        return ["--model", str(layout / "model"),
                "--target_list", str(layout / "targets.txt"),
                "--data_dir", str(layout / "data"), "--staining", "OPT_PAS",
                "--output_dir", str(out), "--batch_size", "4",
                "--window_size", "64", "--overlap_ratio", "0.5",
                "--conf_threshold", "0.3", "--data_parallel", "2"]

    cli_detect.main(argv(tmp_path / "port"), device="cpu", devices=cpus(2))
    jax_cli_detect.main(argv(tmp_path / "jax"))
    got = _outputs(tmp_path / "port", "_GlomusList")
    want = _outputs(tmp_path / "jax", "_GlomusList")
    assert got[1] == want[1]
    assert len(got[0]) == len(want[0]) > 5
    assert [r.split(",")[:5] for r in got[0]] == \
        [r.split(",")[:5] for r in want[0]]
    np.testing.assert_allclose(
        [[float(v) for v in r.split(",")[5:]] for r in got[0]],
        [[float(v) for v in r.split(",")[5:]] for r in want[0]],
        rtol=1e-6, atol=1e-6)
