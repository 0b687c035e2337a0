"""The device mesh on the port's segmentation paths against the JAX
package's on the CPU: the fold ensemble under a data mesh and the
fold-parallel engine, and the commands ``gseg-e2e --data_parallel 2`` /
``--fold_parallel 2`` and ``gseg-segment --data_parallel 2
--pack_output``, on 1, 2 and 4 logical CPU devices against the JAX
package's virtual CPU devices (``tests/conftest.py``).  Everything in f32;
the detector backends computing in f32 as in the detect-stage tests."""
import functools

import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import e2e as jax_cli_e2e
from glomeruli_segmentation_tpu.cli import segment as jax_cli_segment
from glomeruli_segmentation_tpu.parallel import mesh as jax_mesh
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu.pipeline import fused as jax_fused
from glomeruli_segmentation_tpu.wsi.synthetic import pas_like_image
from glomeruli_segmentation_tpu_torch.cli import e2e as cli_e2e
from glomeruli_segmentation_tpu_torch.cli import segment as cli_segment
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.parallel import mesh
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused

from test_torch_e2e import CSV, assert_same_artifacts, write_slide
from test_torch_e2e_cli import _write_detector_ckpt
from test_torch_segment import MEAN, STD, _tree, crop_dirs, weights  # noqa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
FOLDS = (1, 2)
SMALL = dict(p=2, q=2, in_height=64, in_width=128, compute_dtype="float32")
PATIENT = "H16-3"


def cpus(n):
    return [CPU] * n


@pytest.fixture(scope="module")
def fold_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_folds")
    for fold in FOLDS:
        torch.save(random_state_dict(20 + fold, 5, p=2, q=2),
                   d / f"espnet_fold{fold}.pth")
    return d


def _config(cls, fold_dir, **change):
    return cls(checkpoints=[str(fold_dir / f"espnet_fold{f}.pth")
                            for f in FOLDS], folds=FOLDS,
               **{**SMALL, "batch_size": 4, "precision": "highest",
                  **change})


def _batch():
    padded = np.zeros((4, 96, 160, 3), np.uint8)
    hs = np.array([96, 72, 64, 90], np.int32)
    ws = np.array([160, 140, 128, 96], np.int32)
    for i in range(4):
        img, _ = pas_like_image(int(hs[i]), int(ws[i]), seed=40 + i,
                                n_glomeruli=1)
        padded[i, : hs[i], : ws[i]] = img[:, :, ::-1]
    ys = np.tile(np.arange(0, 64, 8, dtype=np.int32), (4, 1))
    xs = np.tile(np.arange(0, 128, 8, dtype=np.int32), (4, 1))
    return padded, hs, ws, ys, xs


@pytest.mark.parametrize("n_dev,engine", [(1, "xla"), (2, "packed"),
                                          (4, "xla")])
def test_ensemble_data_mesh_matches_jax(fold_dir, n_dev, engine):
    """Crop batches split over a data mesh of 1, 2 and 4 devices: the class
    maps equal the JAX engine's under its mesh and the port's one-device
    engine's, the /8 gathers the one-device engine's; under a mesh the
    packed engine's level 3 goes through K1 as on one device (each
    replica runs its shard whole; the JAX package keeps it plain there,
    and the maps agree)."""
    padded, hs, ws, ys, xs = _batch()
    port = port_fused.EnsembleSegmenter(
        _config(port_fused.EnsembleConfig, fold_dir),
        mesh=mesh.make_mesh(n_dev, devices=cpus(n_dev)), engine=engine)
    want = jax_fused.EnsembleSegmenter(
        _config(jax_fused.EnsembleConfig, fold_dir),
        mesh=jax_mesh.make_mesh(n_dev), engine=engine)
    single = port_fused.EnsembleSegmenter(
        _config(port_fused.EnsembleConfig, fold_dir), engine=engine,
        device="cpu")
    assert port.fuse_level3 == single.fuse_level3 == (engine == "packed")
    handle = port.submit_batch_padded(padded, hs, ws)
    assert isinstance(handle, list) == (n_dev > 1)
    maps = port.read_maps(handle)
    np.testing.assert_array_equal(maps,
                                  want.segment_batch_padded(padded, hs, ws))
    np.testing.assert_array_equal(
        maps, single.segment_batch_padded(padded, hs, ws))
    np.testing.assert_array_equal(
        port.segment_batch_gather(padded, hs, ws, ys, xs),
        single.segment_batch_gather(padded, hs, ws, ys, xs))
    with pytest.raises(ValueError, match="multiple of the data-axis"):
        port_fused.EnsembleSegmenter(
            _config(port_fused.EnsembleConfig, fold_dir, batch_size=3),
            mesh=mesh.make_mesh(2, devices=cpus(2)), engine=engine)


def test_fold_parallel_engine_matches_jax_and_sequential(fold_dir):
    """``engine="fold_parallel"`` on a (fold 2, data 2) mesh: the class
    maps equal the JAX fold-parallel engine's and, bit for bit, the
    sequential fold loop (the port's xla nets, softmaxes summed in fold
    order over the same resize); the /8 gather too.  Without a fold and a
    data axis it raises the JAX package's error."""
    padded, hs, ws, ys, xs = _batch()
    cfg = _config(port_fused.EnsembleConfig, fold_dir)
    port = port_fused.EnsembleSegmenter(
        cfg, mesh=mesh.make_fold_mesh(2, 2, 4, devices=cpus(4)),
        engine="fold_parallel")
    got = port.segment_batch_padded(padded, hs, ws)
    want = jax_fused.EnsembleSegmenter(
        _config(jax_fused.EnsembleConfig, fold_dir),
        mesh=jax_mesh.make_fold_mesh(2, 2, 4),
        engine="fold_parallel").segment_batch_padded(padded, hs, ws)
    np.testing.assert_array_equal(got, want)
    plain = port_fused.EnsembleSegmenter(cfg, engine="xla", device="cpu")
    resized = plain._resize_batch(*(torch.from_numpy(a)
                                    for a in (padded, hs, ws)))
    acc = None
    with torch.no_grad():
        for net, m, s in zip(plain.nets, plain._cores.replicas[0].mean,
                             plain._cores.replicas[0].std):
            x = ((resized - m) / s / 255.0).permute(0, 3, 1, 2)
            probs = 1.0 * torch.softmax(net(x.contiguous()), dim=1)
            acc = probs if acc is None else acc + probs
    expect = torch.argmax(acc, dim=1).to(torch.uint8).numpy()
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(
        port.segment_batch_gather(padded, hs, ws, ys, xs),
        expect[:, ::8, ::8])
    for bad in (None, mesh.make_mesh(2, devices=cpus(2))):
        with pytest.raises(ValueError, match="'fold' and 'data' axes"):
            port_fused.EnsembleSegmenter(cfg, mesh=bad,
                                         engine="fold_parallel")


@pytest.fixture
def small_f32(monkeypatch, fold_dir):
    """Both packages' commands at this file's network size in f32: their
    ``EnsembleConfig`` defaults replaced, and the detector backends in
    f32 (the CLIs' bf16 rounds differently in XLA and in torch)."""
    for module in (port_fused, jax_fused):
        monkeypatch.setattr(module, "EnsembleConfig", functools.partial(
            module.EnsembleConfig, **SMALL))
    for cls in (port_detect.TorchDetectorBackend,
                jax_detect.JaxDetectorBackend):
        monkeypatch.setattr(cls, "__init__", functools.partialmethod(
            cls.__init__, compute_dtype="float32"))


@pytest.fixture(scope="module")
def layout(tmp_path_factory, fold_dir):
    root = tmp_path_factory.mktemp("mesh_cli")
    slide_dir = root / "data" / "02_PAS" / PATIENT
    slide_dir.mkdir(parents=True)
    write_slide(slide_dir / f"{PATIENT}.tiff", seed=33)
    (root / "targets.txt").write_text(f"{PATIENT}/{PATIENT}.tiff\n")
    (root / "model").mkdir()
    _write_detector_ckpt(root / "model" / "detector.ckpt.pth")
    return root


@pytest.mark.parametrize("flags", [("--data_parallel", "2"),
                                   ("--fold_parallel", "2")])
def test_e2e_cli_meshes_match_jax(layout, fold_dir, small_f32, tmp_path,
                                  flags):
    """``gseg-e2e --data_parallel 2`` (window and crop batches split over
    two devices) and ``--fold_parallel 2`` (the two folds over a fold
    mesh): the merged CSV (confidences to 1e-6), every labelme JSON and
    the overlay equal the JAX command's with the same flags."""
    def argv(out):
        return ["--model", str(layout / "model"),
                "--target_list", str(layout / "targets.txt"),
                "--data_dir", str(layout / "data"), "--output_dir", str(out),
                "--segmentation_weights_dir", str(fold_dir),
                "--folds", "1", "2", "--batch_size", "4",
                "--seg_batch_size", "2", "--window_size", "64",
                "--overlap_ratio", "0.5", "--conf_threshold", "0.3",
                "--merge_conf_threshold", "0.4", "--precision", "highest",
                *flags]

    cli_e2e.main(argv(tmp_path / "port"), device="cpu", devices=cpus(2))
    jax_cli_e2e.main(argv(tmp_path / "jax"))
    assert len((tmp_path / "port" / CSV).read_text().splitlines()) >= 2
    assert_same_artifacts(tmp_path / "port", tmp_path / "jax", [PATIENT],
                          csv_exact=False)


def test_segment_cli_data_parallel_and_pack_output_match_jax(
        weights, crop_dirs, tmp_path):
    """``gseg-segment --data_parallel 2 --pack_output``: every artifact
    byte-identical to the JAX command's with the same flags."""
    def argv(out):
        return ["--rgb_data_dir", str(crop_dirs / "org_image"),
                "--label_data_dir", str(crop_dirs / "label"),
                "--savedir", str(out), "--weights", weights,
                "--inWidth", "256", "--inHeight", "128", "--p", "2",
                "--q", "2", "--decoder", "--cityFormat", "--colored",
                "--json_image_data", "classmap", "--batch_size", "2",
                "--data_parallel", "2", "--pack_output",
                "--mean", *map(str, MEAN), "--std", *map(str, STD)]

    cli_segment.main(argv(tmp_path / "port"), device="cpu", devices=cpus(2))
    jax_cli_segment.main(argv(tmp_path / "jax"))
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got.keys() == want.keys()
    assert len([k for k in got if k.endswith(".json")]) == 5
    assert [k for k in got if got[k] != want[k]] == []
