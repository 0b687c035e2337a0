"""The port's ``gseg-e2e`` CLI (``cli/e2e.py``) and detector loading
(``cli/detect.load_backend``) on the CPU: ``main`` on a one-slide target
list against a ``FusedEndToEnd`` built by hand, the flags that are not
ported, and ``load_backend``'s precedence and errors against the JAX
package's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import detect as jax_cli_detect
from glomeruli_segmentation_tpu.convert.pb_import import (
    assemble_od_api_params,
)
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu.models import od_api_frcnn as jax_od_api
from glomeruli_segmentation_tpu_torch.cli import detect as cli_detect
from glomeruli_segmentation_tpu_torch.cli import e2e as cli_e2e
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    load_detector_checkpoint,
)
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.pipeline import e2e as port_e2e
from glomeruli_segmentation_tpu_torch.pipeline import fused as port_fused

from pb_graph_writer import write_graph
from test_od_api_import import build_od_api_consts
from test_torch_e2e import CSV, LOG, assert_same_artifacts, write_slide
from test_torch_faster_rcnn import DETECT, DETECT_SEED, _setup
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PATIENT = "H16-1"
# the OD-API backends' resizer bounds and NMS sizes at these tiny widths
OD_API = dict(min_dimension=64, max_dimension=96, max_proposals=20)


def _write_detector_ckpt(path):
    """``detector.ckpt.pth`` as the JAX package's detector trainer writes
    it: the legacy torch pickle of the Flax variables and the config."""
    _, variables, _, _, _, _, _ = _setup("detect", DETECT_SEED)
    save_torch_legacy({
        "variables": jax.tree.map(np.asarray, {
            "params": variables["params"],
            "batch_stats": variables["batch_stats"]}),
        "config": dataclasses.asdict(jax_frcnn.FasterRCNNConfig(**DETECT)),
    }, str(path))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A data dir with one slide, its target list, a model dir with a
    small detector.ckpt.pth and a fold-1 checkpoint (p=1, q=2)."""
    root = tmp_path_factory.mktemp("cli")
    slide_dir = root / "data" / "02_PAS" / PATIENT
    slide_dir.mkdir(parents=True)
    write_slide(slide_dir / f"{PATIENT}.tiff", seed=50)
    (root / "targets.txt").write_text(f"#comment/x.tiff\n"
                                      f"{PATIENT}/{PATIENT}.tiff\n"
                                      f"H16-missing/H16-missing.tiff\n")
    (root / "model").mkdir()
    _write_detector_ckpt(root / "model" / "detector.ckpt.pth")
    (root / "weights").mkdir()
    torch.save(random_state_dict(1, 5, p=1, q=2),
               root / "weights" / "espnet_fold1.pth")
    return root


def _argv(root, out, *extra):
    return ["--model", str(root / "model"),
            "--target_list", str(root / "targets.txt"),
            "--data_dir", str(root / "data"),
            "--output_dir", str(out),
            "--segmentation_weights_dir", str(root / "weights"),
            "--folds", "1", "--batch_size", "4", "--seg_batch_size", "2",
            "--window_size", "64", "--overlap_ratio", "0.5",
            "--conf_threshold", "0.3", "--merge_conf_threshold", "0.4",
            "--precision", "highest", *extra]


def test_main_matches_pipeline_built_by_hand(layout, tmp_path):
    out = tmp_path / "cli"
    cli_e2e.main(_argv(layout, out), device="cpu")
    rows = (out / CSV).read_text().splitlines()
    assert rows and all(f'"{PATIENT}.tiff"' in r for r in rows)

    state, config = load_detector_checkpoint(
        str(layout / "model" / "detector.ckpt.pth"))
    backend = port_detect.TorchDetectorBackend(state, config, batch_size=4,
                                               device="cpu")
    ensemble = port_fused.EnsembleSegmenter(port_fused.EnsembleConfig(
        checkpoints=[str(layout / "weights" / "espnet_fold1.pth")],
        folds=(1,), batch_size=2, precision="highest"), engine="auto",
        device="cpu")
    assert ensemble.engine == "packed"
    pipe = port_e2e.FusedEndToEnd(backend, ensemble, window_size=64,
                                  overlap_ratio=0.5, detect_conf=0.3,
                                  merge_conf=0.4)
    by_hand = tmp_path / "by_hand"
    pipe.run_slide(str(layout / "data" / "02_PAS" / PATIENT /
                       f"{PATIENT}.tiff"), str(by_hand), PATIENT,
                   json_dir=str(by_hand / "json"))
    assert_same_artifacts(out, by_hand, [PATIENT])

    # --resume skips the recorded slide and leaves its artifacts alone
    before = (out / CSV).read_bytes(), (out / LOG).read_bytes()
    cli_e2e.main(_argv(layout, out, "--resume", "--no_overlay"),
                 device="cpu")
    assert ((out / CSV).read_bytes(), (out / LOG).read_bytes()) == before


def test_build_pipeline_defaults(layout):
    """The CLI defaults: engine auto -> packed at crop batch 32, bf16, the
    flat transfer, the reference's thresholds and window geometry."""
    args = cli_e2e.build_parser().parse_args(
        ["--model", "m", "--target_list", "t", "--data_dir", "d",
         "--segmentation_weights_dir", str(layout / "weights"),
         "--folds", "1"])
    pipe = cli_e2e.build_pipeline(args, object(), device="cpu")
    ens = pipe.segmenter.ensemble
    assert ens.engine == "packed" and ens.fuse_level3
    assert ens.config.batch_size == 32
    assert ens.config.compute_dtype == "bfloat16"
    assert pipe.segmenter.transfer == "flat"
    assert (pipe.window_size, pipe.overlap_ratio, pipe.detect_conf,
            pipe.merge_conf, pipe.merge_overlap) == (2000, 0.1, 0.2, 0.9,
                                                     0.35)
    assert args.batch_size == 8 and args.slide_pipeline == "auto"
    assert cli_e2e.resolve_slide_pipeline(args) == (
        len(__import__("os").sched_getaffinity(0)) >= 2)
    for flag, want in (("--serial_slides", False),
                       ("--slide_pipeline=on", True),
                       ("--slide_pipeline=off", False)):
        assert cli_e2e.resolve_slide_pipeline(cli_e2e.build_parser()
                                              .parse_args(["--model", "m",
                                                           "--target_list",
                                                           "t", "--data_dir",
                                                           "d", flag])) \
            == want


CPU2 = [torch.device("cpu")] * 2


def _by_hand(layout, out, name):
    """The pipeline each flag asks for, built by hand from the classes, run
    on the layout's slide into ``out``."""
    from glomeruli_segmentation_tpu_torch.parallel.mesh import (
        make_fold_mesh,
        make_mesh,
    )

    state, config = load_detector_checkpoint(
        str(layout / "model" / "detector.ckpt.pth"))
    backend = port_detect.TorchDetectorBackend(
        state, config, batch_size=4, device="cpu",
        data_parallel=2 if name == "--data_parallel" else 0, devices=CPU2)
    engine, mesh = "auto", None
    if name == "--data_parallel":
        mesh = make_mesh(2, devices=CPU2)
    elif name == "--fold_parallel":
        engine, mesh = "fold_parallel", make_fold_mesh(2, 0, 2,
                                                        devices=CPU2)
    elif name == "--engine xla":
        engine = "xla"
    ensemble = port_fused.EnsembleSegmenter(port_fused.EnsembleConfig(
        checkpoints=[str(layout / "weights" / "espnet_fold1.pth")],
        folds=(1,), batch_size=2, precision="highest",
        pack_output=name == "--pack_output"), mesh=mesh, engine=engine,
        device="cpu")
    pipe = port_e2e.FusedEndToEnd(backend, ensemble, window_size=64,
                                  overlap_ratio=0.5, detect_conf=0.3,
                                  merge_conf=0.4,
                                  host_resize=name == "--host_resize")
    pipe.run_slide(str(layout / "data" / "02_PAS" / PATIENT /
                       f"{PATIENT}.tiff"), str(out), PATIENT,
                   json_dir=str(out / "json"))


@pytest.mark.parametrize("extra,name", [
    (["--data_parallel", "2"], "--data_parallel"),
    (["--fold_parallel", "2"], "--fold_parallel"),
    (["--segformer_checkpoint", "x.pth"], "--segformer_checkpoint"),
    (["--host_resize"], "--host_resize"),
    (["--pack_output"], "--pack_output"),
    (["--engine", "xla"], "--engine xla"),
])
def test_unported_flags_raise(layout, tmp_path, extra, name):
    """Every flag does what the JAX command does with it.  With
    ``--segformer_checkpoint`` the ESPNet-only flags conflict and it
    raises, before writing anything; ``--data_parallel 2`` on one CPU
    device raises the JAX package's mesh error; otherwise, on 2 logical CPU
    devices, the command's artifacts equal the pipeline the flag asks for,
    built by hand (window and crop batches split over a data mesh, the
    folds over a fold mesh, the host resize, the packed readback, the plain
    fold engine)."""
    out = tmp_path / "o"
    if name == "--segformer_checkpoint":
        with pytest.raises(SystemExit, match=name):
            cli_e2e.main(_argv(layout, out, *extra), device="cpu")
        assert not out.exists()
        return
    if name == "--data_parallel":
        with pytest.raises(ValueError, match="requested a 2-device mesh"):
            cli_e2e.main(_argv(layout, out, *extra), device="cpu")
        assert not out.exists()
    # the mesh flags on 2 logical devices; the others on one (on two,
    # --mesh auto would build a data mesh of its own)
    cli_e2e.main(_argv(layout, out, *extra), device="cpu",
                 devices=CPU2 if name in ("--data_parallel",
                                          "--fold_parallel") else None)
    _by_hand(layout, tmp_path / "by_hand", name)
    assert len((out / CSV).read_text().splitlines()) >= 1
    assert_same_artifacts(out, tmp_path / "by_hand", [PATIENT])


def test_mesh_auto_on_many_cards_raises(capsys):
    """``--mesh auto`` resolves as the JAX command's policy does: on 8
    devices the same flags and the same message as the JAX function (its
    tests' 8 virtual CPU devices); on 4, a fold axis of 4; one device,
    ``--mesh off``, an explicit engine or explicit flags leave the flags
    alone."""
    from glomeruli_segmentation_tpu.cli import e2e as jax_cli_e2e

    parse = cli_e2e.build_parser().parse_args
    base = ["--model", "m", "--target_list", "t", "--data_dir", "d"]
    keys = ("fold_parallel", "data_parallel", "detector_data_parallel")
    for argv in (base, base + ["--folds", "1"], base + ["--folds", "1", "2"]
                 + ["--seg_batch_size", "2"]):
        args, jax_args = parse(argv), jax_cli_e2e.build_parser().parse_args(
            argv)
        cli_e2e.resolve_mesh_policy(args, 8)
        got = capsys.readouterr().out
        jax_cli_e2e.resolve_mesh_policy(jax_args)
        assert got == capsys.readouterr().out and got.startswith(
            "--mesh auto: 8 devices -> ")
        assert [getattr(args, k, 0) for k in keys] == \
            [getattr(jax_args, k, 0) for k in keys]
        assert cli_e2e.detector_data_parallel(args) == \
            jax_cli_e2e.detector_data_parallel(jax_args)
    args = parse(base)
    cli_e2e.resolve_mesh_policy(args, 4)
    assert (args.fold_parallel, args.data_parallel,
            args.detector_data_parallel) == (4, 0, 4)
    assert capsys.readouterr().out == (
        "--mesh auto: 4 devices -> fold x data = 4 x 1 (override with "
        "--fold_parallel/--data_parallel, disable with --mesh off)\n")
    for argv, n in ((base, 1), (base + ["--mesh", "off"], 4),
                    (base + ["--engine", "packed"], 4),
                    (base + ["--fold_parallel", "2"], 4)):
        args = parse(argv)
        cli_e2e.resolve_mesh_policy(args, n)
        assert (args.fold_parallel, cli_e2e.detector_data_parallel(args)) \
            == (2 if "--fold_parallel" in argv else 0, 0)
    assert capsys.readouterr().out == ""


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """One of each detector file the loader knows, and an OD-API graph
    with a weight no mapping consumes."""
    d = tmp_path_factory.mktemp("model_files")
    _write_detector_ckpt(d / "detector.ckpt.pth")
    consts, _, _ = build_od_api_consts(seed=5)
    write_graph(consts, str(d / "frozen_inference_graph.pb"))
    params, num_classes = assemble_od_api_params(consts)
    save_torch_legacy({
        "od_api_params": jax.tree.map(np.asarray, params),
        "num_classes": num_classes,
        "od_config": dataclasses.asdict(jax_od_api.ODAPIConfig(
            num_classes=num_classes, anchor_base=128.0)),
    }, str(d / "od_api_detector.ckpt.pth"))
    write_graph(dict(consts, **{"Extra/weights": np.ones(3, np.float32)}),
                str(d / "odd.pb"))
    return d


# (files in the model dir, explicit model_name)
CASES = [
    (("detector.ckpt.pth", "od_api_detector.ckpt.pth",
      "frozen_inference_graph.pb"), None),
    (("od_api_detector.ckpt.pth", "frozen_inference_graph.pb"), None),
    (("frozen_inference_graph.pb",), None),
    ((), None),
    (("detector.ckpt.pth", "od_api_detector.ckpt.pth",
      "frozen_inference_graph.pb"), "frozen_inference_graph.pb"),
    (("detector.ckpt.pth", "od_api_detector.ckpt.pth"),
     "od_api_detector.ckpt.pth"),
    (("detector.ckpt.pth",), "missing.pb"),
    (("odd.pb",), "odd.pb"),
]
PORT_NAME = {"JaxDetectorBackend": "TorchDetectorBackend",
             "ODAPIDetectorBackend": "ODAPIDetectorBackend"}


def _load(loader, model_dir, model_name, **kw):
    try:
        return loader(str(model_dir), model_name, 4,
                      od_api_overrides=dict(OD_API), **kw)
    except SystemExit as e:
        return e


@pytest.mark.parametrize("files,model_name", CASES)
def test_load_backend_choices_match_jax(model_files, tmp_path, files,
                                        model_name):
    for f in files:
        (tmp_path / f).symlink_to(model_files / f)
    want = _load(jax_cli_detect.load_backend, tmp_path, model_name)
    got = _load(cli_detect.load_backend, tmp_path, model_name,
                device="cpu")
    if isinstance(want, SystemExit):
        assert isinstance(got, SystemExit)
        assert str(got) == str(want)
        return
    assert type(got).__name__ == PORT_NAME[type(want).__name__]
    assert got.batch_size == want.batch_size == 4
    assert got.device.type == "cpu"
    if isinstance(got, port_detect.ODAPIDetectorBackend):
        assert got.num_classes == want.num_classes == 1
        for k in ("min_dimension", "max_dimension", "max_proposals",
                  "anchor_base"):
            assert getattr(got.base_config, k) == \
                getattr(jax_od_api.ODAPIConfig(**want.config_overrides), k)
        flat_got = jax.tree_util.tree_leaves(got.params)
        flat_want = jax.tree_util.tree_leaves(want.params)
        assert len(flat_got) == len(flat_want)
        for a, b in zip(flat_got, flat_want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert got.base_config == load_detector_checkpoint(
            str(model_files / "detector.ckpt.pth"))[1]


def test_load_backend_data_parallel_raises(model_files):
    """``data_parallel=2``: on one CPU device the JAX package's mesh error;
    on 2 logical devices a backend whose window batches split 2 + 2, with
    the one-device backend's detections."""
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        cli_detect.load_backend(str(model_files), data_parallel=2,
                                device="cpu")
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (4, 128, 128, 3)).astype(np.uint8)
    for name in ("detector.ckpt.pth", "od_api_detector.ckpt.pth"):
        one = cli_detect.load_backend(str(model_files), name, 4,
                                      od_api_overrides=dict(OD_API),
                                      device="cpu")
        two = cli_detect.load_backend(str(model_files), name, 4,
                                      od_api_overrides=dict(OD_API),
                                      data_parallel=2, device="cpu",
                                      devices=CPU2)
        assert one.mesh is None and two.mesh.shape == {"data": 2,
                                                       "model": 1}
        handle = two.detect_batch_submit(images)
        assert isinstance(handle, list) and len(handle) == 2
        for a, b in zip(two.read_detections(handle),
                        one.detect_batch(images)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
