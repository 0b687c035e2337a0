"""The port's training commands on two gloo ranks, on the CPU.

- ``gseg-train --data_parallel 2`` (one process starting two ranks) and the
  same run as two processes (``--coordinator 127.0.0.1:PORT
  --num_processes 2 --process_id r``, one rank each), one epoch of
  ESPNet(5, 1, 2) on five 48x96 crops (a ragged last batch) with every
  scale at 64x32 (``tests/torch_train_worker.py``): the same
  ``model_1.pth`` to rtol 2e-4 / atol 2e-5 (the JAX package's bar for its
  one- and two-process runs, ``tests/test_distributed.py``) and the same
  ``trainValLog.txt``; the artifacts are rank 0's alone, and the
  statistics cache is written once.
- ``gseg-train-detector --data_parallel 2`` (the tiny backbone, and
  ``--finetune_pb``): the checkpoint is written by rank 0, and the JAX
  package loads it and detects with it."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pb_graph_writer import write_graph
from test_od_api_import import build_od_api_consts
from test_torch_distributed_detector import annotated_tree
from test_torch_train_data import write_espnet_tree
from torch_threads import one_torch_thread  # noqa: F401

from glomeruli_segmentation_tpu.cli import detect as jax_detect_cli
from glomeruli_segmentation_tpu.convert.torch_pickle import load_torch_pickle
from glomeruli_segmentation_tpu_torch.cli import train_detector as port_cli
from glomeruli_segmentation_tpu_torch.parallel import distributed
from glomeruli_segmentation_tpu_torch.train.espnet_train import FULL_STATE

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
ARTIFACTS = {"checkpoint.pth.tar", "model_1.pth", "acc_0.txt",
             "trainValLog.txt", "mean_std.txt", "model.txt", FULL_STATE}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(root, name, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    argv = ["--data_dir", str(root), "--cached_data_file",
            str(root / f"{name}.p"), "--savedir", str(root / name),
            "--classes", "5", "--p", "1", "--q", "2", "--batch_size", "2",
            "--num_workers", "2", "--max_epochs", "1", "--scaleIn", "8",
            "--data_parallel", "2", "--device", "cpu", *extra]
    return subprocess.Popen(
        [sys.executable, str(TESTS / "torch_train_worker.py"), *argv],
        env=env, cwd=str(root), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _writes(out):
    return [line.split(" ", 2)[1:] for line in out.splitlines()
            if line.startswith("WRITE ")]


@pytest.fixture(scope="module")
def espnet_runs(tmp_path_factory):
    root = write_espnet_tree(tmp_path_factory.mktemp("dp"), n_train=5)
    port = _free_port()
    procs = {"spawn": [_worker(root, "spawn")],
             "coordinator": [_worker(root, "coordinator", "--coordinator",
                                     f"127.0.0.1:{port}", "--num_processes",
                                     "2", "--process_id", str(r))
                             for r in range(2)]}
    outs = {k: [p.communicate(timeout=300)[0] for p in ps]
            for k, ps in procs.items()}
    for k, ps in procs.items():
        for p, out in zip(ps, outs[k]):
            assert p.returncode == 0, out[-4000:]
            assert "WORKER-DONE" in out
    return root, outs


def test_spawned_ranks_equal_two_processes(espnet_runs):
    root, _ = espnet_runs
    a = load_torch_pickle(str(root / "spawn_enc_1_2" / "model_1.pth"))
    b = load_torch_pickle(str(root / "coordinator_enc_1_2" / "model_1.pth"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    logs = [(root / f"{n}_enc_1_2" / "trainValLog.txt").read_text()
            for n in ("spawn", "coordinator")]
    assert logs[0] == logs[1] and len(logs[0].splitlines()) == 3


@pytest.mark.parametrize("name", ["spawn", "coordinator"])
def test_rank_zero_writes_every_artifact_once(espnet_runs, name):
    root, outs = espnet_runs
    writes = [w for out in outs[name] for w in _writes(out)]
    assert {rank for rank, _ in writes} == {"rank=0"}
    paths = [Path(p) for _, p in writes]
    assert paths.count(root / f"{name}.p") == 1        # the stats cache
    savedir = root / f"{name}_enc_1_2"
    assert set(os.listdir(savedir)) == ARTIFACTS
    # the full state goes through a temporary file and a rename
    assert {p.name for p in paths if p.parent == savedir} == (
        ARTIFACTS - {FULL_STATE}) | {FULL_STATE + ".tmp"}
    if name == "coordinator":
        # process 1's own output: no write at all, and its rank is 1
        assert _writes(outs[name][1]) == []
        assert "data axis: 2 ranks, backend gloo" in outs[name][0]


@pytest.fixture(scope="module")
def detector_tree(tmp_path_factory):
    return annotated_tree(tmp_path_factory.mktemp("dpdet"), 11)


def _args(tree, out, *extra):
    return ["--data_dir", str(tree / "data"), "--target_list",
            str(tree / "targets.txt"), "--output_dir", str(out), "--steps",
            "2", "--batch_size", "4", "--image_size", "128",
            "--data_parallel", "2", *extra]


def test_train_detector_on_two_ranks(detector_tree, tmp_path):
    path = port_cli.main(_args(detector_tree, tmp_path / "model",
                               "--backbone", "tiny", "--seed", "1"),
                         device="cpu")
    assert path == str(tmp_path / "model" / "detector.ckpt.pth")
    assert os.listdir(tmp_path / "model") == ["detector.ckpt.pth"]
    reports = distributed.last_reports
    assert [r["k3_launches"] for r in reports] == [0, 0]   # plain NMS here
    assert reports[0]["losses"] == reports[1]["losses"]
    assert np.isfinite(reports[0]["losses"]).all()
    backend = jax_detect_cli.load_backend(str(tmp_path / "model"), None, 2)
    assert backend.base_config.backbone == "tiny"
    _, scores, _, _ = backend.detect_batch(np.zeros((2, 128, 128, 3),
                                                    np.uint8))
    assert np.isfinite(scores).all()
    from glomeruli_segmentation_tpu_torch.convert.detector_import import (
        load_detector_checkpoint)

    state, config = load_detector_checkpoint(path)
    assert config.backbone == "tiny" and len(state) > 0


def test_finetune_pb_on_two_ranks(detector_tree, tmp_path):
    consts, _, _ = build_od_api_consts(seed=3)
    pb = tmp_path / "frozen_inference_graph.pb"
    write_graph(consts, str(pb))
    path = port_cli.main(_args(detector_tree, tmp_path / "model",
                               "--finetune_pb", str(pb)), device="cpu")
    assert os.listdir(tmp_path / "model") == ["od_api_detector.ckpt.pth"]
    assert len(distributed.last_reports) == 2
    backend = jax_detect_cli.load_backend(
        str(tmp_path / "model"), None, 2,
        od_api_overrides={"min_dimension": 128, "max_dimension": 128})
    _, scores, _, _ = backend.detect_batch(np.zeros((2, 128, 128, 3),
                                                    np.uint8))
    assert np.isfinite(scores).all()
    from glomeruli_segmentation_tpu_torch.convert.pb_import import (
        load_od_api_checkpoint)

    params, n, saved = load_od_api_checkpoint(path)
    assert n == 1 and saved["max_proposals"] == 64 and params
