"""``gseg-train`` end to end on the CPU through both packages' commands
(``cli/train.py`` ``main`` with ``--device cpu``), at ESPNet(5, 1, 2) on
a few 48x96 crops, one epoch, with every training scale and the
validation set resized to 64x32 (the trainers' ``build_loaders`` patched
alike, as the JAX package's own end-to-end test does, so that each
package builds one training and one validation step).  The port trains
the encoder, then the decoder from the encoder's ``model_1.pth``; the JAX
command trains a decoder from that same port-written encoder file.
Checked: the artifact set and every log's format against the JAX run's
(the numbers differ: the two inits differ; the step tests cover them),
the checkpoints read across packages in both directions, ``--resume``
from the port's full state and from a JAX ``checkpoint.pth.tar``."""
import contextlib
import io
import math
import os
import re
import types

import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.cli import train as jax_cli
from glomeruli_segmentation_tpu.convert.espnet_import import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from glomeruli_segmentation_tpu.convert.torch_pickle import load_torch_pickle
from glomeruli_segmentation_tpu.data import dataset as jax_dataset
from glomeruli_segmentation_tpu.data import transforms as jax_t
from glomeruli_segmentation_tpu.train import espnet_train as jax_train
from glomeruli_segmentation_tpu_torch.cli import train as port_cli
from glomeruli_segmentation_tpu_torch.data import dataset as port_dataset
from glomeruli_segmentation_tpu_torch.data import transforms as port_t
from glomeruli_segmentation_tpu_torch.models.espnet import ESPNet
from glomeruli_segmentation_tpu_torch.train import espnet_train as port_train

from test_torch_train_data import write_espnet_tree

CHECKPOINT_KEYS = {"epoch", "arch", "state_dict", "lossTr", "lossVal",
                   "iouTr", "iouVal", "lr"}


def small_loaders(t, dataset):
    """``build_loaders`` with every scale at 64x32 (crops and flips kept,
    batch 2), the trainers' seeds and order."""
    def build(self, data):
        mean, std = data["mean"], data["std"]

        def pipe(crop):
            steps = [t.Normalize(mean, std), t.Scale(64, 32)]
            if crop:
                steps.append(t.RandomCropResize(crop))
            steps += [t.RandomFlip(), t.ToTensor(self.args.scaleIn)]
            return t.Compose(steps)

        def mk(crop, seed):
            return dataset.DataLoader(dataset.SegmentationDataset(
                data["trainIm"], data["trainAnnot"], pipe(crop)), 2,
                num_workers=2, seed=seed)

        loaders = {"scale1": mk(8, 1), "scale2": mk(8, 2),
                   "scale4": mk(None, 4), "scale3": mk(4, 3),
                   "main": mk(4, 0)}
        loaders["val"] = dataset.DataLoader(dataset.SegmentationDataset(
            data["valIm"], data["valAnnot"], t.Compose([
                t.Normalize(mean, std), t.Scale(64, 32),
                t.ToTensor(self.args.scaleIn)])), 2, shuffle=False,
            num_workers=2)
        return loaders
    return build


def _argv(root, savedir, *extra):
    return ["--data_dir", str(root), "--cached_data_file",
            str(root / "data.p"), "--savedir", str(savedir), "--classes",
            "5", "--p", "1", "--q", "2", "--batch_size", "2",
            "--num_workers", "2", "--max_epochs", "1", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = write_espnet_tree(tmp_path_factory.mktemp("espnet"))
    mp = pytest.MonkeyPatch()
    mp.setattr(port_train.EspnetTrainer, "build_loaders",
               small_loaders(port_t, port_dataset))
    mp.setattr(jax_train.EspnetTrainer, "build_loaders",
               small_loaders(jax_t, jax_dataset))
    encoder = root / "port_enc_1_2" / "model_1.pth"
    out = {}
    try:
        for name, cli, savedir, argv in (
                ("enc", port_cli, "port", ["--scaleIn", "8",
                                           "--device", "cpu"]),
                ("dec", port_cli, "port", ["--scaleIn", "1", "--decoder",
                                           "True", "--pretrained",
                                           str(encoder), "--device", "cpu"]),
                ("jax", jax_cli, "jax", ["--scaleIn", "1", "--decoder",
                                         "True", "--pretrained",
                                         str(encoder)])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out[name] = cli.main(_argv(root, root / savedir, *argv))
            out[name + "_stdout"] = buf.getvalue()
    finally:
        mp.undo()
    return types.SimpleNamespace(
        root=root, enc=out["enc"], dec=out["dec"], encoder=encoder,
        stdout={k: out[k + "_stdout"] for k in ("enc", "dec", "jax")},
        port_enc=root / "port_enc_1_2", port_dec=root / "port_dec_1_2",
        jax_dec=root / "jax_dec_1_2")


def test_artifacts_and_formats_match_jax(runs):
    names = {"checkpoint.pth.tar", "model_1.pth", "acc_0.txt",
             "trainValLog.txt", "mean_std.txt", "model.txt"}
    assert set(os.listdir(runs.port_enc)) == names | {port_train.FULL_STATE}
    assert set(os.listdir(runs.port_dec)) == names | {port_train.FULL_STATE}
    assert set(os.listdir(runs.jax_dec)) == names | {"native_ckpt"}
    # the same cache, so the same statistics file byte for byte
    assert ((runs.port_dec / "mean_std.txt").read_bytes()
            == (runs.jax_dec / "mean_std.txt").read_bytes())
    port_log = (runs.port_dec / "trainValLog.txt").read_text().split("\n")
    jax_log = (runs.jax_dec / "trainValLog.txt").read_text().split("\n")
    assert port_log[:2] == jax_log[:2]          # parameter count, header
    row = re.compile(r"0\t\d+\.\d{4}\t\d+\.\d{4}\t\d\.\d{4}\t\d\.\d{4}"
                     r"\t0\.0005000")
    assert len(port_log) == len(jax_log) == 3
    assert row.fullmatch(port_log[2]) and row.fullmatch(jax_log[2])
    assert all(math.isfinite(float(v)) for v in port_log[2].split("\t"))

    def shape(text):
        """The text with every number as '#' and numpy's column padding
        dropped."""
        text = re.sub(r"[-+0-9.e]+|nan", "#", text)
        return re.sub(r"(?<=\[) +| +(?=\])", "", re.sub(r" +", " ", text))

    assert (shape((runs.port_dec / "acc_0.txt").read_text())
            == shape((runs.jax_dec / "acc_0.txt").read_text()))
    port_txt = (runs.port_dec / "model.txt").read_text().splitlines()
    jax_txt = (runs.jax_dec / "model.txt").read_text().splitlines()
    assert port_txt[:2] == jax_txt[:2] and port_txt[-1] == jax_txt[-1]
    # the port's per-step timings: one row per training step, 5 scales
    # of 2 batches
    assert [t[0] for t in runs.dec.timings] == [
        s for s in port_train.TRAIN_SCALES for _ in range(2)]


@pytest.mark.parametrize("which", ["port_enc", "port_dec", "jax_dec"])
def test_checkpoints_read_across(runs, which):
    """Each ``checkpoint.pth.tar`` has the JAX trainer's keys; each run's
    weights load into the port's model with ``strict=True`` and through
    the JAX package's ``load_torch_pickle`` -> ``state_dict_to_variables``
    (whose inverse gives back the same keys, shapes and values)."""
    folder = getattr(runs, which)
    decoder = which.endswith("dec")
    tar = torch.load(folder / "checkpoint.pth.tar", weights_only=True)
    jax_tar = load_torch_pickle(str(folder / "checkpoint.pth.tar"))
    assert set(tar) == set(jax_tar) == CHECKPOINT_KEYS
    assert tar["epoch"] == jax_tar["epoch"] == 1 and tar["lr"] == 5e-4
    assert all(math.isfinite(tar[k]) for k in ("lossTr", "lossVal"))
    sd = torch.load(folder / "model_1.pth", weights_only=True)
    assert all(torch.equal(sd[k], torch.as_tensor(tar["state_dict"][k]))
               for k in sd)
    model = ESPNet(5, 1, 2) if decoder else ESPNet(5, 1, 2).encoder
    model.load_state_dict(sd, strict=True)
    back = variables_to_state_dict(state_dict_to_variables(
        load_torch_pickle(str(folder / "model_1.pth"))))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        # torch reads the JAX legacy writer's 0-d counters as (1,)
        assert np.array_equal(np.ravel(back[k]), v.numpy().ravel()), k
        if which.startswith("port"):
            assert np.shape(back[k]) == tuple(v.shape), k


def test_decoder_starts_from_the_encoder(runs):
    """Both decoder runs loaded the port-written encoder file; the encoder
    run did not; every step's loss was finite."""
    assert "Encoder loaded!" not in runs.stdout["enc"]
    assert "Encoder loaded!" in runs.stdout["dec"]
    assert "Encoder loaded!" in runs.stdout["jax"]
    for name in ("enc", "dec"):
        losses = re.findall(r"loss: (\S+) time", runs.stdout[name])
        assert len(losses) == 10
        assert all(math.isfinite(float(v)) for v in losses)


def test_resume_from_a_jax_checkpoint(runs, tmp_path):
    """``--resume`` without the port's full state reads ``--resumeLoc``,
    here the JAX trainer's ``checkpoint.pth.tar``: its weights and
    epoch."""
    args = port_cli.build_parser().parse_args(_argv(
        runs.root, tmp_path / "r", "--decoder", "True", "--resume", "True",
        "--resumeLoc", str(runs.jax_dec / "checkpoint.pth.tar"),
        "--device", "cpu"))
    trainer = port_train.EspnetTrainer(args)
    model = trainer.build_model()
    optimizer = trainer.build_optimizer(model)
    assert trainer._resume(model, optimizer) == 1
    want = load_torch_pickle(str(runs.jax_dec / "checkpoint.pth.tar"))
    got = model.state_dict()
    assert got.keys() == want["state_dict"].keys()
    for k, v in want["state_dict"].items():
        assert np.array_equal(got[k].numpy().ravel(), np.ravel(v)), k


def test_resume_full_state_continues(runs, tmp_path):
    """``--resume`` in a savedir with the port's full state restores the
    weights, Adam's state and the epoch, and trains on from there."""
    import shutil

    shutil.copytree(runs.port_dec, tmp_path / "run_dec_1_2")
    mp = pytest.MonkeyPatch()
    mp.setattr(port_train.EspnetTrainer, "build_loaders",
               small_loaders(port_t, port_dataset))
    try:
        port_cli.main(_argv(runs.root, tmp_path / "run", "--scaleIn", "1",
                            "--decoder", "True", "--resume", "True",
                            "--max_epochs", "2", "--device", "cpu"))
    finally:
        mp.undo()
    out = tmp_path / "run_dec_1_2"
    assert (out / "model_2.pth").is_file() and (out / "acc_1.txt").is_file()
    log = (out / "trainValLog.txt").read_text().split("\n")
    assert len(log) == 4 and log[3].startswith("1\t")
    state = torch.load(out / port_train.FULL_STATE, weights_only=True)
    assert state["epoch"] == 2
    assert all(int(s["step"]) == 20 for s in
               state["optimizer"]["state"].values())
