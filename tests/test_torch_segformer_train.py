"""The port's SegFormer trainer (``train/segformer_train.py``,
``cli/segformer_train.py``) and checkpoint reading
(``convert/segformer_import.py``) against the JAX package's on the CPU, at
MiT widths (8, 16, 20, 32), one block per stage, decoder 32, 5 labels,
64x64 inputs.

- The stdlib ``.safetensors`` reader against the ``safetensors`` package
  (F32 through ``safetensors.numpy``; BF16 and I64, which numpy cannot
  hold, through ``safetensors.torch``): tensors equal bit for bit.
- ``load_segformer_state_dict`` on ``.safetensors`` files and directories,
  and on backbone-only checkpoints (only with ``backbone_only=True``, as
  the trainer loads them; the serving loader refuses one).
- The train step against the JAX ``build_steps``' ``train_step`` over
  three AdamW steps (the first at lr 0: optax's ``linear_schedule``
  starts at 0, so the first update changes nothing) and, with
  ``--accumulation_steps 2``, against ``optax.MultiSteps`` over four
  micro-batches.  The loss within 1e-5 relative; the head's BN running
  variance within 1e-6; its running mean within 1e-6 while both packages'
  forwards see equal weights; the parameters within 1e-5 absolute where
  AdamW is well conditioned.  Some gradients are zero by construction
  (the attention key biases: the softmax drops a constant per query; the
  head's ``linear_c`` biases and the last stage's norm bias: the head's
  train-mode BN drops a constant per channel) and others may cancel, so
  where ``sqrt`` of AdamW's corrected second moment is within 100 eps of
  0 the update is float32 rounding noise in either package; those
  elements are held to AdamW's bound of two lr per step instead.
- ``gseg-segformer-train`` through both packages' commands from one
  backbone-only ``.safetensors``: the same count of adopted tensors, the
  same ``log.txt`` lines and checkpoint names, and every ``flax_model.pth``
  read by both packages' loaders and the port's ``gseg-segformer-test``
  loader."""
import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glomeruli_segmentation_tpu.cli import segformer_train as jax_cli
from glomeruli_segmentation_tpu.models import segformer as jax_segformer
from glomeruli_segmentation_tpu.pipeline import (
    fused_segformer as jax_fused_segformer,
)
from glomeruli_segmentation_tpu.train import segformer_train as jax_train
from glomeruli_segmentation_tpu_torch.cli import segformer_train as port_cli
from glomeruli_segmentation_tpu_torch.convert.segformer_import import (
    load_segformer_state_dict,
    read_safetensors,
    save_flax_checkpoint,
    state_dict_from_variables,
)
from glomeruli_segmentation_tpu_torch.models import segformer as port_segformer
from glomeruli_segmentation_tpu_torch.pipeline.fused_segformer import (
    load_segformer_checkpoint,
)
from glomeruli_segmentation_tpu_torch.train import segformer_train as port_train
from glomeruli_segmentation_tpu_torch.train.batch_norm import (
    use_flax_batch_norm,
)

from test_segformer_pipeline import _gtcs_tree

GEOMETRY = dict(hidden_sizes=(8, 16, 20, 32), depths=(1, 1, 1, 1),
                decoder_hidden_size=32)
LR = 6e-5
LOSS_RTOL, STATS_ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5
ILL_CONDITIONED = 100 * 1e-8


def _jax_variables(seed=0):
    model = jax_segformer.Segformer(jax_segformer.SegformerConfig(
        num_labels=5, **GEOMETRY))
    return jax.tree.map(np.asarray, jax.jit(
        lambda key, x: model.init(key, x, train=True))(
            jax.random.key(seed), jnp.zeros((1, 64, 64, 3))))


def _save_safetensors(tensors, path):
    st = pytest.importorskip("safetensors.torch")
    st.save_file({k: v.contiguous() for k, v in tensors.items()}, str(path))


def test_read_safetensors_matches_the_package(tmp_path):
    np_st = pytest.importorskip("safetensors.numpy")
    torch_st = pytest.importorskip("safetensors.torch")
    rng = np.random.RandomState(0)
    f32 = {"a": rng.randn(3, 4, 5).astype(np.float32),
           "b": rng.randn(7).astype(np.float32),
           "empty": np.zeros((0, 3), np.float32)}
    np_st.save_file(f32, str(tmp_path / "f32.safetensors"),
                    metadata={"format": "pt"})
    got = read_safetensors(str(tmp_path / "f32.safetensors"))
    want = np_st.load_file(str(tmp_path / "f32.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), want[k])
    mixed = {"w": torch.from_numpy(rng.randn(4, 6).astype(np.float32))
             .bfloat16(),
             "h": torch.from_numpy(rng.randn(5).astype(np.float16)),
             "n": torch.arange(9, dtype=torch.int64).reshape(3, 3)}
    torch_st.save_file(mixed, str(tmp_path / "mixed.safetensors"))
    got = read_safetensors(str(tmp_path / "mixed.safetensors"))
    want = torch_st.load_file(str(tmp_path / "mixed.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_load_segformer_state_dict_safetensors_and_backbone(tmp_path):
    sd = state_dict_from_variables(_jax_variables(seed=3))
    sd.pop("decode_head.batch_norm.num_batches_tracked")
    hf = tmp_path / "hf"
    hf.mkdir()
    _save_safetensors(sd, hf / "model.safetensors")
    for path in (hf, hf / "model.safetensors"):
        got = load_segformer_state_dict(str(path))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    backbone = {k: t for k, t in sd.items()
                if not k.startswith("decode_head.")}
    for name, write in (("backbone.safetensors", _save_safetensors),
                        ("backbone.bin", torch.save)):
        write(backbone, tmp_path / name)
        with pytest.raises(ValueError, match="backbone-only"):
            load_segformer_state_dict(str(tmp_path / name))
        got = load_segformer_state_dict(str(tmp_path / name),
                                        backbone_only=True)
        assert got.keys() == backbone.keys()
    # the serving commands' loader refuses a backbone-only flax_model.pth
    save_flax_checkpoint(backbone, str(tmp_path / "flax_model.pth"), 5)
    with pytest.raises(ValueError, match="backbone-only"):
        load_segformer_checkpoint(str(tmp_path / "flax_model.pth"))


def _adam(opt_state, accum):
    inner = opt_state.inner_opt_state if accum > 1 else opt_state
    return inner[0]


@pytest.mark.parametrize("accum,warmup,micro", [(1, 2, 3), (2, 1, 4)],
                         ids=["adamw", "accumulation2"])
def test_train_steps_match_jax(accum, warmup, micro):
    """Micro-batches alternate between two batches with some labels 255.
    ``adamw``: updates at lr 0, lr/2, lr (warm-up 2); the forwards of
    steps 1 and 2 see equal weights.  ``accumulation2``: updates after
    micro-batches 2 (lr 0) and 4 (lr), so every forward sees equal
    weights."""
    v = _jax_variables()
    cfg = jax_segformer.SegformerConfig(num_labels=5, **GEOMETRY)
    jax_model = jax_segformer.Segformer(cfg)
    tx = optax.adamw(optax.linear_schedule(0.0, LR, warmup))
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jax_step, _ = jax_train.build_steps(jax_model, tx)
    p, bs, opt = v["params"], v["batch_stats"], tx.init(v["params"])

    model = port_segformer.Segformer(port_segformer.SegformerConfig(
        num_labels=5, **GEOMETRY))
    model.load_state_dict(state_dict_from_variables(v), strict=True)
    use_flax_batch_norm(model)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=0.0, betas=port_train.ADAMW_BETAS,
        eps=port_train.ADAMW_EPS,
        weight_decay=port_train.ADAMW_WEIGHT_DECAY)
    port_step, _ = port_train.build_steps(model, optimizer, LR, warmup,
                                          accum)

    rng = np.random.RandomState(1)
    xs = rng.randn(2, 2, 64, 64, 3).astype(np.float32)
    ys = rng.randint(0, 5, (2, 2, 64, 64)).astype(np.int32)
    ys[:, :, :6] = 255
    equal_weights = 2 if accum == 1 else micro
    masked = total = 0
    for i in range(micro):
        x, y = xs[i % 2], ys[i % 2]
        p, bs, opt, want_loss = jax_step(p, bs, opt, jnp.asarray(x),
                                         jnp.asarray(y))
        loss = port_step(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * float(
            want_loss), i
        adam = _adam(opt, accum)
        count = int(adam.count)
        want = state_dict_from_variables(jax.tree.map(
            np.asarray, {"params": p, "batch_stats": bs}))
        got = model.state_dict()
        if count == 0:
            # no update yet (the first micro-batch of two): the weights
            # are the initial ones in both packages
            for k, t in state_dict_from_variables(v).items():
                if "running" not in k:
                    assert torch.equal(got[k], t) and torch.equal(
                        want[k], t), k
        root_v = state_dict_from_variables({
            "params": jax.tree.map(lambda n: np.sqrt(
                np.asarray(n) / (1 - 0.999 ** max(count, 1))), adam.nu),
            "batch_stats": bs})
        for key, w in want.items():
            g, w = got[key].numpy(), w.numpy()
            if key.endswith("running_var") or (
                    key.endswith("running_mean") and i < equal_weights):
                np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                           err_msg=f"{key} {i}")
            elif count and "running" not in key \
                    and not key.endswith("num_batches_tracked"):
                ok = root_v[key].numpy() >= ILL_CONDITIONED
                np.testing.assert_allclose(g[ok], w[ok], rtol=0,
                                           atol=PARAM_ATOL,
                                           err_msg=f"{key} {i}")
                assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR * count)
                masked += int((~ok).sum())
                total += ok.size
        if i == accum - 1:
            # the first update, at lr 0, leaves the weights as they were
            assert all(torch.equal(got[k], t) for k, t in
                       state_dict_from_variables(v).items()
                       if "running" not in k)
    assert masked <= 0.05 * total, (masked, total)


def _run(cli, root, ckpt, out):
    buf = io.StringIO()
    argv = ["--site", "01_Todai", "--data_root", str(root), "--data_date",
            "20260101", "--model_root", str(root / out), "--fold", "1",
            "--max_epoch", "2", "--save_interval", "1", "--batch_size", "2",
            "--accumulation_steps", "2", "--input_size", "64",
            "--dl_num_workers", "2", "--pretrained_checkpoint", str(ckpt)]
    if cli is port_cli:
        argv += ["--device", "cpu"]
    with contextlib.redirect_stdout(buf):
        out_dir = cli.main(argv) if cli is port_cli else \
            jax_train.train_segformer(cli.build_parser().parse_args(argv))
    return out_dir, buf.getvalue()


def test_cli_from_a_backbone_matches_jax(tmp_path):
    """Both commands from one backbone-only ``model.safetensors``."""
    _gtcs_tree(tmp_path, n_specimens=5, crops_per=2, size=72)
    sd = state_dict_from_variables(_jax_variables(seed=5))
    backbone = {k: t for k, t in sd.items()
                if not k.startswith("decode_head.")}
    ckpt = tmp_path / "mit-tiny"
    ckpt.mkdir()
    _save_safetensors(backbone, ckpt / "model.safetensors")
    port_dir, port_out = _run(port_cli, tmp_path, ckpt, "port")
    jax_dir, jax_out = _run(jax_cli, tmp_path, ckpt, "jax")

    adopted = re.compile(r"pretrained checkpoint loaded \((\d+) tensors "
                         r"adopted\)")
    assert adopted.findall(port_out) == adopted.findall(jax_out) == [
        str(len(backbone))]
    port_log = [json.loads(ln) for ln in
                open(os.path.join(port_dir, "log.txt"))]
    jax_log = [json.loads(ln) for ln in
               open(os.path.join(jax_dir, "log.txt"))]
    assert [sorted(r.items()) for r in port_log if "loss" not in r] != []
    assert ([(sorted(r), r["epoch"]) for r in port_log]
            == [(sorted(r), r["epoch"]) for r in jax_log])
    assert all(np.isfinite(list(r.values())).all() for r in port_log)
    names = sorted(n for n in os.listdir(port_dir) if n != "log.txt")
    assert names == sorted(n for n in os.listdir(jax_dir) if n != "log.txt")
    assert names and all(n.startswith("checkpoint-") for n in names)
    for name in names:
        path = os.path.join(port_dir, name, "flax_model.pth")
        got, labels = load_segformer_checkpoint(path)
        assert labels == 5
        # the backbone's geometry, a fresh head of the default width
        assert port_segformer.config_from_state_dict(got) == \
            port_segformer.SegformerConfig(num_labels=5, **dict(
                GEOMETRY, decoder_hidden_size=256))
        jax_v, jax_labels = jax_fused_segformer.load_segformer_checkpoint(
            path)
        want_v, _ = jax_fused_segformer.load_segformer_checkpoint(
            os.path.join(jax_dir, name, "flax_model.pth"))
        assert jax_labels == 5
        assert jax.tree.structure(jax_v) == jax.tree.structure(want_v)
        assert all(a.shape == b.shape for a, b in zip(
            jax.tree.leaves(jax_v), jax.tree.leaves(want_v)))
        # the adopted encoder tensors moved by at most two updates of lr
        for k, t in backbone.items():
            assert (got[k] - t).abs().max() <= 2 * 2 * LR + 1e-6, k
    # gseg-segformer-test's discovery from the output directory
    best, _ = load_segformer_checkpoint(port_dir)
    assert best.keys() == got.keys()
