"""The port's SegFormer (``models/segformer.py``) and its weight carry-over
(``convert/segformer_import.py``) against the JAX package's on the CPU, at
small widths: logits of ``Segformer.apply`` to float32 tolerance (also at a
size whose stage grids do not divide by ``sr``, and with ``sr`` 1 in every
stage), the bf16 path, the geometry inferred from a state dict for the tiny
widths and for mit-b0 and mit-b4, the key map both ways, the logits'
upsample, and the checkpoint loaders.  Helpers here are shared by the
other SegFormer test files."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.convert.segformer_import import (
    hf_state_dict_to_variables,
)
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.models import segformer as jax_segformer
from glomeruli_segmentation_tpu.ops import resize as jax_resize
from glomeruli_segmentation_tpu.pipeline import (
    fused_segformer as jax_fused_segformer,
)
from glomeruli_segmentation_tpu_torch.convert.segformer_import import (
    load_segformer_state_dict,
    save_flax_checkpoint,
    state_dict_from_variables,
    variables_from_state_dict,
)
from glomeruli_segmentation_tpu_torch.models import segformer as port_segformer
from glomeruli_segmentation_tpu_torch.ops import resize as port_resize
from glomeruli_segmentation_tpu_torch.pipeline.fused_segformer import (
    load_segformer_checkpoint,
)

# the JAX package's tiny test widths (tests/test_e2e_segformer.py), and the
# same with no spatial reduction in any stage
TINY = dict(hidden_sizes=(8, 16, 40, 64), depths=(1, 1, 1, 1),
            sr_ratios=(8, 4, 2, 1), patch_sizes=(7, 3, 3, 3),
            decoder_hidden_size=32)
TINY_SR1 = dict(TINY, sr_ratios=(1, 1, 1, 1))
# the published geometries the slice runs at full width
MIT_B0 = dict(hidden_sizes=(32, 64, 160, 256), depths=(2, 2, 2, 2),
              decoder_hidden_size=256)
MIT_B4 = dict(hidden_sizes=(64, 128, 320, 512), depths=(3, 8, 27, 3),
              decoder_hidden_size=768)
# the classifier is scaled so that random weights leave wide top-2 margins
CLASSIFIER_SCALE = 16.0
MIN_MARGIN = 1e-4
F32_ATOL = 1e-5


def jax_variables(geometry=TINY, num_labels=5, seed=0,
                  classifier_scale=CLASSIFIER_SCALE):
    """``Segformer.init`` with a seeded key, as numpy arrays; the
    classifier scaled by ``classifier_scale``."""
    model = jax_segformer.Segformer(jax_segformer.SegformerConfig(
        num_labels=num_labels, **geometry))
    v = jax.jit(lambda key, x: model.init(key, x, train=True))(
        jax.random.key(seed), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree.map(np.array, v)
    clf = v["params"]["head"]["classifier"]
    clf["kernel"] = clf["kernel"] * np.float32(classifier_scale)
    clf["bias"] = clf["bias"] * np.float32(classifier_scale)
    return v


def port_model(variables, dtype=torch.float32):
    sd = state_dict_from_variables(variables)
    model = port_segformer.Segformer(
        port_segformer.config_from_state_dict(sd), dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def jax_logits(variables, x, dtype=None):
    cfg = jax_segformer.config_from_variables(variables)
    model = jax_segformer.Segformer(cfg, dtype=dtype)
    return np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x))
                      .astype(jnp.float32))


def assert_wide_margins(logits, min_margin=MIN_MARGIN):
    """No pixel's top-2 logit margin is below ``min_margin``: float32
    differences between the packages cannot flip an argmax."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    assert margin >= min_margin, margin


def same_tree(a, b) -> bool:
    return (jax.tree.structure(a) == jax.tree.structure(b)
            and all(np.array_equal(x, y) for x, y in
                    zip(jax.tree.leaves(a), jax.tree.leaves(b))))


@pytest.mark.parametrize("geometry", [TINY, TINY_SR1], ids=["tiny", "sr1"])
@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_logits_match_jax(geometry, hw):
    """72x100: stage grids 18x25, 9x13, 5x7, 3x4, none divisible by sr (8,
    4, 2): the reduction pads 'SAME'.  The classifier is not scaled, so
    the logits stay within a few units."""
    v = jax_variables(geometry, seed=1, classifier_scale=1.0)
    x = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    want = jax_logits(v, x)
    with torch.no_grad():
        got = port_model(v)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // 4), -(-hw[1] // 4), 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    assert_wide_margins(want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_bf16_matches_jax(hw):
    """bf16 products, float32 norms and softmax on both sides: one bf16
    rounding (2^-8 relative) per product, compounded over the layers and
    summed in other orders.  Tolerance: 1/16 of the largest float32 logit;
    the argmax agrees on at least 0.99 of pixels."""
    v = jax_variables(seed=1, classifier_scale=1.0)
    x = np.random.RandomState(3).randn(2, *hw, 3).astype(np.float32)
    want = jax_logits(v, x, dtype=jnp.bfloat16)
    f32 = jax_logits(v, x)
    model = port_model(v, dtype=torch.bfloat16)
    assert model.segformer.encoder.block[0][0].mlp.dense1.weight.dtype == \
        torch.bfloat16
    assert model.segformer.encoder.layer_norm[0].weight.dtype == \
        torch.float32
    assert model.decode_head.batch_norm.running_var.dtype == torch.float32
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.abs(f32).max() / 16)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("geometry", [TINY, MIT_B0, MIT_B4],
                         ids=["tiny", "mit-b0", "mit-b4"])
def test_config_from_state_dict_matches_jax(geometry):
    """Shapes only: the JAX tree from ``jax.eval_shape`` of the init, the
    port's from a model on the meta device; both infer the same geometry,
    and the port's keys map onto the JAX tree's shapes."""
    cfg = jax_segformer.SegformerConfig(num_labels=5, **geometry)
    shapes = jax.eval_shape(
        lambda: jax_segformer.Segformer(cfg).init(
            jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=True))
    want = dataclasses.asdict(jax_segformer.config_from_variables(shapes))
    with torch.device("meta"):
        model = port_segformer.Segformer(port_segformer.SegformerConfig(
            num_labels=5, **geometry))
    sd = model.state_dict()
    got = port_segformer.config_from_state_dict(sd)
    assert dataclasses.asdict(got) == want == dataclasses.asdict(cfg)
    assert port_segformer.config_from_state_dict(sd, num_labels=3) == \
        dataclasses.replace(got, num_labels=3)
    views = {k: np.broadcast_to(np.float32(0), tuple(t.shape))
             for k, t in sd.items() if not k.endswith("num_batches_tracked")}
    mapped = variables_from_state_dict(views)
    assert jax.tree.map(lambda a: a.shape, mapped) == \
        jax.tree.map(lambda a: tuple(a.shape), shapes)


def test_key_map_round_trip_matches_jax():
    v = jax_variables(seed=4)
    sd = state_dict_from_variables(v)
    assert sd["decode_head.batch_norm.num_batches_tracked"].item() == 0
    assert all(t.dtype == torch.float32 for k, t in sd.items()
               if not k.endswith("num_batches_tracked"))
    numpy_sd = {k: t.numpy() for k, t in sd.items()}
    assert same_tree(variables_from_state_dict(numpy_sd), v)
    assert same_tree(hf_state_dict_to_variables(numpy_sd), v)
    # the port's own state dict (HF keys) carries across to the JAX model
    model = port_model(v)
    assert same_tree(hf_state_dict_to_variables(
        {k: t.numpy() for k, t in model.state_dict().items()}), v)


def test_upsample_logits_matches_jax():
    """Byte-equal to the JAX package's host twin ``resize_bilinear_np``
    (the blend as separate float32 operations, what the port computes on
    every device).  XLA on the CPU contracts ``top * (1 - w) + bot * w``
    into one fused multiply-add, so the JAX package's jitted
    ``upsample_logits`` differs from both by a rounding: held to 1e-6,
    under 2^-21 of these logits' largest magnitude."""
    logits = np.random.RandomState(5).randn(2, 16, 16, 5).astype(np.float32)
    for out_hw in ((64, 64), (61, 83), (7, 9)):
        got = port_segformer.upsample_logits(torch.from_numpy(logits),
                                             *out_hw)
        assert got.dtype == torch.float32
        host = np.stack([jax_resize.resize_bilinear_np(lg, *out_hw)
                         for lg in logits])
        assert np.array_equal(got.numpy(), host), out_hw
        assert np.array_equal(got.numpy(), np.stack(
            [port_resize.resize_bilinear_np(lg, *out_hw) for lg in logits]))
        want = np.asarray(jax_segformer.upsample_logits(
            jnp.asarray(logits), *out_hw))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _write_training_dir(root, v, num_labels=5):
    """A training output directory as the trainer leaves it: two
    ``checkpoint-N`` directories and a ``log.txt`` naming the better."""
    blob = {"params": v["params"], "batch_stats": v["batch_stats"],
            "num_labels": num_labels}
    for n in (1, 2):
        (root / f"checkpoint-{n}").mkdir(parents=True)
        save_torch_legacy(blob, str(root / f"checkpoint-{n}" /
                                    "flax_model.pth"))
    (root / "log.txt").write_text(
        "{'eval_mean_iou': 0.5, 'epoch': 1}\n"
        "{'eval_mean_iou': 0.4, 'epoch': 2}\n")
    return root


def test_load_segformer_checkpoint_forms(tmp_path):
    """The file, a ``checkpoint-N`` directory and a training output
    directory, written by the JAX package's ``save_torch_legacy``."""
    v = jax_variables(seed=6)
    run = _write_training_dir(tmp_path / "run", v, num_labels=5)
    want = state_dict_from_variables(v)
    for path in (run / "checkpoint-2" / "flax_model.pth",
                 run / "checkpoint-2", run):
        sd, n = load_segformer_checkpoint(str(path))
        assert n == 5
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in want)
        jax_v, jax_n = jax_fused_segformer.load_segformer_checkpoint(
            str(path))
        assert jax_n == n
        assert same_tree(jax.tree.map(np.asarray, jax_v), v)
    # the port writes the trainer's format too, and both packages read it
    save_flax_checkpoint(want, str(tmp_path / "flax_model.pth"), 5)
    sd, n = load_segformer_checkpoint(str(tmp_path / "flax_model.pth"))
    assert n == 5 and all(torch.equal(sd[k], want[k]) for k in want)
    jax_v, _ = jax_fused_segformer.load_segformer_checkpoint(
        str(tmp_path / "flax_model.pth"))
    assert same_tree(jax.tree.map(np.asarray, jax_v), v)


def test_load_segformer_state_dict(tmp_path):
    """An HF directory, ``pytorch_model.bin`` or ``model.safetensors``
    loads; a backbone-only checkpoint raises unless the trainer asks for
    it (``tests/test_torch_segformer_train.py``)."""
    sd = state_dict_from_variables(jax_variables(seed=7))
    hf = tmp_path / "hf"
    hf.mkdir()
    torch.save(sd, hf / "pytorch_model.bin")
    for path in (hf, hf / "pytorch_model.bin"):
        got = load_segformer_state_dict(str(path))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    st = tmp_path / "st"
    st.mkdir()
    safetensors_torch = pytest.importorskip("safetensors.torch")
    safetensors_torch.save_file({k: t.contiguous() for k, t in sd.items()},
                                str(st / "model.safetensors"))
    for path in (st, st / "model.safetensors"):
        got = load_segformer_state_dict(str(path))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    backbone = tmp_path / "backbone.bin"
    torch.save({k: t for k, t in sd.items()
                if not k.startswith("decode_head.")}, backbone)
    with pytest.raises(ValueError, match="backbone-only"):
        load_segformer_state_dict(str(backbone))
    assert os.path.isfile(backbone)


def test_random_state_dict_is_seeded():
    cfg = port_segformer.SegformerConfig(num_labels=5, **TINY)
    a = port_segformer.random_segformer_state_dict(cfg, 3,
                                                   classifier_scale=4.0)
    b = port_segformer.random_segformer_state_dict(cfg, 3)
    assert all(torch.equal(a[k], b[k]) for k in a
               if k != "decode_head.classifier.weight")
    assert torch.equal(a["decode_head.classifier.weight"],
                       4.0 * b["decode_head.classifier.weight"])
    assert port_segformer.config_from_state_dict(a) == cfg
