"""The port's OD-API fine-tuning (``train/od_api_finetune.py``,
``ODAPIFasterRCNN.train_outputs`` and ``params_tree``) against the JAX
package's on the CPU, on ``build_od_api_consts(seed=3)`` (the JAX tests'
tree) at 128x128, two windows, the JAX tests' overrides (anchor base 64,
256 pre-NMS, 16 proposals), in float32.

The model's BatchNorms are folded, so the JAX step in float32 has no
batch statistics to lose precision in.  Tolerances: ``train_outputs``
within 1e-5 (the proposals equal to 1e-4 pixels); the losses within 1e-5
relative; the gradients within 1e-4 of the largest one (the port crops
ROIs with a gather, the JAX package with two-tap matrix products: equal
values, but the gradients sum in another order); the parameters after one
Adam step within 1e-5, Adam's ill-conditioned elements (``|g|`` under 1000
eps but not 0, see ``test_torch_detector_driver.py``) within two lr.
Checkpoints are read both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_od_api_import import build_od_api_consts

from glomeruli_segmentation_tpu.cli import detect as jax_detect_cli
from glomeruli_segmentation_tpu.convert.pb_import import (
    assemble_od_api_params,
)
from glomeruli_segmentation_tpu.convert.torch_pickle import save_torch_legacy
from glomeruli_segmentation_tpu.models import od_api_frcnn as jax_od
from glomeruli_segmentation_tpu.pipeline import detect as jax_detect
from glomeruli_segmentation_tpu.train import od_api_finetune as jax_ft
from glomeruli_segmentation_tpu.train.detector_driver import (
    DetectorTrainConfig as JaxTrainConfig,
    SlideWindowSampler as JaxSampler,
)
from glomeruli_segmentation_tpu.train.detector_train import (
    detector_loss as jax_detector_loss,
)
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.cli import detect as port_detect_cli
from glomeruli_segmentation_tpu_torch.models import od_api_frcnn as port_od
from glomeruli_segmentation_tpu_torch.pipeline import detect as port_detect
from glomeruli_segmentation_tpu_torch.train import detector_driver
from glomeruli_segmentation_tpu_torch.train import od_api_finetune as port_ft

PATIENT = "H16-55555"
LR = 1e-3
OUT_ATOL, LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-4, 1e-5
ILL_CONDITIONED = 1000 * 1e-8
OVERRIDES = {"anchor_base": 64.0, "max_proposals": 16, "pre_nms_top_n": 256}


@pytest.fixture(scope="module")
def annotated_tree(tmp_path_factory):
    """The JAX tests' layout (``tests/test_od_api_finetune.py``)."""
    tmp = tmp_path_factory.mktemp("odft")
    img, centers = pas_like_image(1536, 2048, seed=7, n_glomeruli=4)
    pdir = tmp / "data" / "02_PAS" / PATIENT
    (pdir / "annotations").mkdir(parents=True)
    write_pyramidal_tiff(str(pdir / f"{PATIENT}.tiff"), img, mpp=0.25,
                         objective_power=40.0, levels=4)
    objs = ""
    for cx, cy, r in centers:
        x1, y1 = (cx - r) // 8, (cy - r) // 8
        x2, y2 = (cx + r) // 8, (cy + r) // 8
        objs += (f"<object><name>glomerulus</name><bndbox>"
                 f"<xmin>{x1}</xmin><ymin>{y1}</ymin>"
                 f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
    (pdir / "annotations" / f"OPT_PAS_{PATIENT}_{PATIENT}_pw40_ds8.xml"
     ).write_text(f"<annotation>{objs}</annotation>")
    (tmp / "targets.txt").write_text(f"{PATIENT}/{PATIENT}\n")
    return tmp


@pytest.fixture(scope="module")
def setup(annotated_tree):
    consts, _, _ = build_od_api_consts(seed=3)
    params, num_classes = assemble_od_api_params(consts)
    params = jax.tree.map(np.asarray, params)
    kw = dict(OVERRIDES, num_classes=num_classes, image_size=(128, 128))
    sampler = JaxSampler("OPT_PAS", str(annotated_tree / "data"),
                         str(annotated_tree / "targets.txt"),
                         JaxTrainConfig(image_size=128, batch_size=2,
                                        max_gt=8))
    batch = sampler.sample_batch(np.random.default_rng(0))
    jm = jax_od.ODAPIFasterRCNN(params, jax_od.ODAPIConfig(**kw), "float32")
    return params, kw, batch, jm


def _port_model(params, kw):
    return port_od.ODAPIFasterRCNN(params, port_od.ODAPIConfig(**kw),
                                   "float32", kernel_nms=False)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_checkpoint_name_and_loader_match_jax():
    assert port_ft.OD_API_CKPT_NAME == jax_ft.OD_API_CKPT_NAME
    from glomeruli_segmentation_tpu_torch.convert import pb_import

    assert port_ft.load_od_api_checkpoint is pb_import.load_od_api_checkpoint


def test_params_tree_round_trips(setup):
    params, kw, _, _ = setup
    tree = _port_model(params, kw).params_tree()
    want = dict(_flat(params))
    got = dict(_flat(tree))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


def test_train_outputs_match_jax(setup):
    params, kw, batch, jm = setup
    x = np.asarray(batch[0], np.float32)
    want = jax.tree.map(np.asarray, jm.train_outputs(jnp.asarray(x)))
    model = _port_model(params, kw)
    got = model.train_outputs(torch.from_numpy(x),
                              port_od.build_anchors(model.config))
    assert set(got) == set(want)
    assert not got["proposals"].requires_grad
    assert got["class_scores"].requires_grad
    for k, w in want.items():
        g = got[k].detach().numpy()
        assert g.shape == w.shape and g.dtype == np.float32, k
        atol = 1e-4 if k == "proposals" else OUT_ATOL
        np.testing.assert_allclose(g, w, rtol=OUT_ATOL, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX fine-tuner's step (``finetune_od_api``'s, verbatim) once:
    the losses, the gradients, Adam's corrected second moment's root and
    the parameters after it."""
    params, _, batch, jm = setup
    tx = optax.adam(LR)

    def step(p, opt_state, x, gb, gc, gv):
        def loss_fn(pp):
            out = jm.train_outputs(x, params=pp)
            losses = jax_detector_loss(jm.anchors, out, gb, gc, gv)
            return losses["total"], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state2 = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state2, losses, grads

    p = jax.tree.map(jnp.asarray, params)
    x, gb, gc, gv = batch
    new, opt_state, losses, grads = jax.jit(step)(
        p, tx.init(p), np.asarray(x, np.float32), gb, gc, gv)
    nu = opt_state[0].nu
    return (dict(_flat(jax.tree.map(np.asarray, new))),
            {k: float(v) for k, v in losses.items()},
            dict(_flat(jax.tree.map(np.asarray, grads))),
            dict(_flat(jax.tree.map(lambda n: np.sqrt(np.asarray(n) / 0.001),
                                    nu))))


def _port_step(setup):
    params, kw, batch, _ = setup
    model = _port_model(params, kw)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR, eps=1e-8)
    losses, _ = detector_driver.train_step(
        model, optimizer, port_ft.od_api_forward,
        port_od.build_anchors(model.config),
        detector_driver.upload_batch(batch, torch.device("cpu")))
    return model, losses


def test_finetune_step_matches_jax(setup, jax_step):
    want_params, want_losses, want_grads, root_v = jax_step
    model, losses = _port_step(setup)
    for k, w in want_losses.items():
        assert abs(float(losses[k]) - w) <= LOSS_RTOL * abs(w), \
            (k, float(losses[k]), w)
    # the gradients, in the JAX tree's layout
    for p in model.parameters():
        p.data = p.grad
    grads = dict(_flat(model.params_tree()))
    g_max = max(float(np.abs(g).max()) for g in want_grads.values())
    g_diff = max(float(np.abs(grads[k] - g).max())
                 for k, g in want_grads.items())
    assert g_diff <= GRAD_RTOL * g_max, (g_diff, g_max)


def test_finetune_step_parameters_match_jax(setup, jax_step):
    want_params, _, _, root_v = jax_step
    model, _ = _port_step(setup)
    got = dict(_flat(model.params_tree()))
    assert got.keys() == want_params.keys()
    masked = total = 0
    for k, w in want_params.items():
        # a gradient of exactly 0 (a dead ReLU, common in this small tree)
        # moves nothing: held to 1e-5 too
        ok = (root_v[k] >= ILL_CONDITIONED) | (root_v[k] == 0)
        np.testing.assert_allclose(got[k][ok], w[ok], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        assert np.all(np.abs(got[k][~ok] - w[~ok]) <= 2 * LR), k
        masked += int((~ok).sum())
        total += ok.size
    assert masked <= 0.05 * total, (masked, total)


# ---------------- checkpoints both ways ----------------
def _detect_both(params, num_classes, cfg_kw, images):
    kw = dict(OVERRIDES, min_dimension=128, max_dimension=128,
              compat_tf1_resize=True)
    want = jax_detect.ODAPIDetectorBackend(
        params=jax.tree.map(jnp.asarray, params), num_classes=num_classes,
        batch_size=2, compute_dtype="float32", **kw).detect_batch(images)
    got = port_detect.ODAPIDetectorBackend(
        params=params, num_classes=num_classes, batch_size=2,
        compute_dtype="float32", device="cpu", **kw).detect_batch(images)
    return got, want


def test_port_checkpoint_loads_in_jax_and_detects_the_same(
        annotated_tree, setup, tmp_path):
    """A 2-step CPU fine-tune through ``finetune_od_api`` writes
    ``od_api_detector.ckpt.pth`` (``torch.save``): the JAX package's
    loader reads the same tree and config, its ``load_backend`` takes the
    directory, and in float32 both packages detect the same windows
    alike."""
    consts, _, _ = build_od_api_consts(seed=3)
    cfg = detector_driver.DetectorTrainConfig(image_size=128, batch_size=2,
                                              steps=2, max_gt=8)
    path = port_ft.finetune_od_api(
        "OPT_PAS", str(annotated_tree / "data"),
        str(annotated_tree / "targets.txt"), str(tmp_path / "model"), cfg,
        consts=consts, od_config_overrides=dict(OVERRIDES), log_every=1,
        device="cpu")
    assert path.endswith("od_api_detector.ckpt.pth")
    params, n, saved = jax_ft.load_od_api_checkpoint(path)
    port_params, port_n, port_saved = port_ft.load_od_api_checkpoint(path)
    assert n == port_n == 1 and saved == port_saved
    assert saved["anchor_base"] == 64.0 and saved["max_proposals"] == 16
    want = dict(_flat(jax.tree.map(np.asarray, params)))
    got = dict(_flat(port_params))
    assert want.keys() == got.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    init = dict(_flat(setup[0]))
    assert any(not np.array_equal(got[k], init[k]) for k in init)
    assert all(np.isfinite(v).all() for v in got.values())
    backend = jax_detect_cli.load_backend(
        str(tmp_path / "model"), None, 2,
        od_api_overrides={"min_dimension": 128, "max_dimension": 128,
                          "max_proposals": 16})
    assert type(backend).__name__ == "ODAPIDetectorBackend"
    assert isinstance(port_detect_cli.load_backend(
        str(tmp_path / "model"), None, 2, device="cpu"),
        port_detect.ODAPIDetectorBackend)
    images = np.random.RandomState(6).randint(0, 255, (2, 128, 128, 3)
                                              ).astype(np.uint8)
    got_d, want_d = _detect_both(port_params, port_n, saved, images)
    np.testing.assert_array_equal(got_d[3], want_d[3])
    np.testing.assert_allclose(got_d[1], want_d[1], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_d[0], want_d[0], atol=1e-4, rtol=1e-4)


def test_jax_checkpoint_loads_in_the_port(setup, tmp_path):
    """The JAX fine-tuner's checkpoint (the legacy pickle of the numpy
    tree): the port reads the tree, builds the model from it and gives
    the tree back unchanged."""
    params, kw, _, _ = setup
    od_config = jax_od.ODAPIConfig(**kw)
    path = tmp_path / port_ft.OD_API_CKPT_NAME
    save_torch_legacy({"od_api_params": params, "num_classes": 1,
                       "od_config": dataclasses.asdict(od_config)},
                      str(path))
    got, n, saved = port_ft.load_od_api_checkpoint(str(path))
    assert n == 1 and saved["max_proposals"] == 16
    model = port_od.ODAPIFasterRCNN(got, port_od.ODAPIConfig(**kw),
                                    "float32")
    back = dict(_flat(model.params_tree()))
    assert all(np.array_equal(back[k], w) for k, w in _flat(params))
