"""The port's data-parallel native detector step (``detector_driver.
train_step`` on two gloo ranks) against the JAX driver's step jitted by
``_jit_detector_step`` with ``data_parallel=2`` on the suite's CPU
devices, and against the port's one-device step on the same windows.

The tiny backbone at 128x128, batch 4 (two windows per rank), ``roi_chunk``
6 (three second-stage chunks of the 16 proposals), from one JAX
``model.init`` on the first draw of the JAX tests' annotated layout.  As in
``tests/test_torch_detector_driver.py``, the JAX step runs in float64
(``jax.enable_x64``): in float32 Flax's fast BatchNorm variance cancels on
the first layer.  The port's float32 steps are held to it by that file's
bars: the losses within 1e-5 relative, BN running statistics within 1e-6,
the gradients within 1e-4 of the largest or no further from the float64
step than the JAX package's own float32 gradient, the parameters after
Adam within 1e-5 (where ``|g|`` is under 1000 eps, within two lr; at most
5% of them).  Both ranks hold the same state; the two ranks' losses and
statistics equal one device's to the same bars.

The ROI chunk: in a rank of a data axis the automatic chunk is the JAX
package's for the global batch (``max(1, 1024 // B)``, 256 at B = 4), not
the local one (512 for a rank's two windows)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_rank_steps
from torch_threads import one_torch_thread  # noqa: F401

from glomeruli_segmentation_tpu.models import faster_rcnn as jax_frcnn
from glomeruli_segmentation_tpu.train import detector_driver as jax_driver
from glomeruli_segmentation_tpu.train.detector_train import (
    detector_loss as jax_detector_loss,
)
from glomeruli_segmentation_tpu.wsi.synthetic import (
    pas_like_image,
    write_pyramidal_tiff,
)
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models import faster_rcnn as port_frcnn
from glomeruli_segmentation_tpu_torch.parallel import distributed

PATIENT = "H16-44444"
LR = 1e-3
LOSS_RTOL, STATS_ATOL, PARAM_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5, 1e-4
ILL_CONDITIONED = 1000 * 1e-8
TINY = dict(image_size=(128, 128), backbone="tiny",
            anchor_scales=(0.25, 0.5), anchor_aspects=(1.0,),
            anchor_base=128.0, pre_nms_top_n=128, post_nms_top_n=16,
            crop_size=8, max_detections=8, roi_chunk=6)


def annotated_tree(tmp, seed):
    """The JAX tests' layout: one pyramidal TIFF with four glomeruli and
    its Pascal-VOC XML at ds8."""
    img, centers = pas_like_image(1536, 2048, seed=seed, n_glomeruli=4)
    pdir = tmp / "data" / "02_PAS" / PATIENT
    (pdir / "annotations").mkdir(parents=True)
    write_pyramidal_tiff(str(pdir / f"{PATIENT}.tiff"), img, mpp=0.25,
                         objective_power=40.0, levels=4)
    objs = "".join(
        f"<object><name>glomerulus</name><bndbox><xmin>{(cx - r) // 8}"
        f"</xmin><ymin>{(cy - r) // 8}</ymin><xmax>{(cx + r) // 8}</xmax>"
        f"<ymax>{(cy + r) // 8}</ymax></bndbox></object>"
        for cx, cy, r in centers)
    (pdir / "annotations" / f"OPT_PAS_{PATIENT}_{PATIENT}_pw40_ds8.xml"
     ).write_text(f"<annotation>{objs}</annotation>")
    (tmp / "targets.txt").write_text(f"{PATIENT}/{PATIENT}\n")
    return tmp


def first_batch(tree, batch_size=4):
    sampler = jax_driver.SlideWindowSampler(
        "OPT_PAS", str(tree / "data"), str(tree / "targets.txt"),
        jax_driver.DetectorTrainConfig(image_size=128,
                                       batch_size=batch_size, max_gt=8))
    return sampler.sample_batch(np.random.default_rng(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = first_batch(annotated_tree(tmp_path_factory.mktemp("ddet"), 41))
    assert batch[3].any()
    jcfg = jax_frcnn.FasterRCNNConfig(**TINY)
    model = jax_frcnn.FasterRCNN(jcfg)
    anchors32 = jax_frcnn.build_anchors(jcfg)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.asarray(batch[0], jnp.float32), anchors32,
        train=True))
    tx = optax.adam(LR)

    def make_step(anchors):
        def step(params, batch_stats, opt_state, x, gb, gc, gv):
            def loss_fn(p):
                out, upd = model.apply(
                    {"params": p, "batch_stats": batch_stats}, x, anchors,
                    train=True, mutable=["batch_stats"])
                losses = jax_detector_loss(anchors, out, gb, gc, gv)
                return losses["total"], (losses, upd["batch_stats"])

            (_, (losses, new_stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), new_stats,
                    opt_state, losses, grads)
        return step

    x, gb, gc, gv = batch
    with jax.enable_x64(True):
        step, bsh = jax_driver._jit_detector_step(
            make_step(jnp.asarray(anchors32, jnp.float64)), n_state=3,
            n_batch=4, data_parallel=2, batch_size=4)
        p, s = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                            (variables["params"], variables["batch_stats"]))
        p, s, opt, losses, grads = step(
            p, s, tx.init(p), *(jax.device_put(a, bsh) for a in (
                np.asarray(x, np.float64), gb, gc, gv)))
        f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
        after = f32({"params": p, "batch_stats": s})
        want = {"losses": {k: float(v) for k, v in losses.items()},
                "state": _numpy(state_dict_from_flax(after)),
                "grads": _numpy(state_dict_from_flax(
                    {"params": f32(grads),
                     "batch_stats": after["batch_stats"]})),
                "root_v": _numpy(state_dict_from_flax({
                    "params": jax.tree.map(lambda n: np.sqrt(
                        np.asarray(n, np.float32) / 0.001), opt[0].nu),
                    "batch_stats": after["batch_stats"]}))}

    # the JAX package's own float32 gradient, one device
    def loss32(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             np.asarray(x, np.float32), anchors32,
                             train=True, mutable=["batch_stats"])
        return jax_detector_loss(anchors32, out, gb, gc, gv)["total"]

    g32 = _numpy(state_dict_from_flax({
        "params": jax.tree.map(np.asarray, jax.jit(jax.grad(loss32))(
            variables["params"])),
        "batch_stats": variables["batch_stats"]}))
    jax_f32 = _grad_distance(g32, want["grads"])

    state = state_dict_from_flax(variables)
    pcfg = port_frcnn.FasterRCNNConfig(**TINY)
    distributed.launch(distributed.plan_ranks(2, device="cpu"),
                       torch_rank_steps.native_step, state, pcfg, batch, LR)
    ranks = distributed.last_reports
    one = torch_rank_steps.native_step(state, pcfg, batch, LR)
    return want, jax_f32, ranks, one


def _numpy(sd):
    return {k: np.asarray(t) for k, t in sd.items()}


def _grad_distance(got, want):
    keys = [k for k in want if not k.endswith((".bn.mean", ".bn.var"))]
    g_max = max(float(np.abs(want[k]).max()) for k in keys)
    return max(float(np.abs(got[k] - want[k]).max()) for k in keys) / g_max


def _check_step(got, want, jax_f32):
    for k, w in want["losses"].items():
        assert abs(got["losses"][k] - w) <= LOSS_RTOL * abs(w), \
            (k, got["losses"][k], w)
    assert got["grads"].keys() == {k for k in want["grads"] if not
                                   k.endswith((".bn.mean", ".bn.var"))}
    distance = _grad_distance(got["grads"], want["grads"])
    assert distance <= max(GRAD_RTOL, jax_f32), (distance, jax_f32)
    assert got["state"].keys() == want["state"].keys()
    masked = total = 0
    for key, w in want["state"].items():
        g = got["state"][key]
        if key.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                       err_msg=key)
            continue
        ok = want["root_v"][key] >= ILL_CONDITIONED
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=PARAM_ATOL,
                                   err_msg=key)
        assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR), key
        masked += int((~ok).sum())
        total += ok.size
    assert masked <= 0.05 * total, (masked, total)


def test_two_ranks_match_the_jax_mesh_step(runs):
    want, jax_f32, ranks, _ = runs
    assert [r["windows"] for r in ranks] == [2, 2]
    assert [r["proposals"].shape for r in ranks] == [(2, 16, 4)] * 2
    for rank in ranks:
        _check_step(rank, want, jax_f32)


def test_ranks_hold_the_same_state_as_one_device(runs):
    """The ranks hold one state; against one device's float32 step on the
    4 windows, whose own rounding (one torch thread) moves its losses up
    to ~1e-4 from the float64 step: each rank's loss no further from one
    device's than one device's is from the float64 step (plus the ranks'
    1e-5), the statistics within 1e-6, the gradients by the bar above, the
    proposals within 1e-2 pixels."""
    want, jax_f32, (r0, r1), one = runs
    assert r0["losses"] == r1["losses"]
    for key, t in r0["state"].items():
        np.testing.assert_array_equal(t, r1["state"][key], err_msg=key)
    assert one["windows"] == 4
    np.testing.assert_allclose(
        np.concatenate([r0["proposals"], r1["proposals"]]), one["proposals"],
        rtol=0, atol=1e-2)
    for k, w in want["losses"].items():
        floor = abs(one["losses"][k] - w) + LOSS_RTOL * abs(w)
        assert abs(r0["losses"][k] - one["losses"][k]) <= floor, k
    assert _grad_distance(one["grads"], want["grads"]) <= max(GRAD_RTOL,
                                                              jax_f32)
    assert _grad_distance(r0["grads"], one["grads"]) <= max(GRAD_RTOL,
                                                            jax_f32)
    for key, w in one["state"].items():
        if key.endswith((".bn.mean", ".bn.var")):
            np.testing.assert_allclose(r0["state"][key], w, rtol=0,
                                       atol=STATS_ATOL, err_msg=key)


def test_roi_chunk_comes_from_the_global_batch(monkeypatch):
    cfg = port_frcnn.FasterRCNNConfig(**dict(TINY, roi_chunk=0,
                                             post_nms_top_n=600))
    model = port_frcnn.FasterRCNN(cfg, kernel_nms=False, train_form=True)
    jax_chunk = lambda n: max(1, 1024 // n)    # faster_rcnn.py:189
    assert model.roi_chunk(4) == jax_chunk(4) == 256
    monkeypatch.setattr(distributed, "world", lambda: 2)
    assert model.roi_chunk(2) == jax_chunk(4)
    # the forward's chunks: a rank's 2 windows crop 256, 256 and 88
    # proposals a chunk, as GSPMD's B = 4 program does
    sizes = []
    model.box_head.register_forward_pre_hook(
        lambda module, args: sizes.append(args[0].shape[0]))
    with torch.no_grad():
        model.train()(torch.rand(2, 128, 128, 3) * 255,
                      port_frcnn.build_anchors(cfg))
    assert [s // 2 for s in sizes] == [256, 256, 88]
    assert model.roi_chunk(3) == jax_chunk(6)
    assert port_frcnn.FasterRCNN(port_frcnn.FasterRCNNConfig(**TINY),
                                 kernel_nms=False).roi_chunk(2) == 6
