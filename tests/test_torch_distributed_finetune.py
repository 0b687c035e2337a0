"""The port's data-parallel ``--finetune_pb`` step (``detector_driver.
train_step`` over ``ODAPIFasterRCNN.train_outputs`` on two gloo ranks)
against the JAX fine-tuner's step jitted by ``_jit_detector_step`` with
``data_parallel=2`` on the suite's CPU devices, and against the port's
one-device step on the same windows.

``build_od_api_consts(seed=3)`` (the JAX tests' tree) at 128x128, the JAX
tests' overrides, four windows of the JAX tests' annotated layout (two per
rank).  The BatchNorms are folded, so the ranks only sum gradients and
losses, and the JAX step runs in float32 with
``tests/test_torch_od_api_finetune.py``'s bars: the losses within 1e-5
relative, the gradients within 1e-4 of the largest, the parameters after
Adam within 1e-5 (Adam's ill-conditioned elements, ``|g|`` under 1000 eps
but not 0, within two lr; at most 5% of them).  Both ranks hold the same
parameters, and one device's step meets the same bars."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_rank_steps
from test_od_api_import import build_od_api_consts
from test_torch_distributed_detector import annotated_tree, first_batch
from torch_threads import one_torch_thread  # noqa: F401

from glomeruli_segmentation_tpu.convert.pb_import import (
    assemble_od_api_params,
)
from glomeruli_segmentation_tpu.models import od_api_frcnn as jax_od
from glomeruli_segmentation_tpu.train import detector_driver as jax_driver
from glomeruli_segmentation_tpu.train.detector_train import (
    detector_loss as jax_detector_loss,
)
from glomeruli_segmentation_tpu_torch.parallel import distributed

LR = 1e-3
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
ILL_CONDITIONED = 1000 * 1e-8
OVERRIDES = {"anchor_base": 64.0, "max_proposals": 16, "pre_nms_top_n": 256}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = first_batch(annotated_tree(tmp_path_factory.mktemp("dft"), 7))
    consts, _, _ = build_od_api_consts(seed=3)
    params, num_classes = assemble_od_api_params(consts)
    params = jax.tree.map(np.asarray, params)
    jm = jax_od.ODAPIFasterRCNN(params, jax_od.ODAPIConfig(
        num_classes=num_classes, image_size=(128, 128), **OVERRIDES),
        "float32")
    tx = optax.adam(LR)

    def step(p, opt_state, x, gb, gc, gv):
        def loss_fn(pp):
            out = jm.train_outputs(x, params=pp)
            losses = jax_detector_loss(jm.anchors, out, gb, gc, gv)
            return losses["total"], losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state2 = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state2, losses, grads

    jitted, bsh = jax_driver._jit_detector_step(
        step, n_state=2, n_batch=4, data_parallel=2, batch_size=4)
    p = jax.tree.map(jnp.asarray, params)
    x, gb, gc, gv = batch
    new, opt_state, losses, grads = jitted(
        p, tx.init(p), *(jax.device_put(a, bsh) for a in (
            np.asarray(x, np.float32), gb, gc, gv)))
    flat = lambda t: dict(torch_rank_steps._flat(jax.tree.map(np.asarray,
                                                              t)))
    want = {"losses": {k: float(v) for k, v in losses.items()},
            "params": flat(new), "grads": flat(grads),
            "root_v": flat(jax.tree.map(
                lambda n: np.sqrt(np.asarray(n) / 0.001), opt_state[0].nu))}

    args = (params, num_classes, OVERRIDES, 128, batch, LR)
    distributed.launch(distributed.plan_ranks(2, device="cpu"),
                       torch_rank_steps.od_api_step, *args)
    return want, distributed.last_reports, torch_rank_steps.od_api_step(
        *args)


def _check_step(got, want):
    for k, w in want["losses"].items():
        assert abs(got["losses"][k] - w) <= LOSS_RTOL * abs(w), \
            (k, got["losses"][k], w)
    assert got["grads"].keys() == want["grads"].keys()
    g_max = max(float(np.abs(g).max()) for g in want["grads"].values())
    g_diff = max(float(np.abs(got["grads"][k] - g).max())
                 for k, g in want["grads"].items())
    assert g_diff <= GRAD_RTOL * g_max, (g_diff, g_max)
    masked = total = 0
    for k, w in want["params"].items():
        root_v = want["root_v"][k]
        ok = (root_v >= ILL_CONDITIONED) | (root_v == 0)
        g = got["params"][k]
        np.testing.assert_allclose(g[ok], w[ok], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR), k
        masked += int((~ok).sum())
        total += ok.size
    assert masked <= 0.05 * total, (masked, total)


def test_two_ranks_match_the_jax_mesh_step(runs):
    want, ranks, _ = runs
    for rank in ranks:
        _check_step(rank, want)


def test_ranks_hold_the_same_parameters_as_one_device(runs):
    want, (r0, r1), one = runs
    assert r0["losses"] == r1["losses"]
    for k, t in r0["params"].items():
        np.testing.assert_array_equal(t, r1["params"][k], err_msg=k)
    _check_step(one, want)
