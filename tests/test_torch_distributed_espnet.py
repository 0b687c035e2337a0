"""The port's data-parallel ESPNet step (``EspnetTrainer.train_step`` on two
gloo ranks, ``parallel/distributed.py``) against the JAX trainer's
``_get_step`` on a 2-device mesh of the suite's CPU devices, and against
the port's one-device step on the same global batch.

ESPNetEncoder(5, 2, 3) at 32x64 from one JAX ``model.init``; a ragged batch
of 3, padded to 4 by repeating its last sample (both packages' padding),
with the ``valid`` mask; each rank keeps two rows.  One float32 step:

- the loss within 1e-5 relative and the confusion histograms equal;
- the gradients by the JAX package's own bar for sharded against
  unsharded (``tests/test_espnet_training.py``): cosine over all of them
  above 0.99999 and norms within 1e-4;
- the BN running statistics within 1e-6 (the global batch's, padded row
  included, as GSPMD computes them);
- the parameters after Adam within 1e-5, except where the square root of
  Adam's corrected second moment (the JAX step's) is within 100 eps of 0:
  there the update turns on float32 rounding, and such elements (at most
  2%) are held to Adam's bound of two lr (PR 12's rule,
  ``tests/test_torch_espnet_train_steps.py``);
- both ranks hold the same state after the step."""
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_rank_steps
from torch_threads import one_torch_thread  # noqa: F401

from glomeruli_segmentation_tpu.models import espnet as jax_espnet
from glomeruli_segmentation_tpu.train.criteria import (
    cross_entropy_2d as jax_cross_entropy,
)
from glomeruli_segmentation_tpu.train.espnet_train import (
    EspnetTrainer as JaxTrainer,
)
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.parallel import distributed
from glomeruli_segmentation_tpu_torch.train import espnet_train

LR = 5e-4
CLASS_WEIGHTS = np.asarray(1 / np.log(1.10 + np.array(
    [0.6, 0.2, 0.1, 0.07, 0.03])), np.float32)
LOSS_RTOL, STATS_ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5
COSINE, NORM_RTOL = 0.99999, 1e-4
ILL_CONDITIONED = 100 * 1e-8


def _batch():
    rng = np.random.RandomState(3)
    bgr = rng.uniform(120, 240, (3, 32, 64, 3)).astype(np.float32)
    x = ((bgr - np.float32([204.6, 170.2, 199.6]))
         / np.float32([20.6, 42.9, 28.4]) / np.float32(255.0))
    y = rng.randint(0, 5, (3, 4, 8)).astype(np.int32)
    return x.astype(np.float32), y


@pytest.fixture(scope="module")
def runs():
    x, y = _batch()
    model = jax_espnet.ESPNetEncoder(5, 2, 3)
    v = jax.tree.map(np.asarray, model.init(jax.random.key(1),
                                            jnp.asarray(x[:1]), train=True))
    # the JAX trainer on its 2-device mesh
    t = JaxTrainer(Namespace(lr=LR, step_loss=100, weight_decay=5e-4,
                             data_parallel=2))
    assert t.mesh.shape["data"] == 2
    t.class_weights = jnp.asarray(CLASS_WEIGHTS)
    tx = t.build_optimizer()
    xs, ys, n_real = t._pad_batch(x, y)
    assert (xs.shape[0], n_real) == (4, 3) and (xs[3] == xs[2]).all()
    valid = np.arange(4) < n_real
    step = t._get_step(model, tx, xs.shape, True)
    p, bs, opt, loss, hist = step(v["params"], v["batch_stats"],
                                  tx.init(v["params"]), t._put(xs),
                                  t._put(ys), t._put(valid))

    def loss_fn(params, stats, xb, yb, vb):
        logits, _ = model.apply({"params": params, "batch_stats": stats},
                                xb, train=True, mutable=["batch_stats"])
        return jax_cross_entropy(logits.astype(jnp.float32), yb,
                                 t.class_weights, vb)

    repl = NamedSharding(t.mesh, P())
    data = NamedSharding(t.mesh, P("data"))
    grads = jax.jit(jax.grad(loss_fn),
                    in_shardings=(repl, repl, data, data, data))(
        v["params"], v["batch_stats"], xs, ys, valid)
    nu = opt.inner_state[1][0].nu
    after = jax.tree.map(np.asarray, {"params": p, "batch_stats": bs})
    jax_run = {
        "loss": float(loss), "hist": np.asarray(hist),
        "grads": _numpy(state_dict_from_flax({
            "params": jax.tree.map(np.asarray, grads),
            "batch_stats": after["batch_stats"]})),
        "state": _numpy(state_dict_from_flax(after)),
        "root_v": _numpy(state_dict_from_flax({
            "params": jax.tree.map(lambda n: np.sqrt(
                np.asarray(n) / (1 - 0.999)), nu),
            "batch_stats": after["batch_stats"]}))}

    # the port on two ranks, from the unpadded batch
    sd = state_dict_from_flax(v)
    plan = distributed.plan_ranks(2, device="cpu")
    distributed.launch(plan, torch_rank_steps.espnet_step, sd, x, y,
                       CLASS_WEIGHTS, LR)
    ranks = distributed.last_reports

    # the port on one device, on the padded batch and its mask
    model1 = torch_rank_steps.espnet_model(sd)
    trainer = espnet_train.EspnetTrainer(
        Namespace(lr=LR, step_loss=100, weight_decay=5e-4), device="cpu")
    trainer.class_weights = torch.from_numpy(CLASS_WEIGHTS)
    loss1, hist1 = trainer.train_step(
        model1, trainer.build_optimizer(model1),
        espnet_train.nchw(torch.from_numpy(xs)), torch.from_numpy(ys),
        torch.from_numpy(valid))
    one = {"loss": float(loss1), "hist": hist1.numpy(),
           "grads": {k: q.grad.numpy() for k, q in model1.named_parameters()},
           "state": _numpy(model1.state_dict())}
    return jax_run, ranks, one


def _numpy(sd):
    return {k: np.asarray(t) for k, t in sd.items()}


def _flat(grads, keys):
    return np.concatenate([np.ravel(grads[k]) for k in keys])


def _check_step(got, want, root_v):
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    np.testing.assert_array_equal(got["hist"], want["hist"])
    keys = sorted(got["grads"])
    a, b = _flat(got["grads"], keys), _flat(want["grads"], keys)
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > COSINE, cos
    np.testing.assert_allclose(np.linalg.norm(a), np.linalg.norm(b),
                               rtol=NORM_RTOL)
    masked = total = 0
    for key, w in want["state"].items():
        g = got["state"][key]
        if key.endswith("num_batches_tracked"):
            assert g == w == 0
        elif key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            ok = root_v[key] >= ILL_CONDITIONED
            np.testing.assert_allclose(g[ok], w[ok], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
            assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR), key
            masked += int((~ok).sum())
            total += ok.size
    assert masked <= 0.02 * total, (masked, total)


def test_two_ranks_match_the_jax_mesh_step(runs):
    jax_run, ranks, _ = runs
    assert [r["rows"] for r in ranks] == [2, 2]
    assert [r["valid"].tolist() for r in ranks] == [[True, True],
                                                    [True, False]]
    for rank in ranks:
        _check_step(rank, jax_run, jax_run["root_v"])


def test_two_ranks_match_one_device(runs):
    jax_run, ranks, one = runs
    for rank in ranks:
        _check_step(rank, one, jax_run["root_v"])


def test_ranks_hold_the_same_state(runs):
    _, (r0, r1), _ = runs
    assert r0["loss"] == r1["loss"]
    for key, t in r0["state"].items():
        np.testing.assert_array_equal(t, r1["state"][key], err_msg=key)
