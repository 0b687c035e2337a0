"""The port's data-parallel SegFormer steps (``segformer_train.build_steps``
on two gloo ranks) against the JAX ``build_steps`` on a 2-device mesh of
the suite's CPU devices, and against the port's one-device steps on the
same global batches.

MiT widths (8, 16, 20, 32), one block per stage, decoder 32, 5 labels,
64x64, from one JAX ``model.init``.  Two ragged batches of 3 with some
labels 255, padded to 4 as both packages pad (images repeat, labels 255),
two AdamW steps under a warm-up of 2 (lr 0, then lr / 2), then the
evaluation map of the first batch gathered from the ranks:

- each step's loss within 1e-5 relative;
- the head's BN running statistics within 1e-6 (both steps' forwards see
  equal weights);
- the parameters within 1e-5, except where AdamW's corrected second moment
  is within 100 eps of 0, held to AdamW's bound (PR 12's rule,
  ``tests/test_torch_segformer_train.py``), at most 5% of them;
- the gathered class map has the 3 real rows and agrees with the JAX
  mesh's on at least 0.999 of the pixels, and with one device's on all."""
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_rank_steps
from torch_threads import one_torch_thread  # noqa: F401

from glomeruli_segmentation_tpu.models import segformer as jax_segformer
from glomeruli_segmentation_tpu.train import segformer_train as jax_train
from glomeruli_segmentation_tpu_torch.convert.segformer_import import (
    state_dict_from_variables,
)
from glomeruli_segmentation_tpu_torch.models import segformer as port_segformer
from glomeruli_segmentation_tpu_torch.parallel import distributed
from glomeruli_segmentation_tpu_torch.train import (
    segformer_train as port_train,
)
from glomeruli_segmentation_tpu_torch.train.batch_norm import (
    use_flax_batch_norm,
)

GEOMETRY = dict(hidden_sizes=(8, 16, 20, 32), depths=(1, 1, 1, 1),
                decoder_hidden_size=32)
LR, WARMUP = 6e-5, 2
LOSS_RTOL, STATS_ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5
ILL_CONDITIONED = 100 * 1e-8


def _batches():
    rng = np.random.RandomState(4)
    out = []
    for _ in range(2):
        x = rng.randn(3, 64, 64, 3).astype(np.float32)
        y = rng.randint(0, 5, (3, 64, 64)).astype(np.int32)
        y[:, :5] = 255
        out.append((x, y))
    return out


@pytest.fixture(scope="module")
def runs():
    batches = _batches()
    cfg = jax_segformer.SegformerConfig(num_labels=5, **GEOMETRY)
    model = jax_segformer.Segformer(cfg)
    v = jax.tree.map(np.asarray, jax.jit(
        lambda key, x: model.init(key, x, train=True))(
            jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    tx = optax.adamw(optax.linear_schedule(0.0, LR, WARMUP))
    mesh = jax_train._build_mesh(Namespace(data_parallel=2))
    train_step, eval_step = jax_train.build_steps(model, tx, mesh)
    p, bs, opt = v["params"], v["batch_stats"], tx.init(v["params"])
    losses = []
    for x, y in batches:
        xp, yp, n_real = jax_train._pad_batch(x, y, mesh)
        assert (xp.shape[0], n_real) == (4, 3) and (yp[3] == 255).all()
        p, bs, opt, loss = train_step(p, bs, opt, jax_train._put(xp, mesh),
                                      jax_train._put(yp, mesh))
        losses.append(float(loss))
    x, y = batches[0]
    xp, _, n_real = jax_train._pad_batch(x, None, mesh)
    logits = eval_step(p, bs, jax_train._put(xp, mesh))
    up = jax_segformer.upsample_logits(logits, y.shape[1], y.shape[2])
    adam = opt[0]
    after = jax.tree.map(np.asarray, {"params": p, "batch_stats": bs})
    jax_run = {
        "losses": losses,
        "pred": np.asarray(jnp.argmax(up, -1))[:n_real],
        "state": _numpy(state_dict_from_variables(after)),
        "root_v": _numpy(state_dict_from_variables({
            "params": jax.tree.map(lambda n: np.sqrt(
                np.asarray(n) / (1 - 0.999 ** int(adam.count))), adam.nu),
            "batch_stats": after["batch_stats"]}))}

    sd = state_dict_from_variables(v)
    port_cfg = port_segformer.SegformerConfig(num_labels=5, **GEOMETRY)
    distributed.launch(distributed.plan_ranks(2, device="cpu"),
                       torch_rank_steps.segformer_steps, sd, port_cfg,
                       batches, LR, WARMUP)
    ranks = distributed.last_reports

    # one device on the padded global batches
    model1 = port_segformer.Segformer(port_cfg)
    model1.load_state_dict(sd, strict=True)
    use_flax_batch_norm(model1)
    optimizer = torch.optim.AdamW(
        model1.parameters(), lr=0.0, betas=port_train.ADAMW_BETAS,
        eps=port_train.ADAMW_EPS, weight_decay=port_train.ADAMW_WEIGHT_DECAY)
    step1, eval1 = port_train.build_steps(model1, optimizer, LR, WARMUP)
    losses1 = [float(step1(*(torch.from_numpy(np.concatenate(
        [a, a[-1:] if a.dtype == np.float32 else np.full_like(a[:1], 255)]))
        for a in (x, y)))) for x, y in batches]
    x, y = batches[0]
    logits = eval1(torch.from_numpy(np.concatenate([x, x[-1:]])))
    pred1 = port_segformer.upsample_logits(
        logits.float(), y.shape[1], y.shape[2]).argmax(-1)[:3]
    one = {"losses": losses1, "pred": pred1.numpy(),
           "state": _numpy(model1.state_dict())}
    return jax_run, ranks, one


def _numpy(sd):
    return {k: np.asarray(t) for k, t in sd.items()}


def _check_run(got, want, root_v, pred_agreement):
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got["losses"],
                                                  want["losses"])
    assert got["pred"].shape == want["pred"].shape == (3, 64, 64)
    assert float((got["pred"] == want["pred"]).mean()) >= pred_agreement
    masked = total = 0
    for key, w in want["state"].items():
        g = got["state"][key]
        if key.endswith("num_batches_tracked"):
            continue
        if "running" in key:
            np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                       err_msg=key)
        else:
            ok = root_v[key] >= ILL_CONDITIONED
            np.testing.assert_allclose(g[ok], w[ok], rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)
            assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR * 2), key
            masked += int((~ok).sum())
            total += ok.size
    assert masked <= 0.05 * total, (masked, total)


def test_two_ranks_match_the_jax_mesh_steps(runs):
    jax_run, ranks, _ = runs
    for rank in ranks:
        _check_run(rank, jax_run, jax_run["root_v"], 0.999)


def test_two_ranks_match_one_device(runs):
    jax_run, ranks, one = runs
    for rank in ranks:
        _check_run(rank, one, jax_run["root_v"], 1.0)


def test_ranks_hold_the_same_state(runs):
    _, (r0, r1), _ = runs
    assert r0["losses"] == r1["losses"]
    np.testing.assert_array_equal(r0["pred"], r1["pred"])
    for key, t in r0["state"].items():
        np.testing.assert_array_equal(t, r1["state"][key], err_msg=key)
