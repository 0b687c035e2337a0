"""The port's ESPNet training step (``train/espnet_train.py``
``EspnetTrainer.train_step``) against the JAX trainer's ``_get_step`` on
the CPU, over two float32 steps, for the encoder and the decoder:
ESPNet(5, 1, 2) at 32x64, batch 2, inputs normalised as the trainer
normalises them, the reference class weights' form.  Each port step starts
from the JAX state before that step (weights, BN statistics and Adam's
moments and count carried over), so the second step exercises Adam's
moment accumulation and bias correction from equal inputs.

Tolerances: the loss within 1e-5 relative; the confusion histograms
equal; the BN running statistics within 1e-6 (which holds only with the
biased-variance update of ``train/batch_norm.py``); the parameters within
1e-5 absolute.  Adam's update is ``-lr * m / (sqrt(v) + 1e-8)`` (bias
corrected): where ``sqrt(v)`` is within 100 eps of 0 (the coupled
gradient cancels, or is the decay term alone, as for the taps of the d8
and d16 convolutions that see only padding at the 4x8 level-3 grid), the
update turns on float32 rounding that the two packages' convolutions make
differently.  Such elements, found from the JAX step's own second moment,
are held to Adam's bound of two lr per step instead, and at most 2% of
the elements may be such.  The ``--bf16`` step's loss is held to the
float32 one within 5e-2 relative (the JAX package's own bar,
``tests/test_espnet_training.py``)."""
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.models import espnet as jax_espnet
from glomeruli_segmentation_tpu.train.espnet_train import (
    EspnetTrainer as JaxTrainer,
)
from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models import espnet as port_espnet
from glomeruli_segmentation_tpu_torch.train.batch_norm import (
    use_flax_batch_norm,
)
from glomeruli_segmentation_tpu_torch.train.espnet_train import (
    EspnetTrainer as PortTrainer,
)

LR = 5e-4
STEPS = 2
CLASS_WEIGHTS = np.asarray(1 / np.log(1.10 + np.array(
    [0.6, 0.2, 0.1, 0.07, 0.03])), np.float32)
LOSS_RTOL, STATS_ATOL, PARAM_ATOL = 1e-5, 1e-6, 1e-5
ILL_CONDITIONED = 100 * 1e-8         # sqrt of Adam's corrected v below this
BF16_RTOL = 5e-2


def _args():
    return Namespace(lr=LR, step_loss=100, weight_decay=5e-4,
                     data_parallel=0)


def _batch(decoder: bool, seed: int = 0):
    """BGR near the reference's fold means, normalised as the trainer's
    ``Normalize`` + ``ToTensor`` do; labels at the model's output size."""
    rng = np.random.RandomState(seed)
    bgr = rng.uniform(120, 240, (2, 32, 64, 3)).astype(np.float32)
    x = ((bgr - np.float32([204.6, 170.2, 199.6]))
         / np.float32([20.6, 42.9, 28.4]) / np.float32(255.0))
    s = 1 if decoder else 8
    y = rng.randint(0, 5, (2, 32 // s, 64 // s)).astype(np.int32)
    return x.astype(np.float32), y


def _jax_model(decoder: bool):
    cls = jax_espnet.ESPNet if decoder else jax_espnet.ESPNetEncoder
    return cls(5, 1, 2)


def _adam(opt_state):
    """(count, mu, nu) of the JAX trainer's inject_hyperparams(chain(
    add_decayed_weights, adam)) state."""
    adam = opt_state.inner_state[1][0]
    return int(adam.count), adam.mu, adam.nu


@pytest.fixture(scope="module")
def jax_runs():
    """Per model: the batch and, for each of two JAX steps, the state
    before it (variables and Adam's count, mu, nu, all numpy) and after it
    (the port's state dict of the variables, loss, histogram, and the
    square root of Adam's bias-corrected second moment in the port's
    layout)."""
    runs = {}
    for decoder in (False, True):
        x, y = _batch(decoder)
        model = _jax_model(decoder)
        v = model.init(jax.random.key(1), jnp.asarray(x[:1]), train=True)
        trainer = JaxTrainer(_args())
        trainer.class_weights = jnp.asarray(CLASS_WEIGHTS)
        tx = trainer.build_optimizer()
        step = trainer._get_step(model, tx, x.shape, True)
        p, bs, opt = v["params"], v["batch_stats"], tx.init(v["params"])
        steps = []
        for _ in range(STEPS):
            before = jax.tree.map(np.asarray, (
                {"params": p, "batch_stats": bs}, _adam(opt)))
            p, bs, opt, loss, hist = step(p, bs, opt, jnp.asarray(x),
                                          jnp.asarray(y),
                                          jnp.ones((2,), bool))
            after = jax.tree.map(np.asarray,
                                 {"params": p, "batch_stats": bs})
            count, _, nu = _adam(opt)
            root_v = jax.tree.map(
                lambda n: np.sqrt(np.asarray(n) / (1 - 0.999 ** count)), nu)
            steps.append((before, (
                state_dict_from_flax(after), float(loss), np.asarray(hist),
                state_dict_from_flax({"params": root_v,
                                      "batch_stats": after["batch_stats"]}))))
        runs[decoder] = (x, y, steps)
    return runs


def _port_model(variables, decoder: bool):
    cls = port_espnet.ESPNet if decoder else port_espnet.ESPNetEncoder
    model = cls(5, 1, 2)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return use_flax_batch_norm(model)


def _carry_adam(model, optimizer, variables, adam) -> None:
    """Set torch Adam's per-parameter state from the JAX (count, mu, nu)."""
    count, mu, nu = adam
    if count == 0:
        return
    stats = variables["batch_stats"]
    mu = state_dict_from_flax({"params": mu, "batch_stats": stats})
    nu = state_dict_from_flax({"params": nu, "batch_stats": stats})
    for key, param in model.named_parameters():
        optimizer.state[param] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[key].clone(), "exp_avg_sq": nu[key].clone()}


def _port_trainer(bf16=False):
    trainer = PortTrainer(Namespace(**vars(_args()), bf16=bf16),
                          device="cpu")
    trainer.class_weights = torch.from_numpy(CLASS_WEIGHTS)
    return trainer


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("decoder", [False, True],
                         ids=["encoder", "decoder"])
def test_two_f32_steps_match_jax(jax_runs, decoder):
    x, y, steps = jax_runs[decoder]
    masked = total = 0
    for step, ((variables, adam), (want, want_loss, want_hist, root_v)) \
            in enumerate(steps):
        model = _port_model(variables, decoder)
        trainer = _port_trainer()
        optimizer = trainer.build_optimizer(model)
        _carry_adam(model, optimizer, variables, adam)
        loss, hist = trainer.train_step(model, optimizer, _nchw(x),
                                        torch.from_numpy(y))
        assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
        assert hist.dtype == torch.int32
        assert np.array_equal(hist.numpy(), want_hist), step
        got = model.state_dict()
        assert got.keys() == want.keys()
        for key, w in want.items():
            g = got[key].numpy()
            w = w.numpy()
            if key.endswith("num_batches_tracked"):
                assert g == w == 0
            elif key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g, w, rtol=0, atol=STATS_ATOL,
                                           err_msg=f"{key} step {step}")
            else:
                ok = root_v[key].numpy() >= ILL_CONDITIONED
                np.testing.assert_allclose(g[ok], w[ok], rtol=0,
                                           atol=PARAM_ATOL,
                                           err_msg=f"{key} step {step}")
                assert np.all(np.abs(g[~ok] - w[~ok]) <= 2 * LR), key
                masked += int((~ok).sum())
                total += ok.size
    assert masked <= 0.02 * total, (masked, total)


def test_bf16_step_matches_f32(jax_runs):
    """--bf16 autocasts the forward only: the loss within 5e-2 of the
    float32 step's (JAX's and the port's); parameters, gradients, Adam
    state and BN statistics stay float32."""
    x, y, steps = jax_runs[True]
    (variables, _), (_, want, _, _) = steps[0]
    losses = {}
    for bf16 in (False, True):
        model = _port_model(variables, True)
        trainer = _port_trainer(bf16)
        optimizer = trainer.build_optimizer(model)
        loss, _ = trainer.train_step(model, optimizer, _nchw(x),
                                     torch.from_numpy(y))
        losses[bf16] = float(loss)
        assert all(t.dtype == torch.float32 for k, t in
                   model.state_dict().items()
                   if not k.endswith("num_batches_tracked"))
        assert all(p.grad.dtype == torch.float32
                   for p in model.parameters())
        assert all(s.dtype == torch.float32 for st in
                   optimizer.state.values() for k, s in st.items()
                   if k != "step")
    assert abs(losses[True] - want) <= BF16_RTOL * want
    assert abs(losses[True] - losses[False]) <= BF16_RTOL * losses[False]
    assert losses[True] != losses[False]      # the forward ran in bf16
