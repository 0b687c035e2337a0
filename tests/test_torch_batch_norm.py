"""The port's training-mode BatchNorm against Flax's ``nn.BatchNorm``.

``train/batch_norm.py`` ``FlaxBatchNorm2d`` takes the batch variance in
two passes (``torch.var_mean``); Flax's default is one pass, ``E[x^2] -
E[x]^2`` in float32 (``use_fast_variance=True``).  On a channel whose
mean is large against its spread the one-pass variance loses digits to
cancellation: at mean 1000, sd 10 over (2, 128, 128, 16) Flax's batch
variance lies ~8e-3 from the float64 one, the port's ~4e-8.  That is what
parts the JAX package's float32 detector step from the recipe's float64
arithmetic at the first update (``test_torch_learning.py``
``test_detector_steps_follow_the_recipes_float64_arithmetic``).
Here, for the detector's BN (Flax momentum 0.997, eps 1e-5) and ESPNet's
(0.9, 1e-3), on inputs at mean 1000, sd 10 and at mean 0, sd 1:

(a) the port's batch and running variance lie within 1e-5 of float64,
relative;
(b) Flax with the two-pass variance gives the port's output, running
statistics and gradients (x, scale, bias) within float32 rounding;
(c) at mean 1000 Flax's default departs from float64 by more than 100
times the port's error; at mean 0 all three agree within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from glomeruli_segmentation_tpu_torch.train.batch_norm import FlaxBatchNorm2d
from torch_flax_variance import flax_two_pass_variance

SHAPE = (2, 128, 128, 16)  # NHWC, the detector's first layer's width
RECIPES = {"detector": (0.997, 1e-5), "espnet": (0.9, 1e-3)}
INPUTS = {"mean 1000 sd 10": (1000.0, 10.0), "mean 0 sd 1": (0.0, 1.0)}
# float32 against float32, two orders of operations.  The normalised
# output carries the input's own rounding, an ulp of max|x| times
# scale / sd (1.8e-5 at mean 1000, sd 10; 8e-7 at mean 0): within 4 of
# those (measured: 1.8), and the running statistics within 1e-5 of their
# largest (measured: 1.4e-6).  Each gradient within 1e-4 relative of its largest
# element (measured: the scale's 1.8e-5 at mean 1000, the rest < 1e-6)
OUT_ULPS, STATS_RTOL, GRAD_RTOL = 4, 1e-5, 1e-4


def _case(inputs, seed=0):
    """x (NHWC, float32), the per-channel scale and bias, and the cotangent
    ``g`` of the output, from a numpy seed."""
    mean, sd = INPUTS[inputs]
    rng = np.random.default_rng(seed)
    x = (mean + sd * rng.standard_normal(SHAPE)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, SHAPE[-1]).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, SHAPE[-1]).astype(np.float32)
    g = rng.standard_normal(SHAPE).astype(np.float32)
    return x, scale, bias, g


def _float64_stats(x):
    x64 = x.astype(np.float64)
    return x64.mean((0, 1, 2)), x64.var((0, 1, 2))


def _flax(x, scale, bias, g, momentum, eps, fast=True):
    """Flax's BatchNorm in train mode from zero running statistics: its
    output, the batch mean and variance it took (the running ones over
    ``1 - momentum``), the running statistics and the gradients of
    ``sum(out * g)`` for x, scale and bias."""
    bn = nn.BatchNorm(use_running_average=False, momentum=momentum,
                      epsilon=eps, use_fast_variance=fast)
    c = x.shape[-1]
    stats = {"mean": jnp.zeros(c), "var": jnp.zeros(c)}

    def loss(x, scale, bias):
        out, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                             "batch_stats": stats}, x,
                            mutable=["batch_stats"])
        return jnp.sum(out * g), (out, upd["batch_stats"])

    grads, (out, upd) = jax.grad(loss, (0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    running = {k: np.asarray(v, np.float64) for k, v in upd.items()}
    return {"out": np.asarray(out),
            "batch": {k: v / (1 - momentum) for k, v in running.items()},
            "running": {k: np.asarray(v, np.float32)
                        for k, v in running.items()},
            "grads": [np.asarray(t) for t in grads]}


def _port(x, scale, bias, g, momentum, eps):
    """The port's FlaxBatchNorm2d in train mode from zero running
    statistics, on x in NCHW: as :func:`_flax`, back in NHWC."""
    m = 1 - momentum
    bn = FlaxBatchNorm2d(x.shape[-1], eps=eps, momentum=m)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.zero_()
        bn.running_var.zero_()
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    xt.requires_grad_(True)
    out = bn(xt)
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    running = {"mean": bn.running_mean.double().numpy(),
               "var": bn.running_var.double().numpy()}
    return {"out": out.detach().permute(0, 2, 3, 1).numpy(),
            "batch": {k: v / m for k, v in running.items()},
            "running": {k: v.astype(np.float32) for k, v in running.items()},
            "grads": [xt.grad.permute(0, 2, 3, 1).numpy(),
                      bn.weight.grad.numpy(), bn.bias.grad.numpy()]}


def _var_error(run, x):
    """The largest relative distance of ``run``'s batch variance from the
    float64 one, over the channels."""
    _, var = _float64_stats(x)
    return float(np.max(np.abs(run["batch"]["var"] - var) / var))


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("recipe", RECIPES)
def test_port_variance_is_float64s(recipe, inputs):
    """(a) The port's batch variance, and its running variance after one
    step from the start the trainers give it (mean 0, variance 1), within
    1e-5 of float64, relative."""
    momentum, eps = RECIPES[recipe]
    x, scale, bias, g = _case(inputs)
    assert _var_error(_port(x, scale, bias, g, momentum, eps), x) <= 1e-5
    mean, var = _float64_stats(x)
    bn = FlaxBatchNorm2d(SHAPE[-1], eps=eps, momentum=1 - momentum).train()
    bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    want_var = momentum + (1 - momentum) * var
    want_mean = (1 - momentum) * mean
    np.testing.assert_allclose(bn.running_var.double().numpy(), want_var,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.double().numpy(), want_mean,
                               rtol=1e-5, atol=1e-5 * np.abs(want_mean).max())


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("recipe", RECIPES)
def test_flax_two_pass_gives_the_ports_step(recipe, inputs):
    """(b) Flax's BatchNorm with the two-pass variance against the port's
    layer: the output within ``OUT_ULPS`` of the input's resolution, the
    running statistics within ``STATS_RTOL``, the gradients of x, scale
    and bias within ``GRAD_RTOL`` of their largest element."""
    momentum, eps = RECIPES[recipe]
    args = _case(inputs)
    x, scale = args[:2]
    flax = _flax(*args, momentum, eps, fast=False)
    port = _port(*args, momentum, eps)
    _, var = _float64_stats(x)
    resolution = (np.finfo(np.float32).eps * np.abs(x).max() * scale.max()
                  / np.sqrt(var.min()))
    np.testing.assert_allclose(port["out"], flax["out"], rtol=0,
                               atol=OUT_ULPS * resolution)
    for k in ("mean", "var"):
        want = flax["running"][k]
        np.testing.assert_allclose(port["running"][k], want,
                                   rtol=STATS_RTOL,
                                   atol=STATS_RTOL * np.abs(want).max(),
                                   err_msg=k)
    for name, a, b in zip(("x", "scale", "bias"), port["grads"],
                          flax["grads"]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=GRAD_RTOL * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("inputs", INPUTS)
@pytest.mark.parametrize("recipe", RECIPES)
def test_flax_one_pass_variance_departs_where_the_mean_is_large(recipe,
                                                                 inputs):
    """(c) At mean 1000, sd 10 Flax's default (one-pass) batch variance
    lies more than 100 times the port's distance from float64; at mean 0,
    sd 1 Flax's default, Flax's two-pass and the port's all lie within
    1e-5 of it."""
    momentum, eps = RECIPES[recipe]
    args = _case(inputs)
    x = args[0]
    errors = {"flax": _var_error(_flax(*args, momentum, eps), x),
              "flax two-pass": _var_error(
                  _flax(*args, momentum, eps, fast=False), x),
              "port": _var_error(_port(*args, momentum, eps), x)}
    print(f"\n{recipe}, {inputs}: batch variance's relative error {errors}")
    if INPUTS[inputs][0] == 0.0:
        assert max(errors.values()) <= 1e-5, errors
    else:
        assert errors["flax"] > 100 * errors["port"], errors
        assert errors["flax two-pass"] <= 1e-5, errors


def test_two_pass_context_gives_flaxs_own_two_pass_and_restores():
    """Inside ``flax_two_pass_variance`` a default ``nn.BatchNorm`` gives
    ``use_fast_variance=False``'s output and statistics bit for bit; after
    it, the default's again."""
    from flax.linen import normalization

    args = _case("mean 1000 sd 10")
    before = normalization._compute_stats
    momentum, eps = RECIPES["detector"]
    default = _flax(*args, momentum, eps)
    with flax_two_pass_variance():
        inside = _flax(*args, momentum, eps)
    after = _flax(*args, momentum, eps)
    two_pass = _flax(*args, momentum, eps, fast=False)
    assert normalization._compute_stats is before
    for got, want in ((inside, two_pass), (after, default)):
        np.testing.assert_array_equal(got["out"], want["out"])
        for k in ("mean", "var"):
            np.testing.assert_array_equal(got["running"][k],
                                          want["running"][k])
    assert not np.array_equal(default["running"]["var"],
                              two_pass["running"]["var"])
