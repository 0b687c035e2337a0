"""The port's training pieces against the JAX package's on the CPU:
``train/criteria.py`` ``cross_entropy_2d`` (with and without class
weights and ``valid``, within 1e-6 relative), the BN running-statistics
rule of ``train/batch_norm.py`` against Flax's ``nn.BatchNorm`` (and
torch's own unbiased update shown to miss it), the ESPNet trainer's Adam
with coupled weight decay against the JAX trainer's optax chain on equal
gradients (1e-7 absolute over three steps), the ``--weight_decay`` flag,
and the refused flags and devices."""
from argparse import Namespace

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glomeruli_segmentation_tpu.train import criteria as jax_criteria
from glomeruli_segmentation_tpu.train.espnet_train import (
    EspnetTrainer as JaxTrainer,
)
from glomeruli_segmentation_tpu_torch.cli import segformer_train as port_seg_cli
from glomeruli_segmentation_tpu_torch.cli import train as port_cli
from glomeruli_segmentation_tpu_torch.train import criteria as port_criteria
from glomeruli_segmentation_tpu_torch.train.batch_norm import (
    FlaxBatchNorm2d,
    use_flax_batch_norm,
)
from glomeruli_segmentation_tpu_torch.train.espnet_train import (
    EspnetTrainer as PortTrainer,
)

CE_RTOL = 1e-6
BN_ATOL = 1e-6
ADAM_ATOL = 1e-7


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("valid", [None, (True, False, True)])
def test_cross_entropy_2d_matches_jax(weights, valid):
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 5, 6, 7).astype(np.float32) * 3
    labels = rng.randint(0, 5, (3, 6, 7))
    w = rng.uniform(0.5, 9, 5).astype(np.float32) if weights else None
    v = None if valid is None else np.asarray(valid)
    want = float(jax_criteria.cross_entropy_2d(
        jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(labels),
        None if w is None else jnp.asarray(w),
        None if v is None else jnp.asarray(v)))
    for dtype in (torch.int64, torch.int32):
        got = port_criteria.cross_entropy_2d(
            torch.from_numpy(logits), torch.from_numpy(labels).to(dtype),
            None if w is None else torch.from_numpy(w),
            None if v is None else torch.from_numpy(v))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= CE_RTOL * abs(want)
    if valid is not None:
        # the masked loss equals the loss of the valid samples alone
        keep = np.flatnonzero(v)
        alone = port_criteria.cross_entropy_2d(
            torch.from_numpy(logits[keep]), torch.from_numpy(labels[keep]),
            None if w is None else torch.from_numpy(w))
        assert abs(float(alone) - want) <= CE_RTOL * abs(want)
    # bf16 logits reduce in float32
    half = port_criteria.cross_entropy_2d(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert half.dtype == torch.float32


def _flax_bn_update(x_nhwc, mean, var):
    """One training-mode call of Flax's nn.BatchNorm (momentum 0.9, eps
    1e-3, as the JAX ESPNet's) from the given running statistics: (output
    NHWC, new mean, new var)."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-3)
    c = x_nhwc.shape[-1]
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, c),
                            "bias": jnp.linspace(-0.2, 0.2, c)},
                 "batch_stats": {"mean": jnp.asarray(mean),
                                 "var": jnp.asarray(var)}}
    y, upd = bn.apply(variables, jnp.asarray(x_nhwc),
                      mutable=["batch_stats"])
    return (np.asarray(y), np.asarray(upd["batch_stats"]["mean"]),
            np.asarray(upd["batch_stats"]["var"]))


@pytest.mark.parametrize("shape", [(2, 4, 4, 3), (3, 7, 5, 8)])
def test_batch_norm_update_is_flax_biased_rule(shape):
    """Training mode: the output and the running statistics equal Flax's
    (``ra = 0.9 ra + 0.1 var`` with the biased variance) within 1e-6;
    torch's own BatchNorm2d (unbiased update) misses by more.  Evaluation
    mode and the state-dict keys are torch's."""
    rng = np.random.RandomState(1)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    mean0 = rng.randn(c).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    y_want, mean_want, var_want = _flax_bn_update(x, mean0, var0)

    def module(cls):
        bn = cls(c, eps=1e-3)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, c))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        return bn

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    flax_rule = use_flax_batch_norm(torch.nn.Sequential(
        module(torch.nn.BatchNorm2d)))[0]
    assert type(flax_rule) is FlaxBatchNorm2d
    y = flax_rule.train()(xt).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(y, y_want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(flax_rule.running_mean.numpy(), mean_want,
                               rtol=0, atol=BN_ATOL)
    np.testing.assert_allclose(flax_rule.running_var.numpy(), var_want,
                               rtol=0, atol=BN_ATOL)
    assert int(flax_rule.num_batches_tracked) == 0

    torch_rule = module(torch.nn.BatchNorm2d).train()
    torch_rule(xt)
    np.testing.assert_allclose(torch_rule.running_mean.numpy(), mean_want,
                               rtol=0, atol=BN_ATOL)
    assert np.abs(torch_rule.running_var.numpy() - var_want).max() > 10 * BN_ATOL

    ref = module(torch.nn.BatchNorm2d).eval()
    flax_rule.eval()
    with torch.no_grad():
        flax_rule.running_mean.copy_(ref.running_mean)
        flax_rule.running_var.copy_(ref.running_var)
    assert torch.equal(flax_rule(xt), ref(xt))
    assert flax_rule.state_dict().keys() == ref.state_dict().keys()


def test_adam_with_coupled_decay_matches_jax_chain():
    """Equal gradients through both trainers' optimizers (torch Adam with
    ``weight_decay`` against optax's add_decayed_weights + adam), three
    steps, the lr changed between them as the epoch schedule does."""
    rng = np.random.RandomState(2)
    p0 = rng.randn(40).astype(np.float32)
    grads = [rng.randn(40).astype(np.float32) * 10.0 ** -k
             for k in (1, 3, 5)]
    args = Namespace(lr=5e-4, step_loss=1, weight_decay=5e-4,
                     data_parallel=0)
    jt = JaxTrainer(args)
    tx = jt.build_optimizer()
    params = {"w": jnp.asarray(p0)}
    state = tx.init(params)
    pt = PortTrainer(args, device="cpu")
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = torch.nn.Module()
    model.w = w
    opt = pt.build_optimizer(model)
    for epoch, g in enumerate(grads):
        lr = pt.lr_at(epoch)
        assert lr == jt._lr_schedule(epoch) == 5e-4 * 0.5 ** epoch
        state.hyperparams["learning_rate"] = np.asarray(lr, np.float32)
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = {"w": params["w"] + upd["w"]}
        for group in opt.param_groups:
            group["lr"] = lr
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(),
                                   np.asarray(params["w"]), rtol=0,
                                   atol=ADAM_ATOL)


def test_weight_decay_flag_plumbs_through():
    """--weight_decay reaches the optimizer (as the JAX package's test of
    the same name): zero gradients, the coupled decay alone moves the
    weights (of 0.01, so that Adam's first update, lr * g / (|g| + eps),
    tells 5e-4 from 0.25 in float32)."""
    assert port_cli.build_parser().parse_args(
        ["--weight_decay", "0.25"]).weight_decay == 0.25
    assert port_cli.build_parser().parse_args([]).weight_decay == 5e-4

    def one_update(wd):
        w = torch.nn.Parameter(torch.full((4,), 0.01))
        model = torch.nn.Module()
        model.w = w
        opt = PortTrainer(Namespace(lr=1e-3, weight_decay=wd),
                          device="cpu").build_optimizer(model)
        w.grad = torch.zeros(4)
        opt.step()
        return w.detach() - 0.01

    assert float(one_update(0.0).abs().max()) == 0.0
    assert float(one_update(5e-4).abs().max()) > 0.0
    assert not torch.allclose(one_update(5e-4), one_update(0.25))


def test_parsers_match_jax_and_refuse_unported():
    """Every JAX flag under the same name and default, plus --device
    (default cuda); the multi-card flags raise naming themselves."""
    from glomeruli_segmentation_tpu.cli import segformer_train as jax_seg
    from glomeruli_segmentation_tpu.cli import train as jax_cli

    base = ["--site", "01_Todai", "--data_root", "d", "--data_date", "x",
            "--model_root", "m"]
    for jax_mod, port_mod, argv in ((jax_cli, port_cli, []),
                                    (jax_seg, port_seg_cli, base)):
        want = vars(jax_mod.build_parser().parse_args(argv))
        got = vars(port_mod.build_parser().parse_args(argv))
        assert got.pop("device") == "cuda"
        assert got == want
    for flag in (["--data_parallel", "2"], ["--coordinator", "h:1"],
                 ["--num_processes", "2"], ["--process_id", "1"]):
        with pytest.raises(SystemExit, match="not ported: " + flag[0]):
            port_cli.main(flag + ["--device", "cpu"])
        with pytest.raises(SystemExit, match="not ported: " + flag[0]):
            port_seg_cli.main(base + flag + ["--device", "cpu"])


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortTrainer(port_cli.build_parser().parse_args([]))
    from glomeruli_segmentation_tpu_torch.train import segformer_train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        segformer_train.train_segformer(port_seg_cli.build_parser()
                                        .parse_args([
                                            "--site", "01_Todai",
                                            "--data_root", "d",
                                            "--data_date", "x",
                                            "--model_root", "m"]))
