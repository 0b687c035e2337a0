"""The port's ResNet modules against the Flax ones, with the weights carried
across by ``state_dict_from_flax`` and BN folded at load time."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from glomeruli_segmentation_tpu.models import resnet as jax_resnet
from glomeruli_segmentation_tpu_torch.convert.detector_import import (
    state_dict_from_flax,
)
from glomeruli_segmentation_tpu_torch.models import resnet as torch_resnet


def _variables(module, x, seed):
    """Flax variables with random BN statistics (not the identity)."""
    rng = np.random.RandomState(seed)
    variables = module.init(jax.random.key(seed), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(
        lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32)
        if path[-1].key == "scale" else a, params)
    return {"params": params, "batch_stats": stats}


def _compare(flax_module, torch_module, x, seed):
    """Both modules on the same NHWC input; returns (port, jax) NHWC."""
    variables = _variables(flax_module, x, seed)
    want = np.asarray(flax_module.apply(variables, jnp.asarray(x)))
    state = state_dict_from_flax(variables)
    torch_module.load_state_dict(torch_resnet.fold_batchnorm(state),
                                 strict=True)
    torch_module.eval()
    with torch.no_grad():
        got = torch_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


def _close(got, want):
    # f32 convs summed in another order, BN folded into the weights
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-4 + 1e-4 * np.abs(want))


@pytest.mark.parametrize("seed,size", [(0, 64), (1, 48)])
def test_resnet_c4_matches_flax(seed, size):
    x = np.random.RandomState(seed).randn(2, size, size, 3).astype(
        np.float32)
    got, want = _compare(jax_resnet.ResNetC4(depths=(1, 1, 1), width=8),
                         torch_resnet.ResNetC4(depths=(1, 1, 1), width=8),
                         x, seed)
    assert got.shape == (2, size // 16, size // 16, 128)
    _close(got, want)


def test_resnet_c4_two_blocks_per_stage_matches_flax():
    x = np.random.RandomState(5).randn(1, 32, 32, 3).astype(np.float32)
    got, want = _compare(jax_resnet.ResNetC4(depths=(2, 1, 2), width=4),
                         torch_resnet.ResNetC4(depths=(2, 1, 2), width=4),
                         x, 5)
    _close(got, want)


@pytest.mark.parametrize("blocks", [1, 3])
def test_resnet_block4_matches_flax(blocks):
    x = np.random.RandomState(blocks).randn(3, 14, 14, 128).astype(
        np.float32)
    got, want = _compare(jax_resnet.ResNetBlock4(blocks=blocks, width=8),
                         torch_resnet.ResNetBlock4(128, blocks=blocks,
                                                   width=8), x, blocks)
    assert got.shape == (3, 7, 7, 256)
    _close(got, want)


def test_tiny_backbone_and_head_match_flax():
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    got, want = _compare(jax_resnet.TinyBackbone(),
                         torch_resnet.TinyBackbone(), x, 2)
    _close(got, want)
    x = np.random.RandomState(3).randn(4, 8, 8, 128).astype(np.float32)
    got, want = _compare(jax_resnet.TinyHead(), torch_resnet.TinyHead(128),
                         x, 3)
    _close(got, want)


def test_fold_batchnorm_is_the_bn_affine():
    rng = np.random.RandomState(0)
    state = {"a.conv.weight": torch.from_numpy(
        rng.randn(6, 3, 3, 3).astype(np.float32))}
    for part, lo in (("scale", 0.5), ("bias", -1), ("mean", -1),
                     ("var", 0.5)):
        state[f"a.bn.{part}"] = torch.from_numpy(
            rng.uniform(lo, 1.5, 6).astype(np.float32))
    folded = torch_resnet.fold_batchnorm(state)
    assert set(folded) == {"a.conv.weight", "a.conv.bias"}
    x = torch.from_numpy(rng.randn(2, 3, 9, 9).astype(np.float32))
    y = torch.nn.functional.conv2d(x, state["a.conv.weight"], padding=1)
    bn = (y - state["a.bn.mean"].view(1, -1, 1, 1)) / torch.sqrt(
        state["a.bn.var"].view(1, -1, 1, 1) + 1e-5) \
        * state["a.bn.scale"].view(1, -1, 1, 1) \
        + state["a.bn.bias"].view(1, -1, 1, 1)
    got = torch.nn.functional.conv2d(x, folded["a.conv.weight"],
                                     folded["a.conv.bias"], padding=1)
    np.testing.assert_allclose(got.numpy(), bn.numpy(), atol=1e-5, rtol=1e-5)
