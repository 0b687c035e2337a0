"""The port's inception_v2 (TF-slim semantics) against the JAX package's:
SAME convs, the depthwise conv and both pools at odd sizes where SAME pads
asymmetrically, and both trunks on the tiny-width tree of
``build_od_api_consts``, in float32."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_od_api_import import build_od_api_consts

from glomeruli_segmentation_tpu.convert.pb_import import (
    assemble_od_api_params,
)
from glomeruli_segmentation_tpu.models import inception_v2 as jax_inc
from glomeruli_segmentation_tpu_torch.models import inception_v2 as port_inc


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).numpy()


def _close(got, want, tol=1e-4):
    # f32 products summed in another order
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def tree():
    return assemble_od_api_params(build_od_api_consts(seed=3)[0])[0]


def test_same_pads_put_the_odd_pixel_last():
    assert port_inc.same_pads(600, 7, 2) == (2, 3)
    assert port_inc.same_pads(300, 3, 2) == (0, 1)
    assert port_inc.same_pads(97, 3, 2) == (1, 1)
    assert port_inc.same_pads(66, 3, 1) == (1, 1)
    assert port_inc.same_pads(14, 2, 2) == (0, 0)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (7, 2), (1, 1)])
def test_conv_same_matches_jax(k, stride):
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 66, 97, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32) * 0.3
    b = rng.randn(6).astype(np.float32)
    want = jax_inc.conv_same(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride, relu=False)
    got = port_inc.conv_same(_nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                             torch.from_numpy(b), stride)
    _close(_nhwc(got), want)


@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_same_matches_jax(stride):
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 66, 97, 3).astype(np.float32)
    w = rng.randn(7, 7, 3, 4).astype(np.float32) * 0.2
    want = jax_inc.depthwise_conv_same(jnp.asarray(x), jnp.asarray(w), stride)
    got = port_inc.depthwise_conv_same(_nchw(x), torch.from_numpy(w), stride)
    _close(_nhwc(got), want)
    # output channel ic * M + m is TF's: channel 1 * 4 + 2 is input 1's
    # third filter alone
    one = port_inc.conv_same(_nchw(x[..., 1:2]),
                             torch.from_numpy(w[:, :, 1, 2]).reshape(
                                 1, 1, 7, 7), None, stride)
    _close(_nhwc(got)[..., 6:7], _nhwc(one))


@pytest.mark.parametrize("pool", ["max", "avg"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (2, 2)])
def test_pools_match_jax(pool, k, stride):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 66, 97, 4).astype(np.float32)
    jax_fn = getattr(jax_inc, f"{pool}_pool_same")
    port_fn = getattr(port_inc, f"{pool}_pool_same")
    want = jax_fn(jnp.asarray(x), k, stride)
    got = port_fn(_nchw(x), k, stride)
    _close(_nhwc(got), want, 1e-6)


def test_max_pool_pads_with_minus_infinity():
    x = -torch.ones(1, 1, 4, 4) * 5
    assert port_inc.max_pool_same(x, 3, 2).max().item() == -5


def test_proposal_features_match_jax(tree):
    rng = np.random.RandomState(1)
    img = rng.uniform(-1, 1, (2, 66, 97, 3)).astype(np.float32)
    want = jax_inc.proposal_features(tree["first"], jnp.asarray(img))
    trunk = port_inc.ProposalFeatures(tree["first"])
    port_inc.load_tree(trunk, tree["first"])
    with torch.no_grad():
        got = _nhwc(trunk(_nchw(img)))
    assert got.shape == (2, 5, 7, 36)
    _close(got, want)


def test_classifier_features_match_jax(tree):
    rng = np.random.RandomState(2)
    roi = rng.uniform(-1, 1, (3, 7, 7, 36)).astype(np.float32)
    want = jax_inc.classifier_features(tree["second"], jnp.asarray(roi))
    head = port_inc.ClassifierFeatures(tree["second"])
    port_inc.load_tree(head, tree["second"])
    with torch.no_grad():
        got = _nhwc(head(_nchw(roi)))
    assert got.shape == (3, 4, 4, 64)
    _close(got, want)


def test_modules_follow_the_tree(tree):
    trunk = port_inc.ProposalFeatures(tree["first"])
    names = {n for n, _ in trunk.named_modules()}
    assert "Mixed_3b.Branch_2.Conv2d_0c_3x3" in names
    assert "Mixed_4a.Branch_1.Conv2d_1a_3x3" in names
    assert "Conv2d_1a_7x7.pointwise" in names
    assert trunk.get_submodule("Mixed_4a.Branch_0.Conv2d_1a_3x3").stride \
        == (2, 2)
    # a kernel of the wrong shape is refused
    with pytest.raises(ValueError, match="kernel"):
        trunk.Conv2d_2b_1x1.load({"w": np.zeros((1, 1, 3, 3), np.float32),
                                  "b": np.zeros(3, np.float32)})
