"""The port's ``crop_and_resize`` (a gather) against both JAX formulations:
the gather form and the two-tap matmul form the JAX detector uses."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glomeruli_segmentation_tpu.ops import roi_align as jax_roi
from glomeruli_segmentation_tpu_torch.ops.roi_align import crop_and_resize


def _inputs(seed, b, h, w, c, n):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, h, w, c).astype(np.float32)
    y = np.sort(rng.uniform(-0.1, 1.1, (b, n, 2)), axis=-1)
    x = np.sort(rng.uniform(-0.1, 1.1, (b, n, 2)), axis=-1)
    boxes = np.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]],
                     -1).astype(np.float32)
    boxes[:, 0] = [0.0, 0.0, 1.0, 1.0]      # the whole map
    boxes[:, 1] = [0.5, 0.25, 0.5, 0.25]    # a single point
    return feats, boxes


@pytest.mark.parametrize("seed,b,h,w,c,n,s", [
    (0, 2, 8, 8, 16, 10, 14),     # the tiny detector's map, crop 14
    (1, 1, 13, 9, 8, 30, 7),      # non-square map
    (2, 3, 5, 6, 4, 70, 8),       # more boxes than the JAX chunk of 64
])
def test_crop_and_resize_matches_both_jax_forms(seed, b, h, w, c, n, s):
    feats, boxes = _inputs(seed, b, h, w, c, n)
    got = crop_and_resize(torch.from_numpy(feats), torch.from_numpy(boxes),
                          s).numpy()
    assert got.shape == (b, n, s, s, c)
    for i in range(b):
        gather = np.asarray(jax_roi.crop_and_resize(
            jnp.asarray(feats[i]), jnp.asarray(boxes[i]), s))
        matmul = np.asarray(jax_roi.crop_and_resize_matmul(
            jnp.asarray(feats[i]), jnp.asarray(boxes[i]), s,
            precision="highest"))
        # two bilinear taps per axis in float32; the forms round the sums
        # at different points (and XLA may fuse a multiply-add)
        np.testing.assert_allclose(got[i], gather, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[i], matmul, atol=1e-5, rtol=1e-5)


def test_crop_and_resize_keeps_the_feature_type():
    feats, boxes = _inputs(3, 1, 6, 6, 4, 5)
    got = crop_and_resize(torch.from_numpy(feats).bfloat16(),
                          torch.from_numpy(boxes), 4)
    assert got.dtype == torch.bfloat16
    want = crop_and_resize(torch.from_numpy(feats), torch.from_numpy(boxes),
                           4)
    # bf16 operands and weights: a few bf16 roundings (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=5e-2, rtol=2e-2)
