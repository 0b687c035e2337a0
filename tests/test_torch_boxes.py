"""The port's box utilities against the JAX package's, on the same seeded
numpy inputs, in float32."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glomeruli_segmentation_tpu.ops import boxes as jax_boxes
from glomeruli_segmentation_tpu_torch.ops import boxes as torch_boxes


def _random_boxes(rng, n, lo=0.0, hi=500.0):
    centers = rng.uniform(lo, hi, (n, 2))
    sizes = rng.uniform(1, 120, (n, 2))
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          -1).astype(np.float32)


@pytest.mark.parametrize("feat,stride,scales,aspects,base", [
    ((69, 69), 16, (0.25, 0.5, 1.0, 2.0), (0.5, 1.0, 2.0), 256.0),
    ((8, 5), 16, (0.25, 0.5), (1.0,), 128.0),
    ((3, 7), 8, (1.0,), (0.5, 2.0), 64.0),
])
def test_generate_anchors_matches_jax(feat, stride, scales, aspects, base):
    want = np.asarray(jax_boxes.generate_anchors(*feat, stride, scales,
                                                 aspects, base))
    got = torch_boxes.generate_anchors(*feat, stride, scales, aspects, base)
    assert got.dtype == torch.float32
    # the same numpy code: bit-equal, including the cell-major order
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_and_clip_match_jax(seed):
    rng = np.random.RandomState(seed)
    anchors = _random_boxes(rng, 500)
    deltas = (rng.randn(500, 4) * 3).astype(np.float32)
    deltas[:5, 2:] = 40.0  # beyond BBOX_XFORM_CLIP: the clamp must bite
    want = np.asarray(jax_boxes.clip_boxes(
        jax_boxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)),
        400, 300))
    got = torch_boxes.clip_boxes(torch_boxes.decode_boxes(
        torch.from_numpy(deltas), torch.from_numpy(anchors)), 400, 300)
    # the same arithmetic; exp may differ by one float32 ulp between XLA's
    # CPU kernel and PyTorch's, so 1e-6 relative (+1e-4 px near zero)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 3])
def test_iou_and_area_match_jax(seed):
    rng = np.random.RandomState(seed)
    a = _random_boxes(rng, 60)
    b = _random_boxes(rng, 45)
    b[0] = b[1] = [5, 5, 5, 9]  # zero-area boxes: union 0 -> IoU 0
    want = np.asarray(jax_boxes.boxes_iou(jnp.asarray(a), jnp.asarray(b)))
    got = torch_boxes.boxes_iou(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        torch_boxes.boxes_area(torch.from_numpy(a)).numpy(),
        np.asarray(jax_boxes.boxes_area(jnp.asarray(a))), rtol=1e-6)
