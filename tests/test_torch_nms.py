"""The port's NMS (plain version, the CPU path of the K3 wrapper) against the
JAX package's ``lax.scan`` NMS and its Pallas kernel in interpret mode.
Indices and counts must be equal: the result is an integer choice."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from glomeruli_segmentation_tpu.ops.nms import gather_padded as jax_gather
from glomeruli_segmentation_tpu.ops.nms import nms as jax_nms
from glomeruli_segmentation_tpu.ops.pallas.nms_pallas import nms_pallas
from glomeruli_segmentation_tpu_torch.ops import nms as torch_nms


def _problems(seed, p, n, ties=False):
    """P overlapping box sets in a 1100-px window, scores in [0, 1); with
    ``ties`` every score is one of four values."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 1100, (p, n, 2))
    sizes = rng.uniform(20, 400, (p, n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2],
                           -1).astype(np.float32)
    scores = rng.uniform(0, 1, (p, n)).astype(np.float32)
    if ties:
        scores = np.round(scores * 3) / 3
    return boxes, scores.astype(np.float32)


def _jax_nms_batched(boxes, scores, k, thr, score_threshold=float("-inf")):
    out = [jax_nms(jnp.asarray(b), jnp.asarray(s), k, thr, score_threshold)
           for b, s in zip(boxes, scores)]
    return (np.stack([np.asarray(i) for i, _ in out]),
            np.asarray([int(v) for _, v in out]))


def _port(boxes, scores, k, thr, score_threshold=float("-inf")):
    before = torch_nms.nms.launches
    idx, num = torch_nms.nms(torch.from_numpy(boxes),
                             torch.from_numpy(scores), k, thr,
                             score_threshold)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert torch_nms.nms.launches == before
    assert idx.dtype == torch.int32 and num.dtype == torch.int32
    return idx.numpy(), num.numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n,k,thr", [
    (8, 5, 0.5),        # fewer outputs than boxes
    (8, 12, 0.5),       # fewer live boxes than k: -1 padding
    (200, 100, 0.6),    # the second stage's k
    (2000, 300, 0.7),   # the RPN stage's shape
])
def test_nms_plain_matches_jax_scan(seed, n, k, thr):
    boxes, scores = _problems(seed, 3, n)
    want_idx, want_num = _jax_nms_batched(boxes, scores, k, thr)
    idx, num = _port(boxes, scores, k, thr)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(num, want_num)


@pytest.mark.parametrize("score_threshold", [0.0, 0.5, 0.95])
def test_nms_score_threshold_matches_jax(score_threshold):
    boxes, scores = _problems(5, 2, 200)
    scores[:, :20] = 0.0  # exactly at the threshold 0: masked
    want_idx, want_num = _jax_nms_batched(boxes, scores, 100, 0.6,
                                          score_threshold)
    idx, num = _port(boxes, scores, 100, 0.6, score_threshold)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(num, want_num)


@pytest.mark.parametrize("n,k", [(200, 100), (2000, 300)])
def test_nms_ties_take_the_lowest_index(n, k):
    boxes, scores = _problems(7, 2, n, ties=True)
    want_idx, want_num = _jax_nms_batched(boxes, scores, k, 0.7)
    idx, num = _port(boxes, scores, k, 0.7)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(num, want_num)
    # among equal scores, the winners come out in increasing index order
    first = idx[0][idx[0] >= 0]
    s = scores[0][first]
    for v in np.unique(s):
        picked = first[s == v]
        assert (np.diff(picked) > 0).all()


def test_nms_all_boxes_suppressed_by_the_first():
    """One box covers all: the first winner suppresses every other box, the
    rest of the output is -1."""
    boxes = np.tile(np.asarray([[10, 10, 110, 110]], np.float32), (2, 50, 1))
    boxes[:, :, 2:] += np.linspace(0, 1, 50, dtype=np.float32)[None, :, None]
    scores = np.random.RandomState(0).uniform(0, 1, (2, 50)).astype(
        np.float32)
    want_idx, want_num = _jax_nms_batched(boxes, scores, 10, 0.5)
    idx, num = _port(boxes, scores, 10, 0.5)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(num, [1, 1])
    assert (idx[:, 1:] == -1).all()


def test_nms_no_live_box():
    boxes, scores = _problems(2, 2, 30)
    idx, num = _port(boxes, scores, 8, 0.5, score_threshold=1.0)
    assert (idx == -1).all() and (num == 0).all()
    want_idx, _ = _jax_nms_batched(boxes, scores, 8, 0.5, 1.0)
    np.testing.assert_array_equal(idx, want_idx)


@pytest.mark.parametrize("seed,n,k,thr", [
    (1, 120, 128, 0.5), (2, 300, 100, 0.6), (3, 2000, 300, 0.7),
])
def test_nms_plain_matches_pallas_interpret(seed, n, k, thr):
    """The port's plain version against the Pallas kernel K3 replaces,
    with pre-masked scores (the kernel's contract)."""
    boxes, scores = _problems(seed, 1, n, ties=seed == 2)
    want_idx, want_num = nms_pallas(jnp.asarray(boxes[0]),
                                    jnp.asarray(scores[0]), k, thr,
                                    interpret=True)
    idx, num = torch_nms.nms_plain(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), k, thr)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(want_idx))
    assert int(num[0]) == int(want_num)


def test_nms_unbatched_and_bad_shapes():
    boxes, scores = _problems(4, 1, 40)
    idx, num = torch_nms.nms(torch.from_numpy(boxes[0]),
                             torch.from_numpy(scores[0]), 10, 0.5)
    assert idx.shape == (10,) and num.shape == ()
    want_idx, want_num = jax_nms(jnp.asarray(boxes[0]),
                                 jnp.asarray(scores[0]), 10, 0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(num) == int(want_num)
    with pytest.raises(ValueError):
        torch_nms.nms(torch.zeros(2, 5, 3), torch.zeros(2, 5), 3)
    with pytest.raises(ValueError):
        torch_nms.nms(torch.zeros(2, 5, 4), torch.zeros(2, 4), 3)


@pytest.mark.parametrize("trailing", [(4,), ()])
def test_gather_padded_matches_jax(trailing):
    rng = np.random.RandomState(0)
    values = rng.randn(3, 20, *trailing).astype(np.float32)
    indices = rng.randint(0, 20, (3, 7)).astype(np.int32)
    indices[:, 4:] = -1
    indices[1] = -1
    got = torch_nms.gather_padded(torch.from_numpy(values),
                                  torch.from_numpy(indices), -7.0)
    want = np.stack([np.asarray(jax_gather(jnp.asarray(v), jnp.asarray(i),
                                           -7.0))
                     for v, i in zip(values, indices)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_kernel_build_is_one_of_the_port_sources():
    from glomeruli_segmentation_tpu_torch.ops import _build

    assert "nms" in _build.SOURCES
    assert (_build.CSRC / "nms.cu").is_file()
    assert _build.library_path("nms").name.startswith("nms-")

