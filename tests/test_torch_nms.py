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



# ---------------- K3's algorithm, mirrored in numpy ----------------
# The card's kernel (csrc/nms.cu) cannot run here.  These tests pin the
# equivalence it relies on: greedy NMS equals a scan of the boxes sorted by
# (score descending, index ascending) over an upper-triangular IoU bitmask,
# walked 64 boxes at a time, stopping at max_outputs or at the first score
# <= NEG_INF / 2.
_ALL = (1 << 64) - 1


def _f32_iou_ge(b, area, i, j, thr):
    """iou(box i, boxes j) >= thr, every operation rounded in float32."""
    iy = np.maximum(np.minimum(b[i, 2], b[j, 2]) - np.maximum(b[i, 0], b[j, 0]),
                    np.float32(0))
    ix = np.maximum(np.minimum(b[i, 3], b[j, 3]) - np.maximum(b[i, 1], b[j, 1]),
                    np.float32(0))
    inter = iy * ix
    union = (area[i] + area[j]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, np.float32(0))
    return iou >= np.float32(thr)


def _mirror_nms(boxes, scores, k, thr):
    """The kernel's sort -> bitmask -> scan on pre-masked (P, N) scores."""
    p_count, n = scores.shape
    out = np.full((p_count, k), -1, np.int32)
    num = np.zeros(p_count, np.int32)
    words = -(-n // 64)
    for p in range(p_count):
        s = scores[p].astype(np.float32)
        s = np.where(s == 0, np.float32(0), s)  # -0.0 keys as +0.0
        order = np.lexsort((np.arange(n), -s))  # score desc, index asc
        nv = int((s[order] > np.float32(torch_nms.NEG_INF / 2)).sum())
        b = boxes[p][order].astype(np.float32)
        area = (np.maximum(b[:, 2] - b[:, 0], np.float32(0))
                * np.maximum(b[:, 3] - b[:, 1], np.float32(0)))
        mask = [[0] * words for _ in range(nv)]
        for i in range(nv):
            j = np.arange(i + 1, nv)
            bits = np.zeros(words * 64, bool)
            bits[j] = _f32_iou_ge(b, area, i, j, thr)
            for w in range(i // 64, words):
                mask[i][w] = int.from_bytes(np.packbits(
                    bits[64 * w: 64 * w + 64], bitorder="little").tobytes(),
                    "little")
        removed = [0] * words
        count = 0
        for w in range(-(-nv // 64)):
            left = nv - 64 * w
            cand = ~removed[w] & (_ALL if left >= 64 else (1 << left) - 1)
            cand &= _ALL
            kept = []
            while cand and count < k:
                bit = (cand & -cand).bit_length() - 1
                out[p, count] = order[64 * w + bit]
                count += 1
                kept.append(64 * w + bit)
                cand &= ~mask[64 * w + bit][w] & ~((2 << bit) - 1) & _ALL
            if count >= k:
                break
            for row in kept:
                for later in range(w + 1, words):
                    removed[later] |= mask[row][later]
        num[p] = count
    return out, num


def _hard_problems(seed, p, n):
    """Tied scores (a grid of 1/8, with -0.0 beside +0.0), duplicate boxes,
    zero-area and inverted boxes, and a score block masked out."""
    boxes, scores = _problems(seed, p, n)
    rng = np.random.RandomState(seed + 100)
    scores = np.round(scores * 8) / 8
    scores[:, ::7] = 0.0
    scores[:, 3::11] = -0.0
    if n > 4:
        boxes[:, 1::5] = boxes[:, 0:-1:5][:, : boxes[:, 1::5].shape[1]]
        boxes[:, 2::9, 2] = boxes[:, 2::9, 0]  # zero height
        boxes[:, 4::13, 3] = boxes[:, 4::13, 1] - 5  # inverted width
    scores[:, rng.randint(0, n, n // 10)] = -1.0
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("seed,p,n,k,thr,score_threshold", [
    (0, 3, 70, 200, 0.5, float("-inf")),   # N % 64 != 0, k > survivors
    (1, 2, 1, 5, 0.5, float("-inf")),      # N = 1
    (2, 2, 130, 40, 0.3, 0.0),             # the cut at max_outputs
    (3, 2, 300, 100, 0.6, float("-inf")),  # the second stage's shape
    (4, 1, 700, 300, 0.7, 0.1),            # many blocks of 64
    (5, 2, 64, 64, 0.0, float("-inf")),    # threshold 0: one box survives
    (6, 2, 50, 10, 0.5, 2.0),              # every score masked to NEG_INF
])
def test_kernel_algorithm_matches_plain_and_jax(seed, p, n, k, thr,
                                                 score_threshold):
    boxes, scores = _hard_problems(seed, p, n)
    masked = torch_nms.premask(torch.from_numpy(scores),
                               score_threshold).numpy()
    got_idx, got_num = _mirror_nms(boxes, masked, k, thr)
    idx, num = torch_nms.nms_plain(torch.from_numpy(boxes),
                                   torch.from_numpy(masked), k, thr)
    np.testing.assert_array_equal(got_idx, idx.numpy())
    np.testing.assert_array_equal(got_num, num.numpy())
    want_idx, want_num = _jax_nms_batched(boxes, scores, k, thr,
                                          score_threshold)
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_array_equal(got_num, want_num)
    if score_threshold > 1:
        assert (got_num == 0).all() and (got_idx == -1).all()


def test_division_free_threshold_test_agrees_with_the_quotient():
    """The mask kernel decides iou >= thr without dividing when inter is
    more than 1e-5 (relative) away from thr * union; that decision must
    equal the rounded quotient's, near the threshold above all."""
    rng = np.random.RandomState(0)
    union = rng.uniform(1, 4e5, 200000).astype(np.float32)
    thr = rng.choice(np.float32([0.3, 0.5, 0.6, 0.7]), union.size)
    rel = np.concatenate([rng.uniform(-3e-5, 3e-5, 100000),
                          rng.uniform(-0.5, 0.5, 100000)])
    inter = (thr * union * (1 + rel)).astype(np.float32)
    exact = (inter / union) >= thr
    t = thr * union
    fast = np.where(inter > t * np.float32(1.00001), True,
                    np.where(inter < t * np.float32(0.99999), False, exact))
    np.testing.assert_array_equal(fast, exact)
    # the band where the kernel divides is narrow
    assert (inter > t * np.float32(1.00001)).sum() + \
        (inter < t * np.float32(0.99999)).sum() > 0.6 * union.size
