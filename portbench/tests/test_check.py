import numpy as np
import pytest
import torch

from portbench import check


def scores_for(classes_map, c=5, margin=1.0):
    """Scores whose argmax is ``classes_map`` by ``margin``."""
    s = torch.zeros((c,) + classes_map.shape, dtype=torch.float64)
    s.scatter_(0, torch.from_numpy(classes_map)[None].long(), margin)
    return s


def test_agreeing_canvas_reads_zero():
    m = np.random.default_rng(0).integers(0, 5, (3, 4)).astype(np.uint8)
    canvas = np.zeros((4, 6), np.uint8)
    canvas[1:4, 2:6] = m
    c = check.CanvasCheck(canvas, 5, "cpu")
    c.add((16, 8, 48, 32), scores_for(m))
    assert c.result() == {"gap": 0.0, "mismatched": 0, "stray": 0,
                          "pixels": 12}


def test_a_wrong_label_reads_its_margin():
    m = np.full((2, 2), 2, np.uint8)
    canvas = np.zeros((2, 2), np.uint8)
    canvas[:] = 2
    canvas[0, 0] = 4
    c = check.CanvasCheck(canvas, 5, "cpu")
    c.add((0, 0, 16, 16), scores_for(m, margin=0.7))
    assert c.result()["gap"] == pytest.approx(0.7)
    assert check.numbers(c.result()) == {"canvas_gap": pytest.approx(0.7),
                                         "mismatch_share": 0.25}


def test_overlaps_follow_the_max_paste():
    # crop A says 1 everywhere, crop B says 3 on the overlap column
    a, b = np.ones((1, 2), np.uint8), np.full((1, 2), 3, np.uint8)
    canvas = np.array([[1, 3, 3]], np.uint8)
    c = check.CanvasCheck(canvas, 5, "cpu")
    c.add((0, 0, 16, 8), scores_for(a))
    c.add((8, 0, 24, 8), scores_for(b))
    assert c.result()["gap"] == 0.0
    # 1 where B says 3: B would have to choose at most 1
    canvas = np.array([[1, 1, 3]], np.uint8)
    c = check.CanvasCheck(canvas, 5, "cpu")
    c.add((0, 0, 16, 8), scores_for(a))
    c.add((8, 0, 24, 8), scores_for(b, margin=0.4))
    assert c.result()["gap"] == pytest.approx(0.4)


def test_strays_and_bad_classes():
    canvas = np.zeros((2, 4), np.uint8)
    canvas[0, 3] = 1
    canvas[0, 0] = 7
    c = check.CanvasCheck(canvas, 5, "cpu")
    c.add((0, 0, 16, 16), scores_for(np.zeros((2, 2), np.uint8)))
    r = c.result()
    assert r["stray"] == 1 and r["gap"] == 1e300
    assert check.merge([r, {"gap": 0.5, "mismatched": 1, "stray": 2,
                            "pixels": 3}]) == {
        "gap": 1e300, "mismatched": 2, "stray": 3, "pixels": 7}


def test_boxes_past_the_edge_are_clipped():
    canvas = np.zeros((2, 2), np.uint8)
    c = check.CanvasCheck(canvas, 5, "cpu")
    c.add((8, 8, 40, 40), scores_for(np.zeros((4, 4), np.uint8)))
    assert c.result()["pixels"] == 1
