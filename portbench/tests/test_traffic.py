import numpy as np

from conftest import tiny
from portbench import harness, traffic


def boxes_of(params, seed, n, atlas):
    stream = traffic.SlideStream(params, seed, atlas)
    return [stream.slide(i).boxes for i in range(n)]


def test_the_same_seed_gives_the_same_slides_and_pixels():
    _, params = tiny("espnet5-glom-dense")
    a = traffic.make_atlas(params, 2**31 + 5, "cpu")
    b = traffic.make_atlas(params, 2**31 + 5, "cpu")
    assert a.shape == (512, 512, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert boxes_of(params, 2**31 + 5, 9, a) == boxes_of(params, 2**31 + 5,
                                                          9, a)
    s1 = traffic.SlideStream(params, 7, a).slide(3)
    s2 = traffic.SlideStream(params, 7, a).slide(3)
    x1, y1, x2, y2, _ = s1.boxes[0]
    assert np.array_equal(
        s1.read_region_array((x1, y1), 0, (x2 - x1, y2 - y1)),
        s2.read_region_array((x1, y1), 0, (x2 - x1, y2 - y1)))


def test_seeds_differ_in_order_and_place_not_in_work():
    _, _, params = harness.resolve("espnet5-glom-dense")
    atlas = np.zeros((params["atlas_px"],) * 2 + (3,), np.uint8)
    per = params["block_slides"]
    one, two = (boxes_of(params, s, 2 * per, atlas) for s in (11, 12))
    assert one != two
    for first in (0, per):
        counts = [sorted(len(b) for b in run[first: first + per])
                  for run in (one, two)]
        assert counts[0] == counts[1]
        sides = [sorted(b[2] - b[0] for s in run[first: first + per]
                        for b in s) for run in (one, two)]
        assert sides[0] == sides[1]
    counts = sorted(len(b) for b in one[:per])
    assert counts[0] == 16 and counts[-1] == 48
    sides = [b[2] - b[0] for s in one for b in s] + \
        [b[3] - b[1] for s in one for b in s]
    assert min(sides) >= 660 and max(sides) <= 1545
    h, w = params["slide_px"]
    assert all(0 <= b[0] and b[2] <= w and 0 <= b[1] and b[3] <= h
               for s in one for b in s)


def test_reads_wrap_the_atlas():
    atlas = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    slide = traffic.AtlasSlide(atlas, 100, 100, (3, 4), [])
    out = slide.read_region_array((1, 2), 0, (7, 6))
    ys = (np.arange(6) + 2 + 3) % 4
    xs = (np.arange(7) + 1 + 4) % 5
    assert np.array_equal(out, atlas[np.ix_(ys, xs)])


def test_block_summary_matches_the_issue_ranges():
    _, _, params = harness.resolve("segformer-b4-glom-dense")
    counts, sides = traffic.block_counts(params), traffic.block_sides(params)
    assert counts.tolist() == [16, 21, 25, 30, 34, 39, 43, 48]
    assert (len(sides), sides.min(), sides.max()) == (256, 662, 1543)
