import re
import statistics

import pytest

from portbench import harness, roofline
from portbench.spans import Spans
from portbench.stages.segment import p90
from portbench.trace import DeviceTrace, clip, union


def test_p90_is_over_every_slide():
    times = [float(i) for i in range(1, 101)]
    assert p90(times) == pytest.approx(90.1)
    assert p90(times) == statistics.quantiles(times, n=10,
                                              method="inclusive")[8]
    assert p90([3.0]) == 3.0


def test_busy_is_the_union_of_intervals():
    assert union([(5, 9), (0, 2), (1, 3), (8, 12)]) == [[0, 3], [5, 12]]
    assert clip([(0, 3), (5, 12)], 2, 10) == [(2, 3), (5, 10)]
    t = DeviceTrace()
    t.ops = [("a", 0, 4), ("b", 2, 6), ("c", 10, 11), ("d", 20, 30)]
    assert t.busy_s(0, 25) == pytest.approx(12e-9)


def test_idle_gaps_are_named_by_the_open_host_spans():
    t = DeviceTrace()
    us = 1000
    t.ops = [("k", 100 * us, 200 * us), ("k", 500 * us, 600 * us),
             ("k", 605 * us, 610 * us)]
    spans = Spans()
    spans.records = [("result_wait", 200 * us, 400 * us, 1),
                     ("crop_read", 610 * us, 1000 * us, 2),
                     ("slide", 0, 1000 * us, 1)]
    gaps = t.idle_gaps(0, 1000 * us, spans)
    assert gaps == [["crop_read+slide", 390e-6],
                    ["result_wait+slide", 300e-6], ["slide", 100e-6],
                    ["launch gaps (< 20 us)", 5e-6]]


def ctx(**kw):
    base = {"stage": "segment", "window_ns": (0, 2_000_000_000),
            "window_s": 2.0, "crops": 300,
            "config": {"compute_dtype": "bfloat16", "precision": "default",
                       "crop_batch": 32, "in_height": 512,
                       "in_width": 1024},
            "flops_per_crop": 36.3e9}
    base.update(kw)
    return base


def test_the_readers_arithmetic():
    spans = Spans()
    spans.records = [("result_wait", 0, 500_000_000, 1),
                     ("result_wait", 1_500_000_000, 3_000_000_000, 1)]
    assert harness.reader("result_wait_share.seg")(ctx(spans=spans)) == \
        pytest.approx(50.0)
    t = DeviceTrace()
    t.ops = [("x", 0, 1_500_000_000)]
    assert harness.reader("idle_share.seg")(ctx(trace=t)) == \
        pytest.approx(25.0)
    # busy 1.5 s of the 2 s window: the step's share is over the busy time
    assert harness.reader("seg_mfu")(ctx(trace=t)) == pytest.approx(
        100 * 300 * 36.3e9 / 1.5 / 989e12)
    # K1: 4 launches (reduce + branch each) of 0.25 ms against the bound
    t.ops = [(name, i * 10**6, i * 10**6 + 125_000)
             for i in range(4) for name in ("esp_reduce_mma_kernel<1>",
                                            "esp_branch_mma_kernel<1>")]
    work = roofline.esp_block(32, 64, 128, 128, 2)
    one = roofline.bound_s(work["bytes"], work["ops"], 989e12)
    assert one == pytest.approx(134_250_000 / 3.35e12, rel=1e-3)
    assert harness.reader("k1_roofline")(ctx(trace=t)) == pytest.approx(
        100 * 4 * one / 1e-3)
    assert harness.reader("k1_roofline")(ctx(trace=DeviceTrace())) is None


def test_a_reader_finds_nothing_where_nothing_ran():
    assert harness.reader("idle_share.seg")(ctx(trace=DeviceTrace())) is None
    assert harness.reader("result_wait_share.seg")(ctx(spans=None)) is None
    assert harness.reader("seg_mfu")(ctx(trace=DeviceTrace())) is None
    assert harness.reader("seg_mfu")(ctx(crops=0, trace=DeviceTrace())) \
        is None
    assert harness.reader("seg_mfu")(ctx()) is None


def test_rates_are_over_the_whole_window():
    from portbench.stages import segment

    class Slow:
        def segment_slide(self, slide, boxes):
            import time
            time.sleep(0.05)
            return "canvas"

    class Stream:
        def slide(self, i):
            return type("S", (), {"boxes": [0] * (i + 1)})()

    keep = segment.Sample(3, 2)
    times, crops, failed, lo, hi = segment.walk(Slow(), Stream(), 0.12,
                                                keep)
    assert len(times) >= 3 and len(keep.canvases()) == 2
    assert crops == sum(range(1, len(times) + 1))
    assert (hi - lo) / 1e9 >= sum(times)
    assert re.fullmatch(r"\d+", str(failed))


@pytest.mark.parametrize("k", [1, 4])
def test_the_sample_keeps_k_canvases_while_the_window_walks(k):
    """The slide with the most boxes (the first of them) and ``k - 1``
    others drawn from the seed, the same for the same seed; every other
    canvas is let go as soon as it is offered."""
    from portbench.stages.segment import Sample

    boxes = [5, 9, 3, 9, 7, 2, 8, 6, 4, 1] * 5

    def kept(seed):
        s = Sample(seed, k)
        for i, n in enumerate(boxes):
            s.offer(i, n, f"canvas {i}")
            assert len(s.canvases()) <= k
        return s

    one = kept(2**31 + 9)
    assert one.picks()[0] == 1
    assert len(one.picks()) == k == len(set(one.picks()))
    assert one.canvases() == {i: f"canvas {i}" for i in one.picks()}
    assert kept(2**31 + 9).picks() == one.picks()
    if k > 1:
        draws = {tuple(kept(seed).picks()) for seed in range(20)}
        assert len(draws) > 1
        # drawn from the whole window, not its first slides
        assert max(i for d in draws for i in d) >= 25
