"""The port's span and counter recorder (``utils/timing.py``) and where the
slide loops use it, on the CPU.

The recorder keeps nothing while no ``torch.profiler`` session runs, and
``span`` then hands back one shared null context.  Under a CPU profiler
session it keeps spans and counts on ``time.perf_counter_ns`` with the
recording thread, also when a span's body raises, in bounded buffers.
Both slide segmenters (a tiny packed ESPNet ensemble, a tiny MiT) record
the same names: crop reads and packing on the producer thread, the rest
on the caller's, and one pair of slot counts per submitted batch; the
ESPNet loop also counts each staged batch's crop bytes, and those of them
written straight into pinned memory (none on the CPU), on the producer
thread."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
    random_state_dict,
)
from glomeruli_segmentation_tpu_torch.models.segformer import (
    SegformerConfig, random_segformer_state_dict,
)
from glomeruli_segmentation_tpu_torch.pipeline import fused, fused_segformer
from glomeruli_segmentation_tpu_torch.utils import timing

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PRODUCER = {"seg.read", "seg.pack"}
CONSUMER = {"seg.stage_wait", "seg.upload", "seg.launch",
            "seg.result_wait", "seg.paste"}
STAGED = {"seg.staged_bytes", "seg.pinned_bytes"}
BATCH = 4
# nine boxes with pixels (three batches of four: 9 of 12 slots) and one
# without, which neither path reads or counts
BOXES = [[40 + 70 * i, 30 + 50 * (i % 3), 140 + 70 * i + 9 * i,
          130 + 50 * (i % 3) + 5 * i] for i in range(9)] + [
    [300, 300, 300, 420]]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_buffers():
    timing.clear()
    yield
    timing.clear()


class ArraySlide:
    """A level-0 slide held in memory, RGB."""

    def __init__(self, seed: int, height: int = 600, width: int = 900):
        rng = np.random.default_rng(seed)
        self.pixels = rng.integers(0, 256, (height, width, 3), np.uint8)
        self.dimensions = (width, height)

    def read_region_array(self, location, level, size):
        (x, y), (w, h) = location, size
        out = np.zeros((h, w, 3), np.uint8)
        part = self.pixels[y: y + h, x: x + w]
        out[: part.shape[0], : part.shape[1]] = part
        return out


@pytest.fixture(scope="module")
def espnet_segmenter(tmp_path_factory):
    d = tmp_path_factory.mktemp("timing_folds")
    paths = []
    for fold in (1, 2):
        path = d / f"espnet_fold{fold}.pth"
        torch.save(random_state_dict(fold, 5, p=1, q=2), path)
        paths.append(str(path))
    ensemble = fused.EnsembleSegmenter(
        fused.EnsembleConfig(checkpoints=paths, folds=(1, 2), p=1, q=2,
                             in_height=64, in_width=128, batch_size=BATCH,
                             compute_dtype="float32"),
        engine="packed", device="cpu")
    return fused.FusedSlideSegmenter(ensemble)


@pytest.fixture(scope="module")
def segformer_segmenter():
    config = SegformerConfig(hidden_sizes=(16, 32, 40, 64),
                             depths=(1, 1, 1, 1),
                             decoder_hidden_size=16)
    return fused_segformer.SegformerSlideSegmenter(
        random_segformer_state_dict(config, seed=5),
        fused_segformer.SegformerSlideConfig(input_size=64,
                                             batch_size=BATCH),
        device="cpu")


@pytest.fixture(params=["espnet", "segformer"])
def segmenter(request):
    return request.getfixturevalue(f"{request.param}_segmenter")


def test_off_keeps_nothing_and_hands_back_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = timing.span("a"), timing.span("b")
    assert first is second is timing._OFF
    with first:
        pass
    timing.count("c", 3)
    assert timing.records() == [] and timing.counts() == []


def test_spans_and_counts_under_a_cpu_profiler():
    with cpu_profile():
        lo = time.perf_counter_ns()
        with timing.span("outer"):
            with timing.span("inner"):
                torch.ones(8).sum()
            timing.count("slots", 7)
        hi = time.perf_counter_ns()
    # the session is over: off again
    assert timing.span("after") is timing._OFF
    timing.count("after", 1)
    me = threading.get_ident()
    (inner, outer) = timing.records()
    assert [inner[0], outer[0]] == ["inner", "outer"]
    assert lo <= outer[1] <= inner[1] <= inner[2] <= outer[2] <= hi
    assert inner[3] == outer[3] == me
    (slots,) = timing.counts()
    assert slots[0] == "slots" and slots[2] == 7 and slots[3] == me
    assert inner[2] <= slots[1] <= outer[2]


def test_records_and_counts_are_taken_by_window():
    with cpu_profile():
        with timing.span("a"):
            timing.count("n", 1)
        mid = time.perf_counter_ns()
        with timing.span("b"):
            timing.count("n", 2)
    (a, b) = timing.records()
    # a span overlapping the window is returned whole, unclipped
    assert timing.records(a[1] + 1, a[2]) == [a]
    assert timing.records(mid, b[2] + 1) == [b]
    assert timing.records(b[2], b[2] + 10) == []
    assert [c[2] for c in timing.counts(0, mid)] == [1]
    assert [c[2] for c in timing.counts(mid)] == [2]


def test_a_raising_body_keeps_its_span():
    with cpu_profile():
        with pytest.raises(KeyError):
            with timing.span("raises"):
                raise KeyError("kept all the same")
    (rec,) = timing.records()
    assert rec[0] == "raises" and rec[1] <= rec[2]


def test_the_buffers_are_bounded():
    assert timing._SPANS.maxlen == timing._COUNTS.maxlen == \
        timing.MAX_RECORDS
    extra = 5
    with cpu_profile():
        for i in range(timing.MAX_RECORDS + extra):
            with timing.span(i):
                pass
            timing.count("n", i)
    spans, counts = timing.records(), timing.counts()
    assert len(spans) == len(counts) == timing.MAX_RECORDS
    # the oldest went first
    assert spans[0][0] == extra and spans[-1][0] == \
        timing.MAX_RECORDS + extra - 1
    assert counts[0][2] == extra


def test_two_threads_record_apart():
    start = threading.Barrier(2)
    idents = {}

    def work(name):
        idents[name] = threading.get_ident()
        start.wait(timeout=10)
        for _ in range(200):
            with timing.span(name):
                timing.count(name, 1)

    with cpu_profile():
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("left", "right")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert idents["left"] != idents["right"]
    for name, ident in idents.items():
        mine = [r for r in timing.records() if r[0] == name]
        assert len(mine) == 200 and {r[3] for r in mine} == {ident}
        # one thread's spans follow one another
        assert all(a[2] <= b[1] for a, b in zip(mine, mine[1:]))
        counted = [c for c in timing.counts() if c[0] == name]
        assert sum(c[2] for c in counted) == 200
        assert {c[3] for c in counted} == {ident}


def test_the_slide_loops_keep_nothing_without_a_profiler(segmenter):
    dets = [b + [0.9] for b in BOXES]
    segmenter.segment_slide(ArraySlide(1), dets)
    assert timing.records() == [] and timing.counts() == []


def test_the_slide_loops_record_every_stage(segmenter):
    slide = ArraySlide(2)
    dets = [b + [0.9] for b in BOXES]
    plain = segmenter.segment_slide(slide, dets)
    with cpu_profile():
        lo = time.perf_counter_ns()
        canvas = segmenter.segment_slide(slide, dets)
        hi = time.perf_counter_ns()
    # recording changes nothing the loop computes
    np.testing.assert_array_equal(canvas, plain)
    recs = timing.records()
    assert {r[0] for r in recs} == PRODUCER | CONSUMER
    assert all(lo <= t0 <= t1 <= hi for _, t0, t1, _ in recs)
    caller = threading.get_ident()
    for name, _, _, tid in recs:
        assert (tid != caller) == (name in PRODUCER), name
    crops = len(fused.crop_boxes(dets))
    batches = -(-crops // BATCH)
    by_name = {}
    for name, _, n, tid in timing.counts():
        # slots where a batch is submitted, bytes where it is staged
        assert (tid != caller) == (name in STAGED), name
        by_name.setdefault(name, []).append(n)
    assert sum(by_name["seg.slots_used"]) == crops == 9
    assert sum(by_name["seg.slots_computed"]) == batches * BATCH == 12
    assert len(by_name["seg.slots_used"]) == batches
    if isinstance(segmenter, fused.FusedSlideSegmenter):
        staged = sum((x2 - x1) * (y2 - y1) * 3
                     for x1, y1, x2, y2 in fused.crop_boxes(dets))
        assert sum(by_name["seg.staged_bytes"]) == staged
        assert by_name["seg.pinned_bytes"] == [0] * batches
        assert len(by_name["seg.staged_bytes"]) == batches
    else:
        assert not STAGED & set(by_name)
    names = [r[0] for r in recs]
    # one upload, launch, result wait and paste a batch, one read span a
    # batch (ESPNet) or a crop (SegFormer)
    for name in ("seg.upload", "seg.launch", "seg.result_wait",
                 "seg.paste"):
        assert names.count(name) == batches, name
    assert names.count("seg.read") in (batches, crops)
    # the consumer's spans never overlap one another
    mine = sorted((t0, t1) for n, t0, t1, _ in recs if n in CONSUMER)
    assert all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
