"""The readers of the program's own spans and counters
(``portbench/program.py`` and the metrics that use it): their arithmetic
on records and a device trace made by hand, the cases with nothing to
read, a tiny run of both cells' stage on the CPU under a profiler
session, and on the card a traced run whose spans and device operations
share one clock."""
import math
import time
import types
from collections import deque

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import tiny
from portbench import harness, program, traffic
from portbench.stages import segment
from portbench.trace import DeviceTrace

CELLS = ("espnet5-glom-dense", "segformer-b4-glom-dense")
SHARES = {"read_share.seg": "seg.read", "pack_share.seg": "seg.pack",
          "stage_wait_share.seg": "seg.stage_wait",
          "upload_share.seg": "seg.upload",
          "launch_share.seg": "seg.launch",
          "readback_wait_share.seg": "seg.result_wait",
          "paste_share.seg": "seg.paste"}
NEW = list(SHARES) + ["slot_fill.seg", "idle_unattributed_share.seg"]
US = 1000


@pytest.fixture
def timing(monkeypatch):
    """The port's recorder with empty buffers of its own."""
    from glomeruli_segmentation_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "_SPANS", deque())
    monkeypatch.setattr(timing, "_COUNTS", deque())
    return timing


def ctx(**kw):
    base = {"stage": "segment", "window_ns": (0, 1000 * US),
            "window_s": 1e-3, "crops": 52, "trace": None}
    base.update(kw)
    return base


def trace(*ops):
    t = DeviceTrace()
    t.ops = [("k", t0 * US, t1 * US) for t0, t1 in ops]
    return t


def fill(timing):
    """Spans of a consumer (thread 1, it launches) and a producer (2), in
    microseconds, one of them past the window's start; counts of three
    batches, one before the window."""
    for name, t0, t1, tid in [
            ("seg.paste", -50, 50, 1), ("seg.launch", 150, 250, 1),
            ("seg.result_wait", 250, 400, 1), ("x.other", 400, 500, 1),
            ("seg.stage_wait", 650, 700, 1), ("seg.read", 610, 1000, 2),
            ("seg.pack", 100, 180, 2), ("seg.pack", 300, 320, 2)]:
        timing._SPANS.append((name, t0 * US, t1 * US, tid))
    for name, t, n in [("seg.slots_used", -10, 32),
                       ("seg.slots_computed", -10, 32),
                       ("seg.slots_used", 100, 32),
                       ("seg.slots_computed", 100, 32),
                       ("seg.slots_used", 600, 20),
                       ("seg.slots_computed", 600, 32)]:
        timing._COUNTS.append((name, t * US, n, 1))


def test_the_span_shares_are_clipped_to_the_window(timing):
    fill(timing)
    read = {m: harness.reader(m)(ctx()) for m in SHARES}
    assert read["read_share.seg"] == pytest.approx(39.0)
    assert read["pack_share.seg"] == pytest.approx(10.0)
    assert read["stage_wait_share.seg"] == pytest.approx(5.0)
    assert read["launch_share.seg"] == pytest.approx(10.0)
    assert read["readback_wait_share.seg"] == pytest.approx(15.0)
    # only the part inside the window: 50 of its 100 us
    assert read["paste_share.seg"] == pytest.approx(5.0)
    # no span of that name in the window: nothing to read
    assert read["upload_share.seg"] is None


def test_slot_fill_sums_the_windows_counts(timing):
    fill(timing)
    assert harness.reader("slot_fill.seg")(ctx()) == pytest.approx(
        100.0 * 52 / 64)


def test_unattributed_idle_subtracts_the_consumers_spans(timing):
    fill(timing)
    # busy 100-200, 500-600, 605-610: gaps 0-100, 200-500, 610-1000 and a
    # launch gap of 5 us, which does not count; 790 us idle
    t = trace((100, 200), (500, 600), (605, 610))
    # the consumer covers 0-50 (its paste, clipped), 200-250 (launch),
    # 250-400 (its wait), 650-700; the producer's read and the span of
    # another prefix do not count
    got = harness.reader("idle_unattributed_share.seg")(ctx(trace=t))
    assert got == pytest.approx(100.0 * (790 - 300) / 790)
    # a consumer span covering every gap leaves nothing unattributed
    timing._SPANS.append(("seg.paste", 0, 1000 * US, 1))
    assert harness.reader("idle_unattributed_share.seg")(
        ctx(trace=t)) == pytest.approx(0.0)


def test_nothing_to_read(timing, monkeypatch):
    readers = {m: harness.reader(m) for m in NEW}
    busy = trace((100, 200))
    # the recorder is empty: every reader finds nothing
    assert all(r(ctx(trace=busy)) is None for r in readers.values())
    fill(timing)
    # another stage, or no device trace for the idle share
    assert all(r(ctx(stage="detect", trace=busy)) is None
               for r in readers.values())
    assert readers["idle_unattributed_share.seg"](ctx()) is None
    assert readers["idle_unattributed_share.seg"](
        ctx(trace=DeviceTrace())) is None
    # no consumer: no thread launched a batch
    timing._SPANS.clear()
    timing._SPANS.append(("seg.read", 0, 500 * US, 2))
    assert readers["idle_unattributed_share.seg"](ctx(trace=busy)) is None
    # a program without the recorder (the module lacks it)
    monkeypatch.setattr(program, "_recorder", lambda: None)
    assert all(r(ctx(trace=busy)) is None for r in readers.values())


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from glomeruli_segmentation_tpu_torch.utils import timing

    bare = types.ModuleType(timing.__name__)
    monkeypatch.setattr("glomeruli_segmentation_tpu_torch.utils.timing",
                        bare)
    assert program._recorder() is None
    assert program.spans(ctx()) is None and program.counts(ctx()) is None


def batches_of(params, seed, slides, bs):
    from glomeruli_segmentation_tpu_torch.pipeline.fused import crop_boxes

    stream = traffic.SlideStream(params, seed,
                                 traffic.make_atlas(params, seed, "cpu"))
    return sum(math.ceil(len(crop_boxes(stream.slide(i).boxes)) / bs)
               for i in range(slides))


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_under_a_cpu_profiler_reads_every_stage(workload,
                                                           timing):
    cfg, params = tiny(workload)
    seed = 2**31 + 29
    with profile(activities=[ProfilerActivity.CPU]):
        outcome = segment.run(None, cfg, params, seed, 0.3, False,
                              time.perf_counter(), device="cpu")
    c = outcome["ctx"]
    read = {m: harness.reader(m)(c) for m in NEW}
    for m in SHARES:
        assert read[m] is not None and 0 < read[m] < 100, m
    # no device trace on the CPU
    assert read["idle_unattributed_share.seg"] is None
    bs = cfg["crop_batch"]
    batches = batches_of(params, seed, outcome["attempted"], bs)
    assert read["slot_fill.seg"] == pytest.approx(
        100.0 * c["crops"] / (batches * bs))


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_spans_and_device_operations_share_one_clock(card, workload,
                                                     timing):
    """Each batch's first copy to the device starts no earlier than its
    ``seg.upload`` span opened, less 50 us, and the program's wait for
    results reads within a point of the benchmark's own span of it."""
    _, cfg, params = harness.resolve(workload)
    outcome = segment.run(None, cfg, params, 2**31 + 31, 6.0, True,
                          time.perf_counter(), device=card)
    assert outcome["failed"] == 0
    c = outcome["ctx"]
    lo, hi = c["window_ns"]
    opens = sorted(t0 for n, t0, _, _ in timing.records(lo, hi)
                   if n == "seg.upload" and t0 >= lo)
    copies = sorted(t0 for n, t0, _ in c["trace"].ops
                    if "HtoD" in n and lo <= t0 < hi)
    assert opens and copies
    per = len(copies) // len(opens)
    assert per >= 1 and len(copies) == per * len(opens), (len(copies),
                                                          len(opens))
    early = [copies[k * per] - t for k, t in enumerate(opens)
             if copies[k * per] < t - 50 * US]
    assert not early, early[:5]
    ours = harness.reader("readback_wait_share.seg")(c)
    theirs = harness.reader("result_wait_share.seg")(c)
    assert abs(ours - theirs) <= 1.0, (ours, theirs)
    for m in NEW:
        assert harness.reader(m)(c) is not None, m
