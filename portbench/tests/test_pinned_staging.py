"""``pinned_share.seg``, the share of staged crop bytes written straight
into pinned memory: its reader's arithmetic on counts made by hand, the
cases with nothing to read, a tiny run of both cells' stage on the CPU
under a profiler session, and on the card the staging it reads: each flat
batch in pinned memory, uploaded without a host copy, and back-to-back
batches of distinct crops giving the CPU's canvas."""
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import tiny
from portbench import harness, program
from portbench.stages import segment

CELLS = ("espnet5-glom-dense", "segformer-b4-glom-dense")
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


def read(c):
    return harness.reader("pinned_share.seg")(c)


def test_the_share_sums_the_windows_counts(timing):
    # three batches in the window, one of them staged without pinning (a
    # padded batch), and one before the window
    for name, t, n in [("seg.staged_bytes", -10, 900),
                       ("seg.pinned_bytes", -10, 0),
                       ("seg.staged_bytes", 100, 300),
                       ("seg.pinned_bytes", 100, 300),
                       ("seg.slots_used", 120, 32),
                       ("seg.staged_bytes", 400, 100),
                       ("seg.pinned_bytes", 400, 0),
                       ("seg.staged_bytes", 700, 600),
                       ("seg.pinned_bytes", 700, 600)]:
        timing._COUNTS.append((name, t * US, n, 2))
    assert read(ctx()) == pytest.approx(100.0 * 900 / 1000)
    # only the batch at 700 us
    assert read(ctx(window_ns=(500 * US, 1000 * US))) == pytest.approx(100.0)


def test_nothing_to_read(timing, monkeypatch):
    # the recorder is empty
    assert read(ctx()) is None
    # counts without staged bytes: the parent's program, or SegFormer's
    timing._COUNTS.append(("seg.slots_used", 100 * US, 32, 1))
    timing._COUNTS.append(("seg.slots_computed", 100 * US, 32, 1))
    assert read(ctx()) is None
    # another stage
    timing._COUNTS.append(("seg.staged_bytes", 200 * US, 64, 2))
    timing._COUNTS.append(("seg.pinned_bytes", 200 * US, 64, 2))
    assert read(ctx()) == pytest.approx(100.0)
    assert read(ctx(stage="detect")) is None
    # a program without the recorder
    monkeypatch.setattr(program, "_recorder", lambda: None)
    assert read(ctx()) is None


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_under_a_cpu_profiler(workload, timing):
    """On the CPU the ESPNet loop stages its flat batches in numpy: every
    crop byte counted, none pinned.  SegFormer's loop counts none."""
    cfg, params = tiny(workload)
    with profile(activities=[ProfilerActivity.CPU]):
        outcome = segment.run(None, cfg, params, 2**31 + 37, 0.3, False,
                              time.perf_counter(), device="cpu")
    got = read(outcome["ctx"])
    if workload.startswith("espnet"):
        assert got == 0.0
    else:
        assert got is None


class NoiseSlide:
    """A level-0 slide of seeded noise, so that every crop holds other
    bytes; a read is a fresh RGB array, as a slide reader's is."""

    def __init__(self, seed: int, side: int):
        rng = np.random.default_rng(seed)
        self.pixels = rng.integers(0, 256, (side, side, 3), np.uint8)
        self.dimensions = (side, side)

    def read_region_array(self, location, level, size):
        (x, y), (w, h) = location, size
        return self.pixels[y: y + h, x: x + w].copy()

    def boxes(self, n: int, lo: int, hi: int, seed: int) -> list:
        rng = np.random.default_rng(seed)
        side = self.dimensions[0]
        out = []
        for h, w in rng.integers(lo, hi + 1, (n, 2)):
            y, x = rng.integers(0, side - hi, 2)
            out.append([int(x), int(y), int(x + w), int(y + h), 0.9])
        return out


def segmenter(workdir, device, batch_size: int = 8):
    """The flat-transfer slide loop over a one-fold ensemble whose network
    is replaced by an integer function of the crop bytes it was handed,
    sampled over each whole crop: the canvas depends on every batch's
    uploaded bytes alone, exactly, on the card as on the CPU."""
    from glomeruli_segmentation_tpu_torch.convert.espnet_import import (
        random_state_dict)
    from glomeruli_segmentation_tpu_torch.pipeline import fused

    path = workdir / "espnet_fold1.pth"
    torch.save(random_state_dict(1, 5, p=1, q=2), path)
    ensemble = fused.EnsembleSegmenter(
        fused.EnsembleConfig(checkpoints=[str(path)], folds=(1,), p=1, q=2,
                             in_height=64, in_width=128,
                             batch_size=batch_size, compute_dtype="float32"),
        engine="xla", device=device)

    def forward(models, padded, heights, widths, ys, xs):
        b = torch.arange(padded.shape[0], device=padded.device)
        rows = ys.long() * heights.long()[:, None] // 64
        cols = xs.long() * widths.long()[:, None] // 128
        px = padded[b[:, None, None], rows[:, :, None], cols[:, None, :]]
        return (px.long().sum(-1) % 5).to(torch.uint8)

    ensemble._forward_gather = forward
    seg = fused.FusedSlideSegmenter(ensemble)
    assert seg.transfer == "flat"
    return seg


def pinned_pool() -> int:
    """The pinned host bytes that torch's host allocator holds, cached and
    in use."""
    stats = torch.cuda.host_memory_stats()
    assert "allocated_bytes.current" in stats, sorted(stats)
    return stats["allocated_bytes.current"]


@pytest.mark.card
def test_the_flat_batch_is_pinned_and_uploaded_without_a_host_copy(
        card, tmp_path, monkeypatch):
    from glomeruli_segmentation_tpu_torch.parallel.mesh import upload
    from glomeruli_segmentation_tpu_torch.pipeline import fused

    seg = segmenter(tmp_path, card)
    staged = []
    pack = fused.pack_crops_flat
    monkeypatch.setattr(fused, "pack_crops_flat",
                        lambda *a, **k: staged.append(pack(*a, **k))
                        or staged[-1])
    # the host memory each uint8 copy to the card reads from
    sources = []
    to = torch.Tensor.to

    def spy(self, *a, **k):
        if self.device.type == "cpu" and self.dtype == torch.uint8:
            sources.append((self.data_ptr(), self.is_pinned()))
        return to(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    slide = NoiseSlide(1, 2048)
    seg.segment_slide(slide, slide.boxes(20, 200, 600, seed=2))
    assert len(staged) == 3
    assert all(isinstance(f, torch.Tensor) and f.is_pinned()
               for f, *_ in staged)
    # each batch went to the card from the block it was packed into
    assert sources == [(f.data_ptr(), True) for f, *_ in staged]
    flat = staged[-1][0]
    torch.cuda.synchronize()
    before = pinned_pool()
    sources.clear()
    up = upload(flat, seg.ensemble.device)
    # no staging copy: no block taken, none made
    assert sources == [(flat.data_ptr(), True)]
    assert pinned_pool() == before
    torch.cuda.synchronize()
    assert torch.equal(up.cpu(), flat)


@pytest.mark.card
def test_back_to_back_batches_give_the_cpu_canvas(card, tmp_path):
    """40 batches of 8 distinct crops of up to 1536 px through one slide:
    were a pinned block handed out again while its copy to the card was in
    flight, a batch would reach the card with another batch's bytes."""
    slide = NoiseSlide(3, 6144)
    boxes = slide.boxes(320, 600, 1536, seed=4)
    want = segmenter(tmp_path, "cpu").segment_slide(slide, boxes)
    got = segmenter(tmp_path, card).segment_slide(slide, boxes)
    assert want.any()
    np.testing.assert_array_equal(got, want)
