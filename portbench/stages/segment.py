"""The segment stage: slides back to back through a slide segmenter's
``segment_slide(slide, boxes)``, one client, as ``gseg-e2e`` runs each
slide's crops after its detector and merger.

Set-up makes the pixel atlas and the weights on the device from the seed,
builds the program, and runs one block of warm-up slides (every shape
the window uses).  The window then walks the seed's slides until
``seconds`` have passed and the slide in hand is done.  After it closes,
the program is freed and the reference checks the sample of the window's
canvases kept while it walked: the slide with the most boxes and others
drawn from the seed.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from .. import check, traffic
from ..spans import Spans
from ..trace import DeviceTrace


def p90(values) -> float:
    """The 90th percentile of all values (``statistics.quantiles``,
    inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=10, method="inclusive")[8])


def inputs(cfg, params, seed, device):
    """(family, pixel atlas, weights) of one seed, made on ``device``."""
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    atlas = traffic.make_atlas(params, seed, device)
    weights = family.make_weights(cfg, seed, device, atlas)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return family, atlas, weights


class Sample:
    """The canvases a run checks, chosen while the window walks: the slide
    with the most boxes (the first of them) and ``k - 1`` others drawn
    from the seed by reservoir sampling.  Every other canvas is dropped as
    soon as its slide is done, so the window holds ``k`` canvases at most
    and the program's host memory is reused as a deployment's would be."""

    def __init__(self, seed: int, k: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 7])
        self.most = None        # (boxes, index, canvas)
        self.others = []        # [(index, canvas)]
        self.offered = 0

    def offer(self, i: int, boxes: int, canvas) -> None:
        if self.most is None or boxes > self.most[0]:
            old, self.most = self.most, (boxes, i, canvas)
            if old is None:
                return
            i, canvas = old[1], old[2]
        if self.k <= 1:
            return
        if len(self.others) < self.k - 1:
            self.others.append((i, canvas))
        else:
            j = int(self.rng.integers(0, self.offered + 1))
            if j < self.k - 1:
                self.others[j] = (i, canvas)
        self.offered += 1

    def canvases(self) -> dict:
        """The kept canvases by slide index."""
        kept = dict(self.others)
        if self.most is not None:
            kept[self.most[1]] = self.most[2]
        return kept

    def picks(self) -> list:
        """The slides to compare: the one with the most boxes first."""
        rest = sorted(i for i, _ in self.others)
        return rest if self.most is None else [self.most[1]] + rest


def walk(segmenter, stream, seconds: float, keep: Sample, spans=None,
         count=None):
    """Slides of ``stream`` through ``segmenter`` until ``seconds`` have
    passed (or ``count`` slides are done), each canvas offered to
    ``keep``: (per-slide seconds, crops done, failures, window start ns,
    window end ns)."""
    times, crops, failed = [], 0, 0
    lo = time.perf_counter_ns()
    deadline = lo + int(seconds * 1e9)
    i = 0
    while (time.perf_counter_ns() < deadline if count is None
           else i < count):
        slide = stream.slide(i)
        span = spans.span("slide") if spans else contextlib.nullcontext()
        t0 = time.perf_counter_ns()
        try:
            with span:
                canvas = segmenter.segment_slide(slide, slide.boxes)
        except Exception as e:  # a failed slide is counted and reported
            print(f"slide {i} failed: {e!r}", file=sys.stderr)
            failed += 1
            canvas = None
        times.append((time.perf_counter_ns() - t0) / 1e9)
        if canvas is not None:
            crops += len(slide.boxes)
            keep.offer(i, len(slide.boxes), canvas)
        del canvas
        i += 1
    return times, crops, failed, lo, time.perf_counter_ns()


def compare(family, cfg, weights, stream, canvases, picks, device,
            control=False) -> dict:
    results = []
    for i in picks:
        slide = stream.slide(i)
        c = check.CanvasCheck(canvases[i], cfg.get("classes")
                              or cfg["num_labels"], device)
        for box, scores in family.reference_scores(
                cfg, weights, slide, slide.boxes, device, control=control):
            c.add(box, scores)
        results.append(c.result())
    return check.merge(results)


def run(workload, cfg, params, seed, seconds, traced, t_start,
        device="cuda", tamper=None) -> dict:
    """One run of the cell.  ``tamper(family, segmenter)``, for the tests
    only, breaks the program underneath the window and returns a function
    that mends it."""
    with tempfile.TemporaryDirectory() as work:
        family, atlas, weights = inputs(cfg, params, seed, device)
        seg = family.build(cfg, weights, device, work)
        for slide in traffic.warmup_slides(params, seed, atlas):
            seg.segment_slide(slide, slide.boxes)
        if device != "cpu":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        mend = tamper(family, seg) if tamper else None
        spans = dev = None
        if traced:
            spans = Spans()
            for owner, attr in family.result_reads(seg):
                spans.wrap(owner, attr, "result_wait")
            dev = DeviceTrace()
            dev.start()
        stream = traffic.SlideStream(
            params, seed, atlas,
            on_read=spans.factory("crop_read") if spans else None)
        keep = Sample(seed, params["check_slides"])
        times, crops, failed, lo, hi = walk(seg, stream, seconds, keep,
                                            spans)
        if traced:
            dev.stop()
            spans.restore()
        if mend:
            mend()
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        del seg
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
    stream.on_read = None
    picks = keep.picks()
    got = compare(family, cfg, weights, stream, keep.canvases(), picks,
                  device)
    window_s = (hi - lo) / 1e9
    ctx = {"stage": "segment", "config": cfg, "window_ns": (lo, hi),
           "window_s": window_s, "crops": crops, "slides": len(times),
           "trace": dev, "spans": spans,
           "flops_per_crop": family.flops_per_crop(cfg)}
    return {
        "attempted": len(times), "failed": failed,
        "end_to_end": {"crops_per_s": crops / window_s,
                       "slide_s_p90": p90(times), "setup_s": setup_s},
        "checks": dict({k: (v, cfg["limits"][k])
                        for k, v in check.numbers(got).items()
                        if k in cfg["limits"]},
                       stray_pixels=(got["stray"], 0),
                       failed_slides=(failed, 0)),
        "compared": dict(check.numbers(got), slides=len(picks),
                         pixels=got["pixels"]),
        "memory_peak_bytes": peak, "window_s": window_s, "ctx": ctx,
    }
