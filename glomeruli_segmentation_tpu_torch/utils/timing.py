"""Structured per-stage timing and profiling hooks.

The reference logs per-slide wall time to ``*_log.csv`` files
(``detect_glomus_test.py:110-112,152-158``,
``merge_overlaped_glomus.py:103-132``); this module keeps that CSV contract
(:class:`StageTimer` writes the same rows) and adds structured JSONL
metrics plus optional ``torch.profiler`` traces of the device work.

Counterpart of ``glomeruli_segmentation_tpu/utils/timing.py``:
:class:`StageTimer` is the port's own copy; :func:`device_trace` records
with ``torch.profiler`` where the JAX module uses ``jax.profiler``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class StageTimer:
    """Per-item wall-clock logging: reference CSV + structured JSONL."""

    def __init__(self, csv_path: Optional[str] = None,
                 jsonl_path: Optional[str] = None, stage: str = ""):
        self.stage = stage
        self._csv = open(csv_path, "w") if csv_path else None
        if self._csv:
            self._csv.write("file,time\n")
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None

    @contextlib.contextmanager
    def item(self, name: str, **extra):
        start = time.time()
        try:
            yield
        finally:
            duration = time.time() - start
            if self._csv:
                self._csv.write('"{}",{}\n'.format(name, duration))
                self._csv.flush()
            if self._jsonl:
                self._jsonl.write(json.dumps({
                    "stage": self.stage, "item": name,
                    "seconds": duration, "ts": time.time(), **extra}) + "\n")
                self._jsonl.flush()

    def close(self):
        for f in (self._csv, self._jsonl):
            if f:
                f.close()
        self._csv = self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` trace when ``log_dir`` is set:
    host activity, and the card's where CUDA is available.  The trace is
    written as ``trace_<pid>_<ns>.json`` (Chrome trace format) into
    ``log_dir`` when the block ends, also when it raises."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
