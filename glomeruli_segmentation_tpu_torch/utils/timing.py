"""Spans and counters of the port's own stages, kept in this process while
a ``torch.profiler`` session runs.

``span(name)`` times a block as ``(name, t0_ns, t1_ns, thread_id)`` and
``count(name, n)`` keeps ``(name, t_ns, n, thread_id)``, both on
``time.perf_counter_ns``, the host clock a device trace can be tied to, so
a span and an idle gap on the device compare with no other alignment.
The recorder is on exactly while a profiler session is running in the
process (``torch.autograd.profiler._is_profiler_enabled``, which torch
sets when any profiler starts and clears when it stops), so whoever
profiles ``gseg-e2e``, ``gseg-serve`` or the benchmark gets the spans
with the device trace.  Off, ``span`` reads one module attribute and
returns a shared null context: no clock is read and nothing is kept.

Nothing here reaches the profiler itself (no ``record_function``, no NVTX
range), so a device trace holds the device's work alone.  The records are
process-wide, as the profiler is, in two bounded buffers of
``MAX_RECORDS`` entries each (the oldest go first); readers take them with
:func:`records` and :func:`counts`.

The reference's per-slide ``file,time`` logs
(``detect_glomus_test.py:110-112,152-158``,
``merge_overlaped_glomus.py:103-132``) are written by the stages
themselves (``pipeline/detect.py``, ``pipeline/merge.py``,
``pipeline/e2e.py``).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time

from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 17

_SPANS: "collections.deque" = collections.deque(maxlen=MAX_RECORDS)
_COUNTS: "collections.deque" = collections.deque(maxlen=MAX_RECORDS)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # kept also when the body raises
        _SPANS.append((self.name, self.t0, time.perf_counter_ns(),
                       threading.get_ident()))
        return False


def span(name: str):
    """A context manager that keeps the block's start and end while a
    profiler session runs; otherwise the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Keep ``n`` under ``name`` at this time while a profiler session
    runs."""
    if _profiler._is_profiler_enabled:
        _COUNTS.append((name, time.perf_counter_ns(), n,
                        threading.get_ident()))


def records(lo_ns: int = 0, hi_ns: int = 1 << 63) -> list:
    """The kept spans ``(name, t0_ns, t1_ns, thread_id)`` that overlap
    [lo_ns, hi_ns), unclipped, oldest first."""
    return [r for r in list(_SPANS) if r[2] > lo_ns and r[1] < hi_ns]


def counts(lo_ns: int = 0, hi_ns: int = 1 << 63) -> list:
    """The kept counts ``(name, t_ns, n, thread_id)`` taken in
    [lo_ns, hi_ns), oldest first."""
    return [r for r in list(_COUNTS) if lo_ns <= r[1] < hi_ns]


def clear() -> None:
    """Drop every kept span and count."""
    _SPANS.clear()
    _COUNTS.clear()
