"""The device trace of a window: ``torch.profiler`` with CUDA activity
only (no CPU operators, so tracing costs the host little), read from its
kineto events as (name, start ns, end ns) per device operation.

Busy time is the union of the device operations' intervals inside the
window, so operations that overlap on several streams count once.  The
device clock is tied to ``time.perf_counter_ns`` by a marker kernel
(``torch.cuda._sleep``) launched on an idle device just before the window
opens; the host spans of :mod:`.spans` then name what the host was doing
in each idle gap.
"""
from __future__ import annotations

import sys
import time

MARKER = "spin_kernel"
# idle gaps shorter than this are the launch gaps between kernels
SHORT_GAP_NS = 20_000


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def clip(intervals, lo: int, hi: int) -> list:
    return [(max(t0, lo), min(t1, hi)) for t0, t1 in intervals
            if t1 > lo and t0 < hi]


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.ops = []
        self.offset_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.clock_gap = time.time_ns() - time.perf_counter_ns()
        self.marker_host_ns = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            t0 = e.start_ns()
            ops.append((e.name(), t0, t0 + e.duration_ns()))
        markers = [op for op in ops if MARKER in op[0]]
        if markers:
            first = min(markers, key=lambda op: op[1])
            self.offset_ns = first[1] - self.marker_host_ns
            ops = [op for op in ops if op is not first]
        else:
            self.offset_ns = self.clock_gap
        print(f"trace: {len(ops)} device operations, clock tied by "
              f"{'the marker kernel' if markers else 'the wall clocks'}",
              file=sys.stderr)
        # on the host's perf_counter_ns clock from here on
        self.ops = [(n, t0 - self.offset_ns, t1 - self.offset_ns)
                    for n, t0, t1 in ops]
        self.prof = None

    def busy(self, lo_ns: int, hi_ns: int) -> list:
        key = (lo_ns, hi_ns, len(self.ops))
        if getattr(self, "_busy_key", None) != key:
            self._busy = union(clip([(t0, t1) for _, t0, t1 in self.ops],
                                    lo_ns, hi_ns))
            self._busy_key = key
        return self._busy

    def busy_s(self, lo_ns: int, hi_ns: int) -> float:
        return sum(t1 - t0 for t0, t1 in self.busy(lo_ns, hi_ns)) / 1e9

    def named(self, pattern, lo_ns: int, hi_ns: int) -> list:
        """(start, end) of the operations whose name matches the compiled
        regex ``pattern``, inside the window."""
        return [(t0, t1) for n, t0, t1 in self.ops
                if pattern.search(n) and t0 >= lo_ns and t1 <= hi_ns]

    def top_ops(self, lo_ns: int, hi_ns: int, k: int = 10) -> list:
        """The ``k`` operation names with the most device seconds."""
        total = {}
        for n, t0, t1 in self.ops:
            if t1 > lo_ns and t0 < hi_ns:
                key = n[:120]
                total[key] = total.get(key, 0) + min(t1, hi_ns) - max(
                    t0, lo_ns)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, s / 1e9] for n, s in top]

    def idle_gaps(self, lo_ns: int, hi_ns: int, spans, k: int = 10) -> list:
        """Idle seconds by what the host was doing (the host spans open at
        each gap's middle; gaps under 20 us are launch gaps), the ``k``
        largest."""
        busy = self.busy(lo_ns, hi_ns)
        edges = [lo_ns] + [t for iv in busy for t in iv] + [hi_ns]
        active = spans.labeler()
        total = {}
        for g0, g1 in zip(edges[::2], edges[1::2]):
            if g1 <= g0:
                continue
            if g1 - g0 < SHORT_GAP_NS:
                label = "launch gaps (< 20 us)"
            else:
                label = "+".join(active((g0 + g1) // 2)) or "other host"
            total[label] = total.get(label, 0) + g1 - g0
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[n, s / 1e9] for n, s in top]
