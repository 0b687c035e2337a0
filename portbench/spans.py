"""Host spans recorded from the benchmark's own side of the program's
surface: a callable of the program (or of the benchmark's slide) wrapped
in place with a timer, each call kept as (name, start ns, end ns, thread)
on ``time.perf_counter_ns``'s clock.  Only a traced run records them."""
from __future__ import annotations

import bisect
import contextlib
import threading
import time


class Spans:
    def __init__(self):
        self.lock = threading.Lock()
        self.records = []
        self.patched = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self.lock:
                self.records.append((name, t0, t1, threading.get_ident()))

    def factory(self, name: str):
        """A no-argument context factory for ``name`` (a slide's
        ``on_read``)."""
        return lambda: self.span(name)

    def wrap(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)

        def timed(*args, **kwargs):
            with self.span(name):
                return orig(*args, **kwargs)

        self.patched.append((owner, attr, attr in vars(owner), orig))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, own, orig in reversed(self.patched):
            if own:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self.patched = []

    def total_s(self, name: str, lo_ns: int, hi_ns: int) -> float:
        """Seconds of ``name`` spans inside [lo_ns, hi_ns], summed over
        threads."""
        with self.lock:
            recs = list(self.records)
        return sum(max(0, min(t1, hi_ns) - max(t0, lo_ns))
                   for n, t0, t1, _ in recs if n == name) / 1e9

    def labeler(self):
        """A function of a time in ns -> the names of the spans open then,
        sorted, by a binary search per name."""
        with self.lock:
            recs = sorted(self.records, key=lambda r: r[1])
        names = {}
        for n, t0, t1, _ in recs:
            starts, ends = names.setdefault(n, ([], []))
            starts.append(t0)
            ends.append(max(t1, ends[-1]) if ends else t1)

        def active(t_ns: int) -> list:
            out = []
            for n, (starts, ends) in sorted(names.items()):
                i = bisect.bisect_right(starts, t_ns) - 1
                if i >= 0 and ends[i] > t_ns:
                    out.append(n)
            return out
        return active
