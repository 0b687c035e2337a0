"""The program's own spans and counters in a run's window.

The port keeps them in ``glomeruli_segmentation_tpu_torch.utils.timing``
while a ``torch.profiler`` session runs, so a traced run has them: spans
``(name, t0_ns, t1_ns, thread)`` and counts ``(name, t_ns, n, thread)`` on
``time.perf_counter_ns``, the clock :mod:`.trace` ties the device to.
A program without that recorder has none, and every function here then
returns None.
"""
from __future__ import annotations


def _recorder():
    try:
        from glomeruli_segmentation_tpu_torch.utils import timing
    except ImportError:
        return None
    if not hasattr(timing, "records") or not hasattr(timing, "counts"):
        return None
    return timing


def spans(ctx):
    """The program's spans, clipped to ``ctx["window_ns"]``, or None where
    the program keeps none."""
    rec = _recorder()
    if rec is None or ctx.get("stage") != "segment":
        return None
    lo, hi = ctx["window_ns"]
    return [(n, max(t0, lo), min(t1, hi), tid)
            for n, t0, t1, tid in rec.records(lo, hi)]


def counts(ctx):
    """The program's counts taken in ``ctx["window_ns"]``, or None."""
    rec = _recorder()
    if rec is None or ctx.get("stage") != "segment":
        return None
    return rec.counts(*ctx["window_ns"])


def share(ctx, name: str):
    """Seconds of ``name`` spans in the window, summed over threads, as a
    percentage of the window; None where the window holds none."""
    recs = spans(ctx)
    if not recs:
        return None
    mine = [t1 - t0 for n, t0, t1, _ in recs if n == name]
    if not mine:
        return None
    return 100.0 * sum(mine) / 1e9 / ctx["window_s"]

