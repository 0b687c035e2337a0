"""Share of the segment stage's window in which no operation ran on the
device: 1 - (union of the traced device operations' intervals) / window,
in percent."""


def read(ctx):
    if ctx.get("stage") != "segment" or ctx.get("trace") is None:
        return None
    lo, hi = ctx["window_ns"]
    if not ctx["trace"].busy(lo, hi):
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s(lo, hi) / ctx["window_s"])
