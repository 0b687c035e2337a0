"""Share of the device's idle time in the segment stage's window that the
program's spans leave unexplained: of the idle gaps of at least 20 us
(shorter ones are launch gaps), the part during which no ``seg.*`` span of
the slide loop's consumer thread was open, in percent of those gaps."""
from portbench import program
from portbench.trace import SHORT_GAP_NS, union


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    if ctx.get("trace") is None:
        return None
    recs = program.spans(ctx)
    if not recs:
        return None
    # the consumer is the thread that launches the batches
    consumers = {tid for n, _, _, tid in recs if n == "seg.launch"}
    covered = union([(t0, t1) for n, t0, t1, tid in recs
                     if tid in consumers and n.startswith("seg.")])
    if not covered:
        return None
    lo, hi = ctx["window_ns"]
    busy = ctx["trace"].busy(lo, hi)
    if not busy:
        return None
    edges = [lo] + [t for iv in busy for t in iv] + [hi]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2])
            if g1 - g0 >= SHORT_GAP_NS]
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if not idle:
        return None
    return 100.0 * (idle - overlap_ns(gaps, covered)) / idle
