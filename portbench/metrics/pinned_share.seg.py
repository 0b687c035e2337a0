"""Share of the crop bytes staged in the segment stage's window that the
producer wrote straight into pinned host memory, the memory the
host-to-device copy reads: the program's ``seg.pinned_bytes`` counts over
its ``seg.staged_bytes`` counts, summed over the window, in percent.
None where the program counts no staged bytes."""
from portbench import program


def read(ctx):
    recs = program.counts(ctx)
    if not recs:
        return None
    staged = sum(n for name, _, n, _ in recs if name == "seg.staged_bytes")
    if not staged:
        return None
    pinned = sum(n for name, _, n, _ in recs if name == "seg.pinned_bytes")
    return 100.0 * pinned / staged
