"""Share of the computed crop-batch slots that held a crop: the
program's ``seg.slots_used`` counts (crops in each submitted batch) over
its ``seg.slots_computed`` counts (the batch size of each), summed over
the segment stage's window, in percent."""
from portbench import program


def read(ctx):
    recs = program.counts(ctx)
    if not recs:
        return None
    used = sum(n for name, _, n, _ in recs if name == "seg.slots_used")
    computed = sum(n for name, _, n, _ in recs
                   if name == "seg.slots_computed")
    if not computed:
        return None
    return 100.0 * used / computed
