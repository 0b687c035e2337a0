"""Share of the segment stage's window spent in the consumer's waits for
the producer's next staged batch (``staged``): the program's
``seg.stage_wait`` spans clipped to the window, summed over threads, in
percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.stage_wait")
