"""Share of the segment stage's window spent in the consumer's enqueue of a
batch's forward and its readback: the program's ``seg.launch`` spans
clipped to the window, summed over threads, in percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.launch")
