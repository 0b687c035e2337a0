"""Share of the segment stage's window spent in the producer thread's crop
reads (``slide.read_region_array``): the program's ``seg.read`` spans
clipped to the window, summed over threads, in percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.read")
