"""Share of the segment stage's window spent in the consumer's paste of a
batch's maps into the slide canvas: the program's ``seg.paste`` spans
clipped to the window, summed over threads, in percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.paste")
