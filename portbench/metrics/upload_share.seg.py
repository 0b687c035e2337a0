"""Share of the segment stage's window spent in the consumer's uploads of a
batch: the pinned copies and the host-to-device enqueues: the program's
``seg.upload`` spans clipped to the window, summed over threads, in
percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.upload")
