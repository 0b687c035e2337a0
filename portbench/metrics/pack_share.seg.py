"""Share of the segment stage's window spent in the producer thread's
packing of a batch after its reads: bucketing, the flat or padded copy
or the host cv2 resize, and the /8 tables: the program's ``seg.pack``
spans clipped to the window, summed over threads, in percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.pack")
