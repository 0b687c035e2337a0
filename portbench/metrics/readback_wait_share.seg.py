"""Share of the segment stage's window spent in the consumer's waits for a
batch's result on the host, measured inside the program (the twin of
``result_wait_share.seg``): the program's ``seg.result_wait`` spans
clipped to the window, summed over threads, in percent."""
from portbench import program


def read(ctx):
    return program.share(ctx, "seg.result_wait")
