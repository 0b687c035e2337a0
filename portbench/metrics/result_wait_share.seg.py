"""Share of the window in which the segment stage's slide loop waited
for a batch's result on the host (``EnsembleSegmenter.read_gathered``;
``fused_segformer.read_host``), from the benchmark's spans around those
calls, in percent."""


def read(ctx):
    if ctx.get("stage") != "segment" or ctx.get("spans") is None:
        return None
    lo, hi = ctx["window_ns"]
    return 100.0 * ctx["spans"].total_s("result_wait", lo, hi) \
        / ctx["window_s"]
