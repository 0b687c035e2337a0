"""The segment stage's whole model step against the card's peak while the
card is busy: crops done in the traced window times the reference's
operations per crop at the cell's shapes, over the device's busy time in
that window (the union of the traced operations' intervals) and the peak
of the configuration's compute type, in percent."""
from portbench.roofline import peak_flops


def read(ctx):
    if ctx.get("stage") != "segment" or not ctx.get("crops") \
            or ctx.get("trace") is None:
        return None
    lo, hi = ctx["window_ns"]
    busy_s = ctx["trace"].busy_s(lo, hi)
    if not busy_s:
        return None
    cfg = ctx["config"]
    peak = peak_flops(cfg["compute_dtype"], cfg.get("precision") == "default"
                      and cfg["compute_dtype"] == "float32")
    return 100.0 * ctx["crops"] * ctx["flops_per_crop"] / busy_s / peak
