"""Kernel K1 (the fused ESP block, ``esp_reduce`` then ``esp_branch``)
against its roofline: its launches in the window times the least time of
one launch at the level-3 shape (crop batch, H/8, W/8, 128), over its
traced device time, in percent."""
import re

from portbench.roofline import bound_s, esp_block, peak_flops

REDUCE = re.compile(r"esp_reduce")
BOTH = re.compile(r"esp_(reduce|branch)")
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(ctx):
    if ctx.get("trace") is None or "in_height" not in ctx["config"]:
        return None
    lo, hi = ctx["window_ns"]
    launches = len(ctx["trace"].named(REDUCE, lo, hi))
    device_ns = sum(t1 - t0 for t0, t1 in ctx["trace"].named(BOTH, lo, hi))
    if not launches or not device_ns:
        return None
    cfg = ctx["config"]
    work = esp_block(cfg["crop_batch"], cfg["in_height"] // 8,
                     cfg["in_width"] // 8, 128,
                     DTYPE_BYTES[cfg["compute_dtype"]])
    one = bound_s(work["bytes"], work["ops"],
                  peak_flops(cfg["compute_dtype"]))
    return 100.0 * launches * one / (device_ns / 1e9)
