"""The yardstick's peaks and the operations and bytes of the kernels.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit.  ``float32`` is the rate outside the tensor cores, the
one a float32 program with TF32 off can reach.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 494.5e12,
              "float32": 67e12}


def peak_flops(compute_dtype: str, tf32: bool = False) -> float:
    if compute_dtype == "float32" and tf32:
        return PEAK_FLOPS["tf32"]
    return PEAK_FLOPS[compute_dtype]


def esp_block(batch: int, height: int, width: int, channels: int,
              dtype_bytes: int) -> dict:
    """One ESP residual block (kernel K1) over a (batch, height, width,
    channels) map: a 1x1 reduce to n = C // 5, then five dilated 3x3
    branches to n1 + 4n = C outputs, the BN, PReLU and residual folded in.
    Each input byte is read once, each output byte written once, the
    weights once, and the per-channel scale, bias and slope in float32."""
    n = channels // 5
    pixels = batch * height * width
    w1 = channels * n
    wd = 9 * n * channels
    nbytes = (2 * pixels * channels + w1 + wd) * dtype_bytes \
        + 3 * channels * 4
    ops = 2 * pixels * (w1 + wd)
    return {"bytes": nbytes, "ops": ops}


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """The least time the chip could take: bytes over the HBM rate or
    operations over the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)
