"""OpenCV's sampling rules, as the references use them."""
from __future__ import annotations

import numpy as np
import torch


def nearest(out_n: int, src_n: int) -> np.ndarray:
    """INTER_NEAREST: the source index of each of ``out_n`` outputs,
    ``floor(i * src_n / out_n)`` in float64 as OpenCV computes it."""
    return np.minimum(np.floor(np.arange(out_n) * (src_n / max(out_n, 1)))
                      .astype(np.int64), src_n - 1)


def linear_taps(src_n: int, out_n: int, at: np.ndarray, device):
    """INTER_LINEAR (half-pixel, clamped edges; ``F.interpolate`` with
    ``align_corners=False`` when upsampling): the two source indices and
    the weight of the second, for the outputs ``at`` of an ``src_n`` ->
    ``out_n`` resize."""
    x = (torch.from_numpy(np.asarray(at)).to(device, torch.float64) + 0.5) \
        * (src_n / out_n) - 0.5
    x = x.clamp(0.0, src_n - 1.0)
    lo = x.floor().long()
    return lo, torch.clamp_max(lo + 1, src_n - 1), x - lo
