"""ROI feature cropping with TF ``crop_and_resize`` semantics.

Counterpart of ``glomeruli_segmentation_tpu/ops/roi_align.py``: both its
``crop_and_resize`` (gathers) and ``crop_and_resize_matmul`` (two-tap
matrices on the TPU's matrix unit) compute this function.  Bilinear samples
on a ``crop x crop`` grid whose corner samples sit exactly on the
normalized box corners (endpoint-aligned).  On the GPU a gather of the four
neighbours is the direct form; the rows are interpolated first and the
columns second, as in the JAX package.
"""
from __future__ import annotations

import torch


def _taps(q: torch.Tensor, size: int):
    """Sample positions -> (lower index, upper index, fraction), clamped to
    the map like the JAX package's two-tap rows."""
    q = torch.clamp(q, 0.0, size - 1.0)
    lo = torch.floor(q)
    frac = q - lo
    lo = lo.long()
    return lo, torch.clamp_max(lo + 1, size - 1), frac


def crop_and_resize(features: torch.Tensor, boxes: torch.Tensor,
                    crop_size: int) -> torch.Tensor:
    """Crop normalized boxes from a batch of feature maps.

    Args:
      features: (B, H, W, C), the JAX package's layout (a channels_last NCHW
        tensor's ``permute(0, 2, 3, 1)`` is such a view, without a copy)
      boxes: (B, N, 4) float32 normalized [ymin, xmin, ymax, xmax]
      crop_size: output size S (>= 2)
    Returns (B, N, S, S, C) in the features' type.  The sample grid is
    computed in float32; the interpolation in the features' type.
    """
    b, h, w, c = features.shape
    s = crop_size
    dev = features.device
    t = torch.arange(s, dtype=torch.float32, device=dev) / (s - 1)
    y1, x1, y2, x2 = boxes.float().unbind(-1)          # (B, N)
    # the JAX matmul form's association: y1*(h-1) + t * ((y2-y1)*(h-1))
    ys = (y1 * (h - 1))[..., None] + t * ((y2 - y1) * (h - 1))[..., None]
    xs = (x1 * (w - 1))[..., None] + t * ((x2 - x1) * (w - 1))[..., None]
    y_lo, y_hi, wy = _taps(ys, h)                       # (B, N, S)
    x_lo, x_hi, wx = _taps(xs, w)
    wy = wy.to(features.dtype)[..., :, None, None]      # (B, N, S, 1, 1)
    wx = wx.to(features.dtype)[..., None, :, None]      # (B, N, 1, S, 1)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    rows_lo, rows_hi = y_lo[..., :, None], y_hi[..., :, None]
    cols_lo, cols_hi = x_lo[..., None, :], x_hi[..., None, :]
    # rows first, at both column taps, then the columns
    left = features[bi, rows_lo, cols_lo] * (1 - wy) + \
        features[bi, rows_hi, cols_lo] * wy
    right = features[bi, rows_lo, cols_hi] * (1 - wy) + \
        features[bi, rows_hi, cols_hi] * wy
    return left * (1 - wx) + right * wx
