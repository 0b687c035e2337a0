"""Bilinear resizes of the frozen-graph detector backend and of the
SegFormer logits.

Counterpart of ``glomeruli_segmentation_tpu/ops/resize.py``:

- :func:`resize_bilinear_tf1_np`, the host (numpy) TF1 ``resize_bilinear``
  (align_corners=False: ``src = dst * src/dst``, no half-pixel shift), the
  sampling of the graph's own ``keep_aspect_ratio_resizer``.  It is the
  backend's default path; a verbatim copy, blend expression included.
- :func:`resize_bilinear_tf1` and :func:`resize_bilinear` (OpenCV
  INTER_LINEAR: ``src = (dst + 0.5) * scale - 0.5``), their torch forms for
  a (B, H, W, C) batch on the device.  The sample tables are computed on
  the batch's device in float64, as numpy computes them, so a call copies
  nothing from the host.  Rows are blended first, then columns, in float32.
- :func:`_linear_weights` and :func:`resize_bilinear_np`, verbatim copies
  of the JAX module's cv2-INTER_LINEAR tables and their host (numpy) twin:
  the SegFormer slide path samples its logits with those tables, and its
  per-crop path upsamples them on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def _tf1_linear_weights(src_size: int, dst_size: int):
    """TF1 ``resize_bilinear`` (align_corners=False) samples at
    ``src = dst * (src/dst)``: scale*i, no half-pixel shift."""
    scale = src_size / dst_size
    x = np.arange(dst_size, dtype=np.float64) * scale
    x = np.clip(x, 0.0, src_size - 1.0)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, src_size - 1)
    w = (x - lo).astype(np.float32)
    return lo, hi, w


def resize_bilinear_tf1_np(img: np.ndarray, out_h: int,
                           out_w: int) -> np.ndarray:
    """TF1 bilinear resize of one HWC or HW image on the host -> float32."""
    img = np.asarray(img, np.float32)
    ylo, yhi, wy = _tf1_linear_weights(img.shape[0], out_h)
    xlo, xhi, wx = _tf1_linear_weights(img.shape[1], out_w)
    if img.ndim == 3:
        wy = wy[:, None, None]
        wx = wx[None, :, None]
    else:
        wy = wy[:, None]
        wx = wx[None, :]
    rows = img[ylo] * (1.0 - wy) + img[yhi] * wy
    return rows[:, xlo] * (1.0 - wx) + rows[:, xhi] * wx


def _linear_weights(src_size: int, dst_size: int):
    """cv2 INTER_LINEAR (half-pixel) taps of one axis: lo, hi, weight."""
    scale = src_size / dst_size
    x = (np.arange(dst_size, dtype=np.float64) + 0.5) * scale - 0.5
    x = np.clip(x, 0.0, src_size - 1.0)
    lo = np.floor(x).astype(np.int32)
    hi = np.minimum(lo + 1, src_size - 1)
    w = (x - lo).astype(np.float32)
    return lo, hi, w


def resize_bilinear_np(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host (numpy) twin of :func:`resize_bilinear` for one HWC or HW image:
    the same half-pixel taps and the same float32 blend, rows then
    columns, so the two agree bit for bit."""
    img = np.asarray(img, np.float32)
    ylo, yhi, wy = _linear_weights(img.shape[0], out_h)
    xlo, xhi, wx = _linear_weights(img.shape[1], out_w)
    if img.ndim == 3:
        wy = wy[:, None, None]
        wx = wx[None, :, None]
    else:
        wy = wy[:, None]
        wx = wx[None, :]
    rows = img[ylo] * (np.float32(1.0) - wy) + img[yhi] * wy
    return rows[:, xlo] * (np.float32(1.0) - wx) + rows[:, xhi] * wx


def _taps(src_size: int, dst_size: int, half_pixel: bool,
          device) -> tuple:
    """(lo, hi, weight) of one axis on ``device``: float64 sample positions
    clipped to the source, as ``_tf1_linear_weights`` (or, with
    ``half_pixel``, the cv2 form) computes them."""
    scale = src_size / dst_size
    x = torch.arange(dst_size, dtype=torch.float64, device=device)
    x = (x + 0.5) * scale - 0.5 if half_pixel else x * scale
    x = torch.clamp(x, 0.0, src_size - 1.0)
    lo = torch.floor(x)
    w = (x - lo).float()
    lo = lo.long()
    return lo, torch.clamp_max(lo + 1, src_size - 1), w


def _resize(img: torch.Tensor, out_h: int, out_w: int,
            half_pixel: bool) -> torch.Tensor:
    if img.dim() != 4:
        raise ValueError(f"(B, H, W, C) expected, got {tuple(img.shape)}")
    img = img.float()
    ylo, yhi, wy = _taps(img.shape[1], out_h, half_pixel, img.device)
    xlo, xhi, wx = _taps(img.shape[2], out_w, half_pixel, img.device)
    wy = wy[:, None, None]
    wx = wx[None, :, None]
    rows = img[:, ylo] * (1.0 - wy) + img[:, yhi] * wy
    return rows[:, :, xlo] * (1.0 - wx) + rows[:, :, xhi] * wx


def resize_bilinear_tf1(img: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """TF1 ``tf.image.resize_bilinear`` (align_corners=False) of a
    (B, H, W, C) batch -> float32 (B, out_h, out_w, C), on its device."""
    return _resize(img, out_h, out_w, half_pixel=False)


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) of a (B, H, W, C) batch -> float32
    (B, out_h, out_w, C), on its device."""
    return _resize(img, out_h, out_w, half_pixel=True)
