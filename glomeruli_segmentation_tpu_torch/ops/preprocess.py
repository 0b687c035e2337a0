"""Crop preprocessing for ESPNet inference: the cv2-exact bilinear resize of
a padded crop batch, the ragged flat crop transfer, and the nearest resize
of class maps back to crop size.

Counterpart of ``glomeruli_segmentation_tpu/ops/preprocess.py``.  The JAX
package vmaps its per-crop functions; here the batch dimension is written
out.  Bilinear resampling is affine in pixel values, so resizing raw pixels
and normalising after (as :mod:`..pipeline.fused` does) equals the
reference's normalise-then-resize up to float rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def _dynamic_linear_gather(img: torch.Tensor, src_size: torch.Tensor,
                           out_size: int, axis: int) -> torch.Tensor:
    """Bilinear gather along ``axis`` (1 = rows, 2 = columns) of a padded
    (B, H, W, C) batch whose per-crop valid extent is ``src_size`` (B,).

    OpenCV coordinate mapping: src = (dst + 0.5) * scale - 0.5, clipped to
    the valid extent, then floored.  Gathers the raw values and converts to
    float32 after, which is exact."""
    b = img.shape[0]
    src = src_size.to(img.device, torch.float32)[:, None]          # (B, 1)
    scale = src / out_size
    x = (torch.arange(out_size, dtype=torch.float32,
                      device=img.device)[None] + 0.5) * scale - 0.5
    x = torch.minimum(torch.clamp_min(x, 0.0), src - 1.0)
    lo = torch.floor(x).long()
    hi = torch.minimum(lo + 1, src_size.to(img.device).long()[:, None] - 1)
    w = x - lo.float()
    batch = torch.arange(b, device=img.device)[:, None]
    if axis == 1:
        a, c = img[batch, lo], img[batch, hi]                     # (B, out, W, C)
        w = w[:, :, None, None]
    else:
        a, c = img[batch, :, lo], img[batch, :, hi]               # (B, out, H, C)
        a, c = a.transpose(1, 2), c.transpose(1, 2)
        w = w[:, None, :, None]
    return a.float() * (1 - w) + c.float() * w


def resize_bilinear_dynamic(img: torch.Tensor, src_h: torch.Tensor,
                            src_w: torch.Tensor, out_h: int,
                            out_w: int) -> torch.Tensor:
    """cv2 INTER_LINEAR resize of a padded (B, maxH, maxW, C) batch whose
    valid extents are ``src_h``/``src_w`` (B,) -> (B, out_h, out_w, C)
    float32."""
    img = _dynamic_linear_gather(img, src_h, out_h, axis=1)
    return _dynamic_linear_gather(img, src_w, out_w, axis=2)


def unflatten_crops(flat: torch.Tensor, offsets: torch.Tensor,
                    heights: torch.Tensor, widths: torch.Tensor,
                    max_h: int, max_w: int) -> torch.Tensor:
    """Rebuild a padded (B, max_h, max_w, 3) uint8 crop batch from the
    ragged flat buffer of :func:`pack_crops_flat`.

    Row ``r`` of crop ``i`` is the ``max_w * 3`` bytes starting at
    ``offsets[i] + min(r, h_i - 1) * w_i * 3``, its start clamped to
    ``len(flat) - max_w * 3`` as XLA's ``dynamic_slice`` clamps it.  Rows
    past a crop's height repeat its last row and bytes past a row's width
    are the next row's: neither is read by :func:`resize_bilinear_dynamic`.
    The rows are one gather over a strided view, no per-byte index."""
    maxw3 = max_w * 3
    rows = flat.unfold(0, maxw3, 1)               # (len - maxw3 + 1, maxw3)
    r = torch.arange(max_h, device=flat.device)[None]
    h = heights.to(flat.device).long()[:, None]
    w3 = widths.to(flat.device).long()[:, None] * 3
    starts = offsets.to(flat.device).long()[:, None] + \
        torch.minimum(r, h - 1) * w3
    starts = starts.clamp(0, flat.shape[0] - maxw3)
    return rows[starts].reshape(-1, max_h, max_w, 3)


# The JAX package addresses the flat buffer with int32 device offsets; the
# port keeps the same limit so both stage the same batches the same way.
FLAT_OFFSET_LIMIT = 2**31 - 1


def flat_bytes_needed(crops, max_w: int = 0) -> int:
    """Bytes a flat transfer of ``crops`` addresses (content + row slack)."""
    pos = sum(c.shape[0] * c.shape[1] * 3 for c in crops)
    slack = max(max(int(c.shape[1]) for c in crops), max_w) * 3
    return pos + slack


def flat_quantum(batch_size: int, max_h: int, max_w: int,
                 bucket_bytes: int = 1 << 21) -> int:
    """Flat-buffer length quantum: one eighth of the padded batch bytes
    when the padded shape is given, else ``bucket_bytes``."""
    if max_h and max_w:
        return max(1, batch_size * max_h * max_w * 3 // 8)
    return bucket_bytes


def pack_crops_flat(crops, batch_size: int, max_w: int = 0, max_h: int = 0,
                    bucket_bytes: int = 1 << 21):
    """Pack ragged HWC uint8 crops into one flat transfer buffer.

    Returns ``(flat, offsets, heights, widths)``: ``flat`` holds each crop's
    bytes back to back, its length rounded up to :func:`flat_quantum` plus
    ``max(max_w, widest crop) * 3`` slack bytes, so that no valid row of
    :func:`unflatten_crops` is clamped.  Empty batch slots get offset 0 and
    size 1x1.  Raises if the buffer would pass :data:`FLAT_OFFSET_LIMIT`.
    """
    n = len(crops)
    offsets = np.zeros(batch_size, np.int64)
    heights = np.ones(batch_size, np.int32)
    widths = np.ones(batch_size, np.int32)
    pos = 0
    for i, c in enumerate(crops):
        offsets[i] = pos
        heights[i], widths[i] = c.shape[:2]
        pos += c.shape[0] * c.shape[1] * 3
    slack = max(int(widths.max()), max_w) * 3
    if pos + slack > FLAT_OFFSET_LIMIT:
        raise ValueError(
            f"flat crop buffer needs {pos + slack} bytes, over the int32 "
            "device-offset limit; stage this batch in the padded layout")
    quantum = flat_quantum(batch_size, max_h, max_w, bucket_bytes)
    total = -(-(pos + slack) // quantum) * quantum
    total = min(total, FLAT_OFFSET_LIMIT)
    flat = np.zeros(total, np.uint8)
    for i, c in enumerate(crops[:n]):
        copy_pixels(flat[offsets[i]: offsets[i] + c.size].reshape(c.shape), c)
    return flat, offsets.astype(np.int32), heights, widths


def copy_pixels(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` for (H, W, C) images.  A view with reversed
    channels (the BGR view of an RGB read) goes one channel at a time:
    numpy copies it whole pixel by pixel, a 3-element inner loop, several
    times slower than three strided passes."""
    if src.flags.c_contiguous:
        dst[...] = src
        return
    for ch in range(src.shape[-1]):
        dst[..., ch] = src[..., ch]


def postprocess_nearest_host(class_map: np.ndarray, out_h: int,
                             out_w: int) -> np.ndarray:
    """cv2 INTER_NEAREST resize of the argmax map back to crop size (host)."""
    h, w = class_map.shape
    ys = np.minimum(np.floor(np.arange(out_h) * (h / out_h)).astype(np.intp), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (w / out_w)).astype(np.intp), w - 1)
    return class_map[np.ix_(ys, xs)]
