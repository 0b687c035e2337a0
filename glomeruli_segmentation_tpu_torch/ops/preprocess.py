"""Crop preprocessing for ESPNet inference: the reference-exact cv2 path
(:func:`preprocess_host`), the cv2-exact bilinear resize of a padded crop
batch and the fused resize and normalise built on it
(:func:`preprocess_batch_device`), the ragged flat crop transfer, the
base-``classes`` packing of class maps for their readback
(:func:`pack_classmap`, exactly undone on the host by
:func:`unpack_classmap`), and the nearest resize of class maps back to crop
size.

Counterpart of ``glomeruli_segmentation_tpu/ops/preprocess.py``.  The JAX
package vmaps its per-crop functions; here the batch dimension is written
out.  Bilinear resampling is affine in pixel values, so resizing raw pixels
and normalising after (as :mod:`..pipeline.fused` does) equals the
reference's normalise-then-resize up to float rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def preprocess_host(img_bgr: np.ndarray, mean, std, width: int = 1024,
                    height: int = 512) -> np.ndarray:
    """Reference-exact preprocessing (``VisualizeResults_iou.py:103-119``):
    subtract the BGR mean, divide by the std, ``cv2.resize`` to (width,
    height), divide by 255.  Returns (H, W, 3) float32 (NHWC order)."""
    import cv2

    img = img_bgr.astype(np.float32)
    for j in range(3):
        img[:, :, j] -= mean[j]
    for j in range(3):
        img[:, :, j] /= std[j]
    img = cv2.resize(img, (width, height))
    img /= 255.0
    return img


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


def preprocess_batch_device(padded: torch.Tensor, heights: torch.Tensor,
                            widths: torch.Tensor, mean_std: torch.Tensor,
                            out_h: int = 512,
                            out_w: int = 1024) -> torch.Tensor:
    """Fused resize and normalise of a batch of padded BGR uint8 crops, on
    their device: ``padded`` (B, maxH, maxW, 3) with the valid region
    top-left, ``heights``/``widths`` (B,) the valid extents, ``mean_std``
    (2, 3) float32 whose rows are the BGR mean and std.  Returns the
    (B, out_h, out_w, 3) float32 network input: the raw pixels resized,
    then ``(x - mean) / std / 255``, which equals :func:`preprocess_host`
    up to float rounding."""
    resized = resize_bilinear_dynamic(padded, heights, widths, out_h, out_w)
    return (resized - mean_std[0]) / mean_std[1] / 255.0


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
                    bucket_bytes: int = 1 << 21, pin_memory: bool = False):
    """Pack ragged HWC uint8 crops into one flat transfer buffer.

    Returns ``(flat, offsets, heights, widths)``: ``flat`` holds each crop's
    bytes back to back, its length rounded up to :func:`flat_quantum` plus
    ``max(max_w, widest crop) * 3`` slack bytes, so that no valid row of
    :func:`unflatten_crops` is clamped; the bytes past the crops are zero.
    Empty batch slots get offset 0 and size 1x1.  Raises if the buffer
    would pass :data:`FLAT_OFFSET_LIMIT`.

    ``flat`` is a numpy array, or with ``pin_memory`` a uint8 tensor in
    pinned memory from torch's host allocator: the crops are then written
    once, into the memory the host-to-device copy reads, and the upload
    makes no staging copy.  Pass that tensor itself to the upload, not a
    numpy view of it: the allocator keeps the block from reuse until the
    copies enqueued from the tensor have run.
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
    if pin_memory:
        flat = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        buf = flat.numpy()
    else:
        flat = buf = np.empty(total, np.uint8)
    # each byte is written once: the crops fill [0, pos), the rest is zeroed
    buf[pos:] = 0
    for i, c in enumerate(crops[:n]):
        copy_pixels(buf[offsets[i]: offsets[i] + c.size].reshape(c.shape), c)
    return flat, offsets.astype(np.int32), heights, widths


def _packed_pixels(a: np.ndarray) -> bool:
    """Whether ``a`` is an (H, W, 3) uint8 image whose rows are runs of
    whole pixels, the layout a ``cv::Mat`` has (a row step of its own)."""
    return (a.ndim == 3 and a.shape[2] == 3 and a.dtype == np.uint8
            and a.strides[1:] == (3, 1) and a.strides[0] >= 3 * a.shape[1])


def copy_pixels(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` for (H, W, C) images.  A view with reversed
    channels whose reversal has packed rows (the BGR view of an RGB read,
    or of a window of one) goes in one pass, cv2's channel swap written
    straight into ``dst`` where ``dst`` has packed rows too.  Any other
    view goes one channel at a time: numpy copies it whole pixel by pixel,
    a 3-element inner loop, several times slower than three strided
    passes."""
    if src.flags.c_contiguous:
        dst[...] = src
        return
    rgb = src[:, :, ::-1]
    if _packed_pixels(rgb) and _packed_pixels(dst):
        import cv2

        # cv2 may hand back a new array instead of writing into dst
        out = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR, dst=dst)
        if np.may_share_memory(out, dst):
            return
    for ch in range(src.shape[-1]):
        dst[..., ch] = src[..., ch]


def classmap_pack_width(classes: int) -> int:
    """Pixels per byte for base-``classes`` class-map packing: the largest
    ``k`` with ``classes ** k <= 256`` (3 at 5 classes); 1 (no packing)
    above 16 classes."""
    if classes < 2:  # degenerate map; 1**k/0**k never exceed 256
        return 1
    k = 1
    while classes ** (k + 1) <= 256:
        k += 1
    return k


def pack_classmap(maps: torch.Tensor, classes: int) -> torch.Tensor:
    """(B, H, W) uint8 class maps -> (B, H, ceil(W/k)) base-``classes``
    packed bytes, on their device (the exact inverse is
    :func:`unpack_classmap`).

    The digit layout is the JAX package's, chunked: with chunk =
    ceil(W/k), byte ``j`` holds pixels ``j, j + chunk, j + 2 chunk, ...``
    as digits 0..k-1.  The zero pad pixels of a width that k does not
    divide land in the tail of the last digit and are dropped on unpack."""
    k = classmap_pack_width(classes)
    if k == 1:
        return maps
    w = maps.shape[-1]
    chunk = -(-w // k)
    m = torch.nn.functional.pad(maps, (0, chunk * k - w)).to(torch.uint8)
    packed = m[..., :chunk].clone()
    for i in range(1, k):
        # uint8 arithmetic wraps as the JAX package's does; the sum of the
        # digits never passes classes ** k - 1 <= 255
        packed += m[..., i * chunk: (i + 1) * chunk] * (classes ** i)
    return packed


def unpack_classmap(packed: np.ndarray, classes: int, w: int) -> np.ndarray:
    """Host inverse of :func:`pack_classmap`: digit ``i`` of each byte is
    pixels ``[i * chunk, (i + 1) * chunk)``, recovered with one 256-entry
    lookup table per digit."""
    k = classmap_pack_width(classes)
    if k == 1:
        return packed[..., :w]
    chunk = packed.shape[-1]
    vals = np.arange(256)
    out = np.empty(packed.shape[:-1] + (chunk * k,), np.uint8)
    for i in range(k):
        lut = (vals // classes ** i % classes).astype(np.uint8)
        out[..., i * chunk: (i + 1) * chunk] = lut[packed]
    return out[..., :w]


def maybe_pack(maps: torch.Tensor, classes: int,
               enabled: bool) -> torch.Tensor:
    """:func:`pack_classmap` when ``enabled`` (device side), the one
    flag-and-classes contract of ``EnsembleSegmenter`` and
    ``EspnetSegmenter``."""
    return pack_classmap(maps, classes) if enabled else maps


def read_packed(maps: np.ndarray, classes: int, w: int,
                enabled: bool) -> np.ndarray:
    """Host class maps read back from a :func:`maybe_pack` result under the
    same flag -> (..., H, ``w``) uint8."""
    return unpack_classmap(maps, classes, w) if enabled else maps


def postprocess_nearest_host(class_map: np.ndarray, out_h: int,
                             out_w: int) -> np.ndarray:
    """cv2 INTER_NEAREST resize of the argmax map back to crop size (host)."""
    h, w = class_map.shape
    ys = np.minimum(np.floor(np.arange(out_h) * (h / out_h)).astype(np.intp), h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (w / out_w)).astype(np.intp), w - 1)
    return class_map[np.ix_(ys, xs)]
