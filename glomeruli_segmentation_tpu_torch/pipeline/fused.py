"""Slide segmentation on the GPU: crops -> 5-fold ESPNet ensemble -> /8
slide canvas.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/fused.py``, with two
engines:

- ``fused``: a loop over folds, each a :class:`..models.espnet_fused.
  FusedESPNet`.  Each fold normalises the resized crops with its own BGR
  mean/std, fold softmaxes are summed in ``accum_dtype`` in fold order, and
  the argmax takes the first class on ties.
- ``packed``: :class:`..models.espnet_packed.PackedEnsembleESPNet`, all
  folds in one block-diagonal forward, with the same softmax sum and
  argmax.  Its gather entry points gather the decoder features before the
  classifier upconv, so the full-resolution logits are never formed.

``auto`` picks ``packed`` below batch 96 and ``fused`` at or above it, as
the JAX package does.  Both engines run level 3 through the fused ESP block
kernel (K1) below batch 96.  The /8 nearest gather for the slide stitch
runs on the device, so only (B, oh, ow) bytes come back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..convert.espnet_import import load_espnet_state_dict
from ..models.espnet_fused import FusedESPNet
from ..models.espnet_packed import PackedEnsembleESPNet
from ..ops.preprocess import (FLAT_OFFSET_LIMIT, copy_pixels,
                              flat_bytes_needed, pack_crops_flat,
                              postprocess_nearest_host,
                              resize_bilinear_dynamic, unflatten_crops)

log = logging.getLogger(__name__)

# fold -> (BGR mean, BGR std), reference README.md:243-249
FOLD_NORMALIZATION = {
    1: ((204.60071, 170.19359, 199.57469), (20.61257, 42.92207, 28.401505)),
    2: ((202.38148, 167.13171, 198.10599), (20.704079, 42.958416, 28.366297)),
    3: ((203.12099, 167.813, 198.50894), (21.038654, 43.769535, 29.034416)),
    4: ((203.66399, 167.94217, 198.58081), (20.96783, 43.556736, 28.838718)),
    5: ((204.49896, 169.03307, 199.22058), (20.547842, 42.86628, 27.966227)),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class EnsembleConfig:
    checkpoints: Sequence[str]
    folds: Sequence[int] = (1, 2, 3, 4, 5)
    classes: int = 5
    p: int = 2
    q: int = 8
    in_height: int = 512
    in_width: int = 1024
    batch_size: int = 8
    compute_dtype: str = "bfloat16"
    # "highest": float32 convs and matmuls in full float32 (TF32 off), the
    # parity mode -- the checkpoints' BN variances of ~1e-6 amplify operand
    # truncation ~30x.  "default": TF32 on for both.
    precision: str = "default"
    # dtype of the fold-probability softmax + accumulator; a bf16
    # accumulator can flip the argmax at near-ties
    accum_dtype: str = "float32"
    # base-`classes` packing of the full-resolution readback: not ported
    pack_output: bool = False


def pack_tables(tables: Sequence[np.ndarray]):
    """int32 arrays -> (one flat int32 buffer, their shapes), so a batch's
    small tables are uploaded with one copy."""
    buf = np.concatenate([np.asarray(t, np.int32).reshape(-1)
                          for t in tables])
    return buf, [np.shape(t) for t in tables]


def unpack_tables(buf: torch.Tensor, shapes) -> List[torch.Tensor]:
    """The inverse of :func:`pack_tables` on the buffer's device: views of
    ``buf``, no copy."""
    sizes = [int(np.prod(s)) for s in shapes]
    return [part.view(s) for part, s in zip(buf.split(sizes), shapes)]


@contextlib.contextmanager
def _tf32(allow: bool):
    """Set both TF32 switches for the duration of a forward, then restore."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class EnsembleSegmenter:
    """Fold ensemble over raw padded BGR crops -> summed-softmax class maps.

    ``engine`` is ``"fused"``, ``"packed"`` or ``"auto"`` (``"packed"``
    below batch 96, ``"fused"`` from it on).  The default stays ``"fused"``
    because the JAX constructor's default, the ``xla`` fold-vmap engine, is
    not ported.  ``fuse_level3`` defaults to ``batch_size < 96``, as in the
    JAX package; pass False to run level 3 through plain torch ops instead
    of K1.  ``fuse_level2`` (packed engine only, off by default as the JAX
    package's ``level2="xla"``) runs the packed level 2 through K2.
    """

    def __init__(self, config: EnsembleConfig, engine: str = "fused",
                 device="cuda", fuse_level3: Optional[bool] = None,
                 fuse_level2: bool = False):
        if engine == "auto":
            engine = "packed" if config.batch_size < 96 else "fused"
        if engine not in ("fused", "packed"):
            raise ValueError(f"engine {engine!r} is not ported; use "
                             f"'fused', 'packed' or 'auto'")
        if fuse_level2 and engine != "packed":
            raise ValueError("fuse_level2 applies to the packed engine only")
        if config.pack_output:
            raise ValueError("pack_output is not ported")
        if config.precision not in ("default", "highest"):
            raise ValueError(f"unknown precision {config.precision!r}")
        if not config.checkpoints or \
                len(config.checkpoints) != len(config.folds):
            raise ValueError(f"{len(config.checkpoints)} checkpoints for "
                             f"folds {tuple(config.folds)}")
        self.config = config
        self.engine = engine
        self.device = resolve_device(device)
        self.compute_dtype = _DTYPES[config.compute_dtype]
        self.accum_dtype = _DTYPES[config.accum_dtype]
        self.allow_tf32 = config.precision == "default"
        log.info("precision=%s: cudnn.allow_tf32 and cuda.matmul.allow_tf32 "
                 "are %s during the forward", config.precision,
                 self.allow_tf32)
        if fuse_level3 is None:
            fuse_level3 = config.batch_size < 96
        self.fuse_level3 = fuse_level3
        self.fuse_level2 = fuse_level2
        state_dicts = [load_espnet_state_dict(ckpt)
                       for ckpt in config.checkpoints]
        means = [FOLD_NORMALIZATION[f][0] for f in config.folds]
        stds = [FOLD_NORMALIZATION[f][1] for f in config.folds]
        self.nets = self._packed = None
        if engine == "packed":
            self._packed = PackedEnsembleESPNet(
                state_dicts, means, stds, fuse_level3=fuse_level3,
                fuse_level2=fuse_level2, dtype=self.compute_dtype,
                accum_dtype=self.accum_dtype, device=self.device)
        else:
            self.nets = [FusedESPNet(sd, fuse_level3=fuse_level3,
                                     dtype=self.compute_dtype,
                                     device=self.device)
                         for sd in state_dicts]
        self.mean = torch.tensor(means, dtype=torch.float32,
                                 device=self.device)   # (F, 3) BGR
        self.std = torch.tensor(stds, dtype=torch.float32, device=self.device)

    def _upload(self, data: np.ndarray, *tables: np.ndarray):
        """``data`` (the crop bytes) and the int32 ``tables`` as tensors on
        the device.  On a card the tables go up as one buffer, split on the
        device, and both copies are made from pinned memory without waiting
        for the device, so batch N+1 is uploaded and launched while batch N
        runs.  The pinned buffers come from torch's host allocator, which
        reuses none before the copy that reads it has run.  On the CPU
        these are views of the arrays."""
        if self.device.type != "cuda":
            return [torch.from_numpy(np.ascontiguousarray(a))
                    for a in (data,) + tables]
        buf, shapes = pack_tables(tables)
        data, buf = (torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                     .to(self.device, non_blocking=True) for a in (data, buf))
        return [data, *unpack_tables(buf, shapes)]

    def _resize_batch(self, padded, heights, widths) -> torch.Tensor:
        cfg = self.config
        return resize_bilinear_dynamic(padded, heights, widths,
                                       cfg.in_height, cfg.in_width)

    @torch.no_grad()
    def _fold_argmax(self, resized: torch.Tensor) -> torch.Tensor:
        """(B, in_h, in_w, 3) float32 BGR -> (B, in_h, in_w) uint8."""
        if self._packed is not None:
            # normalises per fold itself, from the float32 crops
            with _tf32(self.allow_tf32):
                return self._packed(resized)
        acc_f32 = self.accum_dtype == torch.float32
        # the bf16 path reads the resized batch once per fold: keep it bf16
        resized = resized.to(self.compute_dtype)
        acc = None
        with _tf32(self.allow_tf32):
            for net, mean, std in zip(self.nets, self.mean, self.std):
                x = ((resized - mean) / std / 255.0).to(self.compute_dtype)
                logits = net(x.permute(0, 3, 1, 2))
                probs = torch.softmax(
                    logits.float() if acc_f32 else logits, dim=1)
                probs = probs.to(self.accum_dtype)
                acc = probs if acc is None else acc + probs
        return torch.argmax(acc, dim=1).to(torch.uint8)

    def _forward(self, padded, heights, widths) -> torch.Tensor:
        return self._fold_argmax(self._resize_batch(padded, heights, widths))

    def _forward_gather(self, padded, heights, widths, ys, xs):
        """Forward + per-crop nearest-index gather: (B, oh, ow) uint8.
        ``ys``/``xs`` are (B, oh)/(B, ow) row/column tables into the
        (in_height, in_width) map."""
        if self._packed is not None:
            resized = self._resize_batch(padded, heights, widths)
            with _tf32(self.allow_tf32):
                return self._packed.gathered_argmax(resized, ys, xs)
        maps = self._forward(padded, heights, widths)
        batch = torch.arange(maps.shape[0], device=maps.device)
        return maps[batch[:, None, None], ys.long()[:, :, None],
                    xs.long()[:, None, :]]

    def _readback(self, out: torch.Tensor):
        """A ``submit_batch*`` handle.  On a card the copy of ``out`` into
        pinned host memory is enqueued right behind the batch's kernels,
        with an event after it, so reading batch N waits for batch N only,
        not for batch N+1 launched before the read."""
        if out.device.type != "cuda":
            return out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def read_maps(self, handle) -> np.ndarray:
        """A ``submit_batch*`` handle as host uint8 class maps."""
        if isinstance(handle, tuple):
            host, done = handle
            done.synchronize()
            return host.numpy()
        return handle.cpu().numpy()

    def submit_batch_padded(self, padded: np.ndarray, heights: np.ndarray,
                            widths: np.ndarray):
        """Async: (B, maxH, maxW, 3) uint8 BGR -> (B, in_h, in_w)."""
        return self._readback(self._forward(*self._upload(padded, heights,
                                                          widths)))

    def segment_batch_padded(self, padded: np.ndarray, heights: np.ndarray,
                             widths: np.ndarray) -> np.ndarray:
        return self.read_maps(self.submit_batch_padded(padded, heights,
                                                       widths))

    def submit_batch_gather(self, padded: np.ndarray, heights: np.ndarray,
                            widths: np.ndarray, ys: np.ndarray,
                            xs: np.ndarray):
        """Async: transfer + launch, return the result unread."""
        return self._readback(self._forward_gather(
            *self._upload(padded, heights, widths, ys, xs)))

    def segment_batch_gather(self, padded: np.ndarray, heights: np.ndarray,
                             widths: np.ndarray, ys: np.ndarray,
                             xs: np.ndarray) -> np.ndarray:
        """Padded crops -> per-crop gathered class maps (B, oh, ow)."""
        return self.read_maps(self.submit_batch_gather(padded, heights,
                                                       widths, ys, xs))

    def submit_batch_flat(self, flat: np.ndarray, offsets: np.ndarray,
                          heights: np.ndarray, widths: np.ndarray,
                          max_h: int, max_w: int):
        """Async flat-transfer forward (full-resolution class maps)."""
        flat, offs, hs, ws = self._upload(flat, offsets, heights, widths)
        padded = unflatten_crops(flat, offs, hs, ws, max_h, max_w)
        return self._readback(self._forward(padded, hs, ws))

    def submit_batch_gather_flat(self, flat: np.ndarray, offsets: np.ndarray,
                                 heights: np.ndarray, widths: np.ndarray,
                                 ys: np.ndarray, xs: np.ndarray,
                                 max_h: int, max_w: int):
        """Async flat-transfer forward + on-device /8 stitch gather."""
        flat, offs, hs, ws, ys, xs = self._upload(flat, offsets, heights,
                                                  widths, ys, xs)
        padded = unflatten_crops(flat, offs, hs, ws, max_h, max_w)
        return self._readback(self._forward_gather(padded, hs, ws, ys, xs))


class FusedSlideSegmenter:
    """Whole slide: detections -> /8 prediction canvas.

    ``slide`` is anything with ``.dimensions`` (width, height) and
    ``read_region_array(location, level, size)`` returning RGB uint8.
    Crops are bucketed to a shared padded shape per batch (multiples of
    256), staged on a producer thread while the device runs the previous
    batch, segmented by the fold ensemble and max-pasted into the canvas
    on the host.

    ``transfer``: ``"flat"`` (default) ships each batch as one ragged byte
    buffer and rebuilds the padded view on the device; ``"padded"`` ships
    the per-batch max-shape layout.  Both give the same bytes.
    """

    def __init__(self, ensemble: EnsembleSegmenter, transfer: str = "flat"):
        if transfer not in ("flat", "padded"):
            raise ValueError(f"unknown transfer {transfer!r}")
        self.ensemble = ensemble
        self.transfer = transfer

    def segment_slide(self, slide, detections: List[List[float]],
                      progress: bool = False, on_crop=None) -> np.ndarray:
        """``on_crop(box, class_map)`` is invoked per crop with the
        crop-resolution class map; without it the /8 stitch maps are
        gathered on the device."""
        width, height = slide.dimensions
        canvas = np.zeros((height // 8, width // 8), np.uint8)
        bs = self.ensemble.config.batch_size
        net_h = self.ensemble.config.in_height
        net_w = self.ensemble.config.in_width
        boxes = [[int(v) for v in det[:4]] for det in detections]
        ds8 = on_crop is None

        def nearest_idx(out_n: int, src_n: int, table_n: int) -> np.ndarray:
            idx = np.minimum(np.floor(
                np.arange(table_n) * (src_n / max(out_n, 1))).astype(np.int64),
                src_n - 1)
            return idx.astype(np.int32)

        def stage_batch(chunk):
            crops = [slide.read_region_array((x1, y1), 0,
                                             (x2 - x1, y2 - y1))[:, :, ::-1]
                     for x1, y1, x2, y2 in chunk]  # BGR
            n = len(crops)
            # shapes bucketed to multiples of 256, as in the JAX package
            max_h = -(-max(c.shape[0] for c in crops) // 256) * 256
            max_w = -(-max(c.shape[1] for c in crops) // 256) * 256
            if (self.transfer == "flat"
                    and flat_bytes_needed(crops, max_w) <= FLAT_OFFSET_LIMIT):
                flat, offs, hs, ws = pack_crops_flat(crops, bs, max_w=max_w,
                                                     max_h=max_h)
                staged = (flat, offs, max_h, max_w)
            else:
                # padded layout: by request, or per batch when a flat buffer
                # would pass the offset limit
                staged = np.zeros((bs, max_h, max_w, 3), np.uint8)
                hs = np.ones(bs, np.int32)
                ws = np.ones(bs, np.int32)
                for i, c in enumerate(crops):
                    copy_pixels(staged[i, : c.shape[0], : c.shape[1]], c)
                    hs[i], ws[i] = c.shape[:2]
            if not ds8:
                return chunk, n, staged, hs, ws, None, None
            ys = np.zeros((bs, max_h // 8), np.int32)
            xs = np.zeros((bs, max_w // 8), np.int32)
            for i, c in enumerate(crops):
                ys[i] = nearest_idx(c.shape[0] // 8, net_h, max_h // 8)
                xs[i] = nearest_idx(c.shape[1] // 8, net_w, max_w // 8)
            return chunk, n, staged, hs, ws, ys, xs

        # double-buffered staging; a producer failure (e.g. a slide-read
        # error) is handed to the consumer and raised there, so a slide is
        # never reported complete with a truncated canvas
        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()

        def producer():
            try:
                for first in range(0, len(boxes), bs):
                    q.put(stage_batch(boxes[first: first + bs]))
                q.put(sentinel)
            except BaseException as e:  # re-raised in the consumer loop
                q.put(e)

        threading.Thread(target=producer, daemon=True).start()
        done = 0

        def submit(item):
            chunk, n, staged, hs, ws, ys, xs = item
            ens = self.ensemble
            if isinstance(staged, tuple):
                flat, offs, max_h, max_w = staged
                if ds8:
                    out = ens.submit_batch_gather_flat(flat, offs, hs, ws,
                                                       ys, xs, max_h, max_w)
                else:
                    out = ens.submit_batch_flat(flat, offs, hs, ws, max_h,
                                                max_w)
            elif ds8:
                out = ens.submit_batch_gather(staged, hs, ws, ys, xs)
            else:
                out = ens.submit_batch_padded(staged, hs, ws)
            return chunk, n, out

        def drain(pending):
            nonlocal done
            chunk, n, out = pending
            maps = self.ensemble.read_maps(out)
            for (x1, y1, x2, y2), net_map in zip(chunk, maps[:n]):
                if on_crop is not None:
                    on_crop((x1, y1, x2, y2),
                            postprocess_nearest_host(net_map, y2 - y1,
                                                     x2 - x1))
                ch, cw = (y2 - y1) // 8, (x2 - x1) // 8
                small = net_map if ds8 else postprocess_nearest_host(
                    net_map, ch, cw)
                y0, x0 = y1 // 8, x1 // 8
                # boxes may overhang or lie past the slide edge: paste only
                # the intersection with the canvas
                ch = max(0, min(ch, canvas.shape[0] - y0))
                cw = max(0, min(cw, canvas.shape[1] - x0))
                if ch == 0 or cw == 0:
                    continue
                region = canvas[y0: y0 + ch, x0: x0 + cw]
                np.maximum(region, small[:ch, :cw], out=region)
            done += n
            if progress:
                print(f"{done}/{len(boxes)} crops")

        # batch N+1 is launched before batch N is read back, so its
        # transfer and launch overlap the device's work on batch N (and the
        # read of batch N waits for batch N only, see _readback)
        pending = None
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            submitted = submit(item)
            if pending is not None:
                drain(pending)
            pending = submitted
        if pending is not None:
            drain(pending)
        return canvas
