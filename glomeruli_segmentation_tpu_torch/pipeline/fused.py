"""Slide segmentation on the GPU: crops -> 5-fold ESPNet ensemble -> /8
slide canvas.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/fused.py``, with its
four engines:

- ``xla`` (the constructor's default, as in the JAX package): per fold the
  plain ``nn.Module`` :class:`..models.espnet.ESPNet` in the compute dtype,
  with that fold's BGR normalisation ``(x - mean) / std / 255``; the fold
  softmaxes in ``accum_dtype``, their mean, the argmax (first class on
  ties).
- ``fused``: a loop over folds, each a :class:`..models.espnet_fused.
  FusedESPNet`; the fold softmaxes summed in fold order.
- ``packed``: :class:`..models.espnet_packed.PackedEnsembleESPNet`, all
  folds in one block-diagonal forward, with the same sum.  Its gather
  entry points gather the decoder features before the classifier upconv,
  so the full-resolution logits are never formed.
- ``fold_parallel``: the folds spread over the ``fold`` axis of a mesh
  (:mod:`..parallel.fold_parallel`), summed in fold order.

``auto`` picks ``packed`` below batch 96 and ``fused`` at or above it, as
the JAX package does.  The fused and packed engines run level 3 through
the fused ESP block kernel (K1) below batch 96, under a mesh too: each
data-axis position runs a whole replica, so the kernel needs no
partitioning (the JAX package keeps the packed level 3 off its Pallas
kernel under a mesh because GSPMD cannot partition a custom call).  The
/8 nearest gather for the slide stitch runs on the device, so only
(B, oh, ow) bytes come back; the
full-resolution readback can be packed 3 px/byte (``pack_output``).
Under a mesh (:mod:`..parallel.mesh`) crop batches split over its data
axis.  :class:`FusedSlideSegmenter` stages crop batches on a producer
thread, ragged (``flat``), padded, or cv2-resized to the network input on
the host (``host_resize``).
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

from .. import read_host, readback, resolve_device, tf32
from ..convert.espnet_import import (infer_architecture,
                                     load_espnet_state_dict)
from ..models.espnet import ESPNet
from ..models.espnet_fused import FusedESPNet
from ..models.espnet_packed import PackedEnsembleESPNet
from ..ops.preprocess import (FLAT_OFFSET_LIMIT, copy_pixels,
                              flat_bytes_needed, maybe_pack, pack_crops_flat,
                              postprocess_nearest_host, read_packed,
                              resize_bilinear_dynamic, unflatten_crops)
from ..parallel.fold_parallel import (FoldParallelEnsemble, stack_states,
                                      unstack)
from ..parallel.mesh import Replicas, upload
from .merge import has_pixels

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
    # pack k class-map pixels per byte (base-`classes`; k=3 at 5 classes)
    # before the full-resolution readback: exact, 3x fewer device->host
    # bytes; off by default, as in the JAX package
    pack_output: bool = False


@contextlib.contextmanager
def staged(stage, chunks):
    """Double-buffered staging: ``stage(chunk)`` for each chunk on a
    producer thread, at most two ahead of the consumer, which iterates
    what this yields.  A producer failure (a slide-read error) is raised in
    the consumer, so a slide is never reported complete with a truncated
    canvas.  When the consumer leaves early (it raised), the producer is
    stopped and joined before the ``with`` ends, so no staging read
    outlives the caller's slide."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    sentinel = object()
    stop = threading.Event()

    def producer():
        try:
            for chunk in chunks:
                if stop.is_set():
                    return
                q.put(stage(chunk))
            q.put(sentinel)
        except BaseException as e:  # re-raised in the consumer
            q.put(e)

    def items():
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        yield items()
    finally:
        stop.set()
        while thread.is_alive():  # a put may wait on the full queue
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


def host_resized(resized: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A float32 batch resized on the host as a CPU tensor of the compute
    dtype: numpy has no bfloat16, so the cast is torch's (round to nearest
    even, as ``ml_dtypes`` rounds in the JAX package)."""
    return torch.from_numpy(resized).to(dtype)


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


class _FoldModels:
    """An engine's fold models on one device: plain ``nn.Module`` ESPNets
    (``xla``), ``FusedESPNet`` models (``fused``) or one
    ``PackedEnsembleESPNet`` (``packed``), with the folds' BGR mean and std
    there.  Each net's architecture is its checkpoint's, as the fused and
    packed models infer theirs."""

    def __init__(self, engine: str, state_dicts, means, stds,
                 config: EnsembleConfig, device: torch.device,
                 fuse_level3: bool, fuse_level2: bool,
                 dtype: torch.dtype, accum_dtype: torch.dtype):
        self.device = device
        self.nets = self.packed = None
        if engine == "packed":
            self.packed = PackedEnsembleESPNet(
                state_dicts, means, stds, fuse_level3=fuse_level3,
                fuse_level2=fuse_level2, dtype=dtype,
                accum_dtype=accum_dtype, device=device)
        elif engine == "fused":
            self.nets = [FusedESPNet(sd, fuse_level3=fuse_level3,
                                     dtype=dtype, device=device)
                         for sd in state_dicts]
        else:
            # the compute dtype goes into the weights: a bf16 input alone
            # would run the float32 convs of a float32 model
            self.nets = []
            for sd in state_dicts:
                net = ESPNet(*infer_architecture(sd)[:3])
                net.load_state_dict(sd, strict=True)
                self.nets.append(net.to(device, dtype).eval())
        self.mean = torch.tensor(means, dtype=torch.float32, device=device)
        self.std = torch.tensor(stds, dtype=torch.float32, device=device)


class EnsembleSegmenter:
    """Fold ensemble over raw padded BGR crops -> class maps.

    ``engine``:

    - ``"xla"`` (the default, as in the JAX constructor): per fold the
      plain :class:`..models.espnet.ESPNet` in the compute dtype; softmax
      in ``accum_dtype``, the **mean** over folds, argmax;
    - ``"fused"``: per fold a :class:`..models.espnet_fused.FusedESPNet`
      (level 3 through K1 below batch 96); the sum of the softmaxes;
    - ``"packed"``: all folds in one block-diagonal forward; the sum;
    - ``"fold_parallel"``: the folds spread over the ``fold`` axis of
      ``mesh`` (:class:`..parallel.fold_parallel.FoldParallelEnsemble`,
      ordered exact combine); needs a mesh with ``fold`` and ``data`` axes;
    - ``"auto"``: ``"xla"`` with injected ``variables``, else ``"packed"``
      below batch 96 and ``"fused"`` from it on.

    ``variables`` injects a fold-leading stacked state dict instead of
    loading ``config.checkpoints`` (``xla`` and ``fold_parallel`` only).
    With a ``mesh`` (:mod:`..parallel.mesh`) crop batches split over its
    ``data`` axis, one replica of the models per data-axis device;
    ``batch_size`` must divide by the axis size.  ``fuse_level3`` (fused
    and packed engines) defaults to ``batch_size < 96``, as in the JAX
    package, with or without a mesh (each replica runs its shard whole).
    ``fuse_level2`` (packed engine only, off by default as the JAX
    package's ``level2="xla"``) runs the packed level 2 through K2.
    ``config.pack_output`` packs every full-resolution readback 3 px/byte
    (:func:`..ops.preprocess.pack_classmap`); :meth:`read_maps` unpacks.
    """

    def __init__(self, config: EnsembleConfig, mesh=None,
                 engine: str = "xla", device="cuda",
                 fuse_level3: Optional[bool] = None,
                 fuse_level2: bool = False, variables=None):
        if engine == "auto":
            engine = ("xla" if variables is not None
                      else "packed" if config.batch_size < 96 else "fused")
        if engine not in ("xla", "fused", "packed", "fold_parallel"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "fold_parallel" and (
                mesh is None or not {"fold", "data"} <= set(mesh.axis_names)):
            raise ValueError(
                "engine='fold_parallel' needs a mesh with 'fold' and "
                "'data' axes (parallel.mesh.make_fold_mesh)")
        if variables is not None and engine not in ("xla", "fold_parallel"):
            raise ValueError("injected variables require engine='xla'/"
                             "'fold_parallel'")
        if fuse_level2 and engine != "packed":
            raise ValueError("fuse_level2 applies to the packed engine only")
        if fuse_level3 is not None and engine not in ("fused", "packed"):
            raise ValueError("fuse_level3 applies to the fused and packed "
                             "engines only")
        if config.precision not in ("default", "highest"):
            raise ValueError(f"unknown precision {config.precision!r}")
        if variables is None and (not config.checkpoints or len(
                config.checkpoints) != len(config.folds)):
            raise ValueError(f"{len(config.checkpoints)} checkpoints for "
                             f"folds {tuple(config.folds)}")
        self.config = config
        self.engine = engine
        self.mesh = mesh
        self.compute_dtype = _DTYPES[config.compute_dtype]
        self.accum_dtype = _DTYPES[config.accum_dtype]
        self.allow_tf32 = config.precision == "default"
        log.info("precision=%s: cudnn.allow_tf32 and cuda.matmul.allow_tf32 "
                 "are %s during the forward", config.precision,
                 self.allow_tf32)
        if fuse_level3 is None:
            fuse_level3 = engine in ("fused", "packed") and \
                config.batch_size < 96
        self.fuse_level3 = fuse_level3
        self.fuse_level2 = fuse_level2
        if variables is not None:
            state_dicts = [unstack(variables, f)
                           for f in range(len(config.folds))]
        else:
            state_dicts = [load_espnet_state_dict(ckpt)
                           for ckpt in config.checkpoints]
        means = [FOLD_NORMALIZATION[f][0] for f in config.folds]
        stds = [FOLD_NORMALIZATION[f][1] for f in config.folds]
        self._fp = None
        if engine == "fold_parallel":
            self._fp = FoldParallelEnsemble(
                mesh, ESPNet(*infer_architecture(state_dicts[0])[:3]),
                stack_states(state_dicts), means, stds, axis_name="fold",
                data_axis="data", compute_dtype=self.compute_dtype,
                precision=config.precision, exact=True)
            # one position per data column: its index into the ensemble
            self._cores = Replicas(
                self._fp.column_devices, list(range(len(
                    self._fp.columns))), self._fp.column_streams)
        else:
            def build(dev):
                return _FoldModels(engine, state_dicts, means, stds, config,
                                   dev, fuse_level3, fuse_level2,
                                   self.compute_dtype, self.accum_dtype)

            if mesh is None:
                dev = resolve_device(device)
                self._cores = Replicas([dev], [build(dev)], [None])
            else:
                self._cores = Replicas.build(mesh.axis_devices("data"),
                                             build)
        if config.batch_size % len(self._cores):
            raise ValueError(
                f"batch_size {config.batch_size} must be a multiple of the "
                f"data-axis size {len(self._cores)}")
        self.device = self._cores.devices[0]
        first = self._cores.replicas[0]
        self.nets = getattr(first, "nets", None)
        self._packed = getattr(first, "packed", None)

    def _upload(self, device, data, *tables):
        """``data`` (the crop bytes, or a host tensor) and the int32
        ``tables`` as tensors on ``device``, on its current stream.  On a
        card the tables go up as one buffer, split on the device, and both
        copies are made from pinned memory without waiting for the device,
        so batch N+1 is uploaded and launched while batch N runs.  The
        pinned buffers come from torch's host allocator, which reuses none
        before the copy that reads it has run.  On the CPU these are views
        of the arrays."""
        if device.type != "cuda" or not tables:
            return [upload(a, device) for a in (data,) + tables]
        buf, shapes = pack_tables(tables)
        return [upload(data, device),
                *unpack_tables(upload(buf, device), shapes)]

    def _run(self, forward, data, *tables, shared=None):
        """``forward(models, data, *tables)`` at each data-axis position on
        its shard of every batch-leading array -- ``data`` and the
        ``tables`` -- after their upload there; returns the readback
        handle(s) (:func:`..read_host` takes the list).  ``shared`` (the
        flat crop buffer) goes whole to every position, before ``data``."""
        def one(models, dev, *parts):
            if shared is not None:
                parts = (shared,) + parts
            return readback(forward(models, *self._upload(dev, *parts)))

        return self._cores.submit(one, data, *tables)

    def _resize_batch(self, padded, heights, widths) -> torch.Tensor:
        cfg = self.config
        return resize_bilinear_dynamic(padded, heights, widths,
                                       cfg.in_height, cfg.in_width)

    @torch.no_grad()
    def _fold_argmax(self, models, resized: torch.Tensor) -> torch.Tensor:
        """(B, in_h, in_w, 3) BGR crops at network size -> (B, in_h, in_w)
        uint8 class maps on the models' device."""
        if self._fp is not None:
            # the fold positions normalise per fold and cast themselves,
            # from the float32 batch, each under its own TF32 switches
            return self._fp.column_argmax(models, resized.float())
        if models.packed is not None:
            # normalises per fold itself, from the float32 crops
            with tf32(self.allow_tf32, self.allow_tf32):
                return models.packed(resized)
        acc_f32 = self.accum_dtype == torch.float32
        # the bf16 path reads the resized batch once per fold: keep it bf16
        resized = resized.to(self.compute_dtype)
        acc = None
        with tf32(self.allow_tf32, self.allow_tf32):
            for net, mean, std in zip(models.nets, models.mean, models.std):
                x = ((resized - mean) / std / 255.0).to(self.compute_dtype)
                x = x.permute(0, 3, 1, 2)
                logits = net(x.contiguous() if self.engine == "xla" else x)
                probs = torch.softmax(
                    logits.float() if acc_f32 else logits, dim=1)
                probs = probs.to(self.accum_dtype)
                acc = probs if acc is None else acc + probs
        if self.engine == "xla":
            # the JAX xla engine takes the mean of the fold softmaxes, the
            # fused and packed engines their sum
            acc = acc / len(models.nets)
        return torch.argmax(acc, dim=1).to(torch.uint8)

    def _gather_argmax(self, models, resized, ys, xs) -> torch.Tensor:
        """Forward + per-crop nearest-index gather: (B, oh, ow) uint8.
        ``ys``/``xs`` are (B, oh)/(B, ow) row/column tables into the
        (in_height, in_width) map."""
        if self._fp is None and models.packed is not None:
            with tf32(self.allow_tf32, self.allow_tf32):
                return models.packed.gathered_argmax(resized, ys, xs)
        maps = self._fold_argmax(models, resized)
        batch = torch.arange(maps.shape[0], device=maps.device)
        return maps[batch[:, None, None], ys.long()[:, :, None],
                    xs.long()[:, None, :]]

    def _maybe_pack(self, maps: torch.Tensor) -> torch.Tensor:
        """Base-``classes`` pack of a full-resolution readback (3 px/byte at
        5 classes) when ``config.pack_output``; :meth:`read_maps` unpacks."""
        return maybe_pack(maps, self.config.classes, self.config.pack_output)

    def _forward(self, models, padded, heights, widths) -> torch.Tensor:
        return self._maybe_pack(self._fold_argmax(
            models, self._resize_batch(padded, heights, widths)))

    def _forward_gather(self, models, padded, heights, widths, ys, xs):
        return self._gather_argmax(
            models, self._resize_batch(padded, heights, widths), ys, xs)

    def read_maps(self, handle) -> np.ndarray:
        """A full-resolution ``submit_batch*`` handle as host uint8 class
        maps (B, in_h, in_w), unpacked on the host when the readback is
        packed."""
        return read_packed(read_host(handle), self.config.classes,
                           self.config.in_width, self.config.pack_output)

    def read_gathered(self, handle) -> np.ndarray:
        """A gather ``submit_batch*`` handle as host uint8 maps (B, oh, ow);
        the small gathered maps are never packed."""
        return read_host(handle)

    def submit_batch_padded(self, padded: np.ndarray, heights: np.ndarray,
                            widths: np.ndarray):
        """Async: (B, maxH, maxW, 3) uint8 BGR -> (B, in_h, in_w)."""
        return self._run(self._forward, padded, heights, widths)

    def segment_batch_padded(self, padded: np.ndarray, heights: np.ndarray,
                             widths: np.ndarray) -> np.ndarray:
        return self.read_maps(self.submit_batch_padded(padded, heights,
                                                       widths))

    def submit_batch_gather(self, padded: np.ndarray, heights: np.ndarray,
                            widths: np.ndarray, ys: np.ndarray,
                            xs: np.ndarray):
        """Async: transfer + launch, return the result unread."""
        return self._run(self._forward_gather, padded, heights, widths,
                         ys, xs)

    def segment_batch_gather(self, padded: np.ndarray, heights: np.ndarray,
                             widths: np.ndarray, ys: np.ndarray,
                             xs: np.ndarray) -> np.ndarray:
        """Padded crops -> per-crop gathered class maps (B, oh, ow)."""
        return self.read_gathered(self.submit_batch_gather(
            padded, heights, widths, ys, xs))

    def submit_batch_flat(self, flat: np.ndarray, offsets: np.ndarray,
                          heights: np.ndarray, widths: np.ndarray,
                          max_h: int, max_w: int):
        """Async flat-transfer forward (full-resolution class maps)."""
        def forward(models, flat, offs, hs, ws):
            padded = unflatten_crops(flat, offs, hs, ws, max_h, max_w)
            return self._forward(models, padded, hs, ws)

        return self._run(forward, offsets, heights, widths, shared=flat)

    def submit_batch_gather_flat(self, flat: np.ndarray, offsets: np.ndarray,
                                 heights: np.ndarray, widths: np.ndarray,
                                 ys: np.ndarray, xs: np.ndarray,
                                 max_h: int, max_w: int):
        """Async flat-transfer forward + on-device /8 stitch gather."""
        def forward(models, flat, offs, hs, ws, ys, xs):
            padded = unflatten_crops(flat, offs, hs, ws, max_h, max_w)
            return self._forward_gather(models, padded, hs, ws, ys, xs)

        return self._run(forward, offsets, heights, widths, ys, xs,
                         shared=flat)

    def submit_batch_resized(self, resized):
        """(B, in_h, in_w, 3) crops resized on the host (cv2, in the compute
        dtype: numpy or a CPU tensor) -> async (B, in_h, in_w) class maps.
        Large crops never cross the host->device link at full
        resolution."""
        return self._run(lambda models, x: self._maybe_pack(
            self._fold_argmax(models, x)), resized)

    def submit_batch_gather_resized(self, resized, ys: np.ndarray,
                                    xs: np.ndarray):
        """Pre-resized forward + the on-device /8 stitch gather."""
        return self._run(self._gather_argmax, resized, ys, xs)


def crop_boxes(detections) -> List[List[int]]:
    """The integer level-0 boxes ``(x1, y1, x2, y2)`` of ``detections`` that
    hold pixels (:func:`.merge.has_pixels`), in order.

    The rule of both segmenters: a merged box of zero (or negative) width
    or height after the integer cast is not read, segmented, pasted or
    given a per-crop artifact.  Its merged-CSV row stays, because the
    detector reported it.  Leaving it out before the batches are cut keeps
    every other crop's batch, and so its bytes, as on the slide without
    it."""
    boxes = [[int(v) for v in det[:4]] for det in detections]
    return [b for b in boxes if has_pixels(b)]


class FusedSlideSegmenter:
    """Whole slide: detections -> /8 prediction canvas.

    ``slide`` is anything with ``.dimensions`` (width, height) and
    ``read_region_array(location, level, size)`` returning RGB uint8.
    Crops are bucketed to a shared padded shape per batch (multiples of
    256), staged on a producer thread while the device runs the previous
    batch, segmented by the fold ensemble and max-pasted into the canvas
    on the host.

    ``host_resize``: each crop is cv2-resized (INTER_LINEAR, float32) to
    the network input on the producer thread and the batch is shipped in
    the compute dtype (cast in torch on the host, rounding to nearest even
    as the JAX package's ``ml_dtypes`` cast does): the bytes crossing the
    link are O(network input), not O(crop).

    ``transfer``: ``"flat"`` ships each batch as one ragged byte buffer and
    rebuilds the padded view on the device; ``"padded"`` ships the
    per-batch max-shape layout.  Both give the same bytes.  ``"auto"`` is
    ``"padded"`` with ``host_resize`` or under a mesh, else ``"flat"``;
    ``"flat"`` with either raises.
    """

    def __init__(self, ensemble: EnsembleSegmenter,
                 host_resize: bool = False, transfer: str = "auto"):
        meshed = ensemble.mesh is not None
        if transfer == "auto":
            transfer = "padded" if host_resize or meshed else "flat"
        if transfer not in ("flat", "padded"):
            raise ValueError(f"unknown transfer {transfer!r}")
        if transfer == "flat" and (host_resize or meshed):
            raise ValueError(
                "transfer='flat' is single-device, full-resolution only")
        self.ensemble = ensemble
        self.host_resize = host_resize
        self.transfer = transfer

    def segment_slide(self, slide, detections: List[List[float]],
                      progress: bool = False, on_crop=None) -> np.ndarray:
        """``on_crop(box, class_map)`` is invoked per crop with the
        crop-resolution class map; without it the /8 stitch maps are
        gathered on the device.  Boxes without pixels are left out
        (:func:`crop_boxes`)."""
        width, height = slide.dimensions
        canvas = np.zeros((height // 8, width // 8), np.uint8)
        bs = self.ensemble.config.batch_size
        net_h = self.ensemble.config.in_height
        net_w = self.ensemble.config.in_width
        boxes = crop_boxes(detections)
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
            if self.host_resize:
                # the batch crossing the link is a fixed (bs, net_h, net_w,
                # 3) in the compute dtype, not the full-resolution crops
                import cv2

                resized = np.zeros((bs, net_h, net_w, 3), np.float32)
                for i, c in enumerate(crops):
                    resized[i] = cv2.resize(c.astype(np.float32),
                                            (net_w, net_h),
                                            interpolation=cv2.INTER_LINEAR)
                staged = host_resized(resized,
                                      self.ensemble.compute_dtype)
                hs = ws = None
            elif (self.transfer == "flat"
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

        done = 0

        def submit(item):
            chunk, n, staged, hs, ws, ys, xs = item
            ens = self.ensemble
            if self.host_resize:
                if ds8:
                    out = ens.submit_batch_gather_resized(staged, ys, xs)
                else:
                    out = ens.submit_batch_resized(staged)
            elif isinstance(staged, tuple):
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
            # the full-resolution readback may come packed (pack_output);
            # the gathered /8 maps never do
            maps = (self.ensemble.read_gathered(out) if ds8
                    else self.ensemble.read_maps(out))
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
        # read of batch N waits for batch N only, see readback)
        pending = None
        with staged(stage_batch, [boxes[first: first + bs] for first
                                  in range(0, len(boxes), bs)]) as items:
            for item in items:
                submitted = submit(item)
                if pending is not None:
                    drain(pending)
                pending = submitted
        if pending is not None:
            drain(pending)
        return canvas
