"""SegFormer/GTCS slide path on the GPU: crops -> MiT forward -> /8 canvas.

Counterpart of ``glomeruli_segmentation_tpu/pipeline/fused_segformer.py``:
the GTCS model family's resident one-process slide path, so ``gseg-e2e
--segformer_checkpoint`` runs detect -> merge -> SegFormer -> stitch with
no intermediate files.  Numerics follow the staged chain:

- a producer thread reads each crop at level 0 and cv2-resizes it to
  ``input_size`` on the host **as uint8** (the SegformerFeatureExtractor
  resize of :func:`..data.segformer_dataset.feature_extract`), and builds
  the /8 sample tables;
- /255, the ImageNet normalisation and the MiT forward run on the device
  (logits at 1/4 of the input);
- the staged chain upsamples the logits bilinearly to crop size and takes
  the argmax; the /8 canvas needs only the nearest-/8 pixels of that map,
  so the device evaluates the same half-pixel blend (the
  :func:`..ops.resize._linear_weights` tables, the same float32
  expression, rows then columns) at those pixels only, and only
  (B, th, tw) uint8 maps come back.  With ``on_crop`` the logits come back
  and the host numpy twin (:func:`..ops.resize.resize_bilinear_np`) makes
  each crop's full map.

With a ``mesh`` (:mod:`..parallel.mesh`) each crop batch splits over its
data axis, one replica of the model per data-axis device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from .. import read_host, readback, resolve_device, tf32
from ..data.segformer_dataset import IMAGENET_MEAN, IMAGENET_STD
from ..ops.preprocess import postprocess_nearest_host
from ..ops.resize import _linear_weights, resize_bilinear_np
from ..parallel.mesh import Replicas, upload
from ..utils.timing import count, span
from .fused import crop_boxes, staged

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class SegformerSlideConfig:
    num_labels: int = 5
    input_size: int = 512
    batch_size: int = 8
    compute_dtype: str = "float32"


def load_segformer_checkpoint(path: str):
    """A ``flax_model.pth`` (the trainer's checkpoint: the Flax tree and
    ``num_labels``) from the file itself, a ``checkpoint-N`` directory, or a
    training output directory (the best checkpoint found from ``log.txt``,
    the reference contract ``SegFormer/test/test.py:149-171``) -> (the
    port's state dict, num_labels)."""
    from ..convert.segformer_import import state_dict_from_variables

    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, "flax_model.pth")):
            path = os.path.join(path, "flax_model.pth")
        else:
            from .segformer_test import search_best_checkpoint

            path = os.path.join(path, search_best_checkpoint(path),
                                "flax_model.pth")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "head" not in blob["params"]:
        raise ValueError(f"{path} is a backbone-only checkpoint (no decode "
                         f"head); only the trainer fills in a head")

    def arrays(node):
        if isinstance(node, dict):
            return {k: arrays(v) for k, v in node.items()}
        return np.asarray(node)

    state_dict = state_dict_from_variables(
        {"params": arrays(blob["params"]),
         "batch_stats": arrays(blob["batch_stats"])})
    return state_dict, int(blob.get("num_labels", 5))


class _Replica:
    """The MiT model on one device, with the ImageNet mean and std there."""

    def __init__(self, state_dict, config: SegformerSlideConfig, device):
        from ..models.segformer import Segformer, config_from_state_dict

        self.model = Segformer(
            config_from_state_dict(state_dict, num_labels=config.num_labels),
            dtype=_DTYPES[config.compute_dtype])
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(device).eval()
        self.mean = torch.from_numpy(IMAGENET_MEAN).to(device)
        self.std = torch.from_numpy(IMAGENET_STD).to(device)


class SegformerSlideSegmenter:
    """Whole slide: detections -> /8 prediction canvas, with the GTCS
    model.  Same ``segment_slide(slide, detections, progress, on_crop)``
    surface as :class:`.fused.FusedSlideSegmenter`, and the same rule for
    boxes without pixels (:func:`.fused.crop_boxes`), so
    :class:`.e2e.FusedEndToEnd` drives either model family.

    ``compute_dtype="float32"`` runs with TF32 off (the JAX package's f32
    parity path); ``"bfloat16"`` runs the products in bf16 and keeps the
    norms and the softmax in float32.  With a ``mesh`` the batch size must
    divide by its data axis."""

    def __init__(self, state_dict, config: Optional[SegformerSlideConfig]
                 = None, device="cuda", mesh=None):
        self.config = config or SegformerSlideConfig()
        cfg = self.config
        self.dtype = _DTYPES[cfg.compute_dtype]
        if mesh is None:
            dev = resolve_device(device)
            self._replicas = Replicas([dev], [_Replica(state_dict, cfg, dev)],
                                      [None])
        else:
            n_data = mesh.shape["data"]
            if cfg.batch_size % n_data:
                raise ValueError(
                    f"batch_size {cfg.batch_size} must be divisible by "
                    f"the mesh 'data' axis size {n_data} (crop batches "
                    f"shard over it -- same contract as EnsembleSegmenter)")
            self._replicas = Replicas.build(
                mesh.axis_devices("data"),
                lambda dev: _Replica(state_dict, cfg, dev))
        self.device = self._replicas.devices[0]
        self.model = self._replicas.replicas[0].model
        # logits resolution: 1/4 of the input (HF Segformer contract)
        self._hq = cfg.input_size // 4

    def _replica(self, device: torch.device) -> _Replica:
        """The replica on ``device``, where a batch shard lies."""
        reps = self._replicas
        if len(reps) == 1:
            return reps.replicas[0]
        return reps.replicas[reps.devices.index(device)]

    @torch.no_grad()
    def logits(self, batch_u8: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) uint8 RGB (host cv2-resized) -> (B, S/4, S/4, C)
        float32 logits, by the replica on the batch's device; /255 and the
        ImageNet normalisation on the device, in float32
        (:func:`..data.segformer_dataset.feature_extract`)."""
        rep = self._replica(batch_u8.device)
        x = batch_u8.float() / 255.0
        x = (x - rep.mean) / rep.std
        # TF32 off: float32 products in full float32 (the bf16 path has
        # no float32 products)
        with tf32(False, False):
            return rep.model(x).float()

    @torch.no_grad()
    def gather(self, batch_u8, ylo, yhi, wy, xlo, xhi, wx) -> torch.Tensor:
        """Forward + the bilinear blend of the logits at the /8 stitch
        positions + argmax: (B, th, tw) uint8.  The blend is the float32
        expression of :func:`..ops.resize.resize_bilinear_np` (rows then
        columns, ``top * (1 - w) + bot * w`` as separate operations), so
        each pixel equals the host twin's upsample-then-argmax."""
        lg = self.logits(batch_u8)
        top = torch.take_along_dim(lg, ylo.long()[:, :, None, None], dim=1)
        bot = torch.take_along_dim(lg, yhi.long()[:, :, None, None], dim=1)
        w_y = wy[:, :, None, None]
        rows = top * (1.0 - w_y) + bot * w_y           # (B, th, hq, C)
        left = torch.take_along_dim(rows, xlo.long()[:, None, :, None], dim=2)
        right = torch.take_along_dim(rows, xhi.long()[:, None, :, None],
                                     dim=2)
        w_x = wx[:, None, :, None]
        out = left * (1.0 - w_x) + right * w_x         # (B, th, tw, C)
        return torch.argmax(out, dim=-1).to(torch.uint8)

    def submit(self, resized: np.ndarray, tables=None):
        """A staged batch uploaded and launched at each data-axis position:
        the gathered /8 maps with ``tables``, else the logits; returns the
        readback handle(s)."""
        def one(rep, dev, *parts):
            with span("seg.upload"):
                parts = [upload(a, dev) for a in parts]
            with span("seg.launch"):
                if tables is None:
                    return readback(self.logits(*parts))
                return readback(self.gather(*parts))

        return self._replicas.submit(one, resized, *(tables or ()))

    def predict_full(self, logits_np: np.ndarray, crop_h: int,
                     crop_w: int) -> np.ndarray:
        """Host per-crop staged math: bilinear logits -> crop size ->
        argmax, through the numpy twin."""
        up = resize_bilinear_np(logits_np, crop_h, crop_w)
        return np.argmax(up, axis=-1).astype(np.uint8)

    def segment_slide(self, slide, detections: List[List[float]],
                      progress: bool = False, on_crop=None) -> np.ndarray:
        import cv2

        cfg = self.config
        size = cfg.input_size
        hq = self._hq
        width, height = slide.dimensions
        canvas = np.zeros((height // 8, width // 8), np.uint8)
        bs = cfg.batch_size
        boxes = crop_boxes(detections)
        ds8 = on_crop is None

        def sample_tables(crop_n: int, out_n: int, table_n: int):
            """Bilinear lo/hi/weight of the full crop_n upsample, taken at
            the nearest-/8 rows ``floor(i * crop_n / out_n)``."""
            lo, hi, w = _linear_weights(hq, max(crop_n, 1))
            sel = np.minimum(np.floor(np.arange(table_n)
                                      * (crop_n / max(out_n, 1))
                                      ).astype(np.int64),
                             max(crop_n, 1) - 1)
            return lo[sel], hi[sel], w[sel]

        def stage_batch(chunk):
            # the batch shape stays fixed at batch_size; rows past the
            # chunk's crops stay zero
            resized = np.zeros((bs, size, size, 3), np.uint8)
            dims = []
            for i, (x1, y1, x2, y2) in enumerate(chunk):
                with span("seg.read"):
                    crop = slide.read_region_array(
                        (x1, y1), 0, (x2 - x1, y2 - y1))  # RGB
                with span("seg.pack"):
                    # uint8 cv2 INTER_LINEAR: the SegformerFeatureExtractor
                    # resize of the staged chain
                    resized[i] = cv2.resize(crop, (size, size),
                                            interpolation=cv2.INTER_LINEAR)
                dims.append((crop.shape[0], crop.shape[1]))
            if not ds8:
                return chunk, resized, None
            with span("seg.pack"):
                return chunk, resized, sample_batch(dims)

        def sample_batch(dims):
            # table extents bucketed to multiples of 64, as in the JAX
            # package
            th = max(-(-max(h // 8 for h, _ in dims) // 64) * 64, 64)
            tw = max(-(-max(w // 8 for _, w in dims) // 64) * 64, 64)
            ylo = np.zeros((bs, th), np.int32)
            yhi = np.zeros((bs, th), np.int32)
            wy = np.zeros((bs, th), np.float32)
            xlo = np.zeros((bs, tw), np.int32)
            xhi = np.zeros((bs, tw), np.int32)
            wx = np.zeros((bs, tw), np.float32)
            for i, (h, w) in enumerate(dims):
                ylo[i], yhi[i], wy[i] = sample_tables(h, h // 8, th)
                xlo[i], xhi[i], wx[i] = sample_tables(w, w // 8, tw)
            return ylo, yhi, wy, xlo, xhi, wx

        done = 0

        def submit(item):
            chunk, resized, tables = item
            count("seg.slots_used", len(chunk))
            count("seg.slots_computed", bs)
            return chunk, self.submit(resized, tables if ds8 else None)

        def drain(pending):
            chunk, handle = pending
            with span("seg.result_wait"):
                maps = read_host(handle)
            with span("seg.paste"):
                paste(chunk, maps)

        def paste(chunk, maps):
            nonlocal done
            for k, (x1, y1, x2, y2) in enumerate(chunk):
                ch, cw = (y2 - y1) // 8, (x2 - x1) // 8
                if ds8:
                    small = maps[k]
                else:
                    full = self.predict_full(maps[k], y2 - y1, x2 - x1)
                    on_crop((x1, y1, x2, y2), full)
                    small = postprocess_nearest_host(full, ch, cw)
                y0, x0 = y1 // 8, x1 // 8
                # boxes may overhang or lie past the slide edge: paste only
                # the intersection with the canvas
                ch = max(0, min(ch, canvas.shape[0] - y0))
                cw = max(0, min(cw, canvas.shape[1] - x0))
                if ch == 0 or cw == 0:
                    continue
                region = canvas[y0: y0 + ch, x0: x0 + cw]
                np.maximum(region, small[:ch, :cw], out=region)
            done += len(chunk)
            if progress:
                print(f"{done}/{len(boxes)} crops")

        # batch N+1 is launched before batch N is read back, so its upload
        # and launch overlap the device's work on batch N
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
