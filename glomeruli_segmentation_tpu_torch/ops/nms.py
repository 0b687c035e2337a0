"""Greedy non-maximum suppression, batched over problems: the CUDA kernel
(K3), its plain PyTorch version, and ``gather_padded``.

Counterpart of ``glomeruli_segmentation_tpu/ops/nms.py`` (the ``lax.scan``
NMS) and of ``ops/pallas/nms_pallas.py`` (the Pallas kernel that
``csrc/nms.cu`` replaces).  The contract: ``max_outputs`` greedy steps;
each takes the highest live score, the lowest index on ties, emits it if
that score is above ``NEG_INF / 2`` (else -1), and then kills the winner
and every box whose IoU with it is >= ``iou_threshold``.  Scores at or
below ``score_threshold`` are set to ``NEG_INF`` first.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .boxes import boxes_area

NEG_INF = -1e10
# the kernel sorts a problem's keys in 64 KB of shared memory (8 bytes a
# box); the frozen-graph detector's pre_nms_top_n is 6000
MAX_BOXES = 8192


def premask(scores: torch.Tensor, score_threshold: float) -> torch.Tensor:
    """Scores at or below ``score_threshold`` -> ``NEG_INF`` (the JAX
    package's ``where(scores > t, scores, NEG_INF)``).  The thresholds here
    and in :func:`nms_plain` are Python scalars, compared in the scores'
    type, so no value is copied to the device."""
    return torch.where(scores > score_threshold, scores, NEG_INF)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
              iou_threshold: float = 0.5
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (P, N, 4), (P, N) float32 ->
    (indices (P, max_outputs) int32 padded with -1, num_valid (P,) int32).
    ``max_outputs`` steps of a few elementwise ops each, on every problem at
    once; the IoU is rounded after each product, sum and quotient."""
    p, n = scores.shape
    dev = boxes.device
    area = boxes_area(boxes)
    live = scores.clone()
    ids = torch.arange(n, device=dev)
    rows = torch.arange(p, device=dev)
    y1, x1, y2, x2 = boxes.unbind(-1)
    out = torch.full((p, max_outputs), -1, dtype=torch.int32, device=dev)
    for step in range(max_outputs):
        best = live.max(dim=1, keepdim=True).values
        # the first index attaining the max
        idx = torch.where(live >= best, ids, n).min(dim=1).values
        valid = best[:, 0] > NEG_INF / 2
        b = boxes[rows, idx]
        iy = torch.clamp_min(torch.minimum(b[:, 2:3], y2)
                             - torch.maximum(b[:, 0:1], y1), 0)
        ix = torch.clamp_min(torch.minimum(b[:, 3:4], x2)
                             - torch.maximum(b[:, 1:2], x1), 0)
        inter = iy * ix
        union = area[rows, idx][:, None] + area - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
        kill = (iou >= iou_threshold) & valid[:, None]
        kill[rows, idx] = True
        live = torch.where(kill, NEG_INF, live)
        out[:, step] = torch.where(valid, idx.to(torch.int32), -1)
    return out, (out >= 0).sum(dim=1, dtype=torch.int32)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _library() -> ctypes.CDLL:
    """The built library, with the C signature declared: pointers and the
    stream as ``c_void_p`` (a bare int would be cut to 32 bits)."""
    lib = _build.load("nms")
    lib.nms_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p])
    lib.nms_forward.restype = ctypes.c_int
    lib.nms_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.nms_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _nms_kernel(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
                iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    p, n = scores.shape
    if n > MAX_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_BOXES} boxes per "
                         f"problem, got {n}")
    for name, t in (("boxes", boxes), ("scores", scores)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scores.device != boxes.device:
        raise ValueError(f"scores on {scores.device}, boxes on {boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (the kernel reads "
                         "each box as one float4)")
    out = torch.empty((p, max_outputs), dtype=torch.int32, device=boxes.device)
    num = torch.empty((p,), dtype=torch.int32, device=boxes.device)
    if p == 0 or max_outputs == 0 or n == 0:
        out.fill_(-1)
        num.zero_()
        return out, num
    lib = _library()
    # the sorted order and boxes, and the (P, N, ceil(N/64)) IoU bitmask
    scratch = torch.empty(lib.nms_scratch_bytes(p, n), dtype=torch.uint8,
                          device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_forward(_ptr(boxes), _ptr(scores), _ptr(scratch),
                              _ptr(out), _ptr(num), p, n, max_outputs,
                              iou_threshold, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    nms.launches += 1
    return out, num


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_outputs: int,
        iou_threshold: float = 0.5, score_threshold: float = float("-inf")
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS.

    Args:
      boxes: (P, N, 4) or (N, 4) float32 [ymin, xmin, ymax, xmax]
      scores: (P, N) or (N,) float32
      max_outputs: number of boxes to keep per problem (padded with -1)
    Returns (indices (P, max_outputs) int32 with -1 padding, num_valid (P,)
    int32), without the P axis for unbatched input.

    A CUDA tensor goes through the kernel, all P problems in one call (or
    the call raises): a sort of each problem's (score, index) keys, the IoU
    bitmask over that order, and a serial scan, on the current stream.  A
    CPU tensor goes through :func:`nms_plain`.  ``nms.launches`` counts
    kernel calls.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    if boxes.dim() != 3 or boxes.shape[2] != 4 or \
            scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes (P, N, 4) and scores (P, N) expected, got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    scores = premask(scores, score_threshold)
    if boxes.device.type == "cpu":
        out, num = nms_plain(boxes, scores, max_outputs, iou_threshold)
    elif boxes.device.type == "cuda":
        out, num = _nms_kernel(boxes.contiguous(), scores.contiguous(),
                               max_outputs, iou_threshold)
    else:
        raise ValueError(f"nms: unsupported device {boxes.device}")
    if single:
        return out[0], num[0]
    return out, num


nms.launches = 0


def gather_padded(values: torch.Tensor, indices: torch.Tensor, pad_value=0):
    """Gather rows by NMS indices along axis 1, replacing -1 slots with
    ``pad_value``: values (P, N, ...), indices (P, k) -> (P, k, ...)."""
    safe = indices.clamp_min(0).long()
    rows = torch.arange(values.shape[0], device=values.device)[:, None]
    out = values[rows, safe]
    mask = (indices >= 0).reshape(indices.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.full_like(out, pad_value))
