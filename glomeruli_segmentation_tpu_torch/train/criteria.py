"""Training losses.

Counterpart of ``glomeruli_segmentation_tpu/train/criteria.py``:
``cross_entropy_2d`` replicates the upstream-ESPNet ``CrossEntropyLoss2d``
the reference trains with (``module/espnet/train/main.py:8,250-258``):
2-D log-softmax + NLL with per-class weights, mean-reduced over weighted
pixels (torch ``NLLLoss`` weighted-mean semantics), on the port's NCHW
logits.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy_2d(logits: torch.Tensor, labels: torch.Tensor,
                     class_weights: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted 2-D cross entropy, always reduced in float32.

    Args:
      logits: (N, C, H, W) float
      labels: (N, H, W) int64 or int32
      class_weights: (C,) float or None
      valid: (N,) bool or None — samples padded onto a ragged
        data-parallel batch carry False and drop out of both the
        numerator and the weight denominator (valid=None or all-True is
        identical to the reference math).
    Returns scalar loss: sum(w_y * nll) / sum(w_y) (torch weighted mean).
    """
    log_probs = F.log_softmax(logits.float(), dim=1)
    labels = labels.long()
    nll = -log_probs.gather(1, labels.unsqueeze(1)).squeeze(1)
    w = (torch.ones_like(nll) if class_weights is None
         else class_weights.to(nll)[labels])
    if valid is not None:
        w = w * valid.to(w)[:, None, None]
    return (w * nll).sum() / w.sum()
