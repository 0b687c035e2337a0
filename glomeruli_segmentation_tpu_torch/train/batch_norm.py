"""BatchNorm's training-mode update as the JAX package makes it.

Flax's ``nn.BatchNorm`` and torch's ``nn.BatchNorm2d`` both normalise a
training batch with its biased variance, but update the running variance
differently: Flax with the biased one, ``ra = 0.9 ra + 0.1 var`` where
``var = E[x^2] - E[x]^2``; torch with the unbiased one (``var * n / (n -
1)``).  Torch's ``momentum=0.1`` is Flax's ``momentum=0.9``.  The trainers
train the port's plain models with :class:`FlaxBatchNorm2d` in place of
every ``nn.BatchNorm2d`` (:func:`use_flax_batch_norm`), so their running
statistics follow the JAX trainers'.  Evaluation mode and the state-dict
keys are those of ``nn.BatchNorm2d``; ``num_batches_tracked`` stays 0, as
the JAX package writes it in every checkpoint.

Inside a rank of a data axis (``parallel/distributed.py``) the layer takes
the statistics of the global batch, as GSPMD gives the JAX trainers on a
sharded batch.  Each rank takes its count, mean and sum of squared
deviations per channel in float32, one ``AllReduceSum`` over a (ranks, 3,
C) tensor holding them in the rank's slot gives every rank every rank's,
and Chan's rule combines them: the global mean, and the biased variance
as the summed deviations plus each rank's count times its mean's squared
distance from the global mean.  The gradient flows back through the
all-reduce.  Sums of ``x`` and ``x^2`` would take the same one all-reduce
but lose the variance to cancellation where a channel's mean is large
against its spread (the detector's first layer, on 0-255 windows), as
Flax's own float32 ``E[x^2] - E[x]^2`` does.

The two-pass variance is deliberate, on one device as across ranks: it is
the model's batch variance, where Flax's default one-pass form
(``use_fast_variance=True``) departs from it by ~8e-3 on such a channel;
``tests/test_torch_batch_norm.py`` holds it to float64 and to Flax's
two-pass form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import distributed


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running statistics take the
    batch's biased variance, computed in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if distributed.joined():
            return self._global_forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
        return out

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        c = xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        count = xf.new_full((c,), xf.numel() // c)
        mine = torch.stack([count, mean, var * count])
        zeros = torch.zeros_like(mine)
        stats = distributed.AllReduceSum.apply(torch.stack([
            mine if r == distributed.rank() else zeros
            for r in range(distributed.world())]))
        counts, means, m2 = stats.unbind(1)
        total = counts.sum(0)
        mean = (counts * means).sum(0) / total
        var = (m2.sum(0) + (counts * (means - mean) ** 2).sum(0)) / total
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
        return out.to(x.dtype)


def use_flax_batch_norm(model: nn.Module) -> nn.Module:
    """Give every ``nn.BatchNorm2d`` of ``model`` the Flax update, in
    place (the modules keep their parameters and buffers); returns
    ``model``."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = FlaxBatchNorm2d
    return model
