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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode running statistics take the
    batch's biased variance, computed in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
        return out


def use_flax_batch_norm(model: nn.Module) -> nn.Module:
    """Give every ``nn.BatchNorm2d`` of ``model`` the Flax update, in
    place (the modules keep their parameters and buffers); returns
    ``model``."""
    for m in model.modules():
        if type(m) is nn.BatchNorm2d:
            m.__class__ = FlaxBatchNorm2d
    return model
