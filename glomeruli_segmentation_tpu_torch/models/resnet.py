"""ResNet-v1 backbone of the detector (NCHW ``nn.Module``s).

Counterpart of ``glomeruli_segmentation_tpu/models/resnet.py``:
``conv1..block3`` give the stride-16 first-stage features and ``block4``,
applied to each ROI crop, is the second-stage head.  Module and key names
follow the JAX package's Flax tree, with each conv and its BatchNorm under
one ``ConvBN`` (the Flax ``c2_conv``/``c2_bn`` pair is ``c2`` here, the stem's
``conv1``/``bn1`` is ``conv1``).

Two forms.  For inference (the default), the state these modules load
(``convert/detector_import``) keeps BatchNorm as
``<name>.bn.{scale,bias,mean,var}``; :func:`fold_batchnorm` folds each BN
(eps 1e-5) into its conv's weight and bias when the state is loaded, so a
``ConvBN`` runs as one biased conv.  For training (``train_form=True``)
each ``ConvBN`` keeps an unbiased conv and its BatchNorm, with the Flax
rule of the JAX package's ``nn.BatchNorm(momentum=0.997, epsilon=1e-5)``
(:class:`..train.batch_norm.FlaxBatchNorm2d`, torch ``momentum=0.003``):
batch statistics in train mode, running statistics updated with the
biased batch variance, parameters and statistics in float32;
:func:`train_state_dict` and :func:`detector_state` map its keys to and
from the detector state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..train.batch_norm import FlaxBatchNorm2d

BN_EPS = 1e-5
# Flax's BatchNorm momentum 0.997 keeps 0.997 of the running statistics a
# step; torch's momentum is the share of the batch's
BN_MOMENTUM = 1 - 0.997
_BN_PARTS = ("scale", "bias", "mean", "var")
# detector-state BN part -> the training form's nn.BatchNorm2d entry
_BN_TRAIN_KEYS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}


def fold_batchnorm(state: Mapping[str, torch.Tensor], eps: float = BN_EPS
                   ) -> Dict[str, torch.Tensor]:
    """A state with ``<name>.conv.weight`` + ``<name>.bn.{scale,bias,mean,
    var}`` entries -> one with ``<name>.conv.weight`` scaled per output
    channel and ``<name>.conv.bias`` (y = conv(x) * s + (bias - mean * s),
    s = scale / sqrt(var + eps), computed in float32).  Other entries are
    passed through."""
    out = {k: v for k, v in state.items()
           if not any(k.endswith(".bn." + p) for p in _BN_PARTS)}
    for key in state:
        if not key.endswith(".bn.scale"):
            continue
        name = key[: -len(".bn.scale")]
        scale, bias, mean, var = (state[f"{name}.bn.{p}"].float()
                                  for p in _BN_PARTS)
        s = scale / torch.sqrt(var + eps)
        weight = state[f"{name}.conv.weight"].float()
        out[f"{name}.conv.weight"] = weight * s.view(-1, 1, 1, 1)
        out[f"{name}.conv.bias"] = bias - mean * s
    return out


def train_state_dict(state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A detector state (``<name>.bn.{scale,bias,mean,var}``) -> the
    training form's state dict (``<name>.bn.{weight,bias,running_mean,
    running_var,num_batches_tracked}``, the count 0)."""
    out = {}
    for key, value in state.items():
        name, _, part = key.rpartition(".")
        if name.endswith(".bn") and part in _BN_TRAIN_KEYS:
            out[f"{name}.{_BN_TRAIN_KEYS[part]}"] = value
            if part == "scale":
                out[f"{name}.num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long)
        else:
            out[key] = value
    return out


def detector_state(train_state: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`train_state_dict`: float32 CPU tensors, no
    ``num_batches_tracked``."""
    back = {v: k for k, v in _BN_TRAIN_KEYS.items()}
    out = {}
    for key, value in train_state.items():
        name, _, part = key.rpartition(".")
        if part == "num_batches_tracked":
            continue
        if name.endswith(".bn") and part in back:
            key = f"{name}.{back[part]}"
        out[key] = value.detach().float().cpu().clone()
    return out


class ConvBN(nn.Module):
    """Conv (no bias of its own) + BatchNorm (+ ReLU).  For inference the
    BN is folded into the conv's weight and bias at load time; with
    ``train_form`` it is a :class:`FlaxBatchNorm2d` of its own, ``bn``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, relu: bool = True,
                 train_form: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride,
                              padding=dilation * (kernel - 1) // 2,
                              dilation=dilation, bias=not train_form)
        self.bn = FlaxBatchNorm2d(out_ch, eps=BN_EPS, momentum=BN_MOMENTUM) \
            if train_form else None
        self.relu = relu

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        return F.relu(y) if self.relu else y


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (carries the stride), 1x1 expand to 4x; a strided
    1x1 projection on the shortcut when ``project``."""

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dilation: int = 1, project: bool = False,
                 train_form: bool = False):
        super().__init__()
        t = train_form
        self.proj = ConvBN(in_ch, 4 * features, 1, stride, relu=False,
                           train_form=t) if project else None
        self.c1 = ConvBN(in_ch, features, 1, train_form=t)
        self.c2 = ConvBN(features, features, 3, stride, dilation,
                         train_form=t)
        self.c3 = ConvBN(features, 4 * features, 1, relu=False, train_form=t)

    def forward(self, x):
        shortcut = x if self.proj is None else self.proj(x)
        return F.relu(shortcut + self.c3(self.c2(self.c1(x))))


class ResNetStage(nn.Module):
    def __init__(self, in_ch: int, features: int, blocks: int,
                 stride: int = 2, dilation: int = 1,
                 train_form: bool = False):
        super().__init__()
        for i in range(blocks):
            self.add_module(f"block{i}", Bottleneck(
                in_ch if i == 0 else 4 * features, features,
                stride=stride if i == 0 else 1, dilation=dilation,
                project=i == 0, train_form=train_form))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class ResNetC4(nn.Module):
    """conv1..block3: stride-16 feature extractor, ``16 * width``
    channels out."""

    def __init__(self, depths: Tuple[int, int, int] = (3, 4, 6),
                 width: int = 64, train_form: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.width = width
        t = train_form
        self.conv1 = ConvBN(3, width, 7, 2, train_form=t)
        self.block1 = ResNetStage(width, width, depths[0], stride=1,
                                  train_form=t)
        self.block2 = ResNetStage(4 * width, 2 * width, depths[1],
                                  train_form=t)
        self.block3 = ResNetStage(8 * width, 4 * width, depths[2],
                                  train_form=t)
        self.out_channels = 16 * width

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)  # pads with -inf, as Flax
        return self.block3(self.block2(self.block1(x)))


class ResNetBlock4(nn.Module):
    """block4 on the ROI crops (second-stage head): stride 2, ``32 * width``
    channels out.  The inner stage is named ``block4`` too, as in Flax."""

    def __init__(self, in_ch: int, blocks: int = 3, width: int = 64,
                 train_form: bool = False):
        super().__init__()
        self.block4 = ResNetStage(in_ch, 8 * width, blocks, stride=2,
                                  train_form=train_form)
        self.out_channels = 32 * width

    def forward(self, x):
        return self.block4(x)


class TinyBackbone(nn.Module):
    """Small stride-16 CNN for tests."""

    def __init__(self, width: int = 32, train_form: bool = False):
        super().__init__()
        in_ch = 3
        for i in range(4):
            out = width * min(2 ** i, 4)
            self.add_module(f"c{i}", ConvBN(in_ch, out, 3, 2,
                                            train_form=train_form))
            in_ch = out
        self.out_channels = in_ch

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class TinyHead(nn.Module):
    def __init__(self, in_ch: int, width: int = 64,
                 train_form: bool = False):
        super().__init__()
        self.h0 = ConvBN(in_ch, width, 3, 2, train_form=train_form)
        self.out_channels = width

    def forward(self, x):
        return self.h0(x)
