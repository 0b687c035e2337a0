"""InceptionV2 trunk with TF-slim semantics: the frozen-graph detector's
backbone, as ``nn.Module``s over NCHW activations in ``channels_last``
memory.

Counterpart of ``glomeruli_segmentation_tpu/models/inception_v2.py``.  The
first stage runs the stem and ``Mixed_3b..Mixed_4e`` (stride 16); the
second stage runs ``Mixed_5a..Mixed_5c`` on the ROI crops.  Module names
follow the parameter tree of :func:`..convert.pb_import.
assemble_od_api_params` (``Mixed_3b.Branch_0.Conv2d_0a_1x1``), and every
width comes from its kernels, never from a constant.  TF semantics kept:

- SAME padding puts the odd pixel at the end (bottom, right): a 7x7/2 conv
  on 600 pads (2, 3), a 3x3/2 pool on an even size (0, 1).  Symmetric
  padding is passed to the op; asymmetric padding is an ``F.pad`` first
  (zeros for convs, -inf for max pools);
- the average pool leaves the padding out of the mean;
- the stem ``Conv2d_1a_7x7`` is depthwise-separable: depthwise 7x7/2 whose
  output channel ``ic * M + m`` is TF's, then pointwise 1x1;
- ReLU after every trunk conv.  Batch norm is folded into each conv's
  weight and bias when the tree is made.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding of one axis: (before, after), the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride: int):
    (t, b), (l, r) = (same_pads(x.shape[2], kh, stride),
                      same_pads(x.shape[3], kw, stride))
    return (t, b), (l, r), t == b and l == r


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias=None,
              stride: int = 1, groups: int = 1) -> torch.Tensor:
    """TF-style SAME conv: NCHW ``x``, OIHW ``weight``, optional bias."""
    (t, b), (l, r), symmetric = _pads(x, weight.shape[2], weight.shape[3],
                                      stride)
    if not symmetric:
        x, t, l = F.pad(x, (l, r, t, b)), 0, 0
    return F.conv2d(x, weight, bias, stride, (t, l), groups=groups)


def depthwise_weight(w_tf: torch.Tensor) -> torch.Tensor:
    """TF depthwise kernel (H, W, IC, M) -> (IC * M, 1, H, W) for a conv
    with ``groups=IC``: output channel ``ic * M + m``, as TF's."""
    kh, kw, ic, m = w_tf.shape
    return w_tf.permute(2, 3, 0, 1).reshape(ic * m, 1, kh, kw)


def depthwise_conv_same(x: torch.Tensor, w_tf: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """TF depthwise conv; ``w_tf`` in the TF layout (H, W, IC, M)."""
    return conv_same(x, depthwise_weight(w_tf.to(x)), None, stride,
                     groups=w_tf.shape[2])


def max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 1
                  ) -> torch.Tensor:
    (t, b), (l, r), symmetric = _pads(x, k, k, stride)
    if symmetric and 2 * t <= k and 2 * l <= k:
        return F.max_pool2d(x, k, stride, (t, l))
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), k,
                        stride)


def avg_pool_same(x: torch.Tensor, k: int = 3, stride: int = 1
                  ) -> torch.Tensor:
    """TF AvgPool: the mean over the valid (unpadded) elements only."""
    (t, b), (l, r), symmetric = _pads(x, k, k, stride)
    if symmetric and 2 * t <= k and 2 * l <= k:
        return F.avg_pool2d(x, k, stride, (t, l), count_include_pad=False)
    summed = F.avg_pool2d(F.pad(x, (l, r, t, b)), k, stride,
                          divisor_override=1)
    ones = F.pad(torch.ones((1, 1) + x.shape[2:], dtype=x.dtype,
                            device=x.device), (l, r, t, b))
    return summed / F.avg_pool2d(ones, k, stride, divisor_override=1)


class ConvSame(nn.Conv2d):
    """A biased conv with TF SAME padding (no activation: the block applies
    the ReLU, so a hook on this module sees the pre-activation output)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride, groups=groups,
                         bias=bias)

    def forward(self, x):
        return conv_same(x, self.weight, self.bias, self.stride[0],
                         self.groups)

    def load(self, p: Mapping) -> None:
        """Copy ``p["w"]``, an HWIO kernel, into this conv's OIHW weight and
        ``p["b"]`` into its bias."""
        w = torch.from_numpy(np.asarray(p["w"]))
        self.assign(w.permute(3, 2, 0, 1), p["b"])

    def tree(self) -> dict:
        """The inverse of :meth:`load`: ``{"w": HWIO kernel, "b": bias}``,
        float32 numpy."""
        return {"w": as_numpy(self.weight.permute(2, 3, 1, 0)),
                "b": as_numpy(self.bias)}

    def assign(self, w_oihw: torch.Tensor, b: np.ndarray = None) -> None:
        if tuple(w_oihw.shape) != tuple(self.weight.shape):
            raise ValueError(f"kernel {tuple(w_oihw.shape)} for a conv of "
                             f"{tuple(self.weight.shape)}")
        with torch.no_grad():
            self.weight.copy_(w_oihw)
            if b is not None:
                self.bias.copy_(torch.from_numpy(np.asarray(b)))


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def conv_like(p: Mapping, stride: int = 1) -> ConvSame:
    """A conv shaped for the HWIO kernel ``p["w"]`` (not loaded)."""
    kh, _, cin, cout = p["w"].shape
    return ConvSame(cin, cout, kh, stride)


class SeparableStem(nn.Module):
    """``Conv2d_1a_7x7``: depthwise 7x7/2 (no bias), pointwise 1x1 with the
    folded BN, ReLU."""

    def __init__(self, p: Mapping):
        super().__init__()
        kh, _, ic, m = p["dw"].shape
        self.depthwise = ConvSame(ic, ic * m, kh, 2, groups=ic, bias=False)
        self.pointwise = ConvSame(ic * m, p["pw"].shape[3], 1)

    def load(self, p: Mapping) -> None:
        self.depthwise.assign(depthwise_weight(torch.from_numpy(
            np.asarray(p["dw"]))))
        self.pointwise.load({"w": p["pw"], "b": p["b"]})

    def tree(self) -> dict:
        """The inverse of :meth:`load`: ``{"dw": (H, W, IC, M), "pw": HWIO,
        "b"}``, float32 numpy."""
        w = self.depthwise.weight                      # (IC * M, 1, H, W)
        ic = self.depthwise.groups
        dw = w.reshape(ic, w.shape[0] // ic, *w.shape[2:]).permute(2, 3, 0, 1)
        pw = self.pointwise.tree()
        return {"dw": as_numpy(dw), "pw": pw["w"], "b": pw["b"]}

    def forward(self, x):
        return F.relu(self.pointwise(self.depthwise(x)))


# Inception block topology (slim inception_v2.inception_v2_base).  Branch
# kinds: t1 = 1x1; t3 = 1x1 -> 3x3; d3 = 1x1 -> 3x3 -> 3x3; avg/max = 3x3
# pool -> 1x1 projection.  "downsample": 1x1 -> 3x3/2; 1x1 -> 3x3 ->
# 3x3/2; 3x3/2 max pool.
_STANDARD = ("t1", "t3", "d3", "avg")
_BLOCKS = {
    "Mixed_3b": _STANDARD,
    "Mixed_3c": _STANDARD,
    "Mixed_4a": "downsample",
    "Mixed_4b": _STANDARD,
    "Mixed_4c": _STANDARD,
    "Mixed_4d": _STANDARD,
    "Mixed_4e": _STANDARD,
    "Mixed_5a": "downsample",
    "Mixed_5b": _STANDARD,
    "Mixed_5c": ("t1", "t3", "d3", "max"),  # 5c projects a max pool
}
_BRANCH_CONVS = {
    "t1": ("Conv2d_0a_1x1",),
    "t3": ("Conv2d_0a_1x1", "Conv2d_0b_3x3"),
    "d3": ("Conv2d_0a_1x1", "Conv2d_0b_3x3", "Conv2d_0c_3x3"),
    "avg": ("Conv2d_0b_1x1",),
    "max": ("Conv2d_0b_1x1",),
}
_DOWNSAMPLE_CONVS = (("Conv2d_0a_1x1", "Conv2d_1a_3x3"),
                     ("Conv2d_0a_1x1", "Conv2d_0b_3x3", "Conv2d_1a_3x3"))
FIRST_BLOCKS = ("Mixed_3b", "Mixed_3c", "Mixed_4a", "Mixed_4b", "Mixed_4c",
                "Mixed_4d", "Mixed_4e")
SECOND_BLOCKS = ("Mixed_5a", "Mixed_5b", "Mixed_5c")


def block_convs(name: str) -> Tuple[Tuple[str, ...], ...]:
    """The conv names of each branch of block ``name``, in order; the
    kernel size ends each name (``_1x1``, ``_3x3``)."""
    spec = _BLOCKS[name]
    if spec == "downsample":
        return _DOWNSAMPLE_CONVS
    return tuple(_BRANCH_CONVS[kind] for kind in spec)


class InceptionBlock(nn.Module):
    """One ``Mixed_*`` block: its branches side by side, concatenated along
    the channels in branch order."""

    def __init__(self, name: str, p: Mapping):
        super().__init__()
        spec = _BLOCKS[name]
        self.kinds = (("conv", "conv", "maxpool2") if spec == "downsample"
                      else spec)
        for i, names in enumerate(block_convs(name)):
            # the last conv of a downsample branch (Conv2d_1a_3x3) has
            # stride 2
            self.add_module(f"Branch_{i}", nn.ModuleDict({
                conv: conv_like(p[f"Branch_{i}"][conv],
                                2 if conv.startswith("Conv2d_1a") else 1)
                for conv in names}))

    def forward(self, x):
        outs = []
        for i, kind in enumerate(self.kinds):
            if kind == "maxpool2":
                outs.append(max_pool_same(x, 3, 2))
                continue
            y = x
            if kind == "avg":
                y = avg_pool_same(x, 3, 1)
            elif kind == "max":
                y = max_pool_same(x, 3, 1)
            for conv in getattr(self, f"Branch_{i}").values():
                y = F.relu(conv(y))
            outs.append(y)
        return torch.cat(outs, dim=1)


class ProposalFeatures(nn.Module):
    """First-stage trunk: stem, ``Conv2d_2b_1x1``, ``Conv2d_2c_3x3``,
    ``Mixed_3b..Mixed_4e``; stride 16.  The input is the preprocessed image
    ((2/255) * pixel - 1)."""

    def __init__(self, p: Mapping):
        super().__init__()
        self.Conv2d_1a_7x7 = SeparableStem(p["Conv2d_1a_7x7"])
        self.Conv2d_2b_1x1 = conv_like(p["Conv2d_2b_1x1"])
        self.Conv2d_2c_3x3 = conv_like(p["Conv2d_2c_3x3"])
        for name in FIRST_BLOCKS:
            self.add_module(name, InceptionBlock(name, p[name]))

    def forward(self, x):
        y = max_pool_same(self.Conv2d_1a_7x7(x), 3, 2)
        y = F.relu(self.Conv2d_2b_1x1(y))
        y = max_pool_same(F.relu(self.Conv2d_2c_3x3(y)), 3, 2)
        for name in FIRST_BLOCKS:
            y = getattr(self, name)(y)
        return y


class ClassifierFeatures(nn.Module):
    """Second-stage head: ``Mixed_5a..Mixed_5c`` over the ROI crops."""

    def __init__(self, p: Mapping):
        super().__init__()
        for name in SECOND_BLOCKS:
            self.add_module(name, InceptionBlock(name, p[name]))

    def forward(self, x):
        for name in SECOND_BLOCKS:
            x = getattr(self, name)(x)
        return x


def load_tree(module: nn.Module, p: Mapping) -> None:
    """Copy the parameter tree ``p`` into ``module``'s convs, child by child:
    module names are the tree's keys."""
    for name, child in module.named_children():
        if isinstance(child, (ConvSame, SeparableStem)):
            child.load(p[name])
        else:
            load_tree(child, p[name])


def tree_of(module: nn.Module) -> dict:
    """The inverse of :func:`load_tree`: ``module``'s convs as a parameter
    tree keyed by module names, float32 numpy leaves."""
    return {name: child.tree() if isinstance(child, (ConvSame, SeparableStem))
            else tree_of(child) for name, child in module.named_children()}
