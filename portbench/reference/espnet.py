"""Plain ESPNet with its light decoder, float32, as published.

The architecture of Mehta et al., "ESPNet: Efficient Spatial Pyramid of
Dilated Convolutions for Semantic Segmentation" (ECCV 2018), in the form
of the glomerulus segmenter's ``Model.py`` (``ESPNet`` with ``p`` level-2
and ``q`` level-3 blocks), whose ``espnet_fold1..5.pth`` checkpoints use
these module names.  Bias-free convolutions with symmetric padding,
BatchNorm eps 1e-3, per-channel PReLU, count-include-pad 3x3/2 average
pooling, 2x2/2 transposed convolutions in the decoder.

Plain ``torch.nn`` modules only: no kernel, no packing, no batching trick.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


def _split(n_out: int):
    n = n_out // 5
    return n, n_out - 4 * n


class C(nn.Module):
    def __init__(self, n_in, n_out, k, stride=1, dilation=1):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, k, stride=stride,
                              padding=(k - 1) // 2 * dilation,
                              dilation=dilation, bias=False)

    def forward(self, x):
        return self.conv(x)


class BR(nn.Module):
    def __init__(self, n_out):
        super().__init__()
        self.bn = nn.BatchNorm2d(n_out, eps=BN_EPS)
        self.act = nn.PReLU(n_out)

    def forward(self, x):
        return self.act(self.bn(x))


class CBR(nn.Module):
    def __init__(self, n_in, n_out, k, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, k, stride=stride,
                              padding=(k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(n_out, eps=BN_EPS)
        self.act = nn.PReLU(n_out)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _Branches(nn.Module):
    def __init__(self, n_in, n_out, reduce_k, reduce_stride):
        super().__init__()
        n, n1 = _split(n_out)
        self.c1 = C(n_in, n, reduce_k, reduce_stride)
        self.d1 = C(n, n1, 3, dilation=1)
        self.d2 = C(n, n, 3, dilation=2)
        self.d4 = C(n, n, 3, dilation=4)
        self.d8 = C(n, n, 3, dilation=8)
        self.d16 = C(n, n, 3, dilation=16)

    def combine(self, x):
        r = self.c1(x)
        add1 = self.d2(r)
        add2 = add1 + self.d4(r)
        add3 = add2 + self.d8(r)
        add4 = add3 + self.d16(r)
        return torch.cat([self.d1(r), add1, add2, add3, add4], 1)


class DownSamplerB(_Branches):
    def __init__(self, n_in, n_out):
        super().__init__(n_in, n_out, 3, 2)
        self.bn = nn.BatchNorm2d(n_out, eps=BN_EPS)
        self.act = nn.PReLU(n_out)

    def forward(self, x):
        return self.act(self.bn(self.combine(x)))


class DilatedParllelResidualBlockB(_Branches):
    def __init__(self, n_in, n_out):
        super().__init__(n_in, n_out, 1, 1)
        self.bn = BR(n_out)

    def forward(self, x):
        return self.bn(x + self.combine(x))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class ESPNetEncoder(nn.Module):
    def __init__(self, classes=5, p=2, q=8):
        super().__init__()
        self.level1 = CBR(3, 16, 3, 2)
        self.b1 = BR(16 + 3)
        self.level2_0 = DownSamplerB(16 + 3, 64)
        self.level2 = nn.ModuleList(
            DilatedParllelResidualBlockB(64, 64) for _ in range(p))
        self.b2 = BR(128 + 3)
        self.level3_0 = DownSamplerB(128 + 3, 128)
        self.level3 = nn.ModuleList(
            DilatedParllelResidualBlockB(128, 128) for _ in range(q))
        self.b3 = BR(256)
        self.classifier = C(256, classes, 1)

    def forward(self, x):
        out0 = self.level1(x)
        inp1 = _avg_pool(x)
        inp2 = _avg_pool(inp1)
        out0_cat = self.b1(torch.cat([out0, inp1], 1))
        out1_0 = self.level2_0(out0_cat)
        out = out1_0
        for block in self.level2:
            out = block(out)
        out1_cat = self.b2(torch.cat([out, out1_0, inp2], 1))
        out2_0 = self.level3_0(out1_cat)
        out = out2_0
        for block in self.level3:
            out = block(out)
        logits = self.classifier(self.b3(torch.cat([out2_0, out], 1)))
        return logits, out0_cat, out1_cat


class ESPNet(nn.Module):
    """(N, 3, H, W) normalised BGR -> (N, classes, H, W) logits."""

    def __init__(self, classes=5, p=2, q=8):
        super().__init__()
        c = classes
        self.encoder = ESPNetEncoder(classes, p, q)
        self.level3_C = C(128 + 3, c, 1)
        self.br = nn.BatchNorm2d(c, eps=BN_EPS)
        self.conv = CBR(19 + c, c, 3)
        self.up_l3 = nn.Sequential(
            nn.ConvTranspose2d(c, c, 2, stride=2, bias=False))
        self.combine_l2_l3 = nn.Sequential(BR(2 * c), CBR(2 * c, c, 3))
        self.up_l2 = nn.Sequential(
            nn.ConvTranspose2d(c, c, 2, stride=2, bias=False), BR(c))
        self.classifier = nn.ConvTranspose2d(c, c, 2, stride=2, bias=False)

    def forward(self, x):
        enc, out0_cat, out1_cat = self.encoder(x)
        out2_c = self.up_l3(self.br(enc))
        out1_c = self.level3_C(out1_cat)
        comb = self.up_l2(self.combine_l2_l3(torch.cat([out1_c, out2_c], 1)))
        return self.classifier(self.conv(torch.cat([comb, out0_cat], 1)))
