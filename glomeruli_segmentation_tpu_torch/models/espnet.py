"""ESPNet / ESPNet-C as plain ``nn.Module``s, NCHW, with the reference
``.pth`` key layout.

Counterpart of ``glomeruli_segmentation_tpu/models/espnet.py``.  Module and
parameter names follow the reference network (``module/espnet/train/
Model.py`` in jinseikenai/glomeruli_segmentation), so a reference
checkpoint loads with ``load_state_dict(strict=True)``: bias-free convs
with torch's symmetric padding ``(k-1)//2 * d``, BatchNorm eps 1e-3,
per-channel PReLU, count-include-pad 3x3/2 average pooling, and 2x2/2
transposed convs in the decoder, whose ``up_l3`` takes a plain BN with no
PReLU.

This is the port's oracle: the inference path (``espnet_fused``) is tested
against it, and it is not on the main path.  Channel arithmetic:
``n = nOut // 5``, ``n1 = nOut - 4n`` (64 -> 12/16, 128 -> 25/28).
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

BN_EPS = 1e-3


def _esp_split(n_out: int):
    n = n_out // 5
    return n, n_out - 4 * n


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``AvgPool2d(3, stride=2, padding=1)``, count_include_pad=True."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class C(nn.Module):
    """Bias-free conv with symmetric padding (ref ``C`` / ``CDilated``)."""

    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, k, stride=stride,
                              padding=(k - 1) // 2 * dilation,
                              dilation=dilation, bias=False)

    def forward(self, x):
        return self.conv(x)


class BR(nn.Module):
    """BatchNorm + PReLU (ref ``BR``)."""

    def __init__(self, n_out: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(n_out, eps=BN_EPS)
        self.act = nn.PReLU(n_out)

    def forward(self, x):
        return self.act(self.bn(x))


class CBR(nn.Module):
    """Conv + BatchNorm + PReLU (ref ``CBR``)."""

    def __init__(self, n_in: int, n_out: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, k, stride=stride,
                              padding=(k - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(n_out, eps=BN_EPS)
        self.act = nn.PReLU(n_out)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _ESPBranches(nn.Module):
    """The reduce conv and five dilated branches shared by both ESP units;
    returns the hierarchical-add concat."""

    def __init__(self, n_in: int, n_out: int, reduce_k: int,
                 reduce_stride: int):
        super().__init__()
        n, n1 = _esp_split(n_out)
        self.c1 = C(n_in, n, reduce_k, reduce_stride)
        self.d1 = C(n, n1, 3, dilation=1)
        self.d2 = C(n, n, 3, dilation=2)
        self.d4 = C(n, n, 3, dilation=4)
        self.d8 = C(n, n, 3, dilation=8)
        self.d16 = C(n, n, 3, dilation=16)

    def combine(self, x):
        reduced = self.c1(x)
        add1 = self.d2(reduced)
        add2 = add1 + self.d4(reduced)
        add3 = add2 + self.d8(reduced)
        add4 = add3 + self.d16(reduced)
        return torch.cat([self.d1(reduced), add1, add2, add3, add4], 1)


class DownSamplerB(_ESPBranches):
    """ESP downsampling unit (ref ``DownSamplerB``)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__(n_in, n_out, 3, 2)
        self.bn = nn.BatchNorm2d(n_out, eps=BN_EPS)
        self.act = nn.PReLU(n_out)

    def forward(self, x):
        return self.act(self.bn(self.combine(x)))


class DilatedParllelResidualBlockB(_ESPBranches):
    """ESP residual block (ref ``DilatedParllelResidualBlockB``)."""

    def __init__(self, n_in: int, n_out: int, add: bool = True):
        super().__init__(n_in, n_out, 1, 1)
        self.bn = BR(n_out)
        self.add = add

    def forward(self, x):
        combine = self.combine(x)
        if self.add:
            combine = x + combine
        return self.bn(combine)


class ESPNetEncoder(nn.Module):
    """ESPNet-C (ref ``ESPNet_Encoder``): logits at 1/8 of the input."""

    def __init__(self, classes: int = 5, p: int = 2, q: int = 8):
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

    def forward(self, x, return_intermediates: bool = False):
        output0 = self.level1(x)
        inp1 = avg_pool_3x3_s2(x)
        inp2 = avg_pool_3x3_s2(inp1)
        output0_cat = self.b1(torch.cat([output0, inp1], 1))
        output1_0 = self.level2_0(output0_cat)
        out = output1_0
        for block in self.level2:
            out = block(out)
        output1_cat = self.b2(torch.cat([out, output1_0, inp2], 1))
        output2_0 = self.level3_0(output1_cat)
        out = output2_0
        for block in self.level3:
            out = block(out)
        logits = self.classifier(self.b3(torch.cat([output2_0, out], 1)))
        if return_intermediates:
            return logits, output0_cat, output1_cat
        return logits


class ESPNet(nn.Module):
    """Full ESPNet: the encoder plus the reference's light decoder (ref
    ``ESPNet``).  Output at input resolution."""

    def __init__(self, classes: int = 5, p: int = 2, q: int = 8):
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
        enc_logits, output0_cat, output1_cat = self.encoder(
            x, return_intermediates=True)
        output2_c = self.up_l3(self.br(enc_logits))
        output1_c = self.level3_C(output1_cat)
        comb = self.combine_l2_l3(torch.cat([output1_c, output2_c], 1))
        comb = self.up_l2(comb)
        feats = self.conv(torch.cat([comb, output0_cat], 1))
        return self.classifier(feats)


def create_espnet(classes: int = 5, p: int = 2, q: int = 8,
                  decoder: bool = True) -> nn.Module:
    return (ESPNet if decoder else ESPNetEncoder)(classes, p, q)
