"""ESPNet inference forward with the fused ESP block kernel at level 3.

Counterpart of ``glomeruli_segmentation_tpu/models/espnet_fused.py``.  BN is
folded into scale/bias once, at construction (inference only).  The q
level-3 residual blocks run through :func:`..ops.esp_block.esp_block_fused`
when ``fuse_level3`` is on, and through :meth:`FusedESPNet._esp_plain` (the
JAX package's ``_esp_xla``) when it is off.  Level 1, level 2, the
downsamplers, the BN/PReLU glue and the decoder are plain torch ops, as the
JAX package leaves them to XLA.

Activations are NCHW tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` hands the kernel its NHWC operand without a copy.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..convert.espnet_import import infer_architecture
from ..ops.esp_block import (BRANCHES, DILATIONS, _np, esp_block_fused,
                             fold_bn, pack_esp_weights)
from .espnet import avg_pool_3x3_s2

Pack = Dict[str, torch.Tensor]


def _conv(x, kernel, stride=1, dilation=1):
    k = kernel.shape[-1]
    return F.conv2d(x, kernel, stride=stride,
                    padding=(k - 1) // 2 * dilation, dilation=dilation)


def _affine_prelu(x, scale, bias, alpha):
    """Folded BN + PReLU in x's type (the JAX package rounds the affine
    operands to the activation type the same way)."""
    y = x * scale.to(x.dtype).view(1, -1, 1, 1) \
        + bias.to(x.dtype).view(1, -1, 1, 1)
    return torch.clamp_min(y, 0) \
        + alpha.to(x.dtype).view(1, -1, 1, 1) * torch.clamp_max(y, 0)


def _affine(x, scale, bias):
    """Folded BN without PReLU, in x's type."""
    return x * scale.to(x.dtype).view(1, -1, 1, 1) \
        + bias.to(x.dtype).view(1, -1, 1, 1)


def _upconv2x2(x, kernel):
    """2x2 stride-2 transposed conv; ``kernel`` is (I, O, 2, 2)."""
    return F.conv_transpose2d(x, kernel, stride=2)


class FusedESPNet:
    """Packs an ESPNet(-C) state dict once; applies the folded-BN forward.

    ``dtype`` is the compute type of activations and conv kernels (the
    folded affines stay float32).  The forward takes and returns NCHW
    tensors on ``device``; it keeps activations in channels_last memory.
    """

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 fuse_level3: bool = True, dtype=torch.float32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.fuse_level3 = fuse_level3
        self.classes, self.p, self.q, self.has_decoder = \
            infer_architecture(state_dict)
        self._sd = state_dict
        pre = "encoder." if self.has_decoder else ""
        self.enc = {
            "level1": self._pack_cbr(pre + "level1."),
            "b1": self._pack_br(pre + "b1."),
            "down2": self._pack_down(pre + "level2_0."),
            "level2": [self._pack_esp_raw(f"{pre}level2.{i}.")
                       for i in range(self.p)],
            "b2": self._pack_br(pre + "b2."),
            "down3": self._pack_down(pre + "level3_0."),
            # only the selected level-3 form is packed
            "level3": [self._pack_esp_fused(f"{pre}level3.{i}.")
                       if fuse_level3 else
                       self._pack_esp_raw(f"{pre}level3.{i}.")
                       for i in range(self.q)],
            "b3": self._pack_br(pre + "b3."),
            "classifier": self._kernel(pre + "classifier.conv.weight"),
        }
        self.dec = self._pack_decoder() if self.has_decoder else None
        del self._sd

    # ---------------- packing ----------------
    def _kernel(self, key: str) -> torch.Tensor:
        return self._sd[key].to(self.device, self.dtype).contiguous()

    def _f32(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def _affine(self, bn: str):
        sd = self._sd
        scale, bias = fold_bn(*(_np(sd[bn + k]) for k in (
            "weight", "bias", "running_mean", "running_var")))
        return self._f32(scale), self._f32(bias)

    def _pack_br(self, prefix: str) -> Pack:
        scale, bias = self._affine(prefix + "bn.")
        return {"scale": scale, "bias": bias,
                "alpha": self._f32(_np(self._sd[prefix + "act.weight"]))}

    def _pack_cbr(self, prefix: str) -> Pack:
        return {"kernel": self._kernel(prefix + "conv.weight"),
                **self._pack_br(prefix)}

    def _branches(self, prefix: str):
        return [self._kernel(f"{prefix}{m}.conv.weight") for m in BRANCHES]

    def _pack_down(self, prefix: str) -> Pack:
        return {"c1": self._kernel(prefix + "c1.conv.weight"),
                "branches": self._branches(prefix),
                **self._pack_br(prefix)}

    def _pack_esp_raw(self, prefix: str) -> Pack:
        """Raw kernels + folded affine for the plain (unfused) block."""
        return {"c1": self._kernel(prefix + "c1.conv.weight"),
                "branches": self._branches(prefix),
                **self._pack_br(prefix + "bn.")}

    def _pack_esp_fused(self, prefix: str) -> Pack:
        w1, wd, scale, bias, alpha = pack_esp_weights(self._sd, prefix)
        return {"w1": torch.as_tensor(w1, device=self.device,
                                      dtype=self.dtype).contiguous(),
                "wd": torch.as_tensor(wd, device=self.device,
                                      dtype=self.dtype).contiguous(),
                "scale": self._f32(scale), "bias": self._f32(bias),
                "alpha": self._f32(alpha)}

    def _pack_decoder(self) -> Pack:
        scale, bias = self._affine("br.")
        return {
            "br_scale": scale, "br_bias": bias,
            "up_l3": self._kernel("up_l3.0.weight"),
            "level3_C": self._kernel("level3_C.conv.weight"),
            "comb_br": self._pack_br("combine_l2_l3.0."),
            "comb_cbr": self._pack_cbr("combine_l2_l3.1."),
            "up_l2": self._kernel("up_l2.0.weight"),
            "up_l2_br": self._pack_br("up_l2.1."),
            "conv": self._pack_cbr("conv."),
            "classifier": self._kernel("classifier.weight"),
        }

    # ---------------- forward pieces ----------------
    @staticmethod
    def _cbr(pack: Pack, x, stride=1):
        return _affine_prelu(_conv(x, pack["kernel"], stride),
                             pack["scale"], pack["bias"], pack["alpha"])

    @staticmethod
    def _br(pack: Pack, x):
        return _affine_prelu(x, pack["scale"], pack["bias"], pack["alpha"])

    @staticmethod
    def _combine(reduced, branches):
        outs = [_conv(reduced, k, dilation=d)
                for k, d in zip(branches, DILATIONS)]
        add1 = outs[1]
        add2 = add1 + outs[2]
        add3 = add2 + outs[3]
        add4 = add3 + outs[4]
        return torch.cat([outs[0], add1, add2, add3, add4], 1)

    @staticmethod
    def _down(pack: Pack, x):
        combine = FusedESPNet._combine(_conv(x, pack["c1"], stride=2),
                                       pack["branches"])
        return FusedESPNet._br(pack, combine)

    @staticmethod
    def _esp_plain(pack: Pack, x):
        combine = x + FusedESPNet._combine(_conv(x, pack["c1"]),
                                           pack["branches"])
        return FusedESPNet._br(pack, combine)

    @staticmethod
    def _esp_chain(packs, x):
        """The level's blocks through the fused kernel, NHWC in between."""
        h = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for pack in packs:
            h = esp_block_fused(h, pack["w1"], pack["wd"], pack["scale"],
                                pack["bias"], pack["alpha"], add_residual=True)
        return h.permute(0, 3, 1, 2)

    def encoder_forward(self, x):
        enc = self.enc
        output0 = self._cbr(enc["level1"], x, stride=2)
        inp1 = avg_pool_3x3_s2(x)
        inp2 = avg_pool_3x3_s2(inp1)
        output0_cat = self._br(enc["b1"], torch.cat([output0, inp1], 1))
        output1_0 = self._down(enc["down2"], output0_cat)
        out = output1_0
        for pack in enc["level2"]:
            out = self._esp_plain(pack, out)
        output1_cat = self._br(enc["b2"],
                               torch.cat([out, output1_0, inp2], 1))
        output2_0 = self._down(enc["down3"], output1_cat)
        if self.fuse_level3:
            out = self._esp_chain(enc["level3"], output2_0)
        else:
            out = output2_0
            for pack in enc["level3"]:
                out = self._esp_plain(pack, out)
        output2_cat = self._br(enc["b3"], torch.cat([output2_0, out], 1))
        logits = _conv(output2_cat, enc["classifier"])
        return logits, output0_cat, output1_cat

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in the compute type -> (B, classes, H, W) logits
        (H/8, W/8 for an encoder-only checkpoint)."""
        x = x.to(self.device, self.dtype).contiguous(
            memory_format=torch.channels_last)
        enc_logits, output0_cat, output1_cat = self.encoder_forward(x)
        dec: Optional[Pack] = self.dec
        if dec is None:
            return enc_logits
        y = _affine(enc_logits, dec["br_scale"], dec["br_bias"])
        output2_c = _upconv2x2(y, dec["up_l3"])
        output1_c = _conv(output1_cat, dec["level3_C"])
        comb = self._br(dec["comb_br"], torch.cat([output1_c, output2_c], 1))
        comb = self._cbr(dec["comb_cbr"], comb)
        comb = self._br(dec["up_l2_br"], _upconv2x2(comb, dec["up_l2"]))
        feats = self._cbr(dec["conv"], torch.cat([comb, output0_cat], 1))
        return _upconv2x2(feats, dec["classifier"])
