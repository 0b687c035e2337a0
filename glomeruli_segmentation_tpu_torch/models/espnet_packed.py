"""Fold-packed ESPNet ensemble: all folds in one tensor, one pass.

Counterpart of ``glomeruli_segmentation_tpu/models/espnet_packed.py``.  The
F fold networks run as ONE network whose channel axis carries all folds
side by side:

- every conv of level 1, level 2, the two downsamplers and the decoder is
  one dense conv with a block-diagonal kernel (fold f's kernel in input
  block f / output block f, zeros elsewhere), so it computes exactly the
  per-fold convs;
- BN is folded into scale/bias, and per-channel parameters concatenate
  over folds;
- the per-fold input normalisation is a (B, 3F, H, W) stack, so the first
  conv's zero padding keeps its per-fold meaning;
- level 3, b3 and the encoder classifier stay per fold (128 channels a
  fold), a loop over folds;
- the fold probabilities combine on (B, H, W, F, classes) logits: softmax
  per fold in ``accum_dtype``, sum over folds, argmax (first index on ties).

Channel layout: tensors stay part-major, in plain concat order
(``cat([d1, add1, ...])``), and the fold-major semantic order is restored by
permuting the input channels (dim 1 of an OIHW kernel) of each consumer
conv and the per-channel vectors once, at pack time.  The ``perm*`` arrays
map a physical channel to its semantic one.

Level 2 runs through plain torch ops by default (``fuse_level2=False``, the
JAX package's ``level2="xla"``), or through K2, the padded-layout ESP block
kernel (:func:`..ops.esp_block.esp_block_padded`), with ``fuse_level2``
(``level2="pallas"``): padded once, p blocks on the padded layout, unpadded
once.  Level 3 runs each fold's blocks through K1 with ``fuse_level3``
(``level3="pallas"``) and through plain ops without (``"xla"``).  The JAX
package's ``interpret`` and ``level2_pack_taps`` are TPU knobs and are not
ported.  Its ``precision`` becomes the TF32 switches that
:class:`..pipeline.fused.EnsembleSegmenter` sets around the forward.

Activations are NCHW tensors in ``torch.channels_last`` memory; kernels
are OIHW, transposed-conv kernels (I, O, 2, 2).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops.esp_block import esp_block_padded, esp_pad_io, esp_unpad_io
from .espnet import avg_pool_3x3_s2
from .espnet_fused import (FusedESPNet, _affine, _affine_prelu, _conv,
                           _upconv2x2)

Pack = Dict[str, object]
_br, _down = FusedESPNet._br, FusedESPNet._down
_esp_plain, _esp_chain = FusedESPNet._esp_plain, FusedESPNet._esp_chain


# ---------------- packing helpers (numpy, float32) ----------------
def _block_diag(kernels: Sequence[np.ndarray]) -> np.ndarray:
    """Per-fold kernels -> one kernel, block-diagonal over dims 0 and 1:
    (O, I, kh, kw) conv kernels and (I, O, 2, 2) transposed-conv kernels
    alike.  Both dims are in the semantic fold-major order (fold f's
    channel c at ``f * C + c``)."""
    ks = [np.asarray(k, np.float32) for k in kernels]
    d0, d1 = ks[0].shape[:2]
    out = np.zeros((len(ks) * d0, len(ks) * d1) + ks[0].shape[2:],
                   np.float32)
    for f, k in enumerate(ks):
        out[f * d0: (f + 1) * d0, f * d1: (f + 1) * d1] = k
    return out


def _cat(params: Sequence[np.ndarray]) -> np.ndarray:
    """Fold-major (semantic) packing of per-channel parameter vectors."""
    return np.concatenate([np.asarray(p) for p in params])


def _identity_perm(folds: int, per_fold: int) -> np.ndarray:
    return np.arange(folds * per_fold, dtype=np.int64)


def _concat_perm(parts: Sequence[tuple], folds: int) -> np.ndarray:
    """phys->sem map of ``cat([t_0, t_1, ...], channels)``.

    ``parts`` is a list of (perm_phys_to_sem, per_fold_width); the semantic
    space of the result is fold-major over the concatenated per-fold
    widths (the reference's per-network concat order)."""
    total = sum(w for _, w in parts)
    offsets = np.cumsum([0] + [w for _, w in parts])[:-1]
    out = []
    for (perm, w), off in zip(parts, offsets):
        f, c = perm // w, perm % w
        out.append(f * total + off + c)
    return np.concatenate(out)


def _pos_of_sem(perm: np.ndarray) -> np.ndarray:
    """Inverse map: physical position holding each semantic channel."""
    pos = np.empty_like(perm)
    pos[perm] = np.arange(perm.size, dtype=perm.dtype)
    return pos


def _permute_kernel_in(kernel: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Reindex a sem-ordered OIHW kernel's input channels for a part-major
    producer: physical input channel i carries semantic channel perm[i]."""
    return kernel[:, perm]


def _permute_vec(vec: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return np.asarray(vec)[perm]


def _esp_fused_operands(pack: Mapping) -> tuple:
    """Part-major packed ESP block -> :func:`esp_block_padded` operands
    ``(w1, wd, scale, bias, alpha)`` as float32 numpy arrays.

    The kernel's output concat ``[d1, add1..add4]`` is the packed engine's
    part-major layout, and its affine takes the already permuted
    scale/bias/alpha: ``w1`` is the permuted block-diagonal 1x1 reduce and
    ``wd`` stacks the block-diagonal dilated taps along the contraction
    axis (tap = ky*3 + kx)."""
    w1 = np.asarray(pack["c1"])[:, :, 0, 0].T  # (C, n)
    n = w1.shape[1]
    widths = [np.asarray(b).shape[0] for b in pack["branches"]]
    wd = np.zeros((5, 9 * n, max(widths)), np.float32)
    for i, b in enumerate(pack["branches"]):
        k = np.asarray(b)  # (width_i, n, 3, 3) block-diagonal
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            wd[i, tap * n: (tap + 1) * n, : k.shape[0]] = k[:, :, ky, kx].T
    return (np.ascontiguousarray(w1, np.float32), wd,
            np.asarray(pack["scale"], np.float32),
            np.asarray(pack["bias"], np.float32),
            np.asarray(pack["alpha"], np.float32))


def _host(t) -> np.ndarray:
    """A packed tensor (any type, any device) as float32 numpy."""
    return t.detach().float().cpu().numpy()


class PackedEnsembleESPNet:
    """F fold ESPNets packed into one block-diagonal forward.

    ``state_dicts`` are the folds' full-net ``.pth`` state dicts (encoder +
    decoder, one architecture); ``means``/``stds`` the per-fold BGR
    normalisation constants, (F, 3).  ``dtype`` is the compute type of
    activations and conv kernels (the folded affines stay float32);
    ``accum_dtype`` the type of the fold-softmax sum.
    """

    def __init__(self, state_dicts: Sequence[Mapping[str, torch.Tensor]],
                 means, stds, fuse_level3: bool = False,
                 fuse_level2: bool = False, dtype=torch.bfloat16,
                 accum_dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.accum_dtype = accum_dtype
        self.fuse_level3 = fuse_level3
        self.fuse_level2 = fuse_level2
        # the per-fold nets: their packs feed the block-diagonal weights;
        # only their level 3, b3 and classifier are kept, to run per fold
        nets = [FusedESPNet(sd, fuse_level3=fuse_level3, dtype=dtype,
                            device=self.device) for sd in state_dicts]
        arch = {(n.classes, n.p, n.q, n.has_decoder) for n in nets}
        if len(arch) != 1 or not nets[0].has_decoder:
            raise ValueError(f"the packed ensemble needs full fold nets of "
                             f"one architecture, got {sorted(arch)}")
        self.folds = F = len(nets)
        self.classes, self.p, self.q = nets[0].classes, nets[0].p, nets[0].q
        self.heads = [{key: n.enc[key] for key in ("level3", "b3",
                                                    "classifier")}
                      for n in nets]

        means = np.asarray(means, np.float32).reshape(F, 3)
        stds = np.asarray(stds, np.float32).reshape(F, 3)
        # x15 = (img - mean_f) / std_f / 255 per fold: affine in the image
        self.norm_scale = self._f32((1.0 / (stds * 255.0)).reshape(-1))
        self.norm_bias = self._f32((-means / (stds * 255.0)).reshape(-1))

        encs = [n.enc for n in nets]
        decs = [n.dec for n in nets]

        # ---- physical channel layouts (phys -> semantic fold-major) ----
        id3 = _identity_perm(F, 3)
        c1_out = encs[0]["level1"]["kernel"].shape[0]  # 16 per fold
        self.perm95 = _concat_perm([(_identity_perm(F, c1_out), c1_out),
                                    (id3, 3)], F)  # out0_cat: [out0|inp1]
        w2 = [b.shape[0] for b in encs[0]["down2"]["branches"]]  # [16, 12 x4]
        pf2 = sum(w2)  # 64
        self.perm320 = _concat_perm(
            [(_identity_perm(F, w), w) for w in w2], F)
        w3 = [b.shape[0] for b in encs[0]["down3"]["branches"]]  # [28, 25 x4]
        self.perm640 = _concat_perm(
            [(_identity_perm(F, w), w) for w in w3], F)
        # out1_cat: [level2_out (perm320) | out1_0 (perm320) | inp2 (id)]
        self.perm655 = _concat_perm([(self.perm320, pf2),
                                     (self.perm320, pf2), (id3, 3)], F)
        self.pos640 = _pos_of_sem(self.perm640)  # level-3 per-fold gather
        idc = _identity_perm(F, self.classes)
        self.perm50 = _concat_perm([(idc, self.classes),
                                    (idc, self.classes)], F)
        self.perm120 = _concat_perm([(idc, self.classes),
                                     (self.perm95, c1_out + 3)], F)
        self._pos640 = torch.as_tensor(self.pos640, device=self.device)

        def cat(key, trees):
            return _cat([_host(t[key]) for t in trees])

        def br(trees, perm=None):
            out = {}
            for key in ("scale", "bias", "alpha"):
                v = cat(key, trees)
                out[key] = self._f32(v if perm is None
                                     else _permute_vec(v, perm))
            return out

        def bd(kernels, perm=None):
            k = _block_diag([_host(t) for t in kernels])
            return self._kernel(k if perm is None
                                else _permute_kernel_in(k, perm))

        self.enc = {
            "level1_k": bd([e["level1"]["kernel"] for e in encs]),
            "level1": br([e["level1"] for e in encs]),
            "b1": br([e["b1"] for e in encs], self.perm95),
            "down2": self._pack_down([e["down2"] for e in encs],
                                     in_perm=self.perm95,
                                     out_perm=self.perm320),
            "b2": br([e["b2"] for e in encs], self.perm655),
            "down3": self._pack_down([e["down3"] for e in encs],
                                     in_perm=self.perm655,
                                     out_perm=self.perm640),
        }
        # the packed (320-channel) level-2 blocks, in the selected form:
        # K2 operands, or plain-block packs
        level2 = [self._host_pack([e["level2"][i] for e in encs],
                                  self.perm320, self.perm320)
                  for i in range(self.p)]
        if fuse_level2:
            self.level2_kernel = [
                self._kernel_operands(_esp_fused_operands(pack))
                for pack in level2]
        else:
            self.enc["level2"] = [self._device_pack(pack) for pack in level2]
        self.dec = {
            "br_scale": self._f32(cat("br_scale", decs)),
            "br_bias": self._f32(cat("br_bias", decs)),
            "up_l3": bd([d["up_l3"] for d in decs]),
            "level3_C": bd([d["level3_C"] for d in decs], self.perm655),
            "comb_br": br([d["comb_br"] for d in decs], self.perm50),
            "comb_k": bd([d["comb_cbr"]["kernel"] for d in decs],
                         self.perm50),
            "comb": br([d["comb_cbr"] for d in decs]),
            "up_l2": bd([d["up_l2"] for d in decs]),
            "up_l2_br": br([d["up_l2_br"] for d in decs]),
            "conv_k": bd([d["conv"]["kernel"] for d in decs], self.perm120),
            "conv": br([d["conv"] for d in decs]),
            "classifier": bd([d["classifier"] for d in decs]),
        }

    # ---------------- packing ----------------
    def _f32(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float32), device=self.device)

    def _kernel(self, k: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(k), device=self.device,
                               dtype=self.dtype)

    def _kernel_operands(self, ops: tuple) -> tuple:
        w1, wd, scale, bias, alpha = ops
        return (self._kernel(w1), self._kernel(wd), self._f32(scale),
                self._f32(bias), self._f32(alpha))

    @staticmethod
    def _host_pack(packs: List[Mapping], in_perm: np.ndarray,
                   out_perm: np.ndarray) -> Dict:
        """Per-fold ESP packs -> one block-diagonal part-major pack on the
        host (float32 numpy): ``c1`` takes a part-major input (in_perm),
        the affine the part-major branch concat (out_perm)."""
        return {
            "c1": _permute_kernel_in(
                _block_diag([_host(p["c1"]) for p in packs]), in_perm),
            "branches": [_block_diag([_host(p["branches"][i])
                                      for p in packs]) for i in range(5)],
            **{key: _permute_vec(_cat([_host(p[key]) for p in packs]),
                                 out_perm)
               for key in ("scale", "bias", "alpha")},
        }

    def _pack_down(self, packs: List[Mapping], in_perm: np.ndarray,
                   out_perm: np.ndarray) -> Pack:
        return self._device_pack(self._host_pack(packs, in_perm, out_perm))

    def _device_pack(self, host: Mapping) -> Pack:
        """A :meth:`_host_pack` on the device, kernels in the compute
        type."""
        return {
            "c1": self._kernel(host["c1"]),
            "branches": [self._kernel(b) for b in host["branches"]],
            **{key: self._f32(host[key])
               for key in ("scale", "bias", "alpha")},
        }

    # ---------------- forward ----------------
    # The packed downsamplers, level-2 blocks and BR glue have the per-fold
    # packs' keys and structure (part-major concat included), so the fold
    # nets' own forward pieces run them: ``_down``, ``_esp_plain``, ``_br``.
    def _esp_chain_packed(self, x):
        """The p packed level-2 blocks through K2: pad once, every block
        on the padded layout, unpad once."""
        c = x.shape[1]
        h = esp_pad_io(x.permute(0, 2, 3, 1))
        for ops in self.level2_kernel:
            h = esp_block_padded(h, *ops, add_residual=True)
        return esp_unpad_io(h, c).permute(0, 3, 1, 2)

    def _level3_per_fold(self, out2_0):
        """(B, 128F, h, w) part-major -> (B, classes*F, h, w) encoder
        logits, fold-major: one gather into fold-major order, then each
        fold's level 3, b3 and classifier."""
        per_fold = out2_0.shape[1] // self.folds
        # the gather on NHWC keeps the result in channels_last memory
        sem = out2_0.permute(0, 2, 3, 1)[..., self._pos640] \
            .permute(0, 3, 1, 2)
        logits = []
        for f, head in enumerate(self.heads):
            x_f = sem[:, f * per_fold: (f + 1) * per_fold]
            if self.fuse_level3:
                out = _esp_chain(head["level3"], x_f)
            else:
                out = x_f
                for pack in head["level3"]:
                    out = _esp_plain(pack, out)
            out2_cat = _br(head["b3"], torch.cat([x_f, out], 1))
            logits.append(_conv(out2_cat, head["classifier"]))
        return torch.cat(logits, 1)

    @torch.no_grad()
    def packed_feats(self, resized: torch.Tensor) -> torch.Tensor:
        """Raw resized BGR crops (B, H, W, 3) -> decoder features
        (B, F*classes, H/2, W/2), fold-major: everything before the final
        2x2 stride-2 classifier upconv."""
        enc, dec = self.enc, self.dec
        x = resized.to(self.device, torch.float32)
        x15 = (x.repeat(1, 1, 1, self.folds) * self.norm_scale
               + self.norm_bias).to(self.dtype).permute(0, 3, 1, 2)
        lv1 = enc["level1"]
        out0 = _affine_prelu(_conv(x15, enc["level1_k"], stride=2),
                             lv1["scale"], lv1["bias"], lv1["alpha"])
        inp1 = avg_pool_3x3_s2(x15)
        inp2 = avg_pool_3x3_s2(inp1)
        out0_cat = _br(enc["b1"], torch.cat([out0, inp1], 1))  # perm95
        out1_0 = _down(enc["down2"], out0_cat)  # perm320
        if self.fuse_level2:
            out = self._esp_chain_packed(
                out1_0.contiguous(memory_format=torch.channels_last))
        else:
            out = out1_0
            for pack in enc["level2"]:
                out = _esp_plain(pack, out)
        out1_cat = _br(enc["b2"],
                       torch.cat([out, out1_0, inp2], 1))  # perm655
        out2_0 = _down(enc["down3"], out1_cat)  # perm640
        enc_logits = self._level3_per_fold(out2_0)  # fold-major

        # RUM decoder, packed
        y = _affine(enc_logits, dec["br_scale"], dec["br_bias"])
        out2_c = _upconv2x2(y, dec["up_l3"])
        out1_c = _conv(out1_cat, dec["level3_C"])
        comb = _br(dec["comb_br"], torch.cat([out1_c, out2_c], 1))
        comb = _br(dec["comb"], _conv(comb, dec["comb_k"]))
        comb = _br(dec["up_l2_br"], _upconv2x2(comb, dec["up_l2"]))
        return _br(dec["conv"],
                   _conv(torch.cat([comb, out0_cat], 1),  # perm120
                         dec["conv_k"]))

    @torch.no_grad()
    def packed_logits(self, resized: torch.Tensor) -> torch.Tensor:
        """Raw resized BGR crops (B, H, W, 3) -> (B, H, W, F, classes), a
        view of the (B, F*classes, H, W) logits."""
        logits = _upconv2x2(self.packed_feats(resized),
                            self.dec["classifier"])
        b, _, h, w = logits.shape
        return logits.reshape(b, self.folds, self.classes, h, w) \
            .permute(0, 3, 4, 1, 2)

    def _ensemble_argmax(self, logits_fc: torch.Tensor) -> torch.Tensor:
        """(..., F, classes) logits -> (...) uint8 ensemble argmax."""
        probs = torch.softmax(logits_fc.to(self.accum_dtype), dim=-1)
        return torch.argmax(probs.sum(dim=-2), dim=-1).to(torch.uint8)

    def __call__(self, resized: torch.Tensor) -> torch.Tensor:
        """Raw resized BGR crops -> (B, H, W) uint8 ensemble argmax."""
        return self._ensemble_argmax(self.packed_logits(resized))

    @torch.no_grad()
    def gathered_argmax(self, resized: torch.Tensor, ys: torch.Tensor,
                        xs: torch.Tensor) -> torch.Tensor:
        """Ensemble argmax at gathered output pixels only: (B, oh, ow).

        ``ys``/``xs`` are (B, oh)/(B, ow) row/column tables into the
        (H, W) class map.  Output pixel (y, x) depends on one feature
        pixel (y//2, x//2) through the (y%2, x%2) phase of the classifier
        upconv, so the features are gathered first and the full-resolution
        logits are never formed."""
        feats = self.packed_feats(resized)
        k = self.dec["classifier"]  # (C, C, 2, 2) block-diagonal
        ys, xs = ys.long(), xs.long()
        batch = torch.arange(feats.shape[0], device=feats.device)
        g = feats.permute(0, 2, 3, 1)[batch[:, None, None],
                                      (ys // 2)[:, :, None],
                                      (xs // 2)[:, None, :]]  # (B, oh, ow, C)
        phases = [torch.matmul(g, k[:, :, u, v].to(g.dtype))
                  for u in (0, 1) for v in (0, 1)]
        py = (ys % 2)[:, :, None, None]
        px = (xs % 2)[:, None, :, None]
        logits = torch.where(
            py == 0, torch.where(px == 0, phases[0], phases[1]),
            torch.where(px == 0, phases[2], phases[3]))
        b, oh, ow, _ = logits.shape
        return self._ensemble_argmax(
            logits.reshape(b, oh, ow, self.folds, self.classes))
