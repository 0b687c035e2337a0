"""SegFormer (MiT encoder + all-MLP decode head) as plain ``nn.Module``s.

Counterpart of ``glomeruli_segmentation_tpu/models/segformer.py``, the
HuggingFace ``SegformerForSemanticSegmentation`` the reference's GTCS
variant fine-tunes (``module/SegFormer/train/train.py:211-212``, default
``nvidia/mit-b0``): overlapped patch embeddings, efficient attention with
spatial reduction, Mix-FFN with a depthwise 3x3, stage layer norms, and a
decode head that projects every stage to one width, upsamples to 1/4 and
fuses with a 1x1 conv + BN.

At its edges the model keeps the JAX contract: (N, H, W, 3) in, (N, H/4,
W/4, labels) logits out.  Inside, tokens are (N, HW, C), and the patch
embeddings and depthwise convolutions run on NCHW views of them in the
channels-last memory format, so those change no layout.  Parameter names are HF's state-dict keys
(``segformer.encoder.block.0.0.attention.self.query.weight``, ...), so a
``pytorch_model.bin`` and this model share one key map
(:mod:`..convert.segformer_import`).

What the JAX module fixes and this one keeps:

- every LayerNorm uses ``config.layer_norm_eps`` (1e-6, not torch's 1e-5);
- the spatial-reduction conv has flax's default 'SAME' padding: a stage
  whose side does not divide by ``sr`` is padded (total // 2, the rest);
  its kernel equals its stride, so it runs as one product over the
  non-overlapping patches;
- GELU is exact (erf); the head's BatchNorm has eps 1e-5 and running
  statistics; its upsample is half-pixel bilinear with clamped edges
  (``jax.image.resize`` "bilinear" when upsampling); its concat order is
  c4, c3, c2, c1;
- attention is q.k^T divided by sqrt(head_dim) in the compute dtype, a
  float32 softmax cast back, then .v -- plain matmuls, as the JAX module
  computes it with einsum outside any Pallas kernel.

``dtype`` is the compute dtype.  ``torch.bfloat16`` follows the JAX
module's ``dtype`` contract: the linear and conv weights are held in bf16
and their products run in bf16, while LayerNorm and BatchNorm parameters
and statistics stay float32 (each norm computes in float32 and casts its
output back) and the softmax runs in float32.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

HEAD_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SegformerConfig:
    num_labels: int = 5
    hidden_sizes: Tuple[int, ...] = (32, 64, 160, 256)
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_attention_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    mlp_ratio: int = 4
    decoder_hidden_size: int = 256
    layer_norm_eps: float = 1e-6


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, computed in float32 and cast back to
    the input's dtype."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


def _nchw(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, h*w, C) tokens as an NCHW view in the channels-last format."""
    n, _, c = tokens.shape
    return tokens.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW (channels-last) -> (N, h*w, C)."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, c)


def _reduce_tokens(x: torch.Tensor, h: int, w: int,
                   conv: nn.Conv2d) -> torch.Tensor:
    """The spatial-reduction conv (kernel = stride = s, flax's default
    'SAME' padding) of (N, h*w, C) tokens -> (N, h'*w', C).  Each side is
    padded up to a multiple of s, (total // 2) before and the rest after;
    then, as kernel and stride are equal, the conv is one product of the
    non-overlapping s x s patches with the flattened kernel."""
    s = conv.kernel_size[0]
    n, _, c = x.shape
    x = x.reshape(n, h, w, c)
    pads = []
    for size in (w, h):                     # F.pad lists the last axis first
        total = -(-size // s) * s - size
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, [0, 0] + pads)
    hs, ws = x.shape[1] // s, x.shape[2] // s
    patches = x.reshape(n, hs, s, ws, s, c).permute(0, 1, 3, 2, 4, 5)
    kernel = conv.weight.permute(0, 2, 3, 1).reshape(conv.out_channels, -1)
    return F.linear(patches.reshape(n, hs * ws, s * s * c), kernel, conv.bias)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch_size: int, stride: int,
                 eps: float):
        super().__init__()
        self.proj = nn.Conv2d(in_ch, dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.layer_norm = LayerNorm(dim, eps=eps)

    def forward(self, x: torch.Tensor):
        """NCHW (channels-last) -> ((N, h*w, dim) tokens, h, w)."""
        x = self.proj(x)
        _, _, h, w = x.shape
        return self.layer_norm(_tokens(x)), h, w


class EfficientAttention(nn.Module):
    """Multi-head attention whose keys and values come from the tokens
    reduced ``sr_ratio`` x in each spatial axis (HF's ``attention.self``
    and ``attention.output.dense``)."""

    def __init__(self, dim: int, heads: int, sr_ratio: int, eps: float,
                 dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.sr_ratio = sr_ratio
        self.self = nn.Module()
        self.self.query = nn.Linear(dim, dim)
        self.self.key = nn.Linear(dim, dim)
        self.self.value = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.self.layer_norm = LayerNorm(dim, eps=eps)
        self.output = nn.Module()
        self.output.dense = nn.Linear(dim, dim)
        # sqrt(head_dim) rounded to the compute dtype, as the JAX module
        # takes it (jnp.sqrt of head_dim in q's dtype)
        self.scale = float(torch.tensor(float(dim // heads), dtype=dtype,
                                        device="cpu").sqrt())

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        n, t, c = x.shape
        s = self.self
        q = s.query(x)
        if self.sr_ratio > 1:
            kv = s.layer_norm(_reduce_tokens(x, h, w, s.sr))
        else:
            kv = x
        k, v = s.key(kv), s.value(kv)

        def split(a):
            return a.reshape(n, a.shape[1], self.heads, -1).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = torch.matmul(q, k.transpose(-1, -2)) / self.scale
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, t, c)
        return self.output.dense(out)


class MixFFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1,
                                       groups=hidden)
        self.dense2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = self.dwconv.dwconv(_nchw(self.dense1(x), h, w))
        return self.dense2(F.gelu(_tokens(x)))


class SegformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int,
                 eps: float, dtype=torch.float32):
        super().__init__()
        self.layer_norm_1 = LayerNorm(dim, eps=eps)
        self.attention = EfficientAttention(dim, heads, sr_ratio, eps, dtype)
        self.layer_norm_2 = LayerNorm(dim, eps=eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x), h, w)
        return x + self.mlp(self.layer_norm_2(x), h, w)


class MiTEncoder(nn.Module):
    def __init__(self, config: SegformerConfig, dtype=torch.float32):
        super().__init__()
        cfg = config
        eps = cfg.layer_norm_eps
        ins = (3,) + tuple(cfg.hidden_sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbed(ins[i], cfg.hidden_sizes[i],
                              cfg.patch_sizes[i], cfg.strides[i], eps)
            for i in range(len(cfg.hidden_sizes)))
        self.block = nn.ModuleList(
            nn.ModuleList(
                SegformerBlock(cfg.hidden_sizes[i],
                               cfg.num_attention_heads[i], cfg.sr_ratios[i],
                               cfg.mlp_ratio, eps, dtype)
                for _ in range(cfg.depths[i]))
            for i in range(len(cfg.hidden_sizes)))
        self.layer_norm = nn.ModuleList(LayerNorm(d, eps=eps)
                                        for d in cfg.hidden_sizes)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW (channels-last) -> per stage, NCHW (channels-last) maps."""
        feats = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block,
                                       self.layer_norm):
            t, h, w = embed(x)
            for blk in blocks:
                t = blk(t, h, w)
            x = _nchw(norm(t), h, w)
            feats.append(x)
        return feats


class _MLP(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out)


class SegformerHead(nn.Module):
    def __init__(self, config: SegformerConfig):
        super().__init__()
        cfg = config
        d = cfg.decoder_hidden_size
        self.linear_c = nn.ModuleList(_MLP(c, d) for c in cfg.hidden_sizes)
        self.linear_fuse = nn.Conv2d(d * len(cfg.hidden_sizes), d, 1,
                                     bias=False)
        self.batch_norm = nn.BatchNorm2d(d, eps=HEAD_BN_EPS)
        self.classifier = nn.Conv2d(d, cfg.num_labels, 1)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        """Per-stage NCHW maps -> (N, h/4, w/4, labels) logits."""
        h4, w4 = feats[0].shape[2:]
        projected = []
        for mlp, f in zip(self.linear_c, feats):
            p = mlp.proj(f.permute(0, 2, 3, 1))          # (N, h, w, D)
            if p.shape[1:3] != (h4, w4):
                p = F.interpolate(p.permute(0, 3, 1, 2), size=(h4, w4),
                                  mode="bilinear", align_corners=False)
                p = p.permute(0, 2, 3, 1)
            projected.append(p)
        x = torch.cat(projected[::-1], dim=-1)
        # the 1x1 convs as products over the channel axis
        x = F.linear(x, self.linear_fuse.weight.flatten(1))
        # float32 statistics; in training mode the batch's (the trainer's
        # FlaxBatchNorm2d updates the running ones as the JAX package does)
        x = self.batch_norm(x.permute(0, 3, 1, 2).float()).to(
            x.dtype).permute(0, 2, 3, 1)
        x = F.relu(x)
        return F.linear(x, self.classifier.weight.flatten(1),
                        self.classifier.bias)


class _Body(nn.Module):
    def __init__(self, config: SegformerConfig, dtype=torch.float32):
        super().__init__()
        self.encoder = MiTEncoder(config, dtype)


class Segformer(nn.Module):
    """The whole model: (N, H, W, 3) float -> (N, H/4, W/4, labels) logits
    in the compute dtype (HF's 1/4-resolution contract)."""

    def __init__(self, config: SegformerConfig = SegformerConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.segformer = _Body(config, dtype)
        self.decode_head = SegformerHead(config)
        if dtype != torch.float32:
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    m.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return self.decode_head(self.segformer.encoder(x))


def config_from_state_dict(state_dict: Mapping,
                           num_labels: Optional[int] = None
                           ) -> SegformerConfig:
    """Infer the MiT geometry from a state dict's keys and shapes, the
    counterpart of the JAX module's ``config_from_variables``: stage
    widths and depths, patch sizes, sr ratios, the mlp ratio, the decoder
    width and the classifier's labels.  Head counts and strides are not
    visible in shapes and take the MiT family's constants, which every
    published variant shares."""
    enc = "segformer.encoder."
    n_stages = sum(1 for k in state_dict if re.fullmatch(
        re.escape(enc) + r"patch_embeddings\.\d+\.proj\.weight", k))
    hidden = tuple(int(state_dict[f"{enc}patch_embeddings.{i}.proj.bias"]
                       .shape[0]) for i in range(n_stages))
    depths = tuple(
        sum(1 for k in state_dict if re.fullmatch(
            re.escape(enc) + rf"block\.{i}\.\d+\.layer_norm_1\.weight", k))
        for i in range(n_stages))
    patch_sizes = tuple(int(state_dict[f"{enc}patch_embeddings.{i}.proj."
                                       f"weight"].shape[2])
                        for i in range(n_stages))
    sr_ratios = tuple(
        int(state_dict[f"{enc}block.{i}.0.attention.self.sr.weight"]
            .shape[2])
        if f"{enc}block.{i}.0.attention.self.sr.weight" in state_dict else 1
        for i in range(n_stages))
    mlp_ratio = int(state_dict[f"{enc}block.0.0.mlp.dense1.bias"].shape[0]
                    // hidden[0])
    default = SegformerConfig()
    decoder = default.decoder_hidden_size
    if "decode_head.linear_fuse.weight" in state_dict:
        decoder = int(state_dict["decode_head.linear_fuse.weight"].shape[0])
        if num_labels is None:
            num_labels = int(state_dict["decode_head.classifier.bias"]
                             .shape[0])
    if num_labels is None:
        num_labels = default.num_labels
    return SegformerConfig(
        num_labels=num_labels, hidden_sizes=hidden, depths=depths,
        num_attention_heads=default.num_attention_heads[:n_stages],
        sr_ratios=sr_ratios, patch_sizes=patch_sizes,
        strides=default.strides[:n_stages], mlp_ratio=mlp_ratio,
        decoder_hidden_size=decoder)


def upsample_logits(logits: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """(N, h, w, C) logits -> float32 (N, out_h, out_w, C): bilinear,
    half-pixel, clamped edges (torch ``F.interpolate`` align_corners=False
    at ``SegFormer/train/train.py:46-52``), with the JAX module's tables
    and blend order (:func:`..ops.resize.resize_bilinear`)."""
    from ..ops.resize import resize_bilinear

    return resize_bilinear(logits, out_h, out_w)


def random_segformer_state_dict(config: SegformerConfig, seed: int,
                                classifier_scale: float = 1.0) -> dict:
    """A seeded state dict of the port's own initialisation (torch's
    defaults), on the CPU in float32.  ``classifier_scale`` multiplies the
    classifier's weights, which widens the logits' top-2 margins."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Segformer(config)
    sd = model.state_dict()
    sd["decode_head.classifier.weight"] = \
        sd["decode_head.classifier.weight"] * classifier_scale
    return sd
