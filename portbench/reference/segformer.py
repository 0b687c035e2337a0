"""Plain SegFormer (MiT encoder and all-MLP decode head), float32.

Xie et al., "SegFormer: Simple and Efficient Design for Semantic
Segmentation with Transformers" (NeurIPS 2021), as HuggingFace's
``SegformerForSemanticSegmentation`` computes it, with its state-dict key
names: overlapped patch embeddings (conv + LayerNorm), efficient
self-attention whose keys and values come from tokens reduced by a
kernel = stride = ``sr`` convolution and a LayerNorm, Mix-FFN (dense,
depthwise 3x3, exact GELU, dense), pre-norm residual blocks, a LayerNorm
after each stage, and a head that projects every stage to the decoder
width, upsamples bilinearly (align_corners=False) to 1/4 of the input,
concatenates c4..c1, fuses with a bias-free 1x1 conv, BatchNorm (eps
1e-5, running statistics), ReLU and a 1x1 classifier.  LayerNorm eps is
the config's 1e-6.

In (N, 3, H, W) normalised RGB, out (N, labels, H/4, W/4) logits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class PatchEmbed(nn.Module):
    def __init__(self, c_in, dim, patch, stride, eps):
        super().__init__()
        self.proj = nn.Conv2d(c_in, dim, patch, stride=stride,
                              padding=patch // 2)
        self.layer_norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x):
        x = self.proj(x)
        n, c, h, w = x.shape
        return self.layer_norm(x.flatten(2).transpose(1, 2)), h, w


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, sr, eps):
        super().__init__()
        self.heads = heads
        self.sr_ratio = sr
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, stride=sr)
            self.layer_norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, h, w):
        n, t, c = x.shape
        kv = x
        if self.sr_ratio > 1:
            grid = x.transpose(1, 2).reshape(n, c, h, w)
            kv = self.layer_norm(self.sr(grid).flatten(2).transpose(1, 2))
        d = c // self.heads

        def heads(a):
            return a.reshape(n, -1, self.heads, d).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(kv)), heads(
            self.value(kv))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        return (attn @ v).transpose(1, 2).reshape(n, t, c)


class Attention(nn.Module):
    def __init__(self, dim, heads, sr, eps):
        super().__init__()
        self.self = SelfAttention(dim, heads, sr, eps)
        self.output = nn.Module()
        self.output.dense = nn.Linear(dim, dim)

    def forward(self, x, h, w):
        return self.output.dense(self.self(x, h, w))


class MixFFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1,
                                       groups=hidden)
        self.dense2 = nn.Linear(hidden, dim)

    def forward(self, x, h, w):
        x = self.dense1(x)
        n, t, c = x.shape
        x = self.dwconv.dwconv(x.transpose(1, 2).reshape(n, c, h, w))
        return self.dense2(F.gelu(x.flatten(2).transpose(1, 2)))


class Block(nn.Module):
    def __init__(self, dim, heads, sr, mlp_ratio, eps):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(dim, eps=eps)
        self.attention = Attention(dim, heads, sr, eps)
        self.layer_norm_2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = MixFFN(dim, dim * mlp_ratio)

    def forward(self, x, h, w):
        x = x + self.attention(self.layer_norm_1(x), h, w)
        return x + self.mlp(self.layer_norm_2(x), h, w)


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        eps = cfg["layer_norm_eps"]
        widths = cfg["hidden_sizes"]
        ins = [cfg["num_channels"]] + list(widths[:-1])
        self.patch_embeddings = nn.ModuleList(
            PatchEmbed(ins[i], widths[i], cfg["patch_sizes"][i],
                       cfg["strides"][i], eps) for i in range(len(widths)))
        self.block = nn.ModuleList(
            nn.ModuleList(Block(widths[i], cfg["num_attention_heads"][i],
                                cfg["sr_ratios"][i], cfg["mlp_ratios"][i],
                                eps) for _ in range(cfg["depths"][i]))
            for i in range(len(widths)))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(d, eps=eps)
                                        for d in widths)

    def forward(self, x):
        feats = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block,
                                       self.layer_norm):
            t, h, w = embed(x)
            for blk in blocks:
                t = blk(t, h, w)
            x = norm(t).transpose(1, 2).reshape(t.shape[0], -1, h, w)
            feats.append(x)
        return feats


class Head(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["decoder_hidden_size"]
        self.linear_c = nn.ModuleList()
        for c in cfg["hidden_sizes"]:
            mlp = nn.Module()
            mlp.proj = nn.Linear(c, d)
            self.linear_c.append(mlp)
        self.linear_fuse = nn.Conv2d(d * len(cfg["hidden_sizes"]), d, 1,
                                     bias=False)
        self.batch_norm = nn.BatchNorm2d(d, eps=1e-5)
        self.classifier = nn.Conv2d(d, cfg["num_labels"], 1)

    def forward(self, feats):
        h4, w4 = feats[0].shape[2:]
        outs = []
        for mlp, f in zip(self.linear_c, feats):
            p = mlp.proj(f.flatten(2).transpose(1, 2))
            p = p.transpose(1, 2).reshape(f.shape[0], -1, *f.shape[2:])
            if p.shape[2:] != (h4, w4):
                p = F.interpolate(p, size=(h4, w4), mode="bilinear",
                                  align_corners=False)
            outs.append(p)
        x = self.linear_fuse(torch.cat(outs[::-1], 1))
        return self.classifier(F.relu(self.batch_norm(x)))


class Segformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.segformer = nn.Module()
        self.segformer.encoder = Encoder(cfg)
        self.decode_head = Head(cfg)

    def forward(self, x):
        return self.decode_head(self.segformer.encoder(x))
