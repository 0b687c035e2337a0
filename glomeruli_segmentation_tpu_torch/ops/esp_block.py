"""Fused ESP residual block (inference): the CUDA kernel, its plain PyTorch
version and the weight packing they share.

Counterpart of ``glomeruli_segmentation_tpu/ops/pallas/esp_block.py``.  The
kernel (``csrc/esp_block.cu``) replaces the Pallas ``_esp_kernel``; its
source note says what bounds it and how it is laid out.  Operands keep the
JAX layout: x is (B, H, W, C) NHWC, w1 (C, n), wd (5, 9n, n_pad) with
tap = (dy+1)*3 + (dx+1) over offsets (-d, 0, +d), and scale, bias and alpha
(C,) f32.  BN is folded into scale/bias on the host.
"""
from __future__ import annotations

import ctypes
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

DILATIONS = (1, 2, 4, 8, 16)
BRANCHES = ("d1", "d2", "d4", "d8", "d16")


def _np(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def fold_bn(scale, bias, mean, var, eps: float = 1e-3):
    """BatchNorm -> affine (y = x*s + b)."""
    s = scale / np.sqrt(var + eps)
    return s, bias - mean * s


def pack_esp_weights(state_dict: Mapping, prefix: str
                     ) -> Tuple[np.ndarray, ...]:
    """An ESP residual block's ``.pth`` entries (``<prefix>c1.conv.weight``,
    ``<prefix>d1.conv.weight`` .. ``d16``, ``<prefix>bn.bn.*``,
    ``<prefix>bn.act.weight``) -> the kernel operands ``(w1, wd, scale,
    bias, alpha)`` as float32 numpy arrays."""
    w1 = _np(state_dict[prefix + "c1.conv.weight"])[:, :, 0, 0].T  # (C, n)
    n = w1.shape[1]
    # OIHW -> HWIO, the layout the taps are stacked from
    kernels = [np.transpose(_np(state_dict[f"{prefix}{m}.conv.weight"]),
                            (2, 3, 1, 0)) for m in BRANCHES]
    n_pad = max(k.shape[-1] for k in kernels)
    wd = np.zeros((5, 9 * n, n_pad), np.float32)
    for i, k in enumerate(kernels):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            wd[i, tap * n: (tap + 1) * n, : k.shape[-1]] = k[dy, dx]
    bn = prefix + "bn.bn."
    scale, bias = fold_bn(_np(state_dict[bn + "weight"]),
                          _np(state_dict[bn + "bias"]),
                          _np(state_dict[bn + "running_mean"]),
                          _np(state_dict[bn + "running_var"]))
    alpha = _np(state_dict[prefix + "bn.act.weight"])
    return (np.array(w1, np.float32, order="C"), wd,
            np.array(scale, np.float32), np.array(bias, np.float32),
            np.array(alpha, np.float32))


def esp_block_plain(x: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    alpha: torch.Tensor, add_residual: bool = True
                    ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points: f32
    products and sums throughout, the 1x1 reduce rounded to x's type, the
    output cast to x's type.  (B, H, W, C) in and out."""
    c = x.shape[3]
    n = w1.shape[1]
    n_pad = wd.shape[2]
    n1 = c - 4 * n
    xf = x.permute(0, 3, 1, 2).float()
    reduced = F.conv2d(xf, w1.float().t().contiguous()[:, :, None, None])
    reduced = reduced.to(x.dtype).float()
    outs = []
    for i, d in enumerate(DILATIONS):
        k = wd[i].float().reshape(3, 3, n, n_pad).permute(3, 2, 0, 1)
        outs.append(F.conv2d(reduced, k.contiguous(), padding=d, dilation=d))
    add1 = outs[1][:, :n]
    add2 = add1 + outs[2][:, :n]
    add3 = add2 + outs[3][:, :n]
    add4 = add3 + outs[4][:, :n]
    combine = torch.cat([outs[0][:, :n1], add1, add2, add3, add4], 1)
    if add_residual:
        combine = combine + xf
    y = combine * scale.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    y = torch.clamp_min(y, 0) + alpha.view(1, -1, 1, 1) * torch.clamp_max(y, 0)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def _check(x, w1, wd, scale, bias, alpha) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[3]
    if w1.dim() != 2 or w1.shape[0] != c:
        raise ValueError(f"w1 must be ({c}, n), got {tuple(w1.shape)}")
    n = w1.shape[1]
    n1 = c - 4 * n
    if wd.dim() != 3 or wd.shape[:2] != (5, 9 * n) or wd.shape[2] < max(n, n1):
        raise ValueError(f"wd must be (5, {9 * n}, >= {max(n, n1)}), "
                         f"got {tuple(wd.shape)}")
    for name, t in (("scale", scale), ("bias", bias), ("alpha", alpha)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({c},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _library() -> ctypes.CDLL:
    """The built library, with the C signatures declared: pointers and the
    stream as ``c_void_p`` (a bare int would be cut to 32 bits)."""
    lib = _build.load("esp_block")
    lib.esp_block_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.esp_block_forward.restype = ctypes.c_int
    lib.esp_block_supports_width.argtypes = [ctypes.c_int]
    lib.esp_block_supports_width.restype = ctypes.c_int
    return lib


def esp_block_fused(x: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    alpha: torch.Tensor, add_residual: bool = True
                    ) -> torch.Tensor:
    """Apply the fused ESP block to a batch.

    Args:
      x:     (B, H, W, C), float32 or bfloat16
      w1:    (C, n) 1x1 reduce weights, x's type
      wd:    (5, 9*n, n_pad) per dilation branch, the 9 taps stacked along
             the contraction axis; output channels padded to ``n_pad``
             (= n1, the d1 branch width); x's type
      scale, bias: (C,) folded BN affine, float32
      alpha: (C,) PReLU slopes, float32

    A CUDA tensor goes through the kernel (or the call raises); a CPU
    tensor goes through :func:`esp_block_plain`.  ``esp_block_fused.launches``
    counts kernel launches.
    """
    _check(x, w1, wd, scale, bias, alpha)
    if x.device.type == "cpu":
        return esp_block_plain(x, w1, wd, scale, bias, alpha, add_residual)
    if x.device.type != "cuda":
        raise ValueError(f"esp_block_fused: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("w1", w1), ("wd", wd), ("scale", scale), ("bias", bias),
                    ("alpha", alpha)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w1.dtype != x.dtype or wd.dtype != x.dtype:
        raise ValueError(f"w1/wd must have x's type {x.dtype}, got "
                         f"{w1.dtype}/{wd.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (a channels_last NCHW "
                         "tensor's permute(0, 2, 3, 1))")
    b, h, w, c = x.shape
    n = w1.shape[1]
    n_pad = wd.shape[2]
    lib = _library()
    if not lib.esp_block_supports_width(n_pad):
        raise ValueError(f"esp_block kernel is not built for branch width "
                         f"{n_pad} (C={c})")
    reduced = torch.empty((b, h, w, n), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.esp_block_forward(
            _ptr(x), _ptr(w1), _ptr(wd), _ptr(scale), _ptr(bias), _ptr(alpha),
            _ptr(reduced), _ptr(y), b, h, w, c, n, c - 4 * n, n_pad,
            int(add_residual), int(x.dtype == torch.bfloat16),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"esp_block kernel launch failed: CUDA error {err}")
    esp_block_fused.launches += 1
    return y


esp_block_fused.launches = 0
