"""Fused ESP residual block (inference): the CUDA kernels, their plain
PyTorch versions and the weight packing they share.

Counterpart of ``glomeruli_segmentation_tpu/ops/pallas/esp_block.py``.  Two
kernels compute the same block: ``csrc/esp_block.cu`` (K1, wrapper
:func:`esp_block_fused`) replaces the Pallas ``_esp_kernel`` on the plain
(B, H, W, C) layout, and ``csrc/esp_block_dma.cu`` (K2, wrapper
:func:`esp_block_padded`) replaces the strip-DMA ``_esp_kernel_dma`` on the
padded layout of :func:`esp_pad_io`.  Each source note says what bounds it
and how it is laid out.  Operands keep the JAX layout: x is (B, H, W, C)
NHWC, w1 (C, n), wd (5, 9n, n_pad) with tap = (dy+1)*3 + (dx+1) over
offsets (-d, 0, +d), and scale, bias and alpha (C,) f32.  BN is folded into
scale/bias on the host.
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
HALO = 16  # max dilation: the zero columns on each side of the padded layout


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
    _check_weights(x.shape[3], w1, wd, scale, bias, alpha)


def _check_weights(c, w1, wd, scale, bias, alpha) -> None:
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


def _check_cuda(fn: str, x, w1, wd, scale, bias, alpha) -> None:
    """What a kernel takes beyond the shapes: one CUDA device, f32 or bf16
    activations with weights of the same type, contiguous operands."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
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
    _check_cuda("esp_block_fused", x, w1, wd, scale, bias, alpha)
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


# ---------------- the padded layout and K2 ----------------
def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _pad_to(x: torch.Tensor, c_pad: int) -> torch.Tensor:
    return F.pad(x, (0, c_pad - x.shape[3], HALO, HALO))


def esp_pad_io(x: torch.Tensor) -> torch.Tensor:
    """Pad (B, H, W, C) to K2's layout: (B, H, W + 2*HALO, round_up(C, 128))
    with zero halo columns and zero pad channels."""
    return _pad_to(x, _round_up(x.shape[3], 128))


def esp_unpad_io(x_padded: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`esp_pad_io` (a view)."""
    return x_padded[:, :, HALO: x_padded.shape[2] - HALO, :c]


def esp_block_padded_plain(x_padded: torch.Tensor, w1: torch.Tensor,
                           wd: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, alpha: torch.Tensor,
                           add_residual: bool = True) -> torch.Tensor:
    """K2's function in plain PyTorch: unpad, :func:`esp_block_plain` (f32
    sums, the reduce rounded to x's type as the TPU kernel's ``rpad``
    scratch rounds it, the output cast to x's type), pad again to x's
    channel count."""
    y = esp_block_plain(esp_unpad_io(x_padded, w1.shape[0]), w1, wd, scale,
                        bias, alpha, add_residual)
    return _pad_to(y, x_padded.shape[3])


def _check_padded(x_padded, w1, wd, scale, bias, alpha) -> None:
    if x_padded.dim() != 4 or x_padded.shape[2] <= 2 * HALO:
        raise ValueError(f"x_padded must be (B, H, W + {2 * HALO}, C_pad), "
                         f"got {tuple(x_padded.shape)}")
    if w1.dim() != 2:
        raise ValueError(f"w1 must be (C, n), got {tuple(w1.shape)}")
    c, c_pad = w1.shape[0], x_padded.shape[3]
    if c_pad not in (c, _round_up(c, 128)):
        raise ValueError(f"x_padded has {c_pad} channels; w1 is {c} wide, "
                         f"so want {c} or {_round_up(c, 128)}")
    _check_weights(c, w1, wd, scale, bias, alpha)


def _dma_library() -> ctypes.CDLL:
    lib = _build.load("esp_block_dma")
    lib.esp_dma_forward.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.esp_dma_forward.restype = ctypes.c_int
    return lib


def esp_block_padded(x_padded: torch.Tensor, w1: torch.Tensor,
                     wd: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, alpha: torch.Tensor,
                     add_residual: bool = True) -> torch.Tensor:
    """The ESP block on the padded layout, the counterpart of the JAX
    package's ``_esp_dma_call``: (B, H, W + 2*HALO, C_pad) in and out.

    ``w1``, ``wd``, ``scale``, ``bias`` and ``alpha`` are the logical-width
    operands of :func:`esp_block_fused`.  The output's halo columns and pad
    channels are exactly zero, so blocks chain on the padded layout.  The
    TPU kernel pads w1, scale, bias and alpha with zeros to reach that; K2
    reads the logical channels only and writes the zeros itself, which is
    the same function for finite inputs.  The halo columns of the input
    are reduced like any other column, as the TPU kernel reduces them.

    The TPU kernel's tiling limits are not carried over: its
    ``H * w_tile <= 8192`` wall and ``w_tile >= HALO`` error are Mosaic
    compile limits, and ``pack_taps`` packs the taps for the TPU's matrix
    unit.  K2 takes any H and W and has no such argument.

    A CUDA tensor goes through K2 (``csrc/esp_block_dma.cu``) or the call
    raises; a CPU tensor goes through :func:`esp_block_padded_plain`.
    ``esp_block_padded.launches`` counts kernel launches.
    """
    _check_padded(x_padded, w1, wd, scale, bias, alpha)
    if x_padded.device.type == "cpu":
        return esp_block_padded_plain(x_padded, w1, wd, scale, bias, alpha,
                                      add_residual)
    _check_cuda("esp_block_padded", x_padded, w1, wd, scale, bias, alpha)
    b, h, wp, c_pad = x_padded.shape
    c, n = w1.shape
    n_pad = wd.shape[2]
    lib = _dma_library()
    reduced = torch.empty((b, h, wp, n), dtype=x_padded.dtype,
                          device=x_padded.device)
    y = torch.empty_like(x_padded)
    with torch.cuda.device(x_padded.device):
        stream = torch.cuda.current_stream(x_padded.device).cuda_stream
        err = lib.esp_dma_forward(
            _ptr(x_padded), _ptr(w1), _ptr(wd), _ptr(scale), _ptr(bias),
            _ptr(alpha), _ptr(reduced), _ptr(y), b, h, wp - 2 * HALO, c,
            c_pad, n, c - 4 * n, n_pad, int(add_residual),
            int(x_padded.dtype == torch.bfloat16), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"esp_block_dma kernel launch failed: CUDA error "
                           f"{err}")
    esp_block_padded.launches += 1
    return y


esp_block_padded.launches = 0


def esp_block_fused_dma(x: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        alpha: torch.Tensor, add_residual: bool = True
                        ) -> torch.Tensor:
    """Pad, :func:`esp_block_padded`, unpad: the same operands and result
    as :func:`esp_block_fused`.  A chain of blocks pads once with
    :func:`esp_pad_io`, calls :func:`esp_block_padded` per block and unpads
    once at the end."""
    out = esp_block_padded(esp_pad_io(x), w1, wd, scale, bias, alpha,
                           add_residual)
    return esp_unpad_io(out, x.shape[3])
