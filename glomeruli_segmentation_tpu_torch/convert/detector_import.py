"""Detector weights: carry them across from the JAX package's Flax tree and
back, read and write ``detector.ckpt.pth``, and make random ones.

The port's detector state is a flat dict of float32 tensors keyed by the
port's module names, which follow the Flax tree:

- Conv kernels ``(kH, kW, I, O)``     -> ``<name>.weight`` ``(O, I, kH, kW)``
- ``nn.Dense`` kernels ``(I, O)``      -> ``<name>.weight`` ``(O, I)``
- biases                              -> ``<name>.bias``
- BatchNorm scale/bias (params) and mean/var (batch_stats)
                                      -> ``<name>.bn.{scale,bias,mean,var}``
- the Flax ``c2_conv``/``c2_bn`` pair of a bottleneck -> ``c2.conv``/``c2.bn``;
  the stem's ``conv1``/``bn1``         -> ``conv1.conv``/``conv1.bn``

:meth:`..models.faster_rcnn.FasterRCNN.load_state` folds every BN into its
conv when the state is loaded (or keeps it, in the training form).
:func:`flax_from_state_dict` is the way back, and
:func:`save_detector_checkpoint` writes the checkpoint both packages'
``gseg-detect`` read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..models.faster_rcnn import FasterRCNN, FasterRCNNConfig, build_anchors
from ..models.resnet import BN_EPS, ConvBN

StateDict = Dict[str, torch.Tensor]

# Flax module name -> the port's
_RENAME = {"c2_conv": "c2.conv", "c2_bn": "c2.bn",
           "conv1": "conv1.conv", "bn1": "conv1.bn"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _leaf(path: Tuple[str, ...], value) -> Tuple[str, torch.Tensor]:
    *modules, leaf = path
    name = ".".join(_RENAME.get(m, m) for m in modules)
    v = np.asarray(value, np.float32)
    if leaf == "kernel":
        leaf = "weight"
        # HWIO -> OIHW; Dense (in, out) -> (out, in)
        v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
    return f"{name}.{leaf}", torch.from_numpy(np.array(v, order="C"))


def state_dict_from_flax(variables: Mapping) -> StateDict:
    """The JAX package's ``FasterRCNN`` variables (``{'params',
    'batch_stats'}``, numpy or tensor leaves) -> the port's state."""
    out: StateDict = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables[collection]):
            key, tensor = _leaf(path, value)
            out[key] = tensor
    return out


def _flax_module(modules):
    """The port's module names -> the Flax ones (the inverse of
    ``_RENAME``): a bottleneck's ``c2.conv``/``c2.bn`` (its parent is a
    ``block<i>``) and the stem's ``conv1.conv``/``conv1.bn``; the tiny
    backbone's ``c2`` is a ``ConvBN`` of its own in both trees."""
    back = {v: k for k, v in _RENAME.items()}
    out, i = [], 0
    while i < len(modules):
        pair = ".".join(modules[i:i + 2])
        bottleneck = i > 0 and modules[i - 1].startswith("block")
        if pair in back and (modules[i] == "conv1" or bottleneck):
            out.append(back[pair])
            i += 2
        else:
            out.append(modules[i])
            i += 1
    return out


def flax_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict:
    """The port's detector state -> the JAX package's ``FasterRCNN``
    variables, ``{"params", "batch_stats"}`` with float32 numpy leaves
    (conv kernels HWIO, Dense kernels (in, out)); the inverse of
    :func:`state_dict_from_flax`."""
    out: Dict = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *modules, leaf = key.split(".")
        v = np.asarray(value.detach().float().cpu().numpy(), np.float32)
        collection = "params"
        if leaf == "weight":
            leaf = "kernel"
            v = np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v.T
        elif modules[-1] == "bn" and leaf in ("mean", "var"):
            collection = "batch_stats"
        node = out[collection]
        for m in _flax_module(modules):
            node = node.setdefault(m, {})
        node[leaf] = np.array(v, order="C")
    return out


def save_detector_checkpoint(state: Mapping[str, torch.Tensor],
                             config: FasterRCNNConfig, path: str) -> str:
    """Write ``detector.ckpt.pth`` as the JAX package's trainer lays it out
    (``{"variables": {"params", "batch_stats"}, "config": FasterRCNNConfig
    fields}``), leaves as float32 CPU tensors, with ``torch.save`` (the zip
    form, which the JAX package's ``load_torch_pickle`` reads too)."""
    def tensors(tree):
        return {k: tensors(v) if isinstance(v, Mapping)
                else torch.from_numpy(v) for k, v in tree.items()}

    torch.save({"variables": tensors(flax_from_state_dict(state)),
                "config": dataclasses.asdict(config)}, path)
    return path


def load_detector_checkpoint(path: str
                             ) -> Tuple[StateDict, FasterRCNNConfig]:
    """Read a ``detector.ckpt.pth`` (``{"variables": {"params",
    "batch_stats"}, "config": FasterRCNNConfig fields}``, the legacy torch
    pickle the JAX package's detector trainer writes) -> (state, config).
    The file is unpickled in full (``weights_only=False``): read only
    checkpoints this project wrote."""
    obj = torch.load(path, map_location="cpu", weights_only=False)

    def numpy_leaves(tree):
        return {k: numpy_leaves(v) if isinstance(v, Mapping)
                else (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in tree.items()}

    fields = {f.name for f in dataclasses.fields(FasterRCNNConfig)}
    config = FasterRCNNConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in obj["config"].items() if k in fields})
    return state_dict_from_flax(numpy_leaves(obj["variables"])), config


# ---------------- random weights ----------------
def calibration_images(rng: np.random.RandomState, batch: int, h: int,
                        w: int) -> np.ndarray:
    """PAS-like RGB windows: pink noise with a few dark round blobs."""
    img = np.clip(rng.randint(-20, 20, (batch, h, w, 3))
                  + np.asarray((230, 205, 215)), 0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for b in range(batch):
        for _ in range(4):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(0.05, 0.2) * min(h, w)
            img[b][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = (170, 110, 150)
    return img


def random_detector_state(seed: int,
                          config: FasterRCNNConfig = FasterRCNNConfig(),
                          device="cuda", calib_size=(256, 256)
                          ) -> StateDict:
    """Random detector weights in the port's layout, made from ``seed`` with
    numpy.

    Conv kernels are He-normal, BN affines near identity, the heads' biases
    zero.  BN running statistics are then set the way training leaves them:
    one forward over two seeded PAS-like windows of ``calib_size`` in
    which each BN normalises with the batch statistics of
    its conv's output (train mode, momentum 1), layer by layer.  Without
    that, unit statistics through 16 bottlenecks overflow bfloat16 and
    every score would be equal or NaN.  The calibration runs on ``device``
    with the plain NMS."""
    rng = np.random.RandomState(seed)
    dev = resolve_device(device)
    calib = dataclasses.replace(config, image_size=tuple(calib_size),
                                roi_chunk=config.post_nms_top_n)
    model = FasterRCNN(calib, kernel_nms=False)
    state: StateDict = {}
    bn_layers = {}
    inside_convbn = set()
    for name, m in model.named_modules():
        if isinstance(m, ConvBN):
            inside_convbn.add(name + ".conv")
            w = m.conv.weight
            out_ch = w.shape[0]
            state[f"{name}.conv.weight"] = torch.from_numpy(np.asarray(
                rng.randn(*w.shape) * np.sqrt(2.0 / w[0].numel()),
                np.float32))
            state[f"{name}.bn.scale"] = torch.from_numpy(
                rng.uniform(0.8, 1.2, out_ch).astype(np.float32))
            state[f"{name}.bn.bias"] = torch.from_numpy(
                (rng.randn(out_ch) * 0.1).astype(np.float32))
            bn_layers[name] = m
        elif isinstance(m, (nn.Conv2d, nn.Linear)) and \
                name not in inside_convbn:
            w = m.weight
            gain = 2.0 if name == "rpn.conv" else 1.0  # ReLU follows
            state[f"{name}.weight"] = torch.from_numpy(np.asarray(
                rng.randn(*w.shape) * np.sqrt(gain / w[0].numel()),
                np.float32))
            state[f"{name}.bias"] = torch.zeros(w.shape[0])

    # calibration: every ConvBN's conv holds the raw kernel and no bias, and
    # a hook normalises its output with the batch statistics
    raw = {k: v for k, v in state.items() if ".bn." not in k}
    for name in bn_layers:
        raw[f"{name}.conv.bias"] = torch.zeros(
            state[f"{name}.conv.weight"].shape[0])
    model.load_state_dict(raw, strict=True)
    model.to(dev).eval()
    stats = {}

    def hook(name):
        scale = state[f"{name}.bn.scale"].to(dev)
        bias = state[f"{name}.bn.bias"].to(dev)

        def fn(_module, _inputs, y):
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            stats[name] = (mean.cpu(), var.cpu())
            s = (scale / torch.sqrt(var + BN_EPS)).view(1, -1, 1, 1)
            return (y - mean.view(1, -1, 1, 1)) * s + bias.view(1, -1, 1, 1)
        return fn

    handles = [m.conv.register_forward_hook(hook(name))
               for name, m in bn_layers.items()]
    try:
        images = torch.from_numpy(calibration_images(
            rng, 2, *calib_size)).to(dev)
        with torch.no_grad():
            model(images, build_anchors(calib).to(dev))
    finally:
        for h in handles:
            h.remove()
    for name in bn_layers:
        mean, var = stats[name]
        state[f"{name}.bn.mean"] = mean.float()
        state[f"{name}.bn.var"] = var.float()
    return state


def _lecun_normal(rng: np.random.RandomState, shape, fan_in: int
                  ) -> np.ndarray:
    """Flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a normal cut at two standard deviations, scaled
    to variance 1 / fan_in."""
    z = rng.randn(*shape)
    out = np.abs(z) > 2
    while out.any():
        z[out] = rng.randn(int(out.sum()))
        out = np.abs(z) > 2
    return (z * (np.sqrt(1.0 / fan_in) / 0.87962566103423978)).astype(
        np.float32)


def init_detector_state(seed: int,
                        config: FasterRCNNConfig = FasterRCNNConfig()
                        ) -> StateDict:
    """Fresh detector weights as the JAX package's ``model.init`` lays them
    out, made from ``seed`` with numpy: conv and Dense kernels drawn like
    Flax's default (LeCun truncated normal), biases zero, BN scale 1, bias
    0, mean 0, var 1.  The draws follow the port's module order, so the
    values are not the JAX package's for the same seed."""
    rng = np.random.RandomState(seed)
    model = FasterRCNN(config, train_form=True)
    state: StateDict = {}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            state[f"{name}.weight"] = torch.from_numpy(_lecun_normal(
                rng, tuple(w.shape), w[0].numel()))
            if m.bias is not None:
                state[f"{name}.bias"] = torch.zeros(w.shape[0])
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            state[f"{name}.scale"] = torch.ones(c)
            state[f"{name}.bias"] = torch.zeros(c)
            state[f"{name}.mean"] = torch.zeros(c)
            state[f"{name}.var"] = torch.ones(c)
    return state
