"""ESPNet ``.pth`` checkpoints: load, inspect, carry weights across from the
JAX package's Flax tree, and make random ones.

Counterpart of ``glomeruli_segmentation_tpu/convert/espnet_import.py``.
The port's models use the reference state-dict layout directly, so a
checkpoint needs no key mapping to load; :func:`state_dict_from_flax` maps
the JAX package's Flax variables (as numpy arrays) onto that layout:

- HWIO conv kernels ``(kH, kW, I, O)``   -> Conv2d ``(O, I, kH, kW)``
- ``(2, 2, I, O)`` upconv kernels        -> ConvTranspose2d ``(I, O, 2, 2)``
- BatchNorm scale/bias (params)          -> weight/bias
- BatchNorm mean/var (batch_stats)       -> running_mean/running_var
- PReLU alpha                            -> act.weight
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.espnet import create_espnet

StateDict = Dict[str, torch.Tensor]


def load_espnet_state_dict(path: str) -> StateDict:
    """Load a reference ``.pth`` checkpoint's state dict.  Also accepts a
    full training checkpoint whose weights live under ``state_dict``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def infer_architecture(state_dict: Mapping):
    """Infer (classes, p, q, decoder) from checkpoint keys/shapes."""
    has_decoder = any(k.startswith("encoder.") for k in state_dict)
    prefix = "encoder." if has_decoder else ""
    classes = state_dict[f"{prefix}classifier.conv.weight"].shape[0]
    p = 1 + max(
        (int(m.group(1)) for k in state_dict
         if (m := re.match(re.escape(prefix) + r"level2\.(\d+)\.", k))),
        default=-1,
    )
    q = 1 + max(
        (int(m.group(1)) for k in state_dict
         if (m := re.match(re.escape(prefix) + r"level3\.(\d+)\.", k))),
        default=-1,
    )
    return classes, p, q, has_decoder


# ---------------- Flax tree -> state dict ----------------
def _conv(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _conv_t(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (2, 3, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _bn(out: StateDict, prefix: str, p, s) -> None:
    out[prefix + "weight"] = _vec(p["scale"])
    out[prefix + "bias"] = _vec(p["bias"])
    out[prefix + "running_mean"] = _vec(s["mean"])
    out[prefix + "running_var"] = _vec(s["var"])
    out[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _cbr(out: StateDict, prefix: str, p, s) -> None:
    out[prefix + "conv.weight"] = _conv(p["c"]["conv"]["kernel"])
    _bn(out, prefix + "bn.", p["norm"]["bn"], s["norm"]["bn"])
    out[prefix + "act.weight"] = _vec(p["act"]["alpha"])


def _br(out: StateDict, prefix: str, p, s) -> None:
    _bn(out, prefix + "bn.", p["norm"]["bn"], s["norm"]["bn"])
    out[prefix + "act.weight"] = _vec(p["act"]["alpha"])


def _esp(out: StateDict, prefix: str, p, s, downsample: bool) -> None:
    for sub in ("c1", "d1", "d2", "d4", "d8", "d16"):
        out[prefix + sub + ".conv.weight"] = _conv(p[sub]["conv"]["kernel"])
    if downsample:
        _bn(out, prefix + "bn.", p["norm"]["bn"], s["norm"]["bn"])
        out[prefix + "act.weight"] = _vec(p["act"]["alpha"])
    else:
        _br(out, prefix + "bn.", p["br"], s["br"])


def state_dict_from_flax(variables: Mapping) -> StateDict:
    """The JAX package's ESPNet(-C) Flax variables (``{'params',
    'batch_stats'}``, numpy leaves) -> the port's state dict."""
    params = variables["params"]
    stats = variables["batch_stats"]
    has_decoder = "encoder" in params
    out: StateDict = {}

    def encoder(p, s, prefix: str) -> None:
        _cbr(out, prefix + "level1.", p["level1"], s["level1"])
        _br(out, prefix + "b1.", p["b1"], s["b1"])
        _esp(out, prefix + "level2_0.", p["down2"], s["down2"], True)
        i = 0
        while f"level2_{i}" in p:
            _esp(out, f"{prefix}level2.{i}.", p[f"level2_{i}"],
                 s[f"level2_{i}"], False)
            i += 1
        _br(out, prefix + "b2.", p["b2"], s["b2"])
        _esp(out, prefix + "level3_0.", p["down3"], s["down3"], True)
        i = 0
        while f"level3_{i}" in p:
            _esp(out, f"{prefix}level3.{i}.", p[f"level3_{i}"],
                 s[f"level3_{i}"], False)
            i += 1
        _br(out, prefix + "b3.", p["b3"], s["b3"])
        out[prefix + "classifier.conv.weight"] = _conv(
            p["classifier"]["conv"]["kernel"])

    if has_decoder:
        encoder(params["encoder"], stats["encoder"], "encoder.")
        out["level3_C.conv.weight"] = _conv(
            params["level3_C"]["conv"]["kernel"])
        _bn(out, "br.", params["br"], stats["br"])
        _cbr(out, "conv.", params["conv"], stats["conv"])
        out["up_l3.0.weight"] = _conv_t(params["up_l3"]["kernel"])
        _br(out, "combine_l2_l3.0.", params["combine_l2_l3_br"],
            stats["combine_l2_l3_br"])
        _cbr(out, "combine_l2_l3.1.", params["combine_l2_l3_cbr"],
             stats["combine_l2_l3_cbr"])
        out["up_l2.0.weight"] = _conv_t(params["up_l2"]["kernel"])
        _br(out, "up_l2.1.", params["up_l2_br"], stats["up_l2_br"])
        out["classifier.weight"] = _conv_t(params["classifier"]["kernel"])
    else:
        encoder(params, stats, "")
    return out


# ---------------- random checkpoints ----------------
# fold-1 BGR mean/std of the reference (pipeline.fused.FOLD_NORMALIZATION)
_CALIB_MEAN = np.asarray((204.60071, 170.19359, 199.57469), np.float32)
_CALIB_STD = np.asarray((20.61257, 42.92207, 28.401505), np.float32)


def random_state_dict(seed: int, classes: int = 5, p: int = 2, q: int = 8,
                      decoder: bool = True,
                      calib_size=(64, 128)) -> StateDict:
    """Random weights in the reference layout, made from ``seed`` with numpy.

    Conv kernels are He-normal, PReLU slopes near 0.25, BN affines near
    identity.  BN running statistics are then set the way training leaves
    them, matched to the layer's input: one forward in train mode with
    momentum 1 over a seeded PAS-like input normalised as the pipeline
    normalises crops (``(x - mean) / std / 255``, so the first statistics
    are tiny, as in the shipped checkpoints).  Without that the random net's
    logits would be near-uniform and every argmax a near-tie."""
    rng = np.random.RandomState(seed)
    model = create_espnet(classes, p, q, decoder)
    sd = {}
    for key, ref in model.state_dict().items():
        shape = tuple(ref.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0, dtype=torch.int64)
            continue
        if key.endswith("running_mean") or key.endswith("running_var"):
            sd[key] = ref.clone()  # replaced by the calibration below
            continue
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            if key.startswith("up_") or key == "classifier.weight":
                fan_in = shape[0]  # ConvTranspose2d: (I, O, 2, 2)
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif key.endswith("act.weight"):
            v = rng.uniform(0.1, 0.4, shape)
        elif key.endswith("weight"):  # BN scale
            v = rng.uniform(0.8, 1.2, shape)
        else:  # BN bias
            v = rng.randn(*shape) * 0.1
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    model.load_state_dict(sd, strict=True)

    h, w = calib_size
    base = rng.uniform(-30, 30, (2, h, w, 3)) + _CALIB_MEAN
    x = (base.astype(np.float32) - _CALIB_MEAN) / _CALIB_STD / 255.0
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k in out:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(0, dtype=torch.int64)
    return out
