"""Frozen TF GraphDef weights, with no TensorFlow: read the Const nodes of
``frozen_inference_graph.pb``, map them onto the OD-API inception_v2
Faster R-CNN tree, and make random ones at the published widths.

Counterpart of ``glomeruli_segmentation_tpu/convert/pb_import.py``, whose
parser and mapping are numpy only; the port keeps its own copy of them
(:func:`load_frozen_graph_constants`, :func:`assemble_od_api_params`,
:class:`UnmappedWeightsError`), held equal to the original by the tests.
The parsed subset of the protobuf wire format: GraphDef.node (field 1),
NodeDef.name/op/attr (fields 1/2/5), AttrValue.tensor (field 8),
TensorProto dtype/shape/tensor_content and the repeated typed values.

Batch norm (slim ``scale=False``: beta and moving statistics, gamma
optional) is folded into each conv's kernel and bias, eps 0.001.  The tree
is numpy, kernels HWIO (the stem's depthwise kernel ``(H, W, IC, M)``, the
FC heads ``(C, K)``); :meth:`..models.od_api_frcnn.ODAPIFasterRCNN.
load_params` lays it out for torch.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np

# TF DataType enum -> numpy dtype
_TF_DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    19: np.dtype("<f2"),  # DT_HALF
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
            yield field, wire, value
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos: pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos: pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_tensor_shape(buf: bytes) -> List[int]:
    dims = []
    for field, _, payload in _iter_fields(buf):
        if field == 2:  # Dim
            size = 0
            for f2, _, v2 in _iter_fields(payload):
                if f2 == 1:
                    size = v2 if isinstance(v2, int) else 0
            dims.append(size)
    return dims


def _parse_tensor(buf: bytes) -> np.ndarray:
    dtype_code = 1
    shape: List[int] = []
    content = b""
    typed_values: List = []
    for field, wire, payload in _iter_fields(buf):
        if field == 1:
            dtype_code = payload
        elif field == 2:
            shape = _parse_tensor_shape(payload)
        elif field == 4:
            content = payload
        elif field == 5:  # float_val (packed or single)
            if wire == 2:
                typed_values.extend(struct.unpack(
                    f"<{len(payload) // 4}f", payload))
            else:
                typed_values.append(struct.unpack("<f", payload)[0])
        elif field == 7:  # int_val
            if wire == 2:
                vals, pos = [], 0
                while pos < len(payload):
                    v, pos = _read_varint(payload, pos)
                    vals.append(v)
                typed_values.extend(vals)
            else:
                typed_values.append(payload)
    count = int(np.prod(shape)) if shape else 1
    # a corrupt shape can claim terabytes; np.zeros would hand out lazy
    # pages and fail later as an out-of-memory kill, not a parse error
    if count < 0 or count > (1 << 31):
        raise ValueError(f"implausible tensor element count {count} "
                         f"(shape {shape}) in frozen graph")
    dtype = _TF_DTYPES.get(dtype_code)
    if dtype is None:
        return np.zeros(shape or 0, np.float32)
    if content:
        arr = np.frombuffer(content, dtype=dtype, count=count)
    elif typed_values:
        arr = np.asarray(typed_values, dtype=dtype)
        if arr.size == 1 and count > 1:  # splat encoding
            arr = np.full(count, arr[0], dtype=dtype)
    else:
        arr = np.zeros(count, dtype=dtype)
    return arr.reshape(shape) if shape else arr.reshape(())


def _parse_node(buf: bytes):
    name = op = ""
    attrs: Dict[str, np.ndarray] = {}
    for field, _, payload in _iter_fields(buf):
        if field == 1:
            name = payload.decode("utf-8")
        elif field == 2:
            op = payload.decode("utf-8")
        elif field == 5:  # attr map entry
            key = None
            value_buf = None
            for f2, _, p2 in _iter_fields(payload):
                if f2 == 1:
                    key = p2.decode("utf-8")
                elif f2 == 2:
                    value_buf = p2
            if key == "value" and value_buf is not None:
                for f3, _, p3 in _iter_fields(value_buf):
                    if f3 == 8:  # AttrValue.tensor
                        attrs["value"] = _parse_tensor(p3)
    return name, op, attrs


def load_frozen_graph_constants(path: str) -> Dict[str, np.ndarray]:
    """Extract {node_name: tensor} for every Const node in a frozen graph."""
    with open(path, "rb") as f:
        buf = f.read()
    consts: Dict[str, np.ndarray] = {}
    for field, _, payload in _iter_fields(buf):
        if field == 1:  # GraphDef.node
            name, op, attrs = _parse_node(payload)
            if op == "Const" and "value" in attrs:
                consts[name] = attrs["value"]
    return consts


# ---------------------------------------------------------------------------
# OD-API export -> parameter tree
# ---------------------------------------------------------------------------
#
# Variable layout of an OD-API ``export_inference_graph`` Faster R-CNN with
# the slim inception_v2 feature extractor:
#
#   FirstStageFeatureExtractor/InceptionV2/<layer>/weights + BatchNorm/*
#   Conv/{weights,biases}                          (RPN 3x3 conv, relu6)
#   FirstStageBoxPredictor/{BoxEncodingPredictor,ClassPredictor}/
#       {weights,biases}                           (1x1 RPN heads)
#   SecondStageFeatureExtractor/InceptionV2/Mixed_5{a,b,c}/...
#   SecondStageBoxPredictor/{BoxEncodingPredictor,ClassPredictor}/
#       {weights,biases}                           (FC heads)

_BN_EPSILON = 0.001  # slim batch_norm's epsilon in the feature extractor

_FIRST = "FirstStageFeatureExtractor/InceptionV2/"
_SECOND = "SecondStageFeatureExtractor/InceptionV2/"


class UnmappedWeightsError(ValueError):
    """A weight-bearing const did not map onto the detector: the graph is
    not the expected OD-API inception_v2 layout."""


def _fold_bn(consts: Dict[str, np.ndarray], scope: str, w: np.ndarray,
             consumed: set, eps: float = _BN_EPSILON):
    """Fold ``<scope>/BatchNorm`` statistics (or plain biases) into
    (w, b)."""
    bn_beta = scope + "/BatchNorm/beta"
    if bn_beta in consts:
        beta = consts[bn_beta].astype(np.float64)
        mean = consts[scope + "/BatchNorm/moving_mean"].astype(np.float64)
        var = consts[scope + "/BatchNorm/moving_variance"].astype(np.float64)
        consumed.update({bn_beta, scope + "/BatchNorm/moving_mean",
                         scope + "/BatchNorm/moving_variance"})
        gamma_name = scope + "/BatchNorm/gamma"
        gamma = 1.0
        if gamma_name in consts:
            gamma = consts[gamma_name].astype(np.float64)
            consumed.add(gamma_name)
        scale = gamma / np.sqrt(var + eps)
        w = (w.astype(np.float64) * scale).astype(np.float32)
        b = (beta - mean * scale).astype(np.float32)
        return w, b
    bias_name = scope + "/biases"
    if bias_name in consts:
        consumed.add(bias_name)
        return w.astype(np.float32), consts[bias_name].astype(np.float32)
    return w.astype(np.float32), np.zeros(w.shape[-1], np.float32)


def _conv_entry(consts, scope, consumed):
    w_name = scope + "/weights"
    if w_name not in consts:
        raise UnmappedWeightsError(f"missing conv weights: {w_name}")
    consumed.add(w_name)
    w, b = _fold_bn(consts, scope, consts[w_name], consumed)
    return {"w": w, "b": b}


def _trunk_params(consts, prefix, consumed):
    """Every conv under ``prefix`` as a nested tree keyed by the path
    relative to the trunk (e.g. Mixed_3b/Branch_0/Conv2d_0a_1x1)."""
    tree: Dict = {}
    scopes = set()
    for name in consts:
        if not name.startswith(prefix):
            continue
        rel = name[len(prefix):]
        # strip the variable suffix to recover the conv scope
        for suffix in ("/weights", "/depthwise_weights", "/pointwise_weights",
                       "/biases", "/BatchNorm/beta", "/BatchNorm/gamma",
                       "/BatchNorm/moving_mean", "/BatchNorm/moving_variance"):
            if rel.endswith(suffix):
                scopes.add(rel[: -len(suffix)])
                break
    for rel in sorted(scopes):
        full = prefix + rel
        parts = rel.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        leaf_name = parts[-1]
        if full + "/depthwise_weights" in consts:  # separable stem
            dw = consts[full + "/depthwise_weights"].astype(np.float32)
            pw = consts[full + "/pointwise_weights"]
            consumed.update({full + "/depthwise_weights",
                             full + "/pointwise_weights"})
            pw, b = _fold_bn(consts, full, pw, consumed)
            node[leaf_name] = {"dw": dw, "pw": pw, "b": b}
        else:
            node[leaf_name] = _conv_entry(consts, full, consumed)
    return tree


def assemble_od_api_params(consts: Dict[str, np.ndarray]):
    """Frozen-graph constants -> ``(params, num_classes)``, the
    ODAPIFasterRCNN tree.  Raises :class:`UnmappedWeightsError` when a
    weight-bearing const is left unconsumed (an unexpected architecture)
    or a required piece is missing."""
    consumed: set = set()
    params = {
        "first": _trunk_params(consts, _FIRST, consumed),
        "second": _trunk_params(consts, _SECOND, consumed),
        "rpn_conv": _conv_entry(consts, "Conv", consumed),
        "rpn_box": _conv_entry(
            consts, "FirstStageBoxPredictor/BoxEncodingPredictor", consumed),
        "rpn_cls": _conv_entry(
            consts, "FirstStageBoxPredictor/ClassPredictor", consumed),
        "fc_box": _conv_entry(
            consts, "SecondStageBoxPredictor/BoxEncodingPredictor", consumed),
        "fc_cls": _conv_entry(
            consts, "SecondStageBoxPredictor/ClassPredictor", consumed),
    }
    for required in ("Conv2d_1a_7x7", "Mixed_3b", "Mixed_4e"):
        if required not in params["first"]:
            raise UnmappedWeightsError(
                f"first-stage trunk is missing {required}; "
                "not an inception_v2 OD-API export")
    for required in ("Mixed_5a", "Mixed_5b", "Mixed_5c"):
        if required not in params["second"]:
            raise UnmappedWeightsError(
                f"second-stage trunk is missing {required}")

    # coverage: every weight-bearing const must have been consumed
    weight_suffixes = ("/weights", "/biases", "/depthwise_weights",
                       "/pointwise_weights", "/beta", "/gamma",
                       "/moving_mean", "/moving_variance")
    leftover = [n for n in consts
                if n.endswith(weight_suffixes) and n not in consumed]
    if leftover:
        raise UnmappedWeightsError(
            "unmapped weight consts (unexpected architecture): "
            + ", ".join(sorted(leftover)[:20]))

    num_classes = int(params["fc_cls"]["b"].shape[-1]) - 1
    if num_classes < 1:
        raise UnmappedWeightsError("ClassPredictor has no foreground class")
    return params, num_classes


def load_od_api_detector_params(path: str):
    """frozen_inference_graph.pb -> (params, num_classes)."""
    return assemble_od_api_params(load_frozen_graph_constants(path))


# ---------------------------------------------------------------------------
# random weights at the published widths
# ---------------------------------------------------------------------------

# slim inception_v2 at depth_multiplier 1.0, per block and branch: the
# output widths of its convs in order (downsample blocks have no Branch_3;
# their Branch_2 is a parameter-free max pool)
INCEPTION_V2_WIDTHS = {
    "Mixed_3b": ((64,), (64, 64), (64, 96, 96), (32,)),
    "Mixed_3c": ((64,), (64, 96), (64, 96, 96), (64,)),
    "Mixed_4a": ((128, 160), (64, 96, 96)),
    "Mixed_4b": ((224,), (64, 96), (96, 128, 128), (128,)),
    "Mixed_4c": ((192,), (96, 128), (96, 128, 128), (128,)),
    "Mixed_4d": ((160,), (128, 160), (128, 160, 160), (96,)),
    "Mixed_4e": ((96,), (128, 192), (160, 192, 192), (96,)),
    "Mixed_5a": ((128, 192), (192, 256, 256)),
    "Mixed_5b": ((352,), (192, 320), (160, 224, 224), (128,)),
    "Mixed_5c": ((352,), (192, 320), (192, 224, 224), (128,)),
}
# the stem: depthwise 7x7/2 with depth multiplier 8, pointwise to 64
STEM_MULTIPLIER, STEM_WIDTH = 8, 64
# the sample faster_rcnn_inception_v2 config: RPN conv depth, anchors/cell
RPN_DEPTH, NUM_ANCHORS = 512, 12


def _block_layers(name: str, convs, cin: int):
    """(scope relative to the trunk, kernel size, in, out) of every conv of
    block ``name`` at the published widths, given its branches' conv names,
    and the block's output width."""
    widths = INCEPTION_V2_WIDTHS[name]
    downsample = len(widths) == 2
    layers, out = [], cin if downsample else 0  # + the max-pooled input
    for i, (names, outs) in enumerate(zip(convs, widths)):
        c = cin
        for conv, o in zip(names, outs):
            layers.append((f"{name}/Branch_{i}/{conv}", int(conv[-1]), c, o))
            c = o
        out += c
    return layers, out


def random_od_api_consts(seed: int, num_classes: int = 1, device="cuda",
                         calib_size=(256, 256), calib_proposals: int = 64
                         ) -> Dict[str, np.ndarray]:
    """Random frozen-graph constants of the OD-API inception_v2 Faster
    R-CNN at the published widths (slim ``inception_v2``, depth multiplier
    1.0; RPN depth 512, 12 anchors), made from ``seed`` with numpy, laid
    out as :func:`load_frozen_graph_constants` returns them.

    Kernels are He-normal; BN betas small; the heads' biases zero.  The BN
    moving statistics are then set the way training leaves them: one
    forward of the whole detector over two seeded PAS-like windows of
    ``calib_size`` (``calib_proposals`` proposals each) on ``device``, with
    the plain NMS, in which each BN normalises its conv's output with the
    batch statistics, layer by layer.  Without that the activations grow
    through the trunk and every RPN and second-stage score is equal."""
    # torch and the model only here: the parser and the mapping above stay
    # numpy only
    import torch

    from .. import resolve_device
    from ..models.inception_v2 import (FIRST_BLOCKS, SECOND_BLOCKS,
                                       block_convs)
    from ..models.od_api_frcnn import (ODAPIConfig, ODAPIFasterRCNN,
                                       build_anchors)
    from .detector_import import calibration_images

    rng = np.random.RandomState(seed)
    dev = resolve_device(device)
    consts: Dict[str, np.ndarray] = {}
    bn_scopes = []

    def he(shape, fan_in, gain=2.0):
        return (rng.randn(*shape) * np.sqrt(gain / fan_in)).astype(
            np.float32)

    def conv(scope, k, cin, cout):
        consts[scope + "/weights"] = he((k, k, cin, cout), k * k * cin)
        consts[scope + "/BatchNorm/beta"] = (rng.randn(cout) * 0.1).astype(
            np.float32)
        bn_scopes.append(scope)

    stem = _FIRST + "Conv2d_1a_7x7"
    consts[stem + "/depthwise_weights"] = he((7, 7, 3, STEM_MULTIPLIER), 49)
    consts[stem + "/pointwise_weights"] = he(
        (1, 1, 3 * STEM_MULTIPLIER, STEM_WIDTH), 3 * STEM_MULTIPLIER)
    consts[stem + "/BatchNorm/beta"] = (rng.randn(STEM_WIDTH) * 0.1).astype(
        np.float32)
    bn_scopes.append(stem)
    conv(_FIRST + "Conv2d_2b_1x1", 1, STEM_WIDTH, 64)
    conv(_FIRST + "Conv2d_2c_3x3", 3, 64, 192)
    c = 192
    for prefix, blocks in ((_FIRST, FIRST_BLOCKS), (_SECOND, SECOND_BLOCKS)):
        for name in blocks:
            layers, out = _block_layers(name, block_convs(name), c)
            for scope, k, cin, cout in layers:
                conv(prefix + scope, k, cin, cout)
            c = out
        if prefix == _FIRST:
            consts["Conv/weights"] = he((3, 3, c, RPN_DEPTH), 9 * c)
            consts["Conv/biases"] = np.zeros(RPN_DEPTH, np.float32)
            for head, k in (("BoxEncodingPredictor", 4),
                            ("ClassPredictor", 2)):
                scope = "FirstStageBoxPredictor/" + head
                consts[scope + "/weights"] = he(
                    (1, 1, RPN_DEPTH, NUM_ANCHORS * k), RPN_DEPTH, 1.0)
                consts[scope + "/biases"] = np.zeros(NUM_ANCHORS * k,
                                                     np.float32)
    for head, k in (("BoxEncodingPredictor", 4 * num_classes),
                    ("ClassPredictor", num_classes + 1)):
        scope = "SecondStageBoxPredictor/" + head
        consts[scope + "/weights"] = he((c, k), c, 1.0)
        consts[scope + "/biases"] = np.zeros(k, np.float32)

    # calibration: the convs hold the raw kernels and zero biases (each BN
    # scope given zero "biases" in place of its statistics), and a hook
    # normalises each BN conv's output with its batch statistics + beta
    raw = {k: v for k, v in consts.items() if "/BatchNorm/" not in k}
    for scope in bn_scopes:
        raw[scope + "/biases"] = np.zeros(consts[scope + "/BatchNorm/beta"]
                                          .shape, np.float32)
    tree, _ = assemble_od_api_params(raw)
    config = ODAPIConfig(num_classes=num_classes, image_size=tuple(calib_size),
                         max_proposals=calib_proposals)
    model = ODAPIFasterRCNN(tree, config, compute_dtype="float32",
                            kernel_nms=False).to(dev).eval()
    stats = {}

    def hook(scope):
        beta = torch.from_numpy(consts[scope + "/BatchNorm/beta"]).to(dev)

        def fn(_module, _inputs, y):
            mean = y.mean(dim=(0, 2, 3))
            var = y.var(dim=(0, 2, 3), unbiased=False)
            stats[scope] = (mean.cpu().numpy(), var.cpu().numpy())
            s = torch.rsqrt(var + _BN_EPSILON).view(1, -1, 1, 1)
            return (y - mean.view(1, -1, 1, 1)) * s + beta.view(1, -1, 1, 1)
        return fn

    def module_of(scope):
        # module names follow the tree: <trunk>.<scope path>; the stem's BN
        # is its pointwise conv's
        for prefix, trunk in ((_FIRST, "first"), (_SECOND, "second")):
            if scope.startswith(prefix):
                m = model.get_submodule(
                    trunk + "." + scope[len(prefix):].replace("/", "."))
                return getattr(m, "pointwise", m)
        raise KeyError(scope)

    handles = [module_of(scope).register_forward_hook(hook(scope))
               for scope in bn_scopes]
    try:
        images = torch.from_numpy(calibration_images(
            rng, 2, *calib_size)).to(dev)
        with torch.no_grad():
            model.detect(images, build_anchors(config).to(dev))
    finally:
        for h in handles:
            h.remove()
    for scope in bn_scopes:
        mean, var = stats[scope]
        consts[scope + "/BatchNorm/moving_mean"] = mean.astype(np.float32)
        consts[scope + "/BatchNorm/moving_variance"] = var.astype(np.float32)
    return consts
