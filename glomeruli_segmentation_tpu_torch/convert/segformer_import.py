"""SegFormer weights: HuggingFace state dicts and the JAX package's Flax
tree, in both directions.

Counterpart of ``glomeruli_segmentation_tpu/convert/segformer_import.py``.
The port's model (:mod:`..models.segformer`) uses HF's
``SegformerForSemanticSegmentation`` keys, so an HF ``pytorch_model.bin``
loads with no key map.  The Flax tree of the JAX package (and of the
trainer's ``flax_model.pth``) maps onto those keys as:

- conv kernels ``(kh, kw, I, O)``         -> ``(O, I, kh, kw)``
- dense kernels ``(in, out)``             -> ``(out, in)``
- depthwise kernels ``(kh, kw, 1, C)``    -> ``(C, 1, kh, kw)``
- LayerNorm/BatchNorm ``scale``           -> ``weight``
- the head's BN ``mean``/``var`` (batch_stats) -> ``running_mean``/``running_var``

:func:`variables_from_state_dict` is a numpy copy of the JAX module's
``hf_state_dict_to_variables``; :func:`state_dict_from_variables` is its
inverse.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _set(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = np.asarray(value)


def _conv(w):  # (O, I, kh, kw) -> (kh, kw, I, O)
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w):  # (out, in) -> (in, out)
    return np.transpose(w, (1, 0))


def _dwconv(w):  # (C, 1, kh, kw) -> (kh, kw, 1, C)
    return np.transpose(w, (2, 3, 1, 0))


def _n_stages(keys) -> int:
    return 1 + max(
        int(m.group(1)) for k in keys
        if (m := re.match(r"segformer\.encoder\.patch_embeddings\.(\d+)\.",
                          k)))


def variables_from_state_dict(sd: Mapping[str, np.ndarray]
                              ) -> Dict[str, Any]:
    """HF-keyed state dict (numpy arrays) -> the Flax tree
    ``{"params": ..., "batch_stats": ...}`` of the JAX package's model."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def ln(dst, key_w, key_b):
        _set(params, dst + ("scale",), sd[key_w])
        _set(params, dst + ("bias",), sd[key_b])

    n_stages = _n_stages(sd)
    for i in range(n_stages):
        base = f"segformer.encoder.patch_embeddings.{i}."
        dst = ("encoder", f"patch_embed{i}")
        _set(params, dst + ("proj", "kernel"), _conv(sd[base + "proj.weight"]))
        _set(params, dst + ("proj", "bias"), sd[base + "proj.bias"])
        ln(dst + ("norm",), base + "layer_norm.weight",
           base + "layer_norm.bias")
        ln(("encoder", f"norm{i}"),
           f"segformer.encoder.layer_norm.{i}.weight",
           f"segformer.encoder.layer_norm.{i}.bias")

        j = 0
        while f"segformer.encoder.block.{i}.{j}.layer_norm_1.weight" in sd:
            b = f"segformer.encoder.block.{i}.{j}."
            d = ("encoder", f"block{i}_{j}")
            ln(d + ("norm1",), b + "layer_norm_1.weight",
               b + "layer_norm_1.bias")
            ln(d + ("norm2",), b + "layer_norm_2.weight",
               b + "layer_norm_2.bias")
            for hf, ours in (("query", "q"), ("key", "k"), ("value", "v")):
                _set(params, d + ("attn", ours, "kernel"),
                     _dense(sd[b + f"attention.self.{hf}.weight"]))
                _set(params, d + ("attn", ours, "bias"),
                     sd[b + f"attention.self.{hf}.bias"])
            if b + "attention.self.sr.weight" in sd:
                _set(params, d + ("attn", "sr", "kernel"),
                     _conv(sd[b + "attention.self.sr.weight"]))
                _set(params, d + ("attn", "sr", "bias"),
                     sd[b + "attention.self.sr.bias"])
                ln(d + ("attn", "sr_norm"),
                   b + "attention.self.layer_norm.weight",
                   b + "attention.self.layer_norm.bias")
            _set(params, d + ("attn", "proj", "kernel"),
                 _dense(sd[b + "attention.output.dense.weight"]))
            _set(params, d + ("attn", "proj", "bias"),
                 sd[b + "attention.output.dense.bias"])
            _set(params, d + ("mlp", "dense1", "kernel"),
                 _dense(sd[b + "mlp.dense1.weight"]))
            _set(params, d + ("mlp", "dense1", "bias"),
                 sd[b + "mlp.dense1.bias"])
            _set(params, d + ("mlp", "dwconv", "kernel"),
                 _dwconv(sd[b + "mlp.dwconv.dwconv.weight"]))
            _set(params, d + ("mlp", "dwconv", "bias"),
                 sd[b + "mlp.dwconv.dwconv.bias"])
            _set(params, d + ("mlp", "dense2", "kernel"),
                 _dense(sd[b + "mlp.dense2.weight"]))
            _set(params, d + ("mlp", "dense2", "bias"),
                 sd[b + "mlp.dense2.bias"])
            j += 1

    # decode head: absent from backbone-only checkpoints (the published
    # nvidia/mit-b* weights), whose head the trainer initialises itself
    if "decode_head.linear_fuse.weight" in sd:
        for i in range(n_stages):
            base = f"decode_head.linear_c.{i}.proj."
            _set(params, ("head", f"linear_c{i}", "kernel"),
                 _dense(sd[base + "weight"]))
            _set(params, ("head", f"linear_c{i}", "bias"), sd[base + "bias"])
        _set(params, ("head", "linear_fuse", "kernel"),
             _conv(sd["decode_head.linear_fuse.weight"]))
        _set(params, ("head", "bn", "scale"),
             sd["decode_head.batch_norm.weight"])
        _set(params, ("head", "bn", "bias"),
             sd["decode_head.batch_norm.bias"])
        _set(stats, ("head", "bn", "mean"),
             sd["decode_head.batch_norm.running_mean"])
        _set(stats, ("head", "bn", "var"),
             sd["decode_head.batch_norm.running_var"])
        _set(params, ("head", "classifier", "kernel"),
             _conv(sd["decode_head.classifier.weight"]))
        _set(params, ("head", "classifier", "bias"),
             sd["decode_head.classifier.bias"])
    return {"params": params, "batch_stats": stats}


def state_dict_from_variables(variables: Mapping[str, Any]) -> StateDict:
    """The Flax tree (numpy arrays; ``{"params", "batch_stats"}``) -> the
    port's HF-keyed state dict of float32 tensors, the inverse of
    :func:`variables_from_state_dict`.  A tree with a head gets the
    ``num_batches_tracked`` counter ``nn.BatchNorm2d`` keeps."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {})
    enc = params["encoder"]
    sd: Dict[str, np.ndarray] = {}

    def ln(dst, node):
        sd[dst + "weight"] = node["scale"]
        sd[dst + "bias"] = node["bias"]

    def inv_conv(w):  # (kh, kw, I, O) -> (O, I, kh, kw)
        return np.transpose(w, (3, 2, 0, 1))

    n_stages = sum(1 for k in enc if str(k).startswith("patch_embed"))
    for i in range(n_stages):
        pe = enc[f"patch_embed{i}"]
        base = f"segformer.encoder.patch_embeddings.{i}."
        sd[base + "proj.weight"] = inv_conv(pe["proj"]["kernel"])
        sd[base + "proj.bias"] = pe["proj"]["bias"]
        ln(base + "layer_norm.", pe["norm"])
        ln(f"segformer.encoder.layer_norm.{i}.", enc[f"norm{i}"])
        j = 0
        while f"block{i}_{j}" in enc:
            blk = enc[f"block{i}_{j}"]
            b = f"segformer.encoder.block.{i}.{j}."
            ln(b + "layer_norm_1.", blk["norm1"])
            ln(b + "layer_norm_2.", blk["norm2"])
            attn = blk["attn"]
            for hf, ours in (("query", "q"), ("key", "k"), ("value", "v")):
                sd[b + f"attention.self.{hf}.weight"] = \
                    _dense(attn[ours]["kernel"])
                sd[b + f"attention.self.{hf}.bias"] = attn[ours]["bias"]
            if "sr" in attn:
                sd[b + "attention.self.sr.weight"] = \
                    inv_conv(attn["sr"]["kernel"])
                sd[b + "attention.self.sr.bias"] = attn["sr"]["bias"]
                ln(b + "attention.self.layer_norm.", attn["sr_norm"])
            sd[b + "attention.output.dense.weight"] = \
                _dense(attn["proj"]["kernel"])
            sd[b + "attention.output.dense.bias"] = attn["proj"]["bias"]
            mlp = blk["mlp"]
            for name in ("dense1", "dense2"):
                sd[b + f"mlp.{name}.weight"] = _dense(mlp[name]["kernel"])
                sd[b + f"mlp.{name}.bias"] = mlp[name]["bias"]
            sd[b + "mlp.dwconv.dwconv.weight"] = \
                inv_conv(mlp["dwconv"]["kernel"])
            sd[b + "mlp.dwconv.dwconv.bias"] = mlp["dwconv"]["bias"]
            j += 1

    head = params.get("head")
    if head is not None:
        for i in range(n_stages):
            base = f"decode_head.linear_c.{i}.proj."
            sd[base + "weight"] = _dense(head[f"linear_c{i}"]["kernel"])
            sd[base + "bias"] = head[f"linear_c{i}"]["bias"]
        sd["decode_head.linear_fuse.weight"] = \
            inv_conv(head["linear_fuse"]["kernel"])
        sd["decode_head.batch_norm.weight"] = head["bn"]["scale"]
        sd["decode_head.batch_norm.bias"] = head["bn"]["bias"]
        sd["decode_head.batch_norm.running_mean"] = stats["head"]["bn"]["mean"]
        sd["decode_head.batch_norm.running_var"] = stats["head"]["bn"]["var"]
        sd["decode_head.classifier.weight"] = \
            inv_conv(head["classifier"]["kernel"])
        sd["decode_head.classifier.bias"] = head["classifier"]["bias"]
    out = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    if head is not None:
        out["decode_head.batch_norm.num_batches_tracked"] = \
            torch.tensor(0, dtype=torch.int64)
    return out


# safetensors dtype names -> torch dtypes (all stored little-endian)
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """A ``.safetensors`` file as CPU tensors, read with the standard
    library: an 8-byte little-endian header length, that many bytes of a
    JSON header (per tensor its dtype, shape and ``[begin, end)`` byte
    offsets into the data that follows; ``__metadata__`` is skipped), then
    the raw little-endian tensor bytes (the hosts' own order).  The card's
    machine has no ``safetensors`` package."""
    import json
    import struct

    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name} has {end - begin} bytes for "
                             f"shape {shape} {info['dtype']}")
        t = (torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def load_segformer_state_dict(checkpoint_path: str,
                              backbone_only: bool = False) -> StateDict:
    """An HF checkpoint directory, ``pytorch_model.bin`` or
    ``model.safetensors`` -> the port's state dict, as the JAX package's
    ``load_segformer_variables`` reads them.  A backbone-only checkpoint
    (no decode head, as the published ``nvidia/mit-b*`` weights) gives the
    encoder-only state dict with ``backbone_only=True``, which only the
    trainer passes (it fills in a head); otherwise it raises
    ``ValueError``."""
    path = checkpoint_path
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            candidate = os.path.join(path, name)
            if os.path.isfile(candidate):
                path = candidate
                break
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if "decode_head.linear_fuse.weight" not in sd and not backbone_only:
        raise ValueError(f"{path} is a backbone-only checkpoint (no decode "
                         f"head); only the trainer fills in a head")
    return dict(sd)


def save_flax_checkpoint(state_dict: Mapping[str, torch.Tensor], path: str,
                         num_labels: int) -> None:
    """Write ``state_dict`` as the trainer's ``flax_model.pth``: the Flax
    tree (``params``, ``batch_stats``) and ``num_labels``, tensors that
    ``torch.load(weights_only=True)`` reads back."""
    variables = variables_from_state_dict(
        {k: v.detach().float().cpu().numpy() for k, v in state_dict.items()
         if not k.endswith("num_batches_tracked")})

    def tensors(node):
        if isinstance(node, dict):
            return {k: tensors(v) for k, v in node.items()}
        return torch.from_numpy(np.ascontiguousarray(node))

    torch.save({"params": tensors(variables["params"]),
                "batch_stats": tensors(variables["batch_stats"]),
                "num_labels": int(num_labels)}, path)
