"""Fold ("expert") parallelism: the ensemble's fold networks spread over
the devices of a mesh axis.

Counterpart of ``glomeruli_segmentation_tpu/parallel/fold_parallel.py``.
Data parallelism puts every fold on every device and splits the crop
batch; this is the other axis: each device holds only its slice of the
folds and runs the whole batch (or its data shard) through them.

The fold count seldom matches the device count, so the stacked fold states
are padded to a multiple of the axis size with duplicates of the first fold
whose probabilities are multiplied by 0.0 (:func:`pad_folds`).  Two ways to
combine the folds' softmaxes:

- ``exact=True`` (default): every fold's weighted probabilities are copied
  to the data column's first device and added strictly in fold order, bit
  for bit the sequential fold loop (a pad adds exactly +0.0);
- ``exact=False``: each device sums its own folds, then the partial sums
  are added in device order, which may reassociate the float32 sum.

The argmax of the sum (first class on ties) is the class map.  A data
axis composes: each (fold, data) position runs data shard ``d`` through
fold slice ``f``, and the fold combine stays inside data column ``d``.

One process drives the mesh (:mod:`.mesh`).  On a card each position runs
on its own CUDA stream, dispatched from its own host thread; the column's
upload, resize, combine and readback run on the stream of its first
position.  On the CPU the positions run in turn.
"""
from __future__ import annotations

import concurrent.futures
import copy
from typing import Mapping

import numpy as np
import torch

from .. import read_host, readback, tf32
from .mesh import Mesh, move, on_stream, position_streams, upload


def pad_folds(stacked_state: Mapping[str, torch.Tensor], mean: torch.Tensor,
              std: torch.Tensor, n_dev: int):
    """Pad a fold-leading stacked state dict to a multiple of ``n_dev``
    folds with copies of fold 0.  Returns (padded state, padded mean,
    padded std, fold weights): 1.0 for the real folds, 0.0 for the pads."""
    n_folds = mean.shape[0]
    pad = (-n_folds) % n_dev

    def pad_leading(a):
        if pad == 0:
            return a
        return torch.cat([a] + [a[:1]] * pad, dim=0)

    weights = torch.cat([torch.ones(n_folds), torch.zeros(pad)])
    return ({k: pad_leading(v) for k, v in stacked_state.items()},
            pad_leading(mean), pad_leading(std), weights)


def unstack(stacked_state: Mapping[str, torch.Tensor], fold: int) -> dict:
    """Fold ``fold``'s state dict out of a fold-leading stacked one."""
    return {k: v[fold] for k, v in stacked_state.items()}


class _Position:
    """One (fold, data) position: its device, stream, the nets of its fold
    slice and their normalisation and weights."""

    def __init__(self, device, stream, nets, mean, std, weight):
        self.device, self.stream = device, stream
        self.nets, self.mean, self.std, self.weight = nets, mean, std, weight


class FoldParallelEnsemble:
    """The fold-sharded ensemble: pads the folds, places each fold slice's
    nets on its device once, and combines per call.

    Args:
      mesh: the device mesh (:mod:`.mesh`).
      model: the per-fold ``nn.Module`` (ESPNet); each fold gets a copy
        loaded with its state, in ``compute_dtype``.
      stacked_state: fold-leading stacked state dict (F on dim 0).
      mean/std: (F, 3) per-fold BGR normalisation.
      axis_name: the mesh axis the folds spread over.
      data_axis: optional second axis the batch splits over.
      compute_dtype: the nets' weights and input type; the softmax and the
        combine are float32.
      precision: ``"highest"`` (TF32 off) or ``"default"`` (TF32 on).
      exact: ordered combine (bit-identical to the sequential fold loop)
        or per-device partial sums.
    """

    def __init__(self, mesh: Mesh, model: torch.nn.Module,
                 stacked_state: Mapping[str, torch.Tensor],
                 mean, std, *, axis_name: str = "data",
                 data_axis: str = None,
                 compute_dtype: torch.dtype = torch.float32,
                 precision: str = "highest", exact: bool = True):
        if precision not in ("default", "highest"):
            raise ValueError(f"unknown precision {precision!r}")
        mean = torch.as_tensor(mean, dtype=torch.float32).cpu()
        std = torch.as_tensor(std, dtype=torch.float32).cpu()
        n_fold = mesh.shape[axis_name]
        state, mean_p, std_p, weights = pad_folds(
            {k: v.cpu() for k, v in stacked_state.items()}, mean, std,
            n_fold)
        per = len(weights) // n_fold
        # (fold, data) grid of devices; other axes at index 0
        axes = [axis_name] + ([data_axis] if data_axis else [])
        order = [mesh.axis_names.index(a) for a in axes]
        order += [i for i in range(len(mesh.axis_names)) if i not in order]
        grid = np.transpose(mesh.devices, order)
        if data_axis is None:
            grid = grid.reshape(grid.shape[0], -1)[:, :1]
        else:
            grid = grid.reshape(grid.shape[0], grid.shape[1], -1)[:, :, 0]
        self.dtype = compute_dtype
        self.allow_tf32 = precision == "default"
        self.exact = exact
        self.data_axis = data_axis
        self.fold_weights = weights
        nets_on = {}

        def nets(f, device):
            # a fold slice's nets once per distinct device
            key = (f, device)
            if key not in nets_on:
                made = []
                for k in range(f * per, (f + 1) * per):
                    net = copy.deepcopy(model)
                    net.load_state_dict(unstack(state, k), strict=True)
                    made.append(net.to(device, compute_dtype).eval())
                nets_on[key] = made
            return nets_on[key]

        self.columns = []
        for d in range(grid.shape[1]):
            devices = [torch.device(x) for x in grid[:, d]]
            streams = position_streams(devices)
            self.columns.append([
                _Position(dev, stream, nets(f, dev),
                          mean_p[f * per:(f + 1) * per].to(dev),
                          std_p[f * per:(f + 1) * per].to(dev),
                          [float(w) for w in weights[f * per:(f + 1) * per]])
                for f, (dev, stream) in enumerate(zip(devices, streams))])
        self._pool = None
        if any(p.stream is not None for p in self.columns[0]) \
                and len(self.columns[0]) > 1:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=len(self.columns[0]),
                thread_name_prefix="fold-position")

    @property
    def column_devices(self):
        """Each data column's first device, where its batch shard is
        uploaded, combined and read back."""
        return [col[0].device for col in self.columns]

    @property
    def column_streams(self):
        return [col[0].stream for col in self.columns]

    @torch.no_grad()
    def _position_probs(self, pos: _Position, x: torch.Tensor, src_stream):
        """The weighted float32 softmaxes (B, C, H, W) of ``pos``'s folds
        for the column's batch ``x`` (float32, on the column's device)."""
        with on_stream(pos.device, pos.stream):
            x = move(x, src_stream, pos.device)
            out = []
            with tf32(self.allow_tf32, self.allow_tf32):
                for net, m, s, w in zip(pos.nets, pos.mean, pos.std,
                                        pos.weight):
                    xn = ((x - m) / s / 255.0).to(self.dtype)
                    logits = net(xn.permute(0, 3, 1, 2).contiguous())
                    out.append(w * torch.softmax(logits.float(), dim=1))
            if not self.exact:
                acc = out[0]
                for p in out[1:]:
                    acc = acc + p
                out = [acc]
            return out

    def column_argmax(self, d: int, x: torch.Tensor) -> torch.Tensor:
        """Data column ``d``: its batch shard ``x`` (B, H, W, 3), float32
        on the column's device with the column's stream current ->
        (B, H, W) uint8 class maps there."""
        col = self.columns[d]
        src = col[0].stream
        if self._pool is not None:
            futures = [self._pool.submit(self._position_probs, pos, x, src)
                       for pos in col]
            parts = [f.result() for f in futures]
        else:
            parts = [self._position_probs(pos, x, src) for pos in col]
        acc = None
        for pos, probs in zip(col, parts):
            for p in probs:
                p = move(p, pos.stream, col[0].device)
                acc = p if acc is None else acc + p
        return torch.argmax(acc, dim=1).to(torch.uint8)

    def __call__(self, resized) -> torch.Tensor:
        """(B, H, W, 3) crops at network resolution (host numpy or a
        tensor) -> (B, H, W) uint8 class maps, on the host."""
        n = len(resized)
        if n % len(self.columns):
            raise ValueError(
                f"batch size {n} must be a multiple of the "
                f"'{self.data_axis}' axis size {len(self.columns)}")
        size = n // len(self.columns)
        handles = []
        for d, (dev, stream) in enumerate(zip(self.column_devices,
                                              self.column_streams)):
            part = resized[d * size:(d + 1) * size]
            with on_stream(dev, stream):
                x = (part.to(dev) if isinstance(part, torch.Tensor)
                     else upload(part, dev)).float()
                handles.append(readback(self.column_argmax(d, x)))
        return torch.from_numpy(read_host(handles))


def fold_parallel_argmax(mesh: Mesh, model, stacked_state, mean, std,
                         resized, **kwargs) -> torch.Tensor:
    """One call of a :class:`FoldParallelEnsemble` built for it (tests);
    callers with many batches build the ensemble once."""
    return FoldParallelEnsemble(mesh, model, stacked_state, mean, std,
                                **kwargs)(resized)


def stack_states(state_dicts) -> dict:
    """Fold state dicts -> one fold-leading stacked state dict."""
    return {k: torch.stack([torch.as_tensor(sd[k]) for sd in state_dicts])
            for k in state_dicts[0]}
