"""Device mesh of one process: the ``--data_parallel``, ``--fold_parallel``
and ``--mesh auto`` policies, and the data axis's execution.

Counterpart of ``glomeruli_segmentation_tpu/parallel/mesh.py``, with the
same policies, messages and examples.  As there, one process drives N
devices: a :class:`Mesh` is a numpy array of torch devices shaped by its
axis names, with its ``shape`` dict.  Its devices default to the visible
CUDA devices; every constructor also takes an explicit ``devices=`` list,
which may name one device more than once (N logical devices on one card,
or N ``cpu`` devices in the tests).  Asking for more devices than the list
holds raises; nothing shrinks the request.

:class:`Replicas` runs the data axis: one replica of a model per data-axis
device, each batch split into contiguous shards, and shard i uploaded to,
run on and read back from device i on that position's own CUDA stream.
Positions on one device share that device's replica.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


def visible_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh takes by default: every visible CUDA device, or
    one ``cpu`` device when ``device`` is the CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def canonical(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card, so that
    two names of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_array(devices: Sequence[torch.device]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [canonical(d) for d in devices]
    return arr


class Mesh:
    """Devices laid out on named axes: ``devices`` is an object array whose
    shape is the axes' sizes, ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        arr = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(arr.reshape(arr.shape[0], -1)[:, 0])


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data", "model"),
              model_parallelism: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` devices (all by
    default); ``model_parallelism > 1`` splits a model axis."""
    devices = visible_devices() if devices is None else list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} device(s) are available "
                f"({[d.type for d in devices]}); lower --data_parallel")
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0 or n % model_parallelism:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model_parallelism}")
    arr = _device_array(devices).reshape(n // model_parallelism,
                                         model_parallelism)
    return Mesh(arr, axis_names)


def make_data_mesh(data_parallel: int, batch_size: int,
                   devices=None) -> Optional[Mesh]:
    """The ``--data_parallel`` CLI policy, shared by every stage: ``0`` ->
    no mesh (single device), ``-1`` -> all devices, ``N`` -> exactly N;
    the batch must split evenly over the data axis."""
    if not data_parallel:
        return None
    mesh = make_mesh(None if data_parallel < 0 else data_parallel,
                     devices=devices)
    d = mesh.shape["data"]
    if batch_size % d:
        raise ValueError(f"batch_size {batch_size} must be a multiple of "
                         f"the data-axis size {d}")
    return mesh


def make_fold_mesh(fold_parallel: int, data_parallel: int,
                   batch_size: int, devices=None) -> Mesh:
    """The ``--fold_parallel`` CLI policy: a 2-D ``("fold", "data")`` mesh.

    ``fold_parallel`` devices carry the ensemble's fold axis (``-1`` -> all
    devices not claimed by the data axis); ``data_parallel`` (``0`` taken
    as 1) carries the crop-batch axis."""
    if data_parallel < 0:
        raise ValueError("--data_parallel -1 cannot compose with "
                         "--fold_parallel; give an explicit size")
    n_data = max(1, data_parallel)
    devices = visible_devices() if devices is None else list(devices)
    n_fold = (len(devices) // n_data if fold_parallel < 0 else fold_parallel)
    need = n_fold * n_data
    if n_fold < 1 or len(devices) < need:
        raise ValueError(
            f"requested a {n_fold}x{n_data} (fold x data) mesh but only "
            f"{len(devices)} device(s) are available; lower the sizes")
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} must be a multiple of "
                         f"the data-axis size {n_data}")
    arr = _device_array(devices[:need]).reshape(n_fold, n_data)
    return Mesh(arr, ("fold", "data"))


def resolve_auto_mesh(n_folds: int, batch_size: int,
                      n_devices: Optional[int] = None) -> tuple:
    """``--mesh auto``: the (fold, data) axis sizes.  The fold axis is
    filled first -- the smallest divisor of the device count that covers
    every fold (zero-weight pads make up the difference,
    :func:`..parallel.fold_parallel.pad_folds`) -- and only the devices
    beyond it go to the data axis, which must divide the crop batch.
    ``(0, 0)``: one device, no mesh.

    Examples: 8 devices x 5 folds -> (8, 1); 16 -> (8, 2); 12 -> (6, 2);
    4 -> (4, 1)."""
    n = len(visible_devices()) if n_devices is None else n_devices
    if n < 2 or n_folds < 1:
        return 0, 0
    if n_folds < 2:
        # one fold has no ensemble to spread: pure data parallelism
        return 0, auto_data_parallel(batch_size, n)
    fold = n
    for d in range(n_folds, n + 1):
        if n % d == 0:
            fold = d
            break
    data = n // fold
    while data > 1 and batch_size % data:
        # grow the fold axis (more zero-weight pads) until the data axis
        # divides the batch
        for d in range(fold + 1, n + 1):
            if n % d == 0:
                fold = d
                break
        else:
            fold = n
        data = n // fold
    return fold, data


def auto_data_parallel(batch_size: int,
                       n_devices: Optional[int] = None) -> int:
    """``--mesh auto`` for a pure data-parallel stage (the detector's
    window batches): the largest device count <= ``n_devices`` that
    divides the batch; 0 = stay on one device."""
    n = len(visible_devices()) if n_devices is None else n_devices
    if n < 2:
        return 0
    d = min(n, batch_size)
    while d > 1 and batch_size % d:
        d -= 1
    return d if d > 1 else 0


class Sharding(NamedTuple):
    """How an array lies on a mesh: ``spec`` names the mesh axis its
    leading axis is split over, or is empty for a replicated array."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis split over the data axis."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, batch) -> List[torch.Tensor]:
    """A host batch split as :class:`Replicas` splits it, shard i on
    data-axis device i."""
    devices = mesh.axis_devices("data")
    return Replicas(devices, [None] * len(devices),
                    [None] * len(devices)).run(
        lambda _, dev, part: part.to(dev), torch.as_tensor(batch))


def replicate(mesh: Mesh, tree):
    """``tree`` (a tensor, or dicts, lists and tuples of tensors) copied to
    every device of the mesh, in the mesh's flat order; one copy per
    distinct device, as :meth:`Replicas.build` makes its replicas."""

    def to(node, dev):
        if isinstance(node, dict):
            return {k: to(v, dev) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(to(v, dev) for v in node)
        return torch.as_tensor(node).to(dev)

    return Replicas.build(mesh.devices.reshape(-1),
                          lambda dev: to(tree, dev)).replicas


def upload(array, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``: on a card through
    pinned memory (a pinned tensor is copied from as it is, with no staging
    copy), without waiting for the device, on the current stream; on the
    CPU a view."""
    t = array if isinstance(array, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def on_stream(device: torch.device, stream):
    """Make ``stream`` current on ``device`` after it has waited for the
    work already on the device's current stream (the weights' uploads,
    for one); nothing on the CPU."""
    if stream is None:
        yield
        return
    with torch.cuda.device(device):
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            yield


def position_streams(devices: Sequence[torch.device]) -> list:
    """One CUDA stream per mesh position (None on the CPU)."""
    return [torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in devices]


class Replicas:
    """Positions of a mesh axis that each run a whole batch shard: position
    i has a device, a replica of the model there and a CUDA stream (None on
    the CPU, or for one position driven on the device's current stream).
    :meth:`build` makes one replica per distinct device."""

    def __init__(self, devices: Sequence[torch.device], replicas: list,
                 streams: list):
        self.devices = [canonical(d) for d in devices]
        self.replicas = list(replicas)
        self.streams = list(streams)

    @classmethod
    def build(cls, devices: Sequence[torch.device],
              build: Callable[[torch.device], object]) -> "Replicas":
        devices = [canonical(d) for d in devices]
        built = {}
        for d in devices:
            if d not in built:
                built[d] = build(d)
        return cls(devices, [built[d] for d in devices],
                   position_streams(devices))

    def __len__(self) -> int:
        return len(self.devices)

    def run(self, fn, *arrays) -> list:
        """``fn(replica, device, *shards)`` at each position in turn, with
        shard i of every array (a contiguous part of its leading axis) and
        position i's stream current; returns the results in order."""
        n, parts = len(arrays[0]), len(self.devices)
        if n % parts:
            raise ValueError(f"batch size {n} must be a multiple of the "
                             f"data-axis size {parts}")
        size = n // parts
        out = []
        for i, (rep, dev, stream) in enumerate(zip(
                self.replicas, self.devices, self.streams)):
            part = slice(i * size, (i + 1) * size)
            with on_stream(dev, stream):
                out.append(fn(rep, dev, *(a[part] for a in arrays)))
        return out

    def submit(self, fn, *arrays):
        """:meth:`run` for an ``fn`` that returns readback handles: the one
        handle of a single position, else the list of the shards' handles
        (:func:`..read_host` reads either)."""
        out = self.run(fn, *arrays)
        return out[0] if len(out) == 1 else out


def move(t: torch.Tensor, stream, device: torch.device) -> torch.Tensor:
    """``t``, made on ``stream``, for use on ``device``'s current stream:
    on the same device that stream waits for ``stream`` and ``t`` is kept
    from reuse until it has run; across devices the copy is enqueued on
    ``stream`` (torch's peer copy runs on the source's current stream and
    orders itself with the destination's).  Call it after the work that
    makes ``t`` has been enqueued."""
    if stream is None:
        return t.to(device)
    if t.device == device:
        current = torch.cuda.current_stream(device)
        if current != stream:
            current.wait_stream(stream)
            t.record_stream(current)
        return t
    with torch.cuda.stream(stream):
        return t.to(device, non_blocking=True)
